"""The port's dense GQA decoder against the JAX model, on the same weights.

``reduced(qwen2-0.5b)`` (2 layers, d_model 64, 4 query heads over 2 KV
heads) with ``PRNGKey(0)`` weights carried over by ``repro_torch.convert``;
both sides in fp32. The tolerance, 1e-4 absolute on logits of magnitude
~1, covers sums taken in another order (XLA vs PyTorch CPU matmuls) over
two layers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from torch_parity import flatten_params, to_torch  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_config("qwen2-0.5b"))
    jparams = jregistry.build(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2-0.5b"))
    params = convert.params_from_numpy(flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s),
                                                dtype=np.int32)


def test_configs_match():
    jcfg = jget_config("qwen2-0.5b")
    cfg = get_config("qwen2_0_5b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qkv_bias", "rope_theta", "rms_eps",
              "tie_embeddings", "sliding_window"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert reduced(cfg).head_dim == jreduced(jcfg).head_dim


def test_converted_params_keep_layouts(pair):
    _, jparams, cfg, params = pair
    flat = flatten_params(jparams)
    native = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    native_flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                native_flat["/".join(prefix + (k,))] = tuple(v.shape)

    walk(native, ())
    assert native_flat == {k: a.shape for k, (a, _) in flat.items()}
    assert params["layers"]["attn"]["q"]["w"].shape == (2, 64, 4, 16)


def test_forward_logits_match(pair):
    jcfg, jparams, cfg, params = pair
    tok = tokens(2, 24)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_logits_and_cache_match(pair):
    jcfg, jparams, cfg, params = pair
    tok = tokens(2, 20, seed=1)
    want_logits, want_cache = jtransformer.prefill(
        jparams, jcfg, jnp.asarray(tok), max_len=32, dtype=jnp.float32)
    got_logits, got_cache = transformer.prefill(
        params, cfg, to_torch(tok), max_len=32, dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got_cache[leaf].numpy(),
                                   np.asarray(want_cache[leaf].value),
                                   atol=ATOL)
    assert int(got_cache["pos"]) == int(want_cache["pos"].value) == 20


def test_per_slot_decode_chain_matches(pair):
    """Four decode steps with every slot at its own depth: slot 0 resumes at
    position 10 over a 16-token prefill (the stale rows beyond are
    overwritten or masked), slot 1 at 16."""
    jcfg, jparams, cfg, params = pair
    tok = tokens(2, 16, seed=2)
    _, jc = jtransformer.prefill(jparams, jcfg, jnp.asarray(tok), max_len=32,
                                 dtype=jnp.float32)
    _, tc = transformer.prefill(params, cfg, to_torch(tok), max_len=32,
                                dtype=torch.float32)
    pos = np.array([10, 16], np.int32)
    jc["pos"] = jc["pos"].__class__(jnp.asarray(pos), ("batch",))
    tc["pos"] = to_torch(pos)
    steps = tokens(4, 2, seed=3)
    for step in steps:
        step = step.reshape(2, 1)
        want, jc = jtransformer.decode_step(jparams, jcfg, jc,
                                            jnp.asarray(step),
                                            dtype=jnp.float32)
        got, tc = transformer.decode_step(params, cfg, tc, to_torch(step),
                                          dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(),
                                   np.asarray(jc[leaf].value), atol=ATOL)
    np.testing.assert_array_equal(tc["pos"].numpy(),
                                  np.asarray(jc["pos"].value))


def test_unported_families_raise():
    """What the decoder still refuses: a dense config with an MoE config,
    and an encoder-decoder config, which ``registry.build`` routes to
    ``models.encdec`` instead; the int8 cache, once refused, gives int8
    values and bf16 scales."""
    from repro_torch.configs import MoEConfig
    from dataclasses import replace
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(NotImplementedError):
        registry.build(replace(cfg, moe=MoEConfig(num_experts=4, top_k=2)))
    encdec_cfg = replace(cfg, is_encoder_decoder=True, n_encoder_layers=1)
    with pytest.raises(NotImplementedError, match="encdec"):
        transformer.check_supported(encdec_cfg)
    cache = registry.build(encdec_cfg).init_cache(1, 16, enc_len=8,
                                                  device="cpu")
    assert set(cache) == {"k", "v", "ek", "ev", "pos"}
    cache = transformer.init_cache(cfg, 1, 16, kv_dtype=torch.int8,
                                   device="cpu")
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].dtype == torch.bfloat16
