"""The port's Mamba2 (SSM family) against the JAX model, on the same weights.

``reduced(mamba2-1.3b)`` (2 layers, d_model 64, 8 SSM heads of head_dim 16,
d_state 16, chunk 32) with ``PRNGKey(0)`` weights carried over by
``repro_torch.convert``; both sides in fp32. Tolerance 1e-4 absolute on
logits of magnitude ~4 and on the cache: sums taken in another order (XLA
vs PyTorch CPU matmuls and einsums) over two layers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.engine import GenerationEngine as JEngine  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.engine import ContinuousBatcher, GenerationEngine  # noqa: E402
from repro_torch.engine.engine import PREFILL_ALIGN, Request  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from torch_parity import flatten_params, to_torch  # noqa: E402

ATOL = 1e-4
ARCH = "mamba2-1.3b"
CACHE = ("ssm_state", "conv_buf")


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduced(jget_config(ARCH))
    jbundle = jregistry.build(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH))
    params = convert.params_from_numpy(flatten_params(jparams), device="cpu")
    return jcfg, jbundle, jparams, cfg, registry.build(cfg), params


def tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s),
                                                dtype=np.int32)


def test_configs_match():
    jcfg, cfg = jget_config(ARCH), get_config("mamba2_1_3b")
    for f in ("family", "n_layers", "d_model", "vocab_size", "attn_type",
              "tie_embeddings", "rms_eps", "d_ff"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("d_state", "expand", "head_dim", "chunk_size", "conv_width",
              "n_groups"):
        assert getattr(cfg.ssm, f) == getattr(jcfg.ssm, f), f
        assert getattr(reduced(cfg).ssm, f) == getattr(jreduced(jcfg).ssm, f)
    assert cfg.param_count() == jcfg.param_count() == 1_446_402_048
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (48, 2048, 50280)


def test_converted_params_keep_layouts(pair):
    """The JAX tree (conv_w under ("layer", "conv", "ssm_conv_ch"), the 1-D
    A_log / D / dt_bias under the layer axis) carries over with its shapes,
    which are those of the port's own init."""
    _, _, jparams, cfg, _, params = pair
    flat = flatten_params(jparams)
    assert flat["layers/ssm/conv_w"][1] == ("layer", "conv", "ssm_conv_ch")
    assert flat["layers/ssm/A_log"][1] == ("layer", "ssm_heads")
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
    for name in ("A_log", "D", "dt_bias"):     # log(1..H) within an ulp
        np.testing.assert_allclose(native["layers"]["ssm"][name].numpy(),
                                   params["layers"]["ssm"][name].numpy(),
                                   rtol=1e-6)


def test_forward_logits_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok = tokens(2, 40)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("seq", [2, 20, 48])
def test_prefill_logits_and_state_match(pair, seq):
    """Sequences shorter than the conv window, shorter than one chunk, and
    longer than one (48: the chunk rule gives 16)."""
    jcfg, _, jparams, cfg, _, params = pair
    tok = tokens(2, seq, seed=seq)
    want_logits, want_cache = jtransformer.prefill(
        jparams, jcfg, jnp.asarray(tok), max_len=64, dtype=jnp.float32)
    got_logits, got_cache = transformer.prefill(
        params, cfg, to_torch(tok), max_len=64, dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL)
    assert set(got_cache) == set(want_cache) == {*CACHE, "pos"}
    for leaf in CACHE:
        assert got_cache[leaf].shape == want_cache[leaf].value.shape
        np.testing.assert_allclose(got_cache[leaf].numpy(),
                                   np.asarray(want_cache[leaf].value),
                                   atol=ATOL)
    assert int(got_cache["pos"]) == int(want_cache["pos"].value) == seq


def test_three_decode_steps_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok = tokens(2, 24, seed=2)
    _, jc = jtransformer.prefill(jparams, jcfg, jnp.asarray(tok), max_len=32,
                                 dtype=jnp.float32)
    _, tc = transformer.prefill(params, cfg, to_torch(tok), max_len=32,
                                dtype=torch.float32)
    for step in tokens(3, 2, seed=3):
        step = step.reshape(2, 1)
        want, jc = jtransformer.decode_step(jparams, jcfg, jc,
                                            jnp.asarray(step),
                                            dtype=jnp.float32)
        got, tc = transformer.decode_step(params, cfg, tc, to_torch(step),
                                          dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for leaf in CACHE:
        np.testing.assert_allclose(tc[leaf].numpy(),
                                   np.asarray(jc[leaf].value), atol=ATOL)
    assert int(tc["pos"]) == int(jc["pos"].value) == 27


def test_decode_matches_teacher_forcing(pair):
    """Greedy decode logits equal the full forward's at each position (the
    recurrent state and conv tail carry what the chunked scan computes);
    the tolerance of ``tests/test_models.py``."""
    _, _, _, cfg, bundle, params = pair
    prompt = torch.from_numpy(tokens(1, 12, seed=7))
    logits, cache = bundle.prefill(params, {"tokens": prompt}, max_len=16,
                                   dtype=torch.float32)
    toks = [int(logits[0, -1].argmax())]
    dec = []
    for _ in range(3):
        lg, cache = bundle.decode_step(params, cache,
                                       torch.tensor([[toks[-1]]]),
                                       dtype=torch.float32)
        dec.append(lg[0, 0])
        toks.append(int(lg[0, 0].argmax()))
    full = torch.cat([prompt, torch.tensor([toks[:-1]], dtype=prompt.dtype)],
                     dim=1)
    want = transformer.forward(params, cfg, full, dtype=torch.float32)
    for i, lg in enumerate(dec):
        torch.testing.assert_close(lg, want[0, prompt.shape[1] + i],
                                   atol=2e-3, rtol=2e-3)


def engine(bundle, params, **kw):
    return GenerationEngine(bundle, params, device="cpu", **kw)


def padded(prompt, max_len=64):
    """The engine's prefill tokens of ``prompt``, and its ids."""
    tok = ByteTokenizer()
    ids = tok.encode(prompt)[:max_len - 1]
    return torch.from_numpy(tok.pad_batch([ids], align=PREFILL_ALIGN)), ids


def test_greedy_tokens_equal_jax_engine(pair):
    """Several requests over two slots, each prompt right-padded to 16 with
    PAD tokens that run through the recurrence (the reference's quirk),
    give the JAX engine's greedy tokens."""
    _, jbundle, jparams, _, bundle, params = pair
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29,
               "semantic query number 4 about movies"]
    jcb = JBatcher(JEngine(jbundle, jparams, max_len=64, n_slots=2))
    cb = ContinuousBatcher(engine(bundle, params, max_len=64, n_slots=2))
    for p in prompts:
        jcb.submit(p, max_new_tokens=10)
        cb.submit(p, max_new_tokens=10)
    want, got = jcb.run(), cb.run()
    assert sorted(len(r.prompt_ids) for r in got.values()) == [7, 12, 16, 30,
                                                               37]
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_padded_prefill_state_differs_from_unpadded(pair):
    """The quirk, stated: the state the engine splices into a slot has seen
    the pad tokens, so it differs from the state after the prompt alone,
    and so does the first token's distribution."""
    _, _, _, cfg, bundle, params = pair
    tokens_pad, ids = padded("hello world")
    assert tokens_pad.shape[1] == 16 and len(ids) == 12
    lp, cp = bundle.prefill(params, {"tokens": tokens_pad}, max_len=64,
                            dtype=torch.float32)
    lu, cu = bundle.prefill(params, {"tokens": torch.tensor([ids])},
                            max_len=64, dtype=torch.float32)
    for leaf in CACHE:
        assert (cp[leaf] - cu[leaf]).abs().max() > 1e-3, leaf
    assert (lp - lu).abs().max() > 1e-3
    eng = engine(bundle, params, max_len=64, n_slots=2)
    eng.insert(Request(0, "hello world", max_new_tokens=4), 1)
    for leaf in CACHE:
        torch.testing.assert_close(eng.cache[leaf][:, 1], cp[leaf][:, 0],
                                   atol=0, rtol=0)
    assert int(eng.cache["pos"][1]) == len(ids)


def test_insert_splices_every_cache_leaf(pair):
    """An SSM slot after ``insert`` holds the state and conv tail of a B=1
    prefill; a second request in the same slot leaves no trace of the
    first; the other slot is untouched."""
    _, _, _, _, bundle, params = pair
    eng = engine(bundle, params, max_len=64, n_slots=3)
    first, second = "a first request about movies", "second"
    eng.insert(Request(0, first, max_new_tokens=4), 1)
    _, c1 = bundle.prefill(params, {"tokens": padded(first)[0]}, max_len=64,
                           dtype=torch.float32)
    for leaf in CACHE:
        torch.testing.assert_close(eng.cache[leaf][:, 1], c1[leaf][:, 0],
                                   atol=0, rtol=0)
        assert not eng.cache[leaf][:, [0, 2]].any(), leaf
    eng.active[1] = False
    eng.insert(Request(1, second, max_new_tokens=4), 1)
    _, c2 = bundle.prefill(params, {"tokens": padded(second)[0]}, max_len=64,
                           dtype=torch.float32)
    for leaf in CACHE:
        torch.testing.assert_close(eng.cache[leaf][:, 1], c2[leaf][:, 0],
                                   atol=0, rtol=0)
    assert int(eng.cache["pos"][1]) == len(padded(second)[1])


def test_unported_families_still_raise():
    from dataclasses import replace

    from repro_torch.configs import FAMILY_HYBRID, MoEConfig
    cfg = reduced(get_config(ARCH))
    for bad in (replace(cfg, family=FAMILY_HYBRID),
                replace(cfg, moe=MoEConfig(num_experts=4, top_k=2)),
                replace(cfg, ssm=None)):
        with pytest.raises(NotImplementedError):
            registry.build(bad)


def test_serve_main_runs_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve
    finished = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "5", "--slots", "2", "--max-new",
                           "6"])
    assert len(finished) == 5
    assert all(len(r.output_ids) == 6 for r in finished.values())
    out = capsys.readouterr().out
    assert "arch=mamba2-1.3b-smoke" in out and "new tok/s" in out
