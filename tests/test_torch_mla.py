"""The port's MLA (minicpm3-4b: multi-head latent attention, prefill with
the latent expanded, the absorbed decode) against the JAX model, on the
same weights.

``reduced(minicpm3-4b)`` (2 layers, d_model 64, 4 heads; qk 16 + 8 rope,
v 16, q_lora 32, kv_lora 16) with ``PRNGKey(0)`` weights carried over by
``repro_torch.convert``; both sides in fp32. The reference runs MLA in jnp
only, and so does the port, in plain PyTorch: no kernel launches.
Tolerances: 1e-5 absolute on one layer's output, 1e-4 on logits and the
latent cache (two layers), decode against teacher forcing 2e-3 as
``tests/test_models.py`` holds the JAX model.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from torch_parity import (flatten_params, greedy_decode,  # noqa: E402
                          greedy_engines, model_pair, random_tokens,
                          to_torch)

ATOL = 1e-4
ARCH = "minicpm3-4b"


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's weights (``PRNGKey(1)``) on both sides."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = jattn.mla_init(jax.random.PRNGKey(1), jcfg)
    p = convert.params_from_numpy(flatten_params(jp), device="cpu")
    return jcfg, jp, cfg, p


def test_configs_match():
    jcfg, cfg = jget_config(ARCH), get_config("minicpm3_4b")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attn_type", "rms_eps",
              "rope_theta", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(reduced(cfg), f) == getattr(jreduced(jcfg), f), f
    assert vars(cfg.mla) == vars(jcfg.mla)
    assert vars(reduced(cfg).mla) == vars(jreduced(jcfg).mla)
    assert cfg.param_count() == jcfg.param_count() == 4_261_836_800
    m = reduced(cfg).mla
    assert (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
            m.kv_lora_rank) == (16, 8, 16, 16)


@pytest.mark.parametrize("seq", [1, 24])
def test_mla_forward_matches_jax(layer, seq):
    jcfg, jp, cfg, p = layer
    x = (np.random.default_rng(seq).normal(size=(2, seq, 64)) * 0.5).astype(
        np.float32)
    pos = np.arange(seq)[None, :]
    want = jattn.mla_forward(jp, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos))
    got = attention.mla_forward(p, to_torch(x), cfg,
                                positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_matches_jax(layer, per_slot):
    """The absorbed decode against the reference's, from a cache holding
    random latents, at one shared position or each slot at its own; the
    written rows and the output."""
    jcfg, jp, cfg, p = layer
    rng = np.random.default_rng(7)
    b, s = 3, 20
    x = (rng.normal(size=(b, 1, 64)) * 0.5).astype(np.float32)
    ckv = rng.normal(size=(b, s, 16)).astype(np.float32)
    krope = rng.normal(size=(b, s, 8)).astype(np.float32)
    pos = np.array([0, 7, 19], np.int32) if per_slot else np.int32(11)
    want, wckv, wkrope = jattn.mla_decode(
        jp, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(krope),
        jnp.asarray(pos), jcfg)
    tckv, tkrope = to_torch(ckv), to_torch(krope)
    got = attention.mla_decode(p, to_torch(x), tckv, tkrope,
                               torch.as_tensor(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tckv.numpy(), np.asarray(wckv), atol=1e-6)
    np.testing.assert_allclose(tkrope.numpy(), np.asarray(wkrope), atol=1e-6)


def test_mla_decode_masks_past_pos(layer):
    """Keys past ``pos`` do not count: changing them leaves the output."""
    _, _, cfg, p = layer
    rng = np.random.default_rng(8)
    x = to_torch((rng.normal(size=(1, 1, 64)) * 0.5).astype(np.float32))
    ckv = to_torch(rng.normal(size=(1, 12, 16)).astype(np.float32))
    krope = to_torch(rng.normal(size=(1, 12, 8)).astype(np.float32))
    pos = torch.tensor(5)
    a = attention.mla_decode(p, x, ckv.clone(), krope.clone(), pos, cfg)
    ckv[:, 6:] += 3.0
    krope[:, 6:] -= 3.0
    b = attention.mla_decode(p, x, ckv, krope, pos, cfg)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("seq", [16, 40])
def test_forward_logits_match(pair, seq):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, seq, seed=seq)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("seq", [16, 48])
def test_prefill_latent_cache_matches(pair, seq):
    """The ``ckv`` and ``krope`` leaves after prefill: the latent and the
    rotated rope key of every position, zeros to max_len."""
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, seq, seed=seq + 1)
    want_logits, want_cache = jtransformer.prefill(
        jparams, jcfg, jnp.asarray(tok), max_len=64, dtype=jnp.float32)
    got_logits, got_cache = transformer.prefill(
        params, cfg, to_torch(tok), max_len=64, dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL)
    assert set(got_cache) == set(want_cache) == {"ckv", "krope", "pos"}
    assert got_cache["ckv"].shape == (2, 2, 64, 16)
    assert got_cache["krope"].shape == (2, 2, 64, 8)
    for leaf in ("ckv", "krope"):
        np.testing.assert_allclose(got_cache[leaf].numpy(),
                                   np.asarray(want_cache[leaf].value),
                                   atol=ATOL, err_msg=leaf)
        assert not got_cache[leaf][:, :, seq:].any()
    assert int(got_cache["pos"]) == int(want_cache["pos"].value) == seq


def test_decode_steps_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, 24, seed=2)
    _, jc = jtransformer.prefill(jparams, jcfg, jnp.asarray(tok), max_len=32,
                                 dtype=jnp.float32)
    _, tc = transformer.prefill(params, cfg, to_torch(tok), max_len=32,
                                dtype=torch.float32)
    for step in random_tokens(3, 2, seed=3):
        step = step.reshape(2, 1)
        want, jc = jtransformer.decode_step(jparams, jcfg, jc,
                                            jnp.asarray(step),
                                            dtype=jnp.float32)
        got, tc = transformer.decode_step(params, cfg, tc, to_torch(step),
                                          dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for leaf in ("ckv", "krope"):
        np.testing.assert_allclose(tc[leaf].numpy(),
                                   np.asarray(jc[leaf].value), atol=ATOL,
                                   err_msg=leaf)
    assert int(tc["pos"]) == int(jc["pos"].value) == 27


def test_decode_matches_teacher_forcing(pair):
    """The absorbed decode's logits at every step equal the expanded
    prefill's at that position, the port's and the JAX model's."""
    jcfg, _, jparams, cfg, bundle, params = pair
    prompt = torch.from_numpy(random_tokens(1, 16, seed=7))
    ops.reset_launch_counts()
    dec, full = greedy_decode(bundle, params, prompt, 64)
    assert not any(ops.launch_counts().values())
    want = transformer.forward(params, cfg, full, dtype=torch.float32)
    jwant = np.asarray(jtransformer.forward(jparams, jcfg,
                                            jnp.asarray(full.numpy()),
                                            dtype=jnp.float32))
    for i, lg in enumerate(dec):
        pos = prompt.shape[1] + i
        torch.testing.assert_close(lg, want[0, pos], atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(lg.numpy(), jwant[0, pos], atol=2e-3,
                                   rtol=2e-3)


def test_greedy_tokens_equal_jax_engine(pair):
    """Requests over two slots; the engine splices the ``ckv`` and
    ``krope`` leaves into each slot."""
    _, jbundle, jparams, _, bundle, params = pair
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29,
               "semantic query number 4 about movies"]
    want, got = greedy_engines(jbundle, jparams, bundle, params, prompts)
    assert len(got) == len(prompts)
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_int8_kv_dtype_ignored_by_mla(pair):
    """``kv_dtype=torch.int8`` no longer raises: as in the reference, the
    MLA cache ignores it (the latent and rope key stay in the cache's
    dtype), and decode over it gives the fp cache's logits exactly."""
    cfg, bundle, params = pair[3], pair[4], pair[5]
    q8 = transformer.init_cache(cfg, 1, 16, dtype=torch.float32,
                                kv_dtype=torch.int8, device="cpu")
    fp = transformer.init_cache(cfg, 1, 16, dtype=torch.float32,
                                device="cpu")
    assert set(q8) == set(fp) == {"ckv", "krope", "pos"}
    assert all(q8[k].dtype == fp[k].dtype for k in fp)
    for t in (3, 7, 11):
        tok = torch.tensor([[t]])
        a, q8 = bundle.decode_step(params, q8, tok, dtype=torch.float32)
        b, fp = bundle.decode_step(params, fp, tok, dtype=torch.float32)
        assert torch.equal(a, b)


def test_serve_main_runs_minicpm3_on_cpu(capsys):
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch import serve
    finished = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "5", "--slots", "2", "--max-new",
                           "6"])
    assert len(finished) == 5
    eos = ByteTokenizer.eos_id
    assert all(len(r.output_ids) == 6 or r.output_ids[-1] == eos
               for r in finished.values())
    out = capsys.readouterr().out
    assert "arch=minicpm3-4b-smoke" in out and "new tok/s" in out
