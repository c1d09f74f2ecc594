"""The port's Hymba (hybrid family: GQA attention and a Mamba2 mixer side by
side in every layer) against the JAX model, on the same weights.

``reduced(hymba-1.5b)`` (2 layers, d_model 64, 4 query / 2 KV heads of 16,
8 SSM heads of head_dim 16, d_state 16, chunk 32; a sliding window of 64
on layer 1, full attention on layer 0) with ``PRNGKey(0)`` weights carried
over by ``repro_torch.convert``; both sides in fp32. Tolerances: 1e-4
absolute on logits of magnitude ~4 and on the four cache leaves (sums
taken in another order over two layers); decode against teacher forcing
2e-3 absolute and relative, as ``tests/test_models.py`` holds the JAX
model (the recurrent SSM step against the chunked scan).
"""
from dataclasses import replace

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
ARCH = "hymba-1.5b"
CACHE = ("k", "v", "ssm_state", "conv_buf")


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
    jcfg, cfg = jget_config(ARCH), get_config("hymba_1_5b")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attn_type", "rms_eps",
              "sliding_window", "full_attn_layers", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(reduced(cfg), f) == getattr(jreduced(jcfg), f), f
    for f in ("d_state", "expand", "head_dim", "chunk_size", "conv_width",
              "n_groups"):
        assert getattr(cfg.ssm, f) == getattr(jcfg.ssm, f), f
    assert cfg.param_count() == jcfg.param_count() == 1_640_663_296
    windows = transformer.layer_windows(cfg)
    assert windows == np.asarray(jtransformer.layer_windows(jcfg)).tolist()
    assert [i for i, w in enumerate(windows) if w == 0] == [0, 15, 31]
    assert set(windows) == {0, 1024}
    assert transformer.layer_windows(reduced(cfg)) == [0, 64]


def test_converted_params_keep_layouts(pair):
    """The JAX hybrid block (attn_norm, attn, ssm, attn_out_norm,
    ssm_out_norm, ffn; no ssm_norm) carries over with the shapes of the
    port's own init."""
    _, _, jparams, cfg, _, params = pair
    flat = flatten_params(jparams)
    native = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert set(native["layers"]) == {"attn_norm", "attn", "ssm",
                                     "attn_out_norm", "ssm_out_norm",
                                     "ffn_norm", "ffn"}
    native_flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                native_flat["/".join(prefix + (k,))] = tuple(v.shape)

    walk(native, ())
    assert native_flat == {k: a.shape for k, (a, _) in flat.items()}


@pytest.mark.parametrize("seq", [40, 96])
def test_forward_logits_match(pair, seq):
    """96 positions run past layer 1's window of 64."""
    jcfg, _, jparams, cfg, _, params = pair
    tok = tokens(2, seq, seed=seq)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("seq", [16, 48, 80])
def test_prefill_logits_and_cache_match(pair, seq):
    """Logits and all four cache leaves (K/V padded to max_len, the SSM
    state and conv tail) at lengths within one chunk, across chunks, and
    past the window."""
    jcfg, _, jparams, cfg, _, params = pair
    tok = tokens(2, seq, seed=seq)
    want_logits, want_cache = jtransformer.prefill(
        jparams, jcfg, jnp.asarray(tok), max_len=96, dtype=jnp.float32)
    got_logits, got_cache = transformer.prefill(
        params, cfg, to_torch(tok), max_len=96, dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL)
    assert set(got_cache) == set(want_cache) == {*CACHE, "pos"}
    for leaf in CACHE:
        assert got_cache[leaf].shape == want_cache[leaf].value.shape
        np.testing.assert_allclose(got_cache[leaf].numpy(),
                                   np.asarray(want_cache[leaf].value),
                                   atol=ATOL, err_msg=leaf)
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
                                   np.asarray(jc[leaf].value), atol=ATOL,
                                   err_msg=leaf)
    assert int(tc["pos"]) == int(jc["pos"].value) == 27


def _greedy_decode(bundle, params, prompt, max_len):
    """Prefill ``prompt`` and decode greedily up to ``max_len`` positions;
    returns (the decode steps' logits, the full token sequence)."""
    logits, cache = bundle.prefill(params, {"tokens": prompt},
                                   max_len=max_len, dtype=torch.float32)
    toks = [int(logits[0, -1].argmax())]
    dec = []
    for _ in range(max_len - prompt.shape[1] - 1):
        lg, cache = bundle.decode_step(params, cache,
                                       torch.tensor([[toks[-1]]]),
                                       dtype=torch.float32)
        dec.append(lg[0, 0])
        toks.append(int(lg[0, 0].argmax()))
    full = torch.cat([prompt, torch.tensor([toks[:-1]], dtype=prompt.dtype)],
                     dim=1)
    return dec, full


def test_decode_matches_teacher_forcing_past_the_window(pair):
    """Greedy decode over a max_len of 96 from a 16-token prompt: from
    position 64 on, layer 1's decode drops its oldest keys. Each step's
    logits equal the full forward's at that position, the port's and the
    JAX model's (windowed flash prefill against the windowed decode)."""
    jcfg, _, jparams, cfg, bundle, params = pair
    prompt = torch.from_numpy(tokens(1, 16, seed=7))
    dec, full = _greedy_decode(bundle, params, prompt, 96)
    assert full.shape[1] == 95
    want = transformer.forward(params, cfg, full, dtype=torch.float32)
    jwant = np.asarray(jtransformer.forward(jparams, jcfg,
                                            jnp.asarray(full.numpy()),
                                            dtype=jnp.float32))
    for i, lg in enumerate(dec):
        pos = prompt.shape[1] + i
        torch.testing.assert_close(lg, want[0, pos], atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(lg.numpy(), jwant[0, pos], atol=2e-3,
                                   rtol=2e-3)


def test_window_changes_decode_past_it(pair):
    """The window is live: the same weights with full attention on every
    layer decode alike up to position 63 and differently after it."""
    _, _, _, cfg, bundle, params = pair
    full_cfg = replace(cfg, sliding_window=0, full_attn_layers=())
    prompt = torch.from_numpy(tokens(1, 16, seed=7))
    _, toks = _greedy_decode(bundle, params, prompt, 96)
    windowed = transformer.forward(params, cfg, toks, dtype=torch.float32)
    unwindowed = transformer.forward(params, full_cfg, toks,
                                     dtype=torch.float32)
    gap = (windowed - unwindowed).abs().amax(dim=-1)[0]
    assert gap[:64].max() == 0
    assert gap[64:].min() > 1e-3


def engine(bundle, params, **kw):
    return GenerationEngine(bundle, params, device="cpu", **kw)


def padded(prompt, max_len=96):
    tok = ByteTokenizer()
    ids = tok.encode(prompt)[:max_len - 1]
    return torch.from_numpy(tok.pad_batch([ids], align=PREFILL_ALIGN)), ids


def test_greedy_tokens_equal_jax_engine(pair):
    """Requests over two slots at max_len 96; the long prompts decode past
    the window of 64 (a 37-token prompt plus 40 new tokens)."""
    _, jbundle, jparams, _, bundle, params = pair
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29,
               "semantic query number 4 about movies"]
    jcb = JBatcher(JEngine(jbundle, jparams, max_len=96, n_slots=2))
    cb = ContinuousBatcher(engine(bundle, params, max_len=96, n_slots=2))
    for p in prompts:
        jcb.submit(p, max_new_tokens=40)
        cb.submit(p, max_new_tokens=40)
    want, got = jcb.run(), cb.run()
    assert max(len(r.prompt_ids) + len(r.output_ids)
               for r in got.values()) > 64
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_insert_splices_all_four_leaves(pair):
    """A slot after ``insert`` holds K, V, the SSM state and the conv tail
    of a B=1 prefill; a second request in the same slot leaves no trace of
    the first; the other slots stay untouched."""
    _, _, _, _, bundle, params = pair
    eng = engine(bundle, params, max_len=96, n_slots=3)
    assert set(eng.cache) == {*CACHE, "pos"}
    first, second = "a first request about movies", "second"
    eng.insert(Request(0, first, max_new_tokens=4), 1)
    _, c1 = bundle.prefill(params, {"tokens": padded(first)[0]}, max_len=96,
                           dtype=torch.float32)
    for leaf in CACHE:
        torch.testing.assert_close(eng.cache[leaf][:, 1], c1[leaf][:, 0],
                                   atol=0, rtol=0)
        assert eng.cache[leaf][:, 1].any(), leaf
        assert not eng.cache[leaf][:, [0, 2]].any(), leaf
    eng.active[1] = False
    eng.insert(Request(1, second, max_new_tokens=4), 1)
    _, c2 = bundle.prefill(params, {"tokens": padded(second)[0]}, max_len=96,
                           dtype=torch.float32)
    for leaf in CACHE:
        torch.testing.assert_close(eng.cache[leaf][:, 1], c2[leaf][:, 0],
                                   atol=0, rtol=0)
    assert int(eng.cache["pos"][1]) == len(padded(second)[1])


def test_hybrid_without_attention_still_raises():
    from repro_torch.configs import ATTN_NONE
    cfg = reduced(get_config(ARCH))
    with pytest.raises(NotImplementedError):
        registry.build(replace(cfg, attn_type=ATTN_NONE))


def test_serve_main_runs_hymba_on_cpu(capsys):
    from repro_torch.launch import serve
    finished = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "5", "--slots", "2", "--max-new",
                           "6"])
    assert len(finished) == 5
    # each request runs to its 6 new tokens or ends at EOS (random weights)
    eos = ByteTokenizer.eos_id
    assert all(len(r.output_ids) == 6 or r.output_ids[-1] == eos
               for r in finished.values())
    assert sum(len(r.output_ids) == 6 for r in finished.values()) >= 4
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b-smoke" in out and "new tok/s" in out
