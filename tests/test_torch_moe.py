"""The port's MoE (granite-moe-1b-a400m, the gather path) against the JAX
model, on the same weights.

``reduced(granite-moe-1b-a400m)`` (2 layers, d_model 64, 4 query / 2 KV
heads of 16, 4 experts of width 64, top-2, capacity factor 8, tied
embeddings) with ``PRNGKey(0)`` weights carried over by
``repro_torch.convert``; both sides in fp32. Tolerances: 1e-5 absolute on
one MoE layer's output (magnitudes ~1; the expert products and the
combine sum in another order), 1e-4 on logits and the cache (two layers),
decode against teacher forcing 2e-3 as ``tests/test_models.py`` holds the
JAX model. ``reduced()`` sets the capacity factor to 8, which never drops;
the cases at the published factor 1.25 feed skewed inputs so that experts
overflow and assignments drop.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import ffn, registry, transformer  # noqa: E402
from torch_parity import (flatten_params, greedy_decode,  # noqa: E402
                          greedy_engines, model_pair, random_tokens,
                          to_torch)

ATOL = 1e-4
ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


def moe_configs(shared=False, capacity_factor=None):
    """The reduced config's MoE on both sides: a shared expert of width
    d_model, and/or another capacity factor."""
    out = []
    for cfg in (jreduced(jget_config(ARCH)), reduced(get_config(ARCH))):
        moe = replace(cfg.moe, shared_expert_ff=cfg.d_model if shared else 0)
        if capacity_factor is not None:
            moe = replace(moe, capacity_factor=capacity_factor)
        out.append(replace(cfg, moe=moe))
    return out


def moe_layer(shared=False, capacity_factor=None, key=1):
    """One MoE layer's weights (``PRNGKey(key)``) on both sides."""
    jcfg, cfg = moe_configs(shared, capacity_factor)
    jp = jffn.moe_init(jax.random.PRNGKey(key), jcfg)
    p = convert.params_from_numpy(flatten_params(jp), device="cpu")
    return jcfg, jp, cfg, p


def skewed(b, s, d, seed):
    """Rows that share one large direction, so the router favours some
    experts over others and, at capacity factor 1.25, overflows them."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=d) * 1.5
    return (rng.normal(size=(b, s, d)) * 0.5 + common).astype(np.float32)


def run_both(jcfg, jp, cfg, p, x):
    want = np.asarray(jffn.moe_forward_gather(jp, jnp.asarray(x), jcfg))
    got = ffn.moe_forward_gather(p, to_torch(x), cfg).numpy()
    return got, want


def dropped(p, cfg, x):
    """(assignments dropped, the dispatch's slot_tok) of the port's routing
    of x (B, S, d)."""
    x2d = to_torch(x).reshape(-1, x.shape[-1])
    _, experts = ffn.route(p["router"], x2d, cfg.moe)
    cap = ffn.capacity(x2d.shape[0], cfg.moe)
    counts = torch.bincount(experts.reshape(-1),
                            minlength=cfg.moe.num_experts)
    slot_tok = ffn.dispatch(experts, cap, cfg.moe.num_experts,
                            x2d.shape[0])[0]
    return int((counts - cap).clamp_min(0).sum()), slot_tok


def test_configs_match():
    jcfg, cfg = jget_config(ARCH), get_config("granite_moe_1b_a400m")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attn_type", "rms_eps",
              "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(reduced(cfg), f) == getattr(jreduced(jcfg), f), f
    assert vars(cfg.moe) == vars(jcfg.moe)
    assert vars(reduced(cfg).moe) == vars(jreduced(jcfg).moe)
    assert cfg.param_count() == jcfg.param_count() == 1_334_627_328
    assert (cfg.moe.num_experts, cfg.moe.top_k) == (32, 8)
    assert cfg.moe.capacity_factor == 1.25
    assert transformer.layer_windows(cfg) is None


@pytest.mark.parametrize("n_tokens", [1, 5, 8, 64, 200])
def test_capacity_matches_reference(n_tokens):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    assert ffn.capacity(n_tokens, cfg.moe) == jffn._capacity(n_tokens,
                                                             jcfg.moe)


def test_converted_params_keep_layouts(pair):
    _, _, jparams, cfg, _, _ = pair
    native = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    flat = flatten_params(jparams)
    native_flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                native_flat["/".join(prefix + (k,))] = tuple(v.shape)

    walk(native, ())
    assert native_flat == {k: a.shape for k, (a, _) in flat.items()}
    assert native_flat["layers/ffn/gate/w"] == (2, 4, 64, 64)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("shape", [(2, 24), (1, 7)])
def test_moe_forward_gather_matches_jax(shared, shape):
    jcfg, jp, cfg, p = moe_layer(shared)
    x = (np.random.default_rng(3).normal(size=shape + (64,)) * 0.5).astype(
        np.float32)
    got, want = run_both(jcfg, jp, cfg, p, x)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_route_matches_reference():
    """Weights renormalised over the top-k, experts in descending order."""
    jcfg, jp, cfg, p = moe_layer()
    x = np.random.default_rng(4).normal(size=(40, 64)).astype(np.float32)
    jw, je = jffn._route(jp["router"], jnp.asarray(x), jcfg.moe)
    w, e = ffn.route(p["router"], to_torch(x), cfg.moe)
    assert e.numpy().tolist() == np.asarray(je).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("shared", [False, True])
def test_production_capacity_drops_as_reference(shared):
    """At the published capacity factor 1.25 with skewed rows, experts
    overflow and assignments drop; the port's output equals the
    reference's, and differs from the dropless one on the dropped rows."""
    jcfg, jp, cfg, p = moe_layer(shared, capacity_factor=1.25)
    x = skewed(2, 64, 64, seed=5)
    n_dropped, _ = dropped(p, cfg, x)
    assert n_dropped > 0
    got, want = run_both(jcfg, jp, cfg, p, x)
    np.testing.assert_allclose(got, want, atol=1e-5)
    _, _, lcfg, _ = moe_layer(shared, capacity_factor=8.0)
    dropless = ffn.moe_forward_gather(p, to_torch(x), lcfg).numpy()
    assert dropped(p, lcfg, x)[0] == 0
    assert np.abs(got - dropless).max() > 1e-2


def test_pads_change_real_rows_and_drop_first():
    """The engine's quirk: a prompt right-padded to PREFILL_ALIGN routes
    its pads too. They raise the token count and so the capacity, so a real
    row's output depends on how much padding its prompt got; and the stable
    sort puts them after the real rows in each expert's block, so they are
    dropped first. Both sides agree padded and unpadded."""
    jcfg, jp, cfg, p = moe_layer(capacity_factor=1.25)
    real = skewed(1, 20, 64, seed=6)
    pads = skewed(1, 12, 64, seed=7)
    padded = np.concatenate([real, pads], axis=1)
    outs = {}
    for name, x in (("real", real), ("padded", padded)):
        got, want = run_both(jcfg, jp, cfg, p, x)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        outs[name] = got[:, :20]
    assert dropped(p, cfg, real)[0] > 0
    assert ffn.capacity(20, cfg.moe) < ffn.capacity(32, cfg.moe)
    assert np.abs(outs["real"] - outs["padded"]).max() > 1e-2
    n_dropped, slot_tok = dropped(p, cfg, padded)
    assert n_dropped > 0
    x2d = to_torch(padded).reshape(32, 64)
    _, experts = ffn.route(p["router"], x2d, cfg.moe)
    for e in range(cfg.moe.num_experts):
        routed = (experts == e).any(dim=1).nonzero().flatten().tolist()
        kept = [t for t in slot_tok[e].tolist() if t < 32]
        assert kept == sorted(kept)            # stable: lower rows first
        if any(t < 20 and t not in kept for t in routed):
            assert all(t < 20 for t in kept), e  # no pad kept over a real


@pytest.mark.parametrize("seq", [16, 40])
def test_forward_logits_match(pair, seq):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, seq, seed=seq)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_prefill_logits_and_cache_match(capacity_factor, monkeypatch):
    """At the reduced factor and at the published 1.25, where the 48
    prompt rows overflow experts in both layers."""
    drops = []
    dispatch = ffn.dispatch

    def counting(experts, cap, num_experts, n_tokens):
        counts = torch.bincount(experts.reshape(-1), minlength=num_experts)
        drops.append(int((counts - cap).clamp_min(0).sum()))
        return dispatch(experts, cap, num_experts, n_tokens)

    monkeypatch.setattr(ffn, "dispatch", counting)
    jcfg, _, jparams, cfg, _, params = model_pair(ARCH)
    if capacity_factor:
        jcfg = replace(jcfg, moe=replace(jcfg.moe,
                                         capacity_factor=capacity_factor))
        cfg = replace(cfg, moe=replace(cfg.moe,
                                       capacity_factor=capacity_factor))
    tok = random_tokens(1, 48, seed=9)
    want_logits, want_cache = jtransformer.prefill(
        jparams, jcfg, jnp.asarray(tok), max_len=64, dtype=jnp.float32)
    got_logits, got_cache = transformer.prefill(
        params, cfg, to_torch(tok), max_len=64, dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL)
    assert set(got_cache) == set(want_cache) == {"k", "v", "pos"}
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got_cache[leaf].numpy(),
                                   np.asarray(want_cache[leaf].value),
                                   atol=ATOL, err_msg=leaf)
    assert len(drops) == 2
    assert all(drops) if capacity_factor else not any(drops)


def test_decode_steps_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(3, 20, seed=2)
    _, jc = jtransformer.prefill(jparams, jcfg, jnp.asarray(tok), max_len=32,
                                 dtype=jnp.float32)
    _, tc = transformer.prefill(params, cfg, to_torch(tok), max_len=32,
                                dtype=torch.float32)
    for step in random_tokens(3, 3, seed=3).T:
        step = step.reshape(3, 1)
        want, jc = jtransformer.decode_step(jparams, jcfg, jc,
                                            jnp.asarray(step),
                                            dtype=jnp.float32)
        got, tc = transformer.decode_step(params, cfg, tc, to_torch(step),
                                          dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert int(tc["pos"]) == int(jc["pos"].value) == 23


def test_decode_matches_teacher_forcing(pair):
    """Greedy decode from a 16-token prompt to position 64: each step's
    logits equal the full forward's at that position, the port's and the
    JAX model's (decode routes one token a slot; the forward routes the
    whole sequence; at the reduced factor neither drops)."""
    jcfg, _, jparams, cfg, bundle, params = pair
    prompt = torch.from_numpy(random_tokens(1, 16, seed=7))
    dec, full = greedy_decode(bundle, params, prompt, 64)
    want = transformer.forward(params, cfg, full, dtype=torch.float32)
    jwant = np.asarray(jtransformer.forward(jparams, jcfg,
                                            jnp.asarray(full.numpy()),
                                            dtype=jnp.float32))
    for i, lg in enumerate(dec):
        pos = prompt.shape[1] + i
        torch.testing.assert_close(lg, want[0, pos], atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(lg.numpy(), jwant[0, pos], atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_greedy_tokens_equal_jax_engine(capacity_factor):
    """Requests over two slots; at 1.25 the padded prompts' rows overflow
    experts at prefill, as they do in the JAX engine."""
    jcfg, _, jparams, cfg, _, params = model_pair(ARCH)
    if capacity_factor:
        jcfg = replace(jcfg, moe=replace(jcfg.moe,
                                         capacity_factor=capacity_factor))
        cfg = replace(cfg, moe=replace(cfg.moe,
                                       capacity_factor=capacity_factor))
    from repro.models import registry as jregistry
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29,
               "semantic query number 4 about movies"]
    want, got = greedy_engines(jregistry.build(jcfg), jparams,
                               registry.build(cfg), params, prompts)
    assert len(got) == len(prompts)
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_serve_main_runs_granite_on_cpu(capsys):
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
    assert "arch=granite-moe-1b-a400m-smoke" in out and "new tok/s" in out


def test_moe_is_served_on_the_moe_family_only():
    """The MoE family needs its MoE config, and the dense family has
    none."""
    from repro_torch.configs import FAMILY_DENSE
    cfg = reduced(get_config(ARCH))
    transformer.check_supported(cfg)
    for bad in (replace(cfg, moe=None), replace(cfg, family=FAMILY_DENSE)):
        with pytest.raises(NotImplementedError):
            registry.build(bad)
