"""The port's training path against the JAX package's, on the same inputs.

Reduced qwen2-0.5b (2 layers, d_model 64, 4/2 heads of 16) and reduced
granite-moe-1b-a400m (4 experts, top-2) with ``PRNGKey`` weights carried
over by ``repro_torch.convert``; tokens and gradients from numpy seeds; both
sides in fp32. Tolerances, each with its reason:

* the loss: 1e-5 relative (sums of ~1e2 terms in another order);
* each gradient leaf: 1e-4 of the leaf's largest |value|, elementwise
  (XLA's and PyTorch's CPU matmuls sum in other orders through two layers
  and their backward; a dropped or doubled term moves a leaf by O(1) of
  its scale);
* AdamW from the same params and gradients: the moments 1e-6 relative;
  the params 1e-5 x lr absolute, a tolerance scaled by the learning rate
  (the first step is about sign(g) x lr wherever |g| >> eps, so a
  relative test of the update would weigh rounding of tiny g), plus two
  fp32 steps of the param (the new value is rounded once more), on every
  leaf;
* a whole train step from the models' own gradients: the params within
  1e-3 lr where JAX's |g| > 100 eps and within 2.2 lr elsewhere (near
  eps a rounding-sized difference in g moves g / (|g| + eps) by up to 2);
* int8 compression: bit-equal (the same fp32 operations, round half to
  even);
* the data pipeline: equal arrays (numpy on both sides).

The kernels run their plain versions here (CPU tensors); the gradient
through ``ops.flash_attention`` is held against JAX's XLA attention. The
``gpu``-marked cases hold the backward kernel against ``plain_backward``
on the card. Every test runs under ``torch_parity.time_limit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import similarity as sim  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.training import compression, optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from torch_parity import (flatten_params, model_pair, random_tokens,  # noqa: E402
                          time_limit, to_torch)

LIMIT_S = 60
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b", "hymba-1.5b",
         "minicpm3-4b", "llama4-scout-17b-a16e"]


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(LIMIT_S):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the models here are tiny, and the suite runs
    several worker processes at once, whose thread pools would otherwise
    contend for the same cores (a step then takes tens of times longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param)


def flat_torch(tree, prefix=()):
    """The port's nested dict -> {"a/b/c": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_torch(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


# Gradient leaves that are zero in exact arithmetic: a top-1 MoE
# renormalises its one routing weight to exactly 1, so its router gets no
# gradient, and both sides hold rounding noise there (~3e-9 against
# leaves of ~1). Each is held to be zero on both sides instead: within
# 1e-7 of the largest |value| of any leaf.
ZERO_LEAVES = {"llama4-scout-17b-a16e-smoke": {"layers/ffn/router/w"}}


def assert_leaves_close(got, want, tol, zero=()):
    """Every leaf within ``tol`` of the JAX leaf's largest |value|; the
    leaves named in ``zero`` within 1e-7 of the largest leaf's on both
    sides."""
    want = {k: a for k, (a, _) in want.items()}
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w = want[name]
        if name in zero:
            assert float(np.abs(w).max()) <= 1e-7 * top, name
            assert float(g.detach().abs().max()) <= 1e-7 * top, name
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (mask, None):
        want = float(jcm.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = float(cm.softmax_cross_entropy(
            to_torch(logits), to_torch(labels),
            None if m is None else to_torch(m)))
        assert got == pytest.approx(want, rel=1e-6)
    zero = cm.softmax_cross_entropy(to_torch(logits), to_torch(labels),
                                    torch.zeros(3, 7))
    assert float(zero) == 0.0   # an all-zero mask divides by max(0, 1)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(pair, remat):
    """``loss_fn`` and the gradient of every param leaf against
    ``jax.value_and_grad`` of the JAX ``loss_fn``, with and without remat
    (the port's ``torch.utils.checkpoint`` per layer)."""
    jcfg, jbundle, jparams, cfg, bundle, _ = pair
    toks = random_tokens(2, 24, seed=3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbundle.loss_fn(p, {"tokens": jnp.asarray(toks)},
                                  dtype=jnp.float32, remat=remat))(jparams)
    from repro_torch import convert
    params = convert.params_from_numpy(flatten_params(jparams),
                                       device="cpu", requires_grad=True)
    loss = bundle.loss_fn(params, {"tokens": to_torch(toks)},
                          dtype=torch.float32, remat=remat)
    names = sorted(flat_torch(params))
    grads = torch.autograd.grad(loss, [flat_torch(params)[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert_leaves_close(dict(zip(names, grads)), flatten_params(jgrads),
                        GRAD_TOL, ZERO_LEAVES.get(cfg.name, ()))


@pytest.mark.parametrize("heads", [(4, 2, 32), (14, 2, 64)])
def test_attention_gradient_matches_jax(heads):
    """``ops.flash_attention``'s gradient (autograd of the plain version on
    the CPU) against ``jax.grad`` of the JAX model's attention, causal and
    windowed, at a GQA group of 2 and head_dim 32 (the rewriter's) and at
    qwen2-0.5b's group of 7 and head_dim 64 (the training shape's, whose
    rows the backward kernel packs seven heads to a position)."""
    hq, hkv, d = heads
    rng = np.random.default_rng(4)
    q, k, v, w = (rng.normal(size=s).astype(np.float32) for s in
                  ((2, 40, hq, d), (2, 40, hkv, d), (2, 40, hkv, d),
                   (2, 40, hq, d)))
    for window in (0, 8):
        jg = jax.grad(lambda q, k, v: jnp.sum(jattention.chunked_attention(
            q, k, v, causal=True, window=window) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=True, window=window)
        tg = torch.autograd.grad((out * to_torch(w)).sum(), leaves)
        for got, want in zip(tg, jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)


def test_plain_backward_is_autograd_of_plain():
    """``plain_backward`` (what the kernel is held against on the card) is
    the gradient of ``plain``, masks and offsets included; a row with no
    valid key gets gradient 0."""
    rng = np.random.default_rng(5)
    q = to_torch(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    k, v = (to_torch(rng.normal(size=(2, 20, 2, 16)).astype(np.float32))
            for _ in range(2))
    do = to_torch(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    kw = dict(causal=True, window=5, q_offset=-3, sk_valid=17)
    dq, dk, dv = fa.plain_backward(q, k, v, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((fa.plain(*leaves, **kw) * do).sum(), leaves)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=0, rtol=0)
    assert torch.all(dq[:, :3] == 0) and torch.isfinite(dq).all()
    assert torch.all(dk[:, 17:] == 0) and torch.all(dv[:, 17:] == 0)
    lse = fa.plain_lse(q, k, **kw)
    assert torch.all(lse[..., :3] == float("-inf"))
    assert torch.isfinite(lse[..., 3:]).all()


def test_wrappers_without_backward_refuse_grad():
    """The three kernels with no backward raise under grad rather than
    return a tensor that cuts the graph; no grad (serving) passes the
    check and reaches the device check. ``ssd_scan`` has a backward
    kernel: under grad its wrapper and its differentiable entry point
    ``scan`` reach the device check too."""
    x = torch.randn(2, 8, 4, 16, requires_grad=True)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    calls = [lambda: dec.decode_attention(x[:, :1], x, x, lens),
             lambda: sim.rowwise_cosine(x[0, :, 0], x[0, :, 1]),
             lambda: sim.cosine_matrix(x[0, :, 0], x[0, :, 1])]
    for call in calls:
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()
    for fn in (ssd.ssd_scan, ssd.scan):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, x[..., 0], x[:, :, :1], x[:, :, :1])
    _build.refuse_grad("x", torch.ones(2), None)   # needs none: passes


def test_schedule_and_global_norm_match_jax():
    cfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        want = float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = float(opt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(opt.global_norm({"a": to_torch(tree["a"]),
                                 "b": {"c": to_torch(tree["b"]["c"])}}))
    assert got == pytest.approx(want, rel=1e-6)


def _grads_like(params, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=a.shape).astype(np.float32) * scale
            for k, (a, _) in params.items()}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_apply_updates_matches_jax(n_steps, grad_scale):
    """One and three AdamW steps from reduced qwen2's params with the same
    numpy gradients each step; at grad_scale 10 the global norm (~9e3) is
    clipped to 1, at 1e-3 (~0.9) it is not."""
    from repro.configs import get_config as jget, reduced as jred
    from repro.models import registry as jreg
    from repro_torch import convert
    jparams = jcm.values(jreg.build(jred(jget("qwen2-0.5b"))).init(
        jax.random.PRNGKey(1)))
    flat = flatten_params(jreg.build(jred(jget("qwen2-0.5b"))).init(
        jax.random.PRNGKey(1)))
    params = convert.params_from_numpy(flat, device="cpu",
                                       requires_grad=True)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate = {"m": jax.tree.map(jnp.zeros_like, jparams),
              "v": jax.tree.map(jnp.zeros_like, jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = opt.init_state(params)
    for i in range(n_steps):
        g = _grads_like(flat, 10 + i, grad_scale)
        jg = jcm.values(convert_tree(flat, g, jnp.asarray))
        tg = convert_tree(flat, g, to_torch)
        jparams, jstate, jm = jopt.apply_updates(jcfg, jparams, jg, jstate)
        params, state, m = opt.apply_updates(cfg, params, tg, state)
    assert int(state["step"]) == int(jstate["step"]) == n_steps
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for name, p in flat_torch(params).items():
        assert p.requires_grad
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(_at(jparams, name)),
                                   rtol=2.0 ** -22, atol=1e-5 * cfg.lr)
    for key in ("m", "v"):
        for name, t in flat_torch(state[key]).items():
            want = np.asarray(_at(jstate[key], name))
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def convert_tree(flat, values, fn):
    """{"a/b": array} -> a nested dict of fn(array), JAX Param leaves where
    ``fn`` is jnp.asarray (with the Param tree's axes)."""
    tree = {}
    for path, arr in values.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        leaf = fn(arr)
        node[keys[-1]] = (jcm.Param(leaf, flat[path][1])
                          if fn is jnp.asarray else leaf)
    return tree


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_compress_decompress_is_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    grads = {"a": rng.normal(size=(1000,)).astype(np.float32) * 3,
             "b": rng.normal(size=(3, 257)).astype(np.float32),
             "c": np.zeros((300,), np.float32),
             "d": np.concatenate([np.zeros(256, np.float32),
                                  rng.normal(size=20).astype(np.float32)
                                  * 1e-3])}
    want = jcomp.compress_decompress(jax.tree.map(jnp.asarray, grads))
    got = compression.compress_decompress(
        {k: to_torch(v) for k, v in grads.items()})
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].shape == grads[k].shape
    q, scale = compression._quant(to_torch(grads["a"]))
    jq, jscale = jcomp._quant(jnp.asarray(grads["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    with pytest.raises(NotImplementedError, match="mesh"):
        compression.compressed_psum(to_torch(grads["a"]), "data")


def test_train_step_microbatches_match_jax_and_one_batch(pair):
    """``make_train_step`` with microbatches=2 against JAX's with 2 (the
    new params and the loss), and against the port's with 1 (a masked mean
    over equal halves is the mean: the same step within rounding)."""
    jcfg, jbundle, jparams, cfg, bundle, _ = pair
    from repro_torch import convert
    toks = random_tokens(4, 16, seed=8)
    ocfg = opt.AdamWConfig(warmup_steps=1, total_steps=10)
    jstep = jtrain_loop.make_train_step(
        jbundle, jopt.AdamWConfig(warmup_steps=1, total_steps=10),
        microbatches=2, dtype=jnp.float32, remat=False)
    jstate = {"params": jparams, "opt": jopt.init_state(jparams)}
    jnew, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
    new = {}
    for mb in (2, 1):
        params = convert.params_from_numpy(flatten_params(jparams),
                                           device="cpu", requires_grad=True)
        step = train_loop.make_train_step(bundle, ocfg, microbatches=mb,
                                          dtype=torch.float32, remat=False)
        new[mb], m = step({"params": params, "opt": opt.init_state(params)},
                          {"tokens": to_torch(toks)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
    # AdamW's first step is g / (|g| + eps) x lr: where |g| is near eps, a
    # rounding-sized difference in g moves it by up to 2 lr. So the params
    # are compared within 1e-3 lr where JAX's |g| > 100 eps, and within
    # 2.2 lr (the most a first step moves them, decay included) elsewhere.
    # AdamW sees the gradient after clipping (x min(1, clip_norm / norm)):
    # an entry that clipping leaves at 20 eps or less is held to 2.2 lr
    # alone (a large norm, as the reduced SSM, hybrid and MLA models have,
    # puts entries there). An entry with no gradient at all (an untied
    # embedding's rows of tokens the batch does not hold) moves by the decay
    # alone, the same on both sides, so it is held within 1e-3 lr too.
    jg = flatten_params(jax.grad(lambda p: jbundle.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32,
        remat=False))(jparams))
    clip = min(1.0, ocfg.clip_norm / float(jm["grad_norm"]))
    want = flatten_params(jnew["params"])
    for name, p in flat_torch(new[2]["params"]).items():
        g = np.abs(jg[name][0])
        strict = ((g > 100 * ocfg.eps) & (g * clip > 20 * ocfg.eps)) \
            | (g == 0)
        # (a leaf of ZERO_LEAVES holds rounding noise: it moves by up to
        # 2 lr on either side, as the bound below allows)
        assert strict.mean() > 0.5 or name in ZERO_LEAVES.get(cfg.name, ()), \
            name
        for other in (want[name][0], flat_torch(new[1]["params"])[name]
                      .detach().numpy()):
            err = np.abs(p.detach().numpy() - other)
            assert err[strict].max(initial=0) <= 1e-3 * ocfg.lr, name
            assert err.max() <= 2.2 * ocfg.lr, name


def test_token_pipeline_matches_jax():
    docs = ["a movie about a heist", "NEWLY BUILT DUPLEX", "VR supported"]
    for kw in (dict(), dict(documents=docs), dict(dp_rank=1, dp_world=2)):
        a = jpipeline.TokenPipeline(vocab_size=512, global_batch=4,
                                    seq_len=8, seed=3, **kw)
        b = pipeline.TokenPipeline(vocab_size=512, global_batch=4,
                                   seq_len=8, seed=3, **kw)
        for step in (0, 1, 17):
            np.testing.assert_array_equal(a.batch_at(step)["tokens"],
                                          b.batch_at(step)["tokens"])


def test_init_and_convert_give_trainable_leaves():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    bundle = registry.build(reduced(get_config("qwen2-0.5b")))
    p = bundle.init(generator=torch.Generator().manual_seed(0), device="cpu",
                    requires_grad=True)
    assert all(t.requires_grad and t.is_leaf for t in opt.leaves(p))
    served = bundle.init(generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert not any(t.requires_grad for t in opt.leaves(served))
    state = train_loop.init_train_state(bundle, torch.Generator().manual_seed(0),
                                        device="cpu")
    assert all(t.requires_grad for t in opt.leaves(state["params"]))
    assert int(state["opt"]["step"]) == 0


def test_unported_training_inputs_raise(pair):
    """The MoE through shard_map (``moe_ctx``) still raises. Encoder inputs
    no longer do: a decoder-only model's loss ignores ``enc_embeds``, as
    the reference's does (the encoder-decoder's loss is
    ``tests/test_torch_encdec.py``'s)."""
    _, _, _, cfg, bundle, params = pair
    toks = torch.as_tensor(random_tokens(1, 8, seed=11)).long()
    with torch.no_grad():
        with_enc = bundle.loss_fn(params, {"tokens": toks,
                                           "enc_embeds": toks},
                                  dtype=torch.float32)
        alone = bundle.loss_fn(params, {"tokens": toks}, dtype=torch.float32)
    assert torch.equal(with_enc, alone)
    with pytest.raises(NotImplementedError):
        bundle.loss_fn(params, {"tokens": toks}, moe_ctx="shardmap")


def test_train_rewriter_example_runs_on_cpu():
    """The §3.3 example end to end on the CPU: 2 steps, then the trained
    policy as the LocalModelRewriter (every rewrite scored by the model,
    none falling back to a random pick)."""
    from repro_torch.examples import train_rewriter
    out = train_rewriter.main(["--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert 0.0 <= out["eval_acc"] <= 1.0 and 0.0 <= out["train_acc"] <= 1.0
    assert out["policy_calls"] == out["rewriter_calls"] > 0
    initial, best = out["plan_cost"]["local model"]
    assert best <= initial


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The backward kernel against plain_backward, elementwise:
# |kernel - plain| <= a M + r |plain|, M the largest |value| of the three
# plain gradients (dQ and dK are exactly 0 at S = 1). fp32: both sum in fp32 in
# other orders (readings ~3e-6 of the max on an H100): a = 1e-5. bf16: both
# round fp32 gradients to bf16 (one step, <= 2^-7 |x|), and the kernel's
# Delta = rowsum(dO o) reads the forward's bf16 output where autograd keeps
# fp32 (~2^-9 of |dO||o| through dS): r = 2^-7, a = 2^-8.
BWD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2.0 ** -8, 2.0 ** -7)}
# (heads, B, S, causal, window, q_offset, sk_valid), each in fp32 and bf16:
# the training shape, the rewriter's, head_dim 16 at the tile edges, with
# the window, non-causal, rows with no key; then the kernel's own edges:
# qwen2's group of 7 at S = 73 (511 packed rows, the last tile cut
# mid-tile), and a window of 24 crossing key tiles at head_dim 32 and 64.
BWD_CASES = [((14, 2, 64), 8, 512, True, 0, 0, 0),
             ((4, 2, 32), 16, 384, True, 0, 0, 0),
             ((4, 2, 16), 2, 1, True, 0, 0, 0),
             ((4, 2, 16), 2, 17, True, 0, 0, 0),
             ((4, 2, 16), 2, 129, True, 24, 0, 0),
             ((4, 2, 16), 2, 128, False, 0, 0, 0),
             ((4, 2, 16), 2, 127, False, 24, 0, 0),
             ((14, 2, 64), 2, 48, True, 8, -6, 37),
             ((14, 2, 64), 2, 73, True, 0, 0, 0),
             ((4, 2, 32), 2, 200, True, 24, 0, 0),
             ((14, 2, 64), 2, 200, True, 24, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, case):
    (hq, hkv, d), b, s, causal, window, q_offset, sk_valid = case
    td = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(s)

    def rn(*shape):
        return (torch.randn(*shape, generator=g, device=cuda) * 0.5).to(td)
    q, k, v, do = rn(b, s, hq, d), rn(b, s, hkv, d), rn(b, s, hkv, d), \
        rn(b, s, hq, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              sk_valid=sk_valid)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_backward(q, k, v, out, do, lse, **kw)
    a, r = BWD_TOL[dtype]
    wants = fa.plain_backward(q, k, v, do, **kw)
    scale = max(w.float().abs().max().item() for w in wants)
    for x, want in zip(got, wants):
        err = (x.float() - want.float()).abs()
        lim = a * scale + r * want.float().abs()
        assert bool((err <= lim).all()), err.max().item()
    again = fa.flash_attention_backward(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("bfloat16", (14, 2, 64), 8, 512),
                                  ("float32", (4, 2, 32), 16, 384)])
def test_backward_kernel_is_deterministic_on_card(cuda, case):
    """Three launches on the same inputs at the training shapes give the
    same bits: no atomics, and the sums' order does not depend on which
    pass or block runs first."""
    dtype, (hq, hkv, d), b, s = case
    td = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(7)

    def rn(*shape):
        return (torch.randn(*shape, generator=g, device=cuda) * 0.5).to(td)
    q, k, v, do = rn(b, s, hq, d), rn(b, s, hkv, d), rn(b, s, hkv, d), \
        rn(b, s, hq, d)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    runs = [fa.flash_attention_backward(q, k, v, out, do, lse)
            for _ in range(3)]
    for again in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], again))


@pytest.mark.gpu
def test_wrappers_refuse_grad_on_card(cuda):
    """The three kernels with no backward raise under grad on the card;
    the SSD scan's differentiable entry point records a graph."""
    x = torch.randn(2, 8, 4, 16, device=cuda, requires_grad=True)
    lens = torch.tensor([3, 8], dtype=torch.int32, device=cuda)
    for call in (lambda: dec.decode_attention(x[:, :1], x, x, lens),
                 lambda: sim.rowwise_cosine(x[0, :, 0], x[0, :, 1]),
                 lambda: sim.cosine_matrix(x[0, :, 0], x[0, :, 1])):
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
    y, state = ssd.scan(x, x[..., 0].float(), x[:, :, :1], x[:, :, :1])
    assert y.grad_fn is not None and state.grad_fn is not None


@pytest.mark.gpu
def test_ops_gradient_through_kernels_on_card(cuda):
    """``ops.flash_attention`` under grad on the card: one forward and one
    backward launch, the gradient equal to the CPU's autograd of plain."""
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 64, h, 32, generator=g, device=cuda)
               for h in (4, 2, 2))
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(ops.flash_attention(*leaves).square().sum(),
                                leaves)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 1
    cpu = [t.cpu().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*cpu).square().sum(), cpu)
    for x, w in zip(grads, want):
        torch.testing.assert_close(x.cpu(), w, atol=1e-4, rtol=1e-4)
