"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
model, on the same weights and inputs.

``reduced(seamless-m4t-large-v2)`` (2 encoder and 2 decoder layers,
d_model 64, 4/4 heads of 16, vocab 512) with ``PRNGKey(0)`` weights carried
over by ``repro_torch.convert``; tokens and frame embeddings from numpy
seeds; both sides in fp32. Tolerances, each with its reason:

* logits, the encoder's output and every cache leaf: 1e-4 absolute
  (values ~1; XLA's and PyTorch's CPU matmuls sum in other orders through
  four layers);
* the loss: 1e-5 relative, and each gradient leaf 1e-4 of the leaf's
  largest |value| (as ``test_torch_train.py``: sums in another order
  through the encoder, the decoder and their backward; a dropped or doubled
  term moves a leaf by O(1) of its scale);
* a restarted training run: bit-identical (the same operations on the
  same inputs on the CPU).

The kernels run their plain versions here (CPU tensors). The ``gpu``-marked
cases hold the flash forward and backward at cross-attention's shapes
(Sq != Sk, a GQA group of 1) and decode attention over an encoder cache
against their plain versions on the card. Every test runs under
``torch_parity.time_limit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import encdec, registry  # noqa: E402
from test_torch_train import assert_leaves_close, flat_torch  # noqa: E402
from torch_parity import (flatten_params, model_pair, random_tokens,  # noqa: E402
                          time_limit, to_torch)

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LIMIT_S = 60


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(LIMIT_S):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


def frames(b, s, seed=0, d=64):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def test_configs_match():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "n_encoder_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "head_dim", "rope_theta",
              "rms_eps", "is_encoder_decoder", "family"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model) == (24, 24, 1024)


def test_converted_params_keep_layouts(pair):
    _, _, jparams, cfg, bundle, params = pair
    native = bundle.init(generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert ({k: tuple(v.shape) for k, v in flat_torch(native).items()}
            == {k: a.shape for k, (a, _) in flatten_params(jparams).items()})
    assert params["enc_layers"]["attn"]["q"]["w"].shape == (2, 64, 4, 16)
    assert params["dec_layers"]["cross_attn"]["k"]["w"].shape == (2, 64, 4,
                                                                 16)


@pytest.mark.parametrize("tree", ["enc_layers", "dec_layers"])
def test_convert_rejects_unstacked_layer_axes(pair, tree):
    """A leaf of either stack whose axes do not lead with ``layer`` is
    refused, as one of ``layers`` is."""
    flat = flatten_params(pair[2])
    name = next(k for k in flat if k.startswith(tree + "/"))
    arr, axes = flat[name]
    flat[name] = (np.moveaxis(arr, 0, -1), axes[1:] + axes[:1])
    with pytest.raises(ValueError, match="layer"):
        convert.params_from_numpy(flat, device="cpu")


def test_encode_matches(pair):
    jcfg, _, jparams, cfg, _, params = pair
    x = frames(2, 20, seed=1)
    want = jencdec.encode(jparams, jcfg, jnp.asarray(x), dtype=jnp.float32)
    got = encdec.encode(params, cfg, to_torch(x), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _prefill(pair, b=2, s_dec=12, s_enc=20, max_len=32):
    jcfg, jbundle, jparams, cfg, bundle, params = pair
    tok, x = random_tokens(b, s_dec, seed=2), frames(b, s_enc, seed=3)
    jlogits, jcache = jbundle.prefill(
        jparams, {"tokens": jnp.asarray(tok), "enc_embeds": jnp.asarray(x)},
        max_len=max_len, dtype=jnp.float32)
    logits, cache = bundle.prefill(
        params, {"tokens": to_torch(tok), "enc_embeds": to_torch(x)},
        max_len=max_len, dtype=torch.float32)
    return jlogits, jcache, logits, cache


def test_prefill_logits_and_cache_match(pair):
    """The last position's logits, the four cache leaves (self ``k``/``v``
    padded to max_len, the encoder's ``ek``/``ev``) and ``pos``."""
    jlogits, jcache, logits, cache = _prefill(pair)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    assert set(cache) == set(jcache) == {"k", "v", "ek", "ev", "pos"}
    for leaf in ("k", "v", "ek", "ev"):
        assert tuple(cache[leaf].shape) == jcache[leaf].value.shape
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf].value), atol=ATOL)
    assert int(cache["pos"]) == int(jcache["pos"].value) == 12


def test_decode_chain_matches(pair):
    """Eight ``decode_step``s after the prefill: every step's logits, then
    every cache leaf and ``pos``."""
    jcfg, jbundle, jparams, cfg, bundle, params = pair
    _, jcache, _, cache = _prefill(pair)
    for step in random_tokens(8, 2, seed=4):
        step = step.reshape(2, 1)
        want, jcache = jbundle.decode_step(jparams, jcache, jnp.asarray(step),
                                           dtype=jnp.float32)
        got, cache = bundle.decode_step(params, cache, to_torch(step),
                                        dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for leaf in ("k", "v", "ek", "ev"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf].value), atol=ATOL)
    assert int(cache["pos"]) == int(jcache["pos"].value) == 20


def test_forward_matches(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok, x = random_tokens(2, 16, seed=5), frames(2, 9, seed=6)
    want = jencdec.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(x),
                           dtype=jnp.float32)
    got = encdec.forward(params, cfg, to_torch(tok), to_torch(x),
                         dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(pair, remat):
    """``loss_fn`` and every gradient leaf (both stacks, the input
    projection, the embedding) against ``jax.value_and_grad``, with and
    without remat of the decoder's layers."""
    _, jbundle, jparams, _, bundle, _ = pair
    tok, x = random_tokens(2, 16, seed=7), frames(2, 16, seed=8)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbundle.loss_fn(
            p, {"tokens": jnp.asarray(tok), "enc_embeds": jnp.asarray(x)},
            dtype=jnp.float32, remat=remat))(jparams)
    params = convert.params_from_numpy(flatten_params(jparams),
                                       device="cpu", requires_grad=True)
    loss = bundle.loss_fn(params, {"tokens": to_torch(tok),
                                   "enc_embeds": to_torch(x)},
                          dtype=torch.float32, remat=remat)
    names = sorted(flat_torch(params))
    grads = torch.autograd.grad(loss, [flat_torch(params)[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert_leaves_close(dict(zip(names, grads)), flatten_params(jgrads),
                        GRAD_TOL)


def test_remat_recomputes_the_decoder_only(pair, monkeypatch):
    """Under remat each decoder layer's forward runs twice (forward and
    the backward's recompute) and each encoder layer's once, as the
    reference checkpoints the decoder's scan body only: the cross and
    self-attention of the decoder call the attention 2 x 2 x L times, the
    encoder L times."""
    from repro_torch.kernels import ops
    cfg, bundle = pair[3], pair[4]
    calls = {"causal": 0, "noncausal": 0}
    inner = ops.flash_attention

    def counted(q, k, v, *, causal=True, window=0):
        calls["causal" if causal else "noncausal"] += 1
        return inner(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(ops, "flash_attention", counted)
    tok, x = random_tokens(2, 8, seed=9), frames(2, 8, seed=10)
    params = convert.params_from_numpy(flatten_params(pair[2]),
                                       device="cpu", requires_grad=True)
    loss = bundle.loss_fn(params, {"tokens": to_torch(tok),
                                   "enc_embeds": to_torch(x)},
                          dtype=torch.float32, remat=True)
    torch.autograd.grad(loss, list(flat_torch(params).values()))
    L, E = cfg.n_layers, cfg.n_encoder_layers
    assert calls == {"causal": 2 * L, "noncausal": E + 2 * L}


def test_launch_train_two_steps_and_bit_identical_restart(tmp_path, capsys):
    """``launch.train`` on the reduced model on the CPU: 2 steps with a
    checkpoint after each; then a run with a failure injected after step 0
    restarts from that checkpoint, and one with a failure before any
    checkpoint builds its initial state again; both end with the same bits
    as the uninterrupted run."""
    from repro_torch.launch import train
    flags = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "16", "--ckpt-every", "1"]
    losses = train.main(flags + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert f"[train] arch={ARCH}-smoke" in out and "tok/s" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert ck.committed_steps(str(tmp_path / "a")) == [0, 1]
    args = train.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "b")])
    whole = train.run(args)
    args.ckpt_dir = str(tmp_path / "c")
    restarted = train.run(args, fail_at={0})
    args.ckpt_dir, args.ckpt_every = str(tmp_path / "d"), 100
    rebuilt = train.run(args, fail_at={0})
    assert ck.committed_steps(str(tmp_path / "d")) == []
    a = flat_torch(whole["state"]["params"])
    for run in (restarted, rebuilt):
        assert run["restarts"] == 1
        b = flat_torch(run["state"]["params"])
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert [e["loss"] for e in whole["log"] if "loss" in e] == losses


def test_batches_carry_frames_as_long_as_tokens():
    from repro_torch.launch import train
    cfg = reduced(get_config(ARCH))
    batch = train.synthetic_batch_fn(cfg, 2, 16, device="cpu")(3)
    assert set(batch) == {"tokens", "enc_embeds"}
    assert tuple(batch["enc_embeds"].shape) == (2, 16, cfg.d_model)
    assert batch["enc_embeds"].dtype == torch.bfloat16


def test_registry_init_cache_shapes():
    """``init_cache`` with the reference's signature: the encoder context
    defaults to ENC_CTX_SERVE (4096) frames, ``enc_len`` sets it."""
    cfg = reduced(get_config(ARCH))
    bundle = registry.build(cfg)
    assert registry.ENC_CTX_SERVE == 4096
    c = bundle.init_cache(2, 24, dtype=torch.float32, device="cpu")
    assert tuple(c["k"].shape) == tuple(c["v"].shape) == (2, 2, 24, 4, 16)
    assert tuple(c["ek"].shape) == (2, 2, 4096, 4, 16)
    c = bundle.init_cache(3, 24, enc_len=40, device="cpu")
    assert tuple(c["ev"].shape) == (2, 3, 40, 4, 16)
    assert c["ev"].dtype == torch.bfloat16
    assert c["pos"].shape == () and c["pos"].dtype == torch.int32


def test_engine_refuses_encoder_decoder(pair):
    """The reference's engine fails building an enc-dec cache (TypeError on
    ``per_slot_pos``); the port's refuses it by name."""
    from repro_torch.engine import GenerationEngine
    _, _, _, _, bundle, params = pair
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        GenerationEngine(bundle, params, max_len=32, n_slots=2, device="cpu")


def test_serve_launcher_refuses_encoder_decoder():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--requests", "1"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# |kernel - plain| <= atol + rtol |plain| (chip_smoke's TOL): fp32 sums in
# another order; bf16 one rounding of the fp32 result apart.
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
# as test_torch_train's BWD_TOL, of the three gradients' largest |value|
BWD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2.0 ** -8, 2.0 ** -7)}


def _rn(g, dtype, *shape):
    return (torch.randn(*shape, generator=g, device="cuda") * 0.5).to(
        getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [1, 17, 96, 160])
@pytest.mark.parametrize("sk", [77, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_flash_matches_plain_on_card(cuda, dtype, sk, sq):
    """Cross-attention: Sq queries against Sk keys, non-causal, 16/16 heads
    of 64 (seamless's)."""
    g = torch.Generator(cuda).manual_seed(sq * sk)
    q, k, v = _rn(g, dtype, 2, sq, 16, 64), _rn(g, dtype, 2, sk, 16, 64), \
        _rn(g, dtype, 2, sk, 16, 64)
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.plain(q, k, v, causal=False)
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 129, 200, False), (2, 200, 129, False),
                                  (4, 512, 512, True), (4, 512, 512, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group1_backward_matches_plain_on_card(cuda, dtype, case):
    """The backward at a GQA group of 1 (16/16 heads of 64): Sq != Sk
    non-causal both ways, and seamless's training shape (causal
    self-attention, non-causal encoder and cross-attention)."""
    b, sq, sk, causal = case
    g = torch.Generator(cuda).manual_seed(sq + sk)
    q, k, v, do = (_rn(g, dtype, b, sq, 16, 64), _rn(g, dtype, b, sk, 16, 64),
                   _rn(g, dtype, b, sk, 16, 64), _rn(g, dtype, b, sq, 16, 64))
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = fa.flash_attention_backward(q, k, v, out, do, lse, causal=causal)
    wants = fa.plain_backward(q, k, v, do, causal=causal)
    a, r = BWD_TOL[dtype]
    scale = max(w.float().abs().max().item() for w in wants)
    for x, want in zip(got, wants):
        err = (x.float() - want.float()).abs()
        assert bool((err <= a * scale + r * want.float().abs()).all()), \
            err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(16, 16, 64), (64, 8, 128)])
def test_decode_over_encoder_cache_matches_plain_on_card(cuda, heads):
    """Decode attention at a group of 1 over a 4096-entry cache read whole
    (seamless's cross decode), and at 64/8 heads of 128 (internvl2's), fp32."""
    hq, hkv, d = heads
    g = torch.Generator(cuda).manual_seed(hq)
    q = _rn(g, "float32", 4, 1, hq, d)
    kc, vc = (_rn(g, "float32", 4, 4096, hkv, d) for _ in range(2))
    lens = torch.tensor([4096, 4096, 1, 2000], dtype=torch.int32,
                        device=cuda)
    got = dec.decode_attention(q, kc, vc, lens)
    want = dec.plain(q, kc, vc, lens)
    assert (got - want).abs().max().item() <= TOL["float32"][0]
