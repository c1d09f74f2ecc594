"""The port's VLM path (internvl2-76b: dense GQA after a projected prefix of
precomputed patch embeddings) against the JAX model, on the same weights.

``reduced(internvl2-76b)`` (2 layers, d_model 64, 4 query heads over 2 KV
heads of 16, 8 prefix embeddings, vocab 512) with ``PRNGKey(0)`` weights
carried over by ``repro_torch.convert``; tokens and prefix embeddings from
numpy seeds; both sides in fp32. Tolerances, each with its reason:

* logits and cache leaves: 1e-4 absolute (values ~1; XLA's and PyTorch's
  CPU matmuls sum in other orders through two layers);
* the loss: 1e-5 relative, each gradient leaf 1e-4 of the leaf's largest
  |value| (as ``test_torch_train.py``);
* greedy tokens through the engines: equal.

The prefill's ``pos`` is min(S_total + n_prefix, max_len), S_total
counting the prefix already: the reference adds the prefix twice, and the
port keeps it (pinned below). Where that reaches max_len, the port refuses
the next decode step, which the reference runs with its write dropped
(pinned below, and listed in ROADMAP.md). Every test runs under
``torch_parity.time_limit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from test_torch_train import assert_leaves_close, flat_torch  # noqa: E402
from torch_parity import (flatten_params, greedy_engines, model_pair,  # noqa: E402
                          random_tokens, time_limit, to_torch)

ARCH = "internvl2-76b"
ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LIMIT_S = 60
NPFX = 8  # reduced(internvl2-76b).n_prefix_embeds


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


def prefix(b, seed=0, d=64):
    return np.random.default_rng(seed).normal(size=(b, NPFX, d)).astype(
        np.float32)


def test_configs_match():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "rope_theta", "rms_eps",
              "n_prefix_embeds", "family"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert reduced(cfg).n_prefix_embeds == NPFX


def test_converted_params_keep_layouts(pair):
    _, _, jparams, cfg, bundle, params = pair
    native = bundle.init(generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert ({k: tuple(v.shape) for k, v in flat_torch(native).items()}
            == {k: a.shape for k, (a, _) in flatten_params(jparams).items()})
    assert tuple(params["prefix_proj"]["w"].shape) == (64, 64)


def test_forward_with_prefix_matches(pair):
    """Logits over the prefix and the text, (B, n_prefix + S, V)."""
    jcfg, _, jparams, cfg, _, params = pair
    tok, pfx = random_tokens(2, 12, seed=1), prefix(2, seed=2)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                prefix_embeds=jnp.asarray(pfx),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok),
                              prefix_embeds=to_torch(pfx),
                              dtype=torch.float32)
    assert tuple(got.shape) == (2, NPFX + 12, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _prefill(pair, max_len, s=12):
    jcfg, jbundle, jparams, cfg, bundle, params = pair
    tok, pfx = random_tokens(2, s, seed=3), prefix(2, seed=4)
    jout = jbundle.prefill(jparams, {"tokens": jnp.asarray(tok),
                                     "prefix_embeds": jnp.asarray(pfx)},
                           max_len=max_len, dtype=jnp.float32)
    out = bundle.prefill(params, {"tokens": to_torch(tok),
                                  "prefix_embeds": to_torch(pfx)},
                         max_len=max_len, dtype=torch.float32)
    return jout, out


@pytest.mark.parametrize("max_len", [48, 24])
def test_prefill_with_prefix_matches(pair, max_len):
    """Logits, ``k``/``v`` and ``pos`` = min(20 + 8, max_len): 28 at
    max_len 48, clipped to 24 at max_len 24."""
    (jlogits, jcache), (logits, cache) = _prefill(pair, max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf].value), atol=ATOL)
    assert int(cache["pos"]) == int(jcache["pos"].value) == min(28, max_len)


def test_decode_from_a_full_cache_raises(pair):
    """A deliberate divergence: at max_len 24 the prefill's ``pos`` is 24,
    the cache's end, though the 20 rows fit. The reference's next decode
    step drops its K/V row (its one-hot write matches no row) and runs; the
    port's in-place write refuses the index (on the card: a device-side
    assert)."""
    jcfg, jbundle, jparams, cfg, bundle, params = pair
    (_, jcache), (_, cache) = _prefill(pair, 24)
    step = random_tokens(1, 2, seed=6).reshape(2, 1)
    want, _ = jbundle.decode_step(jparams, jcache, jnp.asarray(step),
                                  dtype=jnp.float32)
    assert np.isfinite(np.asarray(want)).all()
    with pytest.raises(IndexError):
        bundle.decode_step(params, cache, to_torch(step), dtype=torch.float32)


def test_decode_after_prefix_prefill_matches(pair):
    """Six decode steps from the prefill's position (28, past 8 zero rows
    that both attend): every step's logits, then the cache leaves."""
    jcfg, jbundle, jparams, cfg, bundle, params = pair
    (_, jcache), (_, cache) = _prefill(pair, 48)
    for step in random_tokens(6, 2, seed=5):
        step = step.reshape(2, 1)
        want, jcache = jbundle.decode_step(jparams, jcache, jnp.asarray(step),
                                           dtype=jnp.float32)
        got, cache = bundle.decode_step(params, cache, to_torch(step),
                                        dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf].value), atol=ATOL)
    assert int(cache["pos"]) == int(jcache["pos"].value) == 34


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(pair, remat):
    """The loss over the text (the prefix's logits dropped) and every
    gradient leaf, ``prefix_proj`` included, against
    ``jax.value_and_grad``."""
    _, jbundle, jparams, _, bundle, _ = pair
    tok, pfx = random_tokens(2, 16, seed=6), prefix(2, seed=7)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbundle.loss_fn(
            p, {"tokens": jnp.asarray(tok), "prefix_embeds": jnp.asarray(pfx)},
            dtype=jnp.float32, remat=remat))(jparams)
    params = convert.params_from_numpy(flatten_params(jparams),
                                       device="cpu", requires_grad=True)
    loss = bundle.loss_fn(params, {"tokens": to_torch(tok),
                                   "prefix_embeds": to_torch(pfx)},
                          dtype=torch.float32, remat=remat)
    names = sorted(flat_torch(params))
    grads = torch.autograd.grad(loss, [flat_torch(params)[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert_leaves_close(dict(zip(names, grads)), flatten_params(jgrads),
                        GRAD_TOL)
    assert float(grads[names.index("prefix_proj/w")].abs().max()) > 0


def test_prefix_ignored_by_a_config_without_one():
    """As in the reference, a config without a prefix ignores
    ``prefix_embeds``: qwen2's logits are those of the tokens alone."""
    _, _, _, cfg, _, params = model_pair("qwen2-0.5b")
    tok = to_torch(random_tokens(1, 8, seed=8))
    pfx = torch.ones(1, 4, 64)
    torch.testing.assert_close(
        transformer.forward(params, cfg, tok, prefix_embeds=pfx,
                            dtype=torch.float32),
        transformer.forward(params, cfg, tok, dtype=torch.float32))


def test_greedy_tokens_equal_jax_engine(pair):
    """Text-only serving through both engines (their prefill passes the
    tokens alone, as the reference's does): equal greedy tokens."""
    _, jbundle, jparams, _, bundle, params = pair
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29]
    want, got = greedy_engines(jbundle, jparams, bundle, params, prompts)
    assert len(got) == len(prompts)
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_train_launcher_runs_vlm_on_cpu(tmp_path):
    """``launch.train`` on the reduced VLM: batches carry seeded prefix
    embeddings, and two steps give finite losses."""
    from repro_torch.launch import train
    cfg = reduced(get_config(ARCH))
    batch = train.synthetic_batch_fn(cfg, 2, 16, device="cpu")(0)
    assert tuple(batch["prefix_embeds"].shape) == (2, NPFX, 64)
    losses = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt-every", "100", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))
