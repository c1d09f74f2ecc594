"""The port's int8 KV cache against the JAX model's.

``quant_kv`` / ``dequant_kv`` reproduce the reference's arithmetic: the
scale max|x| / 127 in fp32, the values round(x / max(scale, 1e-8)) half to
even and clipped to +-127, the scale stored in bf16 and dequantization
multiplying by that bf16 scale. Tolerances, each with its reason:

* ``quant_kv`` and ``dequant_kv`` on the same inputs: bit-equal (the same
  fp32 operations, the same roundings);
* decode through the int8 cache (``gqa_decode_q8``, reduced qwen2-0.5b's
  attention; the whole reduced qwen2-0.5b and hymba-1.5b): outputs 1e-5
  absolute (values ~1; the projections' sums in another order); the int8
  values within 1 and the bf16 scales within one bf16 step (2^-8
  relative) of JAX's, since a k that differs by rounding (~1e-7) may land
  on the other side of a half step or of a bf16 rounding edge; every other
  element equal;
* the int8 cache against the fp32 one over 10 decode steps: logits within
  0.05 of the fp32 logits' largest |value|, the reference's own bound
  (``tests/test_models.py``).

As in the reference, ``kv_dtype`` is ignored for MLA and SSM caches (and
for any dtype but int8). Every test runs under ``torch_parity.time_limit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from torch_parity import model_pair, random_tokens, time_limit, to_torch  # noqa: E402

ATOL = 1e-5
FP_BOUND = 0.05
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


def kv_rows(seed=0, b=3, kv=4, d=16):
    """(b, 1, kv, d) fp32 rows over five decades of scale, one all-zero
    row (scale 0: the 1e-8 floor) and one row of exact half steps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 1, kv, d)) * 10.0 ** rng.integers(
        -3, 2, size=(b, 1, kv, 1))
    x[0, 0, 0] = 0.0
    x[1, 0, 1] = np.array([127.0, -0.5, 0.5, 1.5, 2.5, -2.5, 3.5, 126.5]
                          + [0.0] * (d - 8))
    return x.astype(np.float32)


def bf16_bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_bit_equal_to_jax(dtype):
    x = kv_rows()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = to_torch(x, getattr(torch, dtype))
    jq, js = jattention.quant_kv(jx)
    q, s = attn.quant_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        bf16_bits(s), np.asarray(js).view(np.int16))


def test_quant_kv_rounds_half_to_even_and_floors_the_scale():
    q, s = attn.quant_kv(to_torch(kv_rows()))
    # scale 127 / 127 = 1: -0.5, 0.5, 1.5, 2.5, -2.5, 3.5, 126.5 go to even
    assert q[1, 0, 1, :8].tolist() == [127, 0, 0, 2, 2, -2, 4, 126]
    assert float(s[1, 0, 1]) == 1.0
    # an all-zero row: scale 0, values 0 (0 / 1e-8)
    assert float(s[0, 0, 0]) == 0.0 and not q[0, 0, 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_kv_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    vals = rng.integers(-127, 128, size=(2, 9, 4, 16)).astype(np.int8)
    scales = (rng.random((2, 9, 4)) * 0.1).astype(np.float32)
    jsc = jnp.asarray(scales, jnp.bfloat16)
    want = jattention.dequant_kv(jnp.asarray(vals), jsc, getattr(jnp, dtype))
    got = attn.dequant_kv(torch.from_numpy(vals),
                          to_torch(scales, torch.bfloat16),
                          getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def assert_int8_close(got, want, values):
    """int8 ``values`` within 1 of JAX's, or bf16 scales within one bf16
    step; at most a few in a thousand elements may differ at all."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert (diff <= (1.0 if values else 2.0 ** -8 * np.abs(want))).all()
    assert (diff != 0).mean() <= 5e-3


@pytest.fixture(scope="module")
def qwen():
    return model_pair("qwen2-0.5b")


@pytest.mark.parametrize("per_slot", [False, True])
def test_gqa_decode_q8_matches_jax(qwen, per_slot):
    """Ten steps of ``gqa_decode_q8`` on layer 0 of reduced qwen2-0.5b
    against an int8 cache of 16 rows; positions shared (0-dim) or per slot
    ((B,), slots at depths 0 and 3)."""
    jcfg, _, jparams, cfg, _, params = qwen
    jpp = _layer0(jparams["layers"]["attn"])
    tp = cm.layer_params(params["layers"], 0)["attn"]
    b, s, kv, hd = 2, 16, cfg.n_kv_heads, cfg.head_dim
    jc = [jnp.zeros((b, s, kv, hd), jnp.int8) for _ in range(2)] + \
        [jnp.zeros((b, s, kv), jnp.bfloat16) for _ in range(2)]
    tc = [torch.zeros((b, s, kv, hd), dtype=torch.int8) for _ in range(2)] + \
        [torch.zeros((b, s, kv), dtype=torch.bfloat16) for _ in range(2)]
    rng = np.random.default_rng(2)
    start = np.array([0, 3], np.int32)
    for step in range(10):
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        pos = start + step if per_slot else np.int32(step)
        jout, *jc = jattention.gqa_decode_q8(
            jpp, jnp.asarray(x), *jc, jnp.asarray(pos), jcfg)
        tpos = to_torch(np.asarray(pos))
        out, *tc = attn.gqa_decode_q8(tp, to_torch(x), *tc, tpos, cfg,
                                      cache_len=tpos + 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    for i, (got, want) in enumerate(zip(tc, jc)):
        assert_int8_close(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)), values=i < 2)


def _layer0(tree):
    """Layer 0 of a JAX layer-stacked Param tree: Params of the same axes
    less the layer axis."""
    return {k: _layer0(v) if isinstance(v, dict)
            else jcm.Param(v.value[0], v.axes[1:]) for k, v in tree.items()}


@pytest.fixture(scope="module", params=["qwen2-0.5b", "hymba-1.5b"])
def pair(request):
    return model_pair(request.param)


def _decode_both(pair, kv_dtype, steps=10, b=2, max_len=16):
    jcfg, jbundle, jparams, cfg, bundle, params = pair
    jc = jbundle.init_cache(b, max_len, dtype=jnp.float32,
                            kv_dtype=None if kv_dtype is None else jnp.int8)
    tc = bundle.init_cache(b, max_len, dtype=torch.float32,
                           kv_dtype=kv_dtype, device="cpu")
    toks = random_tokens(b, steps, seed=3)
    logits = []
    for t in range(steps):
        tok = toks[:, t:t + 1]
        jl, jc = jbundle.decode_step(jparams, jc, jnp.asarray(tok),
                                     dtype=jnp.float32)
        tl, tc = bundle.decode_step(params, tc, to_torch(tok),
                                    dtype=torch.float32)
        logits.append((np.asarray(jl), tl.numpy()))
    return logits, jc, tc


def test_decode_step_int8_matches_jax(pair):
    """The whole model's ``decode_step`` over an int8 cache, ten steps from
    an empty cache: logits at every step, then every cache leaf (int8
    values and scales; the hybrid's SSM state and conv tail too)."""
    logits, jc, tc = _decode_both(pair, torch.int8)
    for jl, tl in logits:
        np.testing.assert_allclose(tl, jl, atol=ATOL)
    assert set(tc) == set(jc)
    for name in tc:
        got, want = tc[name], np.asarray(jc[name].value)
        if name in ("k", "v", "k_scale", "v_scale"):
            assert got.dtype == (torch.int8 if name in ("k", "v")
                                 else torch.bfloat16)
            assert_int8_close(got.float().numpy(), want.astype(np.float32),
                              values=name in ("k", "v"))
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_int8_logits_within_bound_of_fp_cache(pair):
    """The reference's bound: over 10 decode steps the int8 cache's logits
    stay within 0.05 of the fp32 cache's largest |logit|, in the port as in
    JAX."""
    q8, _, _ = _decode_both(pair, torch.int8)
    fp, _, _ = _decode_both(pair, None)
    for side in (0, 1):
        rel = (np.abs(q8[-1][side] - fp[-1][side]).max()
               / np.abs(fp[-1][side]).max())
        assert 0 < rel < FP_BOUND


def test_int8_cache_leaves():
    """int8 ``k``/``v`` (L, B, S, Hkv, D) and bf16 ``k_scale``/``v_scale``
    (L, B, S, Hkv); any other ``kv_dtype`` is ignored, as in the
    reference."""
    cfg = reduced(get_config("qwen2-0.5b"))
    bundle = registry.build(cfg)
    c = bundle.init_cache(3, 16, dtype=torch.float32, per_slot_pos=True,
                          kv_dtype=torch.int8, device="cpu")
    assert set(c) == {"k", "v", "k_scale", "v_scale", "pos"}
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert tuple(c["k"].shape) == (2, 3, 16, 2, 16)
    assert c["k_scale"].dtype == torch.bfloat16
    assert tuple(c["v_scale"].shape) == (2, 3, 16, 2)
    plain = bundle.init_cache(3, 16, dtype=torch.float32,
                              kv_dtype=torch.bfloat16, device="cpu")
    assert set(plain) == {"k", "v", "pos"}
    assert plain["k"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-1.3b"])
def test_kv_dtype_ignored_for_mla_and_ssm(arch):
    """MLA's latent cache and the SSM's state ignore ``kv_dtype=int8``, in
    the reference as in the port: the same leaves, shapes and dtypes."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import registry as jregistry
    bundle = registry.build(reduced(get_config(arch)))
    jbundle = jregistry.build(jreduced(jget_config(arch)))
    got = bundle.init_cache(2, 16, dtype=torch.float32, kv_dtype=torch.int8,
                            device="cpu")
    want = jbundle.init_cache(2, 16, dtype=jnp.float32, kv_dtype=jnp.int8)
    same = bundle.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert set(got) == set(want) == set(same)
    for name in got:
        assert tuple(got[name].shape) == want[name].value.shape \
            == tuple(same[name].shape)
        assert got[name].dtype == same[name].dtype
        assert str(got[name].dtype).split(".")[-1] == str(
            want[name].value.dtype)
