"""The port's attention entry points against the JAX ones.

On the CPU the port runs its kernels' plain versions; the JAX side runs the
Pallas kernel bodies in interpret mode (``repro.kernels.ops``). The
parametrizations and tolerances are those of ``tests/test_kernels.py``:
fp32 2e-5 (sums taken in another order), bf16 2e-2 (one bf16 rounding of
the output). The kernel-vs-plain cases need the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def randn(rng, *shape):
    return (rng.normal(size=shape) * 0.5).astype(np.float32)


def both(x, dtype="float32"):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def assert_close(got_torch, want_jax, atol):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), atol=atol)


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 64, 4, 4, 32),      # MHA
    (2, 128, 8, 2, 32),     # GQA 4x
    (1, 96, 8, 1, 64),      # MQA, non-pow2 seq
    (2, 40, 4, 2, 16),      # needs padding (40 % 32 != 0)
    (1, 40, 14, 2, 64),     # qwen2-0.5b heads: group of 7
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(b, s, hq, hkv, d, dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (both(randn(rng, b, s, h, d), dtype)
                                    for h in (hq, hkv, hkv))
    got = ops.flash_attention(qt, kt, vt, causal=True)
    want = jops.flash_attention(qj, kj, vj, causal=True, bq=32, bk=32)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("window", [8, 24, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_matches_pallas(window, causal):
    """Causal windows, and non-causal ones: the kernel masks one side only
    (q - k < window), where repro.kernels.ref masks both."""
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (both(randn(rng, 1, 96, h, 32))
                                    for h in (4, 2, 2))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                bq=32, bk=32)
    assert_close(got, want, 2e-5)


def test_flash_attention_noncausal_matches_pallas():
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (both(randn(rng, 1, 64, 4, 32))
                                    for _ in range(3))
    got = ops.flash_attention(qt, kt, vt, causal=False)
    want = jops.flash_attention(qj, kj, vj, causal=False, bq=32, bk=32)
    assert_close(got, want, 2e-5)


def test_flash_attention_continuation_offset():
    """Sq < Sk causal: the query block sits at q_offset = Sk - Sq, as the
    JAX wrapper places it (prefill continuation)."""
    rng = np.random.default_rng(3)
    (qj, qt) = both(randn(rng, 2, 24, 4, 32))
    (kj, kt), (vj, vt) = (both(randn(rng, 2, 72, 2, 32)) for _ in range(2))
    got = ops.flash_attention(qt, kt, vt, causal=True)
    want = jops.flash_attention(qj, kj, vj, causal=True, bq=8, bk=8)
    assert_close(got, want, 2e-5)


def test_flash_attention_empty_rows_give_zero():
    """A row with no valid key gives 0 (as the kernels), not the mean of V
    (as repro.kernels.ref)."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(randn(rng, 1, 16, 2, 16)) for _ in range(3))
    out = ref.attention_ref(q, k, v, causal=True, q_offset=-4)
    assert torch.all(out[:, :4] == 0)
    assert torch.all(out[:, 4:].abs().sum(-1) > 0)


@pytest.mark.parametrize("b,hq,hkv,d,s", [
    (1, 4, 4, 32, 128),
    (3, 8, 2, 64, 256),
    (2, 4, 1, 32, 100),     # padding (100 % 64)
    (4, 14, 2, 64, 160),    # qwen2-0.5b heads at the serve cache length
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(b, hq, hkv, d, s, dtype):
    rng = np.random.default_rng(5)
    qj, qt = both(randn(rng, b, 1, hq, d), dtype)
    (kj, kt), (vj, vt) = (both(randn(rng, b, s, hkv, d), dtype)
                          for _ in range(2))
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(lens), bk=64)
    assert_close(got, want, DTYPES[dtype][2])


def test_decode_attention_scalar_len():
    rng = np.random.default_rng(6)
    qj, qt = both(randn(rng, 2, 1, 4, 32))
    (kj, kt), (vj, vt) = (both(randn(rng, 2, 128, 2, 32)) for _ in range(2))
    assert_close(ops.decode_attention(qt, kt, vt, 77),
                 jops.decode_attention(qj, kj, vj, 77), 2e-5)


def test_decode_attention_zero_len_gives_zero():
    """cache_len = 0 gives 0 in both kernels (repro.kernels.ref gives the
    mean of V)."""
    rng = np.random.default_rng(7)
    qj, qt = both(randn(rng, 3, 1, 4, 32))
    (kj, kt), (vj, vt) = (both(randn(rng, 3, 64, 2, 32)) for _ in range(2))
    lens = np.array([0, 5, 64], np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(lens))
    assert torch.all(got[0] == 0)
    assert_close(got, want, 2e-5)


@pytest.mark.parametrize("window", [8, 40])
def test_model_windowed_decode_matches_jax(window):
    """A sliding decode window has no kernel; on the CPU the model runs the
    plain windowed path, equal to the JAX model's einsum decode."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(9)
    qj, qt = both(randn(rng, 3, 1, 4, 32))
    (kj, kt), (vj, vt) = (both(randn(rng, 3, 64, 2, 32)) for _ in range(2))
    lens = np.array([5, 33, 64], np.int32)
    got = attn.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                                window=window)
    want = jattn.decode_attention(qj, kj, vj, jnp.asarray(lens), window=window)
    assert_close(got, want, 2e-5)


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(randn(rng, 1, 16, 2, 16))
    ops.reset_launch_counts()
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :1], q, q, 3)
    ops.rowwise_cosine(q[0, :, 0], q[0, 0, 0])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "rowwise_cosine": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never runs the plain
    version on the tensors it was given."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention(q[:, :1], q, q, torch.ones(1, dtype=torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Kernel against plain version, both fp32 inside: (atol, rtol). In bf16 the
# two round their fp32 results at most one bf16 step (<= 2^-7 |x|) apart.
ON_CARD_TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (4, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda, dtype, hq, hkv, d):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    td = DTYPES[dtype][1]
    atol, rtol = ON_CARD_TOL[dtype]
    g = torch.Generator(cuda).manual_seed(0)

    def rn(*shape):
        return (torch.randn(*shape, generator=g, device=cuda) * 0.5).to(td)

    q, k, v = rn(2, 40, hq, d), rn(2, 40, hkv, d), rn(2, 40, hkv, d)
    for causal, window in ((True, 0), (True, 24), (False, 24)):
        kw = dict(causal=causal, window=window, q_offset=0, sk_valid=40)
        got = fa.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(got.float(), fa.plain(q, k, v, **kw).float(),
                                   atol=atol, rtol=rtol)
    cache = rn(2, 4, 160, hkv, d)         # (L, B, S, Hkv, D): read slices
    qd = rn(4, 1, hq, d)
    lens = torch.tensor([0, 1, 77, 160], dtype=torch.int32, device=cuda)
    got = dec.decode_attention(qd, cache[0], cache[1], lens)
    torch.testing.assert_close(
        got.float(), dec.plain(qd, cache[0], cache[1], lens).float(),
        atol=atol, rtol=rtol)
    assert torch.all(got[0] == 0)
