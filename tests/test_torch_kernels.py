"""The port's attention entry points against the JAX ones.

On the CPU the port runs its kernels' plain versions; the JAX side runs the
Pallas kernel bodies in interpret mode (``repro.kernels.ops``). The
parametrizations and tolerances are those of ``tests/test_kernels.py``:
fp32 2e-5 (sums taken in another order), bf16 2e-2 (one bf16 rounding of
the output). The kernel-vs-plain cases need the card and skip without one.

The Hopper kernel multiplies on the tensor cores: bf16 as bf16, fp32 as
3xTF32 (each operand split into a TF32 high and low part, the product
summed as hi*hi + hi*lo + lo*hi), and P in bf16 as a high and a low bf16
part. The emulation tests below hold that arithmetic, done in torch on the
CPU, to the tolerances ``chip_smoke.py`` holds the kernel to, and show that
the cheaper forms (one TF32 product; P rounded once to bf16) would not.
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
    (1, 40, 4, 4, 128),     # codeqwen1.5-7b's head_dim: group of 1
    (2, 48, 8, 2, 128),     # head_dim 128, group of 4
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
    (4, 4, 4, 128, 160),    # codeqwen1.5-7b's head_dim: group of 1
    (3, 8, 2, 128, 100),    # head_dim 128, group of 4, padding
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
    """The TPU decode kernel has no window; on the CPU the model's windowed
    decode (``ops.decode_attention`` with a window: the plain version of the
    Hopper kernel's window) equals the JAX model's einsum decode."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(9)
    qj, qt = both(randn(rng, 3, 1, 4, 32))
    (kj, kt), (vj, vt) = (both(randn(rng, 3, 64, 2, 32)) for _ in range(2))
    lens = np.array([5, 33, 64], np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens),
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
    ops.cosine_matrix(q[0, :, 0], q[0, :, 1])
    ops.ssd_scan(q, q[..., 0], q[:, :, :1], q[:, :, :1])
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 0,
                                   "rowwise_cosine": 0, "cosine_matrix": 0,
                                   "ssd_scan": 0, "ssd_scan_bwd": 0}


def test_launch_counts_are_exact_across_threads():
    """Every wrapper counts through ``_build.count_launch``: launches from
    several threads at once (the engine's dispatchers, the cascade's tier-0
    workers) are all counted, and a reset clears every kernel's count."""
    import threading

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd
    ops.reset_launch_counts()

    def launch():
        for _ in range(2000):
            _build.count_launch(ssd.stats)
    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ops.launch_counts()["ssd_scan"] == 16000
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


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


def tf32(x):
    """x (fp32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa
    bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """x as wgmma reads a TF32 operand held in an fp32 register: its top 19
    bits, the rest dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_product(a, b, passes):
    """a @ b in fp32 from TF32 parts as the kernel forms them: 1 pass hi*hi;
    3 passes hi*hi + hi*lo + lo*hi, hi = x rounded to TF32 and lo = x - hi
    as wgmma reads it."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def emulated_attention(q, k, v, passes):
    """Causal attention of (S, Hq, D) fp32 q over (S, Hkv, D) k and v, both
    products from TF32 parts, softmax in fp32; one head at a time."""
    s, hq, d = q.shape
    g = hq // k.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    out = torch.empty_like(q)
    for h in range(hq):
        sc = tf32_product(q[:, h], k[:, h // g].T.contiguous(), passes)
        sc = (sc * d ** -0.5).masked_fill(~mask, float("-inf"))
        p = torch.exp(sc - sc.amax(dim=1, keepdim=True))
        out[:, h] = tf32_product(p, v[:, h // g], passes) / p.sum(dim=1,
                                                                   keepdim=True)
    return out


@pytest.mark.parametrize("s", [96, 2048])
def test_three_tf32_attention_holds_fp32_tolerance(s):
    """At qwen2-0.5b's heads (14 over 2, D 64), inputs 0.5 N(0, 1), the
    prefill path's S = 96 and the smoke's long 2048: 3xTF32 stays within the
    fp32 tolerance (2e-5) of attention in fp64; one TF32 product does not,
    so the split is needed."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(randn(rng, s, h, 64)) for h in (14, 2, 2))
    exact = ref.attention_ref(*(x[None].double() for x in (q, k, v)))[0]
    err3 = (emulated_attention(q, k, v, 3).double() - exact).abs().max()
    err1 = (emulated_attention(q, k, v, 1).double() - exact).abs().max()
    assert err3 <= 2e-5 < err1


def test_bf16_p_needs_high_and_low_parts():
    """bf16 attention at S = 2048 over qwen2-0.5b's heads: P fed to P V as
    a high and a low bf16 part holds the bf16 tolerance (1e-5 + 2^-7
    |plain|, element by element) against the plain version; P rounded once
    to bf16, as FlashAttention-3 feeds it, does not."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(randn(rng, 2048, h, 64)).bfloat16()
               for h in (14, 2, 2))
    plain = ref.attention_ref(q[None], k[None], v[None])[0].float()
    mask = torch.ones(2048, 2048, dtype=torch.bool).tril()
    worst = {"split": 0, "once": 0}
    for h in range(14):
        sc = (q[:, h].float() @ k[:, h // 7].float().T) * 64 ** -0.5
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.exp(sc - sc.amax(dim=1, keepdim=True))
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        for name, pp in (("split", hi + lo), ("once", hi)):
            o = ((pp @ v[:, h // 7].float()) / p.sum(dim=1, keepdim=True))
            err = (o.bfloat16().float() - plain[:, h]).abs()
            bad = err > 1e-5 + 2.0 ** -7 * plain[:, h].abs()
            worst[name] += int(bad.sum())
    assert worst["split"] == 0 and worst["once"] > 0


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A source's library is rebuilt when a ``csrc`` header it includes
    changes: the hash covers the headers, and only the sources that include
    an edited header get a new name."""
    import shutil

    from repro_torch.kernels import _build
    assert [p.name for p in _build._sources(
        _build.CSRC / "flash_attention.cu")] == ["flash_attention.cu",
                                                 "hopper.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    # every forward kernel and the flash backward include hopper.cuh (the
    # SSD backward, on the CUDA cores, includes none); ssd_scan.cu also
    # includes a header of its own in this copy, and only ssd_scan's name
    # follows that one
    users = {n for n in _build.SOURCES
             if csrc / "hopper.cuh" in _build._sources(csrc / f"{n}.cu")}
    assert users == set(_build.SOURCES) - {"ssd_scan_bwd"}
    src = csrc / "ssd_scan.cu"
    src.write_text('#include "extra.cuh"\n' + src.read_text())
    (csrc / "extra.cuh").write_text("// extra\n")
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    (csrc / "extra.cuh").write_text("// edited\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {"ssd_scan"}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    again = {n: _build._library_path(n) for n in _build.SOURCES}
    assert {n for n in after if after[n] != again[n]} == users


def test_flash_rows_must_be_16_byte_aligned():
    """The kernel reads q, k and v rows as 16-byte vectors: the model's
    tensors and a layer-stacked cache's slices pass the wrapper's check, a
    view whose rows start off a 16-byte boundary does not."""
    from repro_torch.kernels import flash_attention as fa
    for d in fa.HEAD_DIMS:
        cache = torch.zeros(3, 2, 40, 2, d)
        assert fa.rows_aligned(cache[1]) and fa.rows_aligned(
            torch.zeros(2, 40, 14, d))
        assert fa.rows_aligned(cache[1].bfloat16())
    wide = torch.zeros(1, 16, 2, 18)
    assert not fa.rows_aligned(wide[..., 1:17])
    assert not fa.rows_aligned(wide[..., :16])      # rows 72 bytes apart
    assert not fa.rows_aligned(torch.zeros(1, 16, 2, 16), wide[..., :16])
    assert fa.rows_aligned(torch.zeros(1, 1, 1, 16)[..., :16])


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
@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (4, 2, 16), (32, 32, 128),
                                      (8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda, dtype, hq, hkv, d):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    td = DTYPES[dtype][1]
    atol, rtol = ON_CARD_TOL[dtype]
    g = torch.Generator(cuda).manual_seed(0)

    def rn(*shape):
        return (torch.randn(*shape, generator=g, device=cuda) * 0.5).to(td)

    # (S, causal, window, q_offset, sk_valid): S = 200 spans four 64-key
    # tiles with a ragged last one; q_offset and sk_valid move the masks off
    # the tile edges; q_offset -6 leaves the first 6 rows with no key
    cases = [(40, True, 0, 0, 40), (40, True, 24, 0, 40), (40, False, 24, 0, 40),
             (200, True, 0, 0, 200), (40, True, 0, 5, 33), (40, True, 8, -6, 37),
             (40, False, 0, 3, 20), (200, True, 0, 9, 180)]
    for s, causal, window, q_offset, sk_valid in cases:
        q, k, v = rn(2, s, hq, d), rn(2, s, hkv, d), rn(2, s, hkv, d)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  sk_valid=sk_valid)
        got = fa.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(got.float(), fa.plain(q, k, v, **kw).float(),
                                   atol=atol, rtol=rtol)
        if q_offset < 0:
            assert torch.all(got[:, :-q_offset] == 0)
    cache = rn(2, 4, 160, hkv, d)         # (L, B, S, Hkv, D): read slices
    qd = rn(4, 1, hq, d)
    lens = torch.tensor([0, 1, 77, 160], dtype=torch.int32, device=cuda)
    got = dec.decode_attention(qd, cache[0], cache[1], lens)
    torch.testing.assert_close(
        got.float(), dec.plain(qd, cache[0], cache[1], lens).float(),
        atol=atol, rtol=rtol)
    assert torch.all(got[0] == 0)


# Hymba's heads at full width (25 query over 5 KV heads of 64, a group of 5
# padded to 8 in the kernel) and reduced (4 over 2 of 16).
HYMBA_HEADS = [(25, 5, 64), (4, 2, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", HYMBA_HEADS)
@pytest.mark.parametrize("window", [0, 1, 31, 64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_decode_matches_plain_on_card(cuda, dtype, window, hq, hkv,
                                               d):
    """The decode kernel with a sliding window against its plain version
    at cache lengths on either side of the window and of the 32-key tiles
    (0 gives exactly 0), read as slices of a layer-stacked cache. Every K
    and V row before a sequence's window is NaN: the kernel never loads
    them (its first tile starts at the window), so its output stays finite
    and equals the plain version's on the cache with those rows zeroed."""
    from repro_torch.kernels import decode_attention as dec
    td = DTYPES[dtype][1]
    atol, rtol = ON_CARD_TOL[dtype]
    g = torch.Generator(cuda).manual_seed(window)
    w = window or 64
    s = 2 * w + 40
    lens = torch.tensor(sorted({0, 1, w - 1, w, w + 1, 2 * w, s}),
                        dtype=torch.int32, device=cuda)
    b = len(lens)
    cache = (torch.randn(2, b, s, hkv, d, generator=g, device=cuda)
             * 0.5).to(td)
    q = (torch.randn(b, 1, hq, d, generator=g, device=cuda) * 0.5).to(td)
    first = lens - window if window else torch.zeros_like(lens)
    before = torch.arange(s, device=cuda)[None, :] < first[:, None]
    clean = cache.clone()
    cache[:, before] = float("nan")
    clean[:, before] = 0
    got = dec.decode_attention(q, cache[0], cache[1], lens, window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got.float(),
        dec.plain(q, clean[0], clean[1], lens, window=window).float(),
        atol=atol, rtol=rtol)
    assert torch.all(got[0] == 0)


@pytest.mark.gpu
def test_windowed_decode_through_ops_on_card(cuda):
    """``ops.decode_attention``, which the model's decode calls, sends a
    windowed call on the card to the kernel: one launch, equal to the CPU
    path's plain version."""
    g = torch.Generator(cuda).manual_seed(3)
    q = torch.randn(3, 1, 25, 64, generator=g, device=cuda)
    k, v = (torch.randn(3, 300, 5, 64, generator=g, device=cuda)
            for _ in range(2))
    lens = torch.tensor([5, 130, 300], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, lens, window=64)
    want = ops.decode_attention(q.cpu(), k.cpu(), v.cpu(), lens.cpu(),
                                window=64)
    assert ops.launch_counts()["decode_attention"] == 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)
