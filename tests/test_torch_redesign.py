"""The decompositions of the Hopper decode_attention and ssd_scan kernels,
emulated in plain PyTorch on the CPU and held against the JAX package.

A CUDA kernel cannot run here, but the order in which it splits and merges
its work can. Each emulation below follows its kernel step by step:

* decode_attention: the cache is cut into tiles of 32 keys; warp w of
  cluster block r takes tiles r * 4 + w, then every (4 x ranks)-th after
  it, below cache_len, with an online softmax in log2 units; the 4 warps
  of a block merge their (max, sum, accumulator) states, then the blocks of
  the cluster merge theirs. The number of blocks follows S and the card's
  multiprocessors as in ``ranks_for`` in ``csrc/decode_attention.cu``.
* ssd_scan: chunks of 64 steps (the last one ragged, padded with dA = 0
  and zeros); a block owns 16 columns of P and carries their N x 16 state
  from chunk to chunk; the scores C . B^T and C . state are one product
  whose k-steps (N padded to a multiple of 64) two warpgroups halve and
  add, then each takes half of the score columns for the causal product
  M . dx. In fp32 every product is
  3xTF32: each operand split into hi = its TF32 rounding and lo = the rest,
  which the tensor cores read truncated to TF32; hi*hi + hi*lo + lo*hi.

The JAX side runs the Pallas kernels in interpret mode
(``repro.kernels.ops``) and the reference recurrences in fp64.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_kernels import tf32, tf32_read  # noqa: E402

KEYS, WARPS, MAX_RANKS = 32, 4, 8  # decode_attention.cu
L, PB = 64, 16                     # ssd_scan.cu
H100_SMS = 132  # multiprocessors of an H100 SXM; ranks_for reads the card's


def decode_ranks(s, b, hkv, sms=H100_SMS):
    """Cluster blocks per (KV head, sequence) on a card of ``sms``
    multiprocessors, as ``ranks_for``."""
    tiles = -(-s // KEYS)
    least, most = -(-tiles // (8 * WARPS)), -(-tiles // (2 * WARPS))
    return max(1, min(MAX_RANKS, max(least, min(most, -(-sms // (b * hkv))))))


def merge(states):
    """(max, sum, accumulator) states merged as the kernel merges them; a
    state that saw no key (max -inf) weighs 0."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l, acc = 0, 0
    for m, li, ai in states:
        w = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp2(m - mx))
        l, acc = l + li * w, acc + ai * w[:, None]
    return mx, l, acc


def decode_emulated(q, k, v, lens, dtype, sms=H100_SMS):
    """The kernel's decomposition of decode attention in ``dtype`` on a card
    of ``sms`` multiprocessors: q (B, 1, Hq, D), caches (B, S, Hkv, D), lens
    (B,) ints."""
    q, k, v = (torch.as_tensor(x, dtype=dtype) for x in (q, k, v))
    b, _, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g, ranks = hq // hkv, decode_ranks(s, b, hkv, sms)
    scale = d ** -0.5 * math.log2(math.e)
    out = torch.zeros_like(q)
    for bi in range(b):
        n = max(0, min(int(lens[bi]), s))
        for hk in range(hkv):
            qg = q[bi, 0, hk * g:(hk + 1) * g] * scale
            blocks = []
            for r in range(ranks):
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), -math.inf, dtype=dtype)
                    l = torch.zeros(g, dtype=dtype)
                    acc = torch.zeros(g, d, dtype=dtype)
                    tiles = range(r * WARPS + w, -(-n // KEYS), ranks * WARPS)
                    for t in tiles:
                        keys = slice(t * KEYS, min((t + 1) * KEYS, n))
                        sc = qg @ k[bi, keys, hk].T
                        mx = torch.maximum(m, sc.amax(1))
                        alpha = torch.where(m == -math.inf,
                                            torch.zeros_like(m),
                                            torch.exp2(m - mx))
                        p = torch.exp2(sc - mx[:, None])
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ v[bi, keys, hk]
                        m = mx
                    warps.append((m, l, acc))
                blocks.append(merge(warps))
            _, l, acc = merge(blocks)
            out[bi, 0, hk * g:(hk + 1) * g] = torch.where(
                l[:, None] > 0, acc / torch.where(l > 0, l, 1)[:, None], 0)
    return out


def decode_exact(q, k, v, lens):
    """Decode attention in fp64, straight from its definition (the port's
    ``ref`` computes in fp32); an empty cache gives 0."""
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    b, _, hq, d = q.shape
    g = hq // k.shape[2]
    out = torch.zeros_like(q)
    for bi in range(b):
        n = int(lens[bi])
        if n == 0:
            continue
        for h in range(hq):
            sc = k[bi, :n, h // g] @ q[bi, 0, h] * d ** -0.5
            out[bi, 0, h] = torch.softmax(sc, 0) @ v[bi, :n, h // g]
    return out


def decode_inputs(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * 0.5).astype(np.float32)
            for shape in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("g", [1, 2, 7, 16])
def test_decode_split_and_merge_matches_pallas(g, d):
    """Every edge length at once (none, one key, either side of 64, the
    engine's 160, the whole cache) over S = 300 (clusters of 2 blocks): the
    emulation in fp64 equals attention in fp64, and in fp32 holds the fp32
    tolerance (2e-5) of the Pallas kernel; empty rows give exactly 0."""
    s, hkv = 300, 2
    q, k, v = decode_inputs(g * 10 + d, 7, s, g * hkv, hkv, d)
    assert decode_ranks(s, 7, hkv) == 2
    lens = np.array([0, 1, 63, 64, 65, 160, s], np.int32)
    got64 = decode_emulated(q, k, v, lens, torch.float64)
    torch.testing.assert_close(got64, decode_exact(q, k, v, lens), rtol=0,
                               atol=1e-12)
    got32 = decode_emulated(q, k, v, lens, torch.float32)
    want = jops.decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 jnp.asarray(lens))
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), atol=2e-5)
    assert torch.all(got32[0] == 0)


@pytest.mark.parametrize("sms,ranks", [(H100_SMS, 5), (16, 2)])
def test_decode_many_tiles_per_warp(sms, ranks):
    """S = 1100 over 5 sequences runs clusters of 5 blocks of 4 warps on an
    H100; lengths past 640 give some warps two tiles, so the online softmax
    rescales within a warp as well as across warps and blocks. A card of 16
    multiprocessors gets clusters of 2, and up to 5 tiles a warp."""
    q, k, v = decode_inputs(11, 5, 1100, 14, 2, 64)
    lens = np.array([0, 1, 1024, 1025, 1100], np.int32)
    assert decode_ranks(1100, 5, 2, sms) == ranks
    torch.testing.assert_close(
        decode_emulated(q, k, v, lens, torch.float64, sms),
        decode_exact(q, k, v, lens), rtol=0, atol=1e-12)
    want = jops.decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 jnp.asarray(lens))
    np.testing.assert_allclose(
        decode_emulated(q, k, v, lens, torch.float32, sms).numpy(),
        np.asarray(want), atol=2e-5)


def product(a, b, mode):
    """a @ b as the kernel forms it: fp64 exactly ("f64"), or in fp32 from
    TF32 parts, 3 products ("3xtf32") or the hi parts alone ("1xtf32")."""
    if mode == "f64":
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if mode == "1xtf32":
        return ah @ bh
    return ah @ bh + ah @ tf32_read(b - bh) + tf32_read(a - ah) @ bh


def ssd_emulated(dx, dA, B, C, init, mode):
    """The kernel's decomposition of the SSD scan: fp64 throughout ("f64")
    or fp32 with TF32 products. Returns (y (B, S, H, P), state (B, H, N,
    P))."""
    dt = torch.float64 if mode == "f64" else torch.float32
    dx, dA, B, C = (torch.as_tensor(x, dtype=dt) for x in (dx, dA, B, C))
    b, s, h, p = dx.shape
    g, n = B.shape[2], B.shape[3]
    nk = -(-n // 64) * 64
    y = torch.zeros(b, s, h, p, dtype=dt)
    fin = torch.zeros(b, h, n, p, dtype=dt)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    for bi in range(b):
        for hh in range(h):
            grp = hh // (h // g)
            for p0 in range(0, p, PB):
                cols = slice(p0, min(p0 + PB, p))
                st = torch.zeros(nk, cols.stop - p0, dtype=dt)
                if init is not None:
                    st[:n] = torch.as_tensor(init[bi, hh, :, cols], dtype=dt)
                for c0 in range(0, s, L):
                    ln = min(L, s - c0)
                    steps = slice(c0, c0 + ln)
                    da = torch.zeros(L, dtype=dt)
                    da[:ln] = dA[bi, steps, hh]
                    cc, bb = (torch.zeros(L, nk, dtype=dt) for _ in range(2))
                    cc[:ln, :n] = C[bi, steps, grp]
                    bb[:ln, :n] = B[bi, steps, grp]
                    x = torch.zeros(L, cols.stop - p0, dtype=dt)
                    x[:ln] = dx[bi, steps, hh, cols]
                    cs = torch.cumsum(da, 0)
                    ecs, w = torch.exp(cs), torch.exp(cs[-1] - cs)
                    # scores and C . state: one product with bs = [B; state^T]
                    # whose k-steps the two warpgroups halve and add
                    bs = torch.cat([bb.T, st], 1)
                    kh = nk // 2
                    sc = (product(cc[:, :kh], bs[:kh], mode)
                          + product(cc[:, kh:], bs[kh:], mode))
                    yc = ecs[:, None] * sc[:, L:]
                    for half in range(2):   # M dx over each one's 32 steps
                        sh = slice(32 * half, 32 * half + 32)
                        decay = torch.exp(torch.where(
                            causal[:, sh], cs[:, None] - cs[None, sh], -1e30))
                        m = torch.where(causal[:, sh], sc[:, sh] * decay, 0)
                        yc = yc + product(m, x[sh], mode)
                    st = st * torch.exp(cs[-1]) + product(
                        (bb * w[:, None]).T.contiguous(), x, mode)
                    y[bi, steps, hh, cols] = yc[:ln]
                fin[bi, hh, :, cols] = st[:n]
    return y, fin


def ssd_inputs(seed, s, g, init):
    """The JAX tests' scales at 4 heads of P = 32 (two blocks of 16
    columns); N = 16 with one group, 24 (padded to 32) with two."""
    rng = np.random.default_rng(seed)
    h, p, n = 4, 32, 16 if g == 1 else 24
    dx = rng.normal(size=(1, s, h, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(1, s, h))) * 0.2).astype(np.float32)
    B, C = (rng.normal(size=(1, s, g, n)).astype(np.float32)
            for _ in range(2))
    st = rng.normal(size=(1, h, n, p)).astype(np.float32) if init else None
    return dx, dA, B, C, st


def f64_limit(exact):
    """``chip_smoke.ssd_held``'s limit against fp64: 1e-4 + 2^-19 max|f64|."""
    return 1e-4 + 2.0 ** -19 * exact.abs().max().item()


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s", [1, 15, 63, 64, 65, 96, 272])
def test_ssd_p_split_matches_pallas(s, init, g):
    """The P-split chunked form at the kernel's L = 64: in fp64 it equals
    the sequential recurrence in fp64; with 3xTF32 products in fp32 it
    holds the card's gate against fp64 (1e-4 + 2^-19 max|f64|) and the JAX
    tests' 3e-4 against the Pallas kernel (interpret mode)."""
    args = ssd_inputs(s * 7 + g, s, g, init)
    exact = ref.ssd_ref(*(None if x is None else torch.from_numpy(x).double()
                          for x in args))
    y64, st64 = ssd_emulated(*args, "f64")
    for got, want in ((y64, exact[0]), (st64, exact[1])):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-9 * (1 + want.abs().max().item()))
    y, st = ssd_emulated(*args, "3xtf32")
    for got, want in ((y, exact[0]), (st, exact[1])):
        assert (got.double() - want).abs().max() <= f64_limit(want)
    yj, stj = jops.ssd_scan(*(None if x is None else jnp.asarray(x)
                              for x in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=3e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=3e-4)


def test_ssd_one_tf32_product_misses_the_gate():
    """At mamba2-1.3b's d_state (N = 128) and a ragged S = 272, one TF32
    product per term would move y by more than the card's gate against
    fp64; the 3xTF32 split stays inside it."""
    rng = np.random.default_rng(3)
    s, h, p, n = 272, 1, 16, 128
    args = (rng.normal(size=(1, s, h, p)).astype(np.float32),
            (-np.abs(rng.normal(size=(1, s, h))) * 0.2).astype(np.float32),
            rng.normal(size=(1, s, 1, n)).astype(np.float32),
            rng.normal(size=(1, s, 1, n)).astype(np.float32), None)
    exact = ref.ssd_ref(*(None if x is None else torch.from_numpy(x).double()
                          for x in args))[0]
    err3 = (ssd_emulated(*args, "3xtf32")[0].double() - exact).abs().max()
    err1 = (ssd_emulated(*args, "1xtf32")[0].double() - exact).abs().max()
    assert err3 <= f64_limit(exact) < err1


def test_ssd_probe_phases_follow_the_kernels_stamps():
    """``ssd_probe.py`` names one phase for each stamp after the first that
    ``csrc/ssd_scan.cu`` records in a chunk, in order, and its stamp buffer
    holds them."""
    import re
    from pathlib import Path
    from repro_torch.kernels import ssd_probe
    src = (Path(ssd_probe.__file__).parent.parent / "csrc" /
           "ssd_scan.cu").read_text()
    ks = [int(k) for k in re.findall(r"^\s*STAMP\((\d+)\);", src, re.M)]
    assert ks == list(range(len(ssd_probe.PHASES) + 1))
    assert "stamps[64][8]" in src and len(ks) <= 8


def test_ssd_probe_needs_a_card():
    """Without a CUDA device the probe exits non-zero and prints nothing."""
    import os
    import subprocess
    import sys
    from repro_torch.kernels import ssd_probe
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, ssd_probe.__file__], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Kernel against plain version on the card: (atol, rtol) by dtype, as
# chip_smoke.py holds them (bf16: one bf16 step of the fp32 result apart).
ON_CARD_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(1, 64), (7, 64), (16, 64), (2, 16), (7, 16)])
@pytest.mark.parametrize("s", [160, 1100])
def test_decode_kernel_edges_on_card(cuda, dtype, g, d, s):
    """The Hopper kernel against its plain version at the edge lengths (0
    gives exactly 0), the cache read as a slice of a layer-stacked tensor
    and through rows that are not 16-byte aligned."""
    from repro_torch.kernels import decode_attention as dec
    gen = torch.Generator(cuda).manual_seed(g * d + s)
    hkv, atol, rtol = 2, *ON_CARD_TOL[dtype]

    def rn(*shape):
        x = torch.randn(*shape, generator=gen, device=cuda)
        return (x * 0.5).to(dtype)
    lens = torch.tensor([0, 1, 63, 64, 65, 160, s], dtype=torch.int32,
                        device=cuda)
    b = len(lens)
    q = rn(b, 1, g * hkv, d)
    stacked = rn(3, 2, b, s, hkv, d)
    unaligned = rn(2, b, s, hkv, d + 1)[..., 1:]
    for kc, vc in ((stacked[1, 0], stacked[2, 1]),
                   (unaligned[0], unaligned[1])):
        got = dec.decode_attention(q, kc, vc, lens)
        torch.testing.assert_close(got.float(),
                                   dec.plain(q, kc, vc, lens).float(),
                                   atol=atol, rtol=rtol)
        assert torch.all(got[0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [1, 15, 63, 64, 65, 96, 272])
def test_ssd_kernel_edges_on_card(cuda, dtype, g, s):
    """The Hopper kernel against its plain version at mamba2-1.3b's head
    width and d_state (4 heads of P = 64, N = 128), with and without an
    initial state, B and C read in place as slices of one conv output, as
    the model reads them (plain: 1e-4 + 2^-17 max|plain|, and one bf16 step
    of y in bf16, as chip_smoke.ssd_held)."""
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(cuda).manual_seed(s * 3 + g)
    h, p, n = 4, 64, 128

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)
    xbc = rn(1, s, h * p + 2 * g * n).to(dtype)
    dx = xbc[..., :h * p].view(1, s, h, p)
    B = xbc[..., h * p:h * p + g * n].view(1, s, g, n)
    C = xbc[..., h * p + g * n:].view(1, s, g, n)
    dA = -rn(1, s, h).abs() * 0.2
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for init in (None, rn(1, h, n, p)):
        y, st = ssd.ssd_scan(dx, dA, B, C, init)
        yp, stp = ssd.plain(dx, dA, B, C, init, chunk=ssd.model_chunk(s))
        for got, want, r in ((y, yp, rtol), (st, stp, 0.0)):
            want = want.float()
            torch.testing.assert_close(
                got.float(), want, rtol=r,
                atol=1e-4 + 2.0 ** -17 * want.abs().max().item())
