"""The port's cosine similarity (row-wise and all-pairs) against the JAX
package's.

On the CPU ``kernels.ops.rowwise_cosine`` and ``kernels.ops.cosine_matrix``
run the kernels' plain versions; the JAX side runs the Pallas kernel bodies
in interpret mode. Both sum fp32 products, in another order: atol 1e-5, as
``tests/test_kernels.py`` holds the Pallas kernels against their reference.
The kernel-vs-plain cases need the card and skip without one.

The Hopper ``cosine_matrix`` multiplies fp32 rows as 3xTF32 on the tensor
cores (each value split into its TF32 rounding hi and the rest lo, which
wgmma reads truncated to TF32, the product summed as hi*hi + hi*lo +
lo*hi); the emulation test below holds that arithmetic,
done in torch on the CPU, to the 1e-5 tolerance and shows that one TF32
product would not hold it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import semhash as jsemhash  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import similarity as jsim  # noqa: E402
from repro_torch.core import semhash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import similarity as sim  # noqa: E402


def unit_rows(rng, m, d):
    x = rng.normal(size=(m, d)).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("m", [0, 1, 127, 129, 133])
def test_rowwise_cosine_matches_pallas(m, d):
    rng = np.random.default_rng(m * 1000 + d)
    a, b = unit_rows(rng, m, d), unit_rows(rng, m, d)
    got = ops.rowwise_cosine(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jsim.rowwise_cosine(a, b, interpret=True))
    assert got.shape == (m,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("m", [1, 16, 133])
def test_anchor_row_equals_explicit_broadcast(m):
    """A (D,) anchor gives the values of the anchor tiled to (M, D), as the
    JAX cascade passes it to the Pallas kernel."""
    rng = np.random.default_rng(m)
    vals, anchor = unit_rows(rng, m, 256), unit_rows(rng, 1, 256)[0]
    got = ops.rowwise_cosine(torch.from_numpy(vals), torch.from_numpy(anchor))
    tiled = ops.rowwise_cosine(torch.from_numpy(vals),
                               torch.from_numpy(anchor).expand(m, 256))
    want = np.asarray(jsim.rowwise_cosine(
        vals, np.broadcast_to(anchor, vals.shape), interpret=True))
    np.testing.assert_array_equal(got.numpy(), tiled.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# the shapes of tests/test_kernels.py: its sweep, and M = 1, 127, 129
# against N = 67 (the JAX module itself takes any M and N)
MATRIX_SHAPES = [(128, 128, 256), (130, 70, 256), (16, 16, 64),
                 (1, 67, 256), (127, 67, 256), (129, 67, 256)]


@pytest.mark.parametrize("m,n,d", MATRIX_SHAPES)
def test_cosine_matrix_matches_pallas(m, n, d):
    rng = np.random.default_rng(m * 7 + n + d)
    a, b = unit_rows(rng, m, d), unit_rows(rng, n, d)
    got = ops.cosine_matrix(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (m, n) and got.dtype == torch.float32
    for want in (jops.cosine_matrix(a, b),
                 jsim.cosine_matrix(a, b, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cosine_matrix_empty_and_bf16():
    """M = 0 gives (0, N); bf16 rows are summed in fp32 into fp32."""
    rng = np.random.default_rng(11)
    b = torch.from_numpy(unit_rows(rng, 5, 64))
    assert ops.cosine_matrix(b[:0], b).shape == (0, 5)
    got = ops.cosine_matrix(b.bfloat16(), b.bfloat16())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, b.bfloat16().float() @ b.bfloat16().float().T)


def test_wrapper_refuses_cpu_tensors():
    """The wrappers launch their kernels or raise; only ops dispatches CPU
    tensors to the plain versions."""
    a = torch.zeros(4, 256)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        sim.rowwise_cosine(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        sim.rowwise_cosine(a, a[0])
    with pytest.raises(ValueError, match="CUDA"):
        sim.cosine_matrix(a, a)
    ops.rowwise_cosine(a, a[0])
    ops.cosine_matrix(a, a)
    assert ops.launch_counts() == before


def test_semantic_equal_batch_matches_jax():
    xs = ["the quick brown fox", "a crime story", "N250m"]
    ys = ["the quick brown fox", "a thriller tale", "250 million naira"]
    got = semhash.semantic_equal_batch(xs, ys, use_kernel=True, device="cpu")
    want = jsemhash.semantic_equal_batch(xs, ys, use_kernel=True)
    assert list(got) == list(want)
    assert list(semhash.semantic_equal_batch(xs, ys, use_kernel=False)) \
        == list(want)
    assert got[0]


def tf32(x):
    """x (fp32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa
    bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """x as wgmma reads a TF32 operand held in an fp32 register: its top 19
    bits, the rest dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("m,n", [(250, 250), (4096, 4096)])
def test_three_tf32_cosines_hold_fp32_tolerance(m, n):
    """Unit rows of the embedder's width (256), at the semantic path's
    250 x 250 and the smoke's 4096 x 4096: 3xTF32 stays within 1e-5 of the
    cosines in fp64; one TF32 product does not."""
    rng = np.random.default_rng(m)
    a, b = (torch.from_numpy(unit_rows(rng, r, 256)) for r in (m, n))
    exact = a.double() @ b.double().T
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)   # lo = x - hi, as read
    three = ah @ bh.T + ah @ bl.T + al @ bh.T
    err3 = (three.double() - exact).abs().max()
    err1 = ((ah @ bh.T).double() - exact).abs().max()
    assert err3 <= 1e-5 < err1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, dtype):
    """Full rows and an anchor, aligned (16-byte loads) and not (D = 250,
    and rows that start two elements past an aligned address: one element a
    lane); M = 1, a 16-row morsel, 31 (one row a warp), 133, 4096 and the
    18,891-row game table (four rows a warp); both sum in fp32, in another
    order."""
    g = torch.Generator(cuda).manual_seed(0)
    for m, d in ((1, 256), (16, 256), (31, 256), (133, 256), (4096, 256),
                 (18891, 256), (37, 250)):
        a = torch.randn(m, d, generator=g, device=cuda).to(dtype)
        b = torch.randn(m, d, generator=g, device=cuda).to(dtype)
        for other in (b, b[0]):
            torch.testing.assert_close(sim.rowwise_cosine(a, other),
                                       sim.plain(a, other), atol=2e-4,
                                       rtol=1e-5)
    flat = torch.randn(2 * 64 * 256 + 2, generator=g, device=cuda).to(dtype)
    a, b = flat[2:64 * 256 + 2].view(64, 256), flat[:64 * 256].view(64, 256)
    for other in (b, b[0]):
        torch.testing.assert_close(sim.rowwise_cosine(a, other),
                                   sim.plain(a, other), atol=2e-4, rtol=1e-5)
    empty = torch.zeros(0, 256, device=cuda, dtype=dtype)
    assert sim.rowwise_cosine(empty, empty[0:0]).shape == (0,)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cosine_matrix_kernel_matches_plain_on_card(cuda, dtype):
    """The shapes of tests/test_kernels.py, the semantic path's 250 x 250,
    ragged M, N and D (D = 250 and 33 are read element by element), each
    of the kernel's tilings (clusters of blocks up to 250 x 250, 64 x 64
    tiles at 1000 x 1000, 128 x 128 tiles at 2048 x 1100), D = 0 and M = 0;
    both sum in fp32, in another order."""
    g = torch.Generator(cuda).manual_seed(0)
    for m, n, d in MATRIX_SHAPES + [(37, 45, 250), (600, 130, 256),
                                    (250, 250, 256), (300, 7, 33),
                                    (1000, 1000, 256), (2048, 1100, 200),
                                    (2048, 1100, 250)]:
        a = torch.randn(m, d, generator=g, device=cuda)
        b = torch.randn(n, d, generator=g, device=cuda)
        a = (a / a.norm(dim=1, keepdim=True)).to(dtype)
        b = (b / b.norm(dim=1, keepdim=True)).to(dtype)
        torch.testing.assert_close(sim.cosine_matrix(a, b),
                                   sim.plain_matrix(a, b), atol=1e-5, rtol=0)
    empty = torch.zeros(0, 256, device=cuda, dtype=dtype)
    rows = torch.zeros(7, 256, device=cuda, dtype=dtype)
    assert sim.cosine_matrix(empty, rows).shape == (0, 7)
    no_d = torch.zeros(5, 0, device=cuda, dtype=dtype)
    assert torch.equal(sim.cosine_matrix(no_d, no_d),
                       torch.zeros(5, 5, device=cuda))
