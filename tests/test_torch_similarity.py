"""The port's row-wise cosine against the JAX package's.

On the CPU ``kernels.ops.rowwise_cosine`` runs the kernel's plain version;
the JAX side runs the Pallas kernel body in interpret mode. Both sum fp32
products, in another order: atol 1e-5, as ``tests/test_kernels.py`` holds
the Pallas kernel against its reference. The kernel-vs-plain case needs the
card and skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import semhash as jsemhash  # noqa: E402
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


def test_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; only ops dispatches CPU
    tensors to the plain version."""
    a = torch.zeros(4, 256)
    before = ops.launch_counts()["rowwise_cosine"]
    with pytest.raises(ValueError, match="CUDA"):
        sim.rowwise_cosine(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        sim.rowwise_cosine(a, a[0])
    ops.rowwise_cosine(a, a[0])
    assert ops.launch_counts()["rowwise_cosine"] == before


def test_semantic_equal_batch_matches_jax():
    xs = ["the quick brown fox", "a crime story", "N250m"]
    ys = ["the quick brown fox", "a thriller tale", "250 million naira"]
    got = semhash.semantic_equal_batch(xs, ys, use_kernel=True, device="cpu")
    want = jsemhash.semantic_equal_batch(xs, ys, use_kernel=True)
    assert list(got) == list(want)
    assert list(semhash.semantic_equal_batch(xs, ys, use_kernel=False)) \
        == list(want)
    assert got[0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, dtype):
    """Full rows and an anchor, aligned (16-byte loads) and not (D = 250,
    one element a lane); both sum in fp32, in another order."""
    g = torch.Generator(cuda).manual_seed(0)
    for m, d in ((1, 256), (133, 256), (18891, 256), (37, 250)):
        a = torch.randn(m, d, generator=g, device=cuda).to(dtype)
        b = torch.randn(m, d, generator=g, device=cuda).to(dtype)
        for other in (b, b[0]):
            torch.testing.assert_close(sim.rowwise_cosine(a, other),
                                       sim.plain(a, other), atol=2e-4,
                                       rtol=1e-5)
    empty = torch.zeros(0, 256, device=cuda, dtype=dtype)
    assert sim.rowwise_cosine(empty, empty[0:0]).shape == (0,)
