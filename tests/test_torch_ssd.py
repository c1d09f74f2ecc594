"""The port's SSD scan against the JAX package's.

On the CPU ``kernels.ops.ssd_scan`` runs the kernel's plain version (the
chunked dual form); the JAX side runs the Pallas kernel body in interpret
mode (``repro.kernels.ops.ssd_scan``), the naive recurrence
(``repro.kernels.ref.ssd_ref``) and the model's ``ssd_chunked``. Inputs
are those of ``tests/test_kernels.py``: dA = -|N(0, 1)| * 0.2, the rest
N(0, 1). Tolerances: 3e-4 against the recurrence and the Pallas kernel, as
the JAX tests hold the kernel; 1e-5 + 1e-6 |y| against ``ssd_chunked`` at
the same chunk, which sums the same terms in another order (a few fp32
ulps at |y| up to ~70). The kernel-vs-plain cases need the card and skip
without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

# (B, S, H, P, G, N, chunk): the JAX sweep; reduced mamba2-1.3b's heads at
# its chunk of 32; an S that 256 does not divide (the chunk rule gives 16)
SHAPES = [(1, 64, 2, 16, 1, 8, 16), (2, 128, 4, 32, 2, 16, 32),
          (1, 96, 8, 16, 4, 8, 48), (2, 96, 8, 16, 1, 16, 32),
          (1, 272, 4, 16, 1, 16, 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    whose thread pools would otherwise contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    dx = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(b, s, h))) * 0.2).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return dx, dA, B, C


def torched(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ssd_scan_matches_pallas_and_recurrence(b, s, h, p, g, n, chunk):
    dx, dA, B, C = inputs(s + h, b, s, h, p, g, n)
    y, st = ops.ssd_scan(*torched(dx, dA, B, C), chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, n, p)
    assert st.dtype == torch.float32
    jx = [jnp.asarray(x) for x in (dx, dA, B, C)]
    yj, stj = jops.ssd_scan(*jx, chunk=chunk)
    y_ref, st_ref = jref.ssd_ref(*jx)
    for want_y, want_st in ((yj, stj), (y_ref, st_ref)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=3e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   atol=3e-4)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ssd_scan_matches_model_chunked_path(b, s, h, p, g, n, chunk):
    dx, dA, B, C = inputs(s * h, b, s, h, p, g, n)
    chunk = ssd.model_chunk(s, chunk)
    y, st = ops.ssd_scan(*torched(dx, dA, B, C), chunk=chunk)
    yc, stc = ssd_chunked(*(jnp.asarray(x) for x in (dx, dA, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yc), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(stc), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("s,chunk,want", [(96, 0, 96), (272, 0, 16),
                                          (2048, 0, 256), (48, 32, 16),
                                          (7, 0, 7)])
def test_model_chunk_is_the_jax_rule(s, chunk, want):
    """``chunk`` or min(256, S), halved until it divides S (as
    ``repro.kernels.ops.ssd_scan`` and ``repro.models.ssm`` pick it)."""
    assert ssd.model_chunk(s, chunk) == want


def test_port_recurrence_matches_jax_recurrence():
    dx, dA, B, C = inputs(3, 2, 40, 4, 8, 2, 8)
    init = np.random.default_rng(4).normal(size=(2, 4, 8, 8)).astype(
        np.float32)
    y, st = ref.ssd_ref(*torched(dx, dA, B, C), torch.from_numpy(init))
    yj, stj = jref.ssd_ref(*(jnp.asarray(x) for x in (dx, dA, B, C, init)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=1e-5,
                               rtol=1e-6)


def test_recurrence_runs_in_fp64_when_given_fp64():
    """``ref.ssd_ref`` keeps fp64 inputs in fp64 (the on-card oracle that
    says whether the kernel or the plain version carries a difference),
    and its fp32 run agrees with that to a few fp32 ulps."""
    dx, dA, B, C = torched(*inputs(9, 1, 96, 4, 16, 1, 32))
    init = torch.from_numpy(np.random.default_rng(10).normal(
        size=(1, 4, 32, 16)))
    y64, st64 = ref.ssd_ref(dx.double(), dA.double(), B.double(), C.double(),
                            init)
    y, st = ref.ssd_ref(dx, dA, B, C, init.float())
    assert y64.dtype == st64.dtype == torch.float64
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y.double(), y64, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(st.double(), st64, atol=1e-5, rtol=1e-6)


def test_ssd_scan_initial_state_continuation():
    """Scanning the first half, then the second from the carried state,
    equals one full scan (the prefill-continuation invariant of
    ``tests/test_kernels.py``)."""
    dx, dA, B, C = (torch.from_numpy(x)
                    for x in inputs(5, 1, 64, 2, 8, 1, 8))
    y_full, st_full = ops.ssd_scan(dx, dA, B, C, chunk=16)
    y1, st1 = ops.ssd_scan(dx[:, :32], dA[:, :32], B[:, :32], C[:, :32],
                           chunk=16)
    y2, st2 = ops.ssd_scan(dx[:, 32:], dA[:, 32:], B[:, 32:], C[:, 32:],
                           st1, chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=3e-4)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), atol=3e-4)


def test_initial_state_matches_pallas():
    dx, dA, B, C = inputs(6, 2, 48, 4, 8, 2, 8)
    init = np.random.default_rng(7).normal(size=(2, 4, 8, 8)).astype(
        np.float32)
    y, st = ops.ssd_scan(*torched(dx, dA, B, C), torch.from_numpy(init),
                         chunk=16)
    yj, stj = jops.ssd_scan(*(jnp.asarray(x) for x in (dx, dA, B, C, init)),
                            chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=3e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=3e-4)


def test_plain_keeps_dx_dtype_and_fp32_state():
    """bf16 inputs: y in bf16, one rounding of the fp32 result; the state
    stays fp32."""
    dx, dA, B, C = torched(*inputs(8, 1, 32, 2, 8, 1, 8))
    y, st = ops.ssd_scan(dx.bfloat16(), dA, B.bfloat16(), C.bfloat16())
    y32, st32 = ops.ssd_scan(dx.bfloat16().float(), dA, B.bfloat16().float(),
                             C.bfloat16().float())
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y, y32.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(st, st32, atol=0, rtol=0)


def test_plain_refuses_a_chunk_that_does_not_divide():
    dx, dA, B, C = torched(*inputs(9, 1, 24, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="divide"):
        ssd.plain(dx, dA, B, C, chunk=16)


def test_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises; only ops dispatches CPU
    tensors to the plain version, and that launches nothing."""
    dx, dA, B, C = torched(*inputs(10, 1, 16, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(dx, dA, B, C)
    before = ops.launch_counts()["ssd_scan"]
    ops.ssd_scan(dx, dA, B, C)
    assert ops.launch_counts()["ssd_scan"] == before


# The explicit backward against jax.vjp: every leaf within BWD_RTOL of its
# largest |value|, elementwise. Both sides sum in fp32 in other orders
# (the port in chunks of 64 with the last one ragged, the reference at the
# model's chunk or step by step), so a leaf differs by a few fp32 ulps of
# its scale; a dropped or doubled term moves it by O(1) of its scale.
BWD_RTOL = 2e-5


def jax_vjp(fn, dx, dA, B, C, init, dy, dstate):
    """(ddx, ddA, dB, dC, d init) of ``fn(dx, dA, B, C, init) -> (y,
    final state)`` by ``jax.vjp`` at the cotangents (dy, dstate), in
    numpy."""
    import jax
    _, pull = jax.vjp(fn, *(jnp.asarray(x) for x in (dx, dA, B, C, init)))
    return [np.asarray(g) for g in pull((jnp.asarray(dy),
                                         jnp.asarray(dstate)))]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("with_init,with_dstate", [(False, False),
                                                   (True, True)])
def test_plain_backward_matches_jax_vjp(b, s, h, p, g, n, chunk, with_init,
                                        with_dstate):
    """``ssd_scan.plain_backward`` (the chunk-by-chunk formulas the backward
    kernel runs, chunks of 64, the last one ragged) against ``jax.vjp`` of
    the reference model's ``ssd_chunked`` at the JAX chunk rule and of the
    sequential recurrence ``ref.ssd_ref``, with and without an initial
    state and a cotangent of the final state."""
    dx, dA, B, C = inputs(s + 2 * h, b, s, h, p, g, n)
    rng = np.random.default_rng(s + n)
    init = (rng.normal(size=(b, h, n, p)) if with_init
            else np.zeros((b, h, n, p))).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dstate = (rng.normal(size=(b, h, n, p)) if with_dstate
              else np.zeros((b, h, n, p))).astype(np.float32)
    got = ssd.plain_backward(*torched(dx, dA, B, C),
                             torch.from_numpy(init) if with_init else None,
                             torch.from_numpy(dy),
                             torch.from_numpy(dstate) if with_dstate
                             else None)
    assert [t.dtype for t in got] == [torch.float32] * 5
    chunk = ssd.model_chunk(s, chunk)
    for fn in (lambda *a: ssd_chunked(*a[:4], chunk, a[4]), jref.ssd_ref):
        want = jax_vjp(fn, dx, dA, B, C, init, dy, dstate)
        for name, x, w in zip(("ddx", "ddA", "dB", "dC", "dinit"), got,
                              want):
            assert x.shape == w.shape, name
            np.testing.assert_allclose(
                x.numpy(), w, rtol=0, atol=BWD_RTOL * np.abs(w).max(),
                err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradients_hold_mamba2_decays(seed):
    """At mamba2-1.3b's decays (dA = -softplus(N(0, 1)) x (1 .. H), down to
    ~-30 a step) the A_log gradient, sum over (batch, step) of ddA dA per
    head, adds terms that mostly cancel, and so do the decay's row and
    column terms inside each chunk. Autograd of ``plain`` (the CPU's
    training path, one chunk of 256) must hold it within 1e-4 of the fp64
    gradient's largest |value|, and ``plain_backward`` (the kernel's math,
    chunks of 64) within 2e-5: both sum the decay terms in fp64, as the
    backward kernel does."""
    g = torch.Generator().manual_seed(seed)
    b, s, h, p, n = 2, 256, 32, 16, 32
    dx = torch.randn(b, s, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    dA = -dt * torch.arange(1, h + 1, dtype=torch.float32)
    B, C = (torch.randn(b, s, 1, n, generator=g) for _ in range(2))
    dy = torch.randn(b, s, h, p, generator=g)

    def a_log(ddA):
        return (ddA.double() * dA.double()).sum((0, 1))
    exact = a_log(ssd.plain_backward(dx.double(), dA.double(), B.double(),
                                     C.double(), None, dy.double())[1])
    scale = exact.abs().max()
    leaves = [t.clone().requires_grad_() for t in (dx, dA, B, C)]
    y, _ = ssd.plain(*leaves, chunk=ssd.model_chunk(s))
    autograd = a_log(torch.autograd.grad(y, leaves, dy)[1])
    explicit = a_log(ssd.plain_backward(dx, dA, B, C, None, dy)[1])
    assert (autograd - exact).abs().max() <= 1e-4 * scale
    assert (explicit - exact).abs().max() <= 2e-5 * scale


def test_plain_backward_keeps_input_dtype():
    """bf16 inputs: ddx, dB and dC in bf16 (fp32 sums rounded once), ddA
    and the state's gradient fp32; an fp64 run stays fp64."""
    dx, dA, B, C = torched(*inputs(11, 1, 70, 2, 8, 1, 8))
    dy = torch.randn(1, 70, 2, 8, generator=torch.Generator().manual_seed(0))
    got = ssd.plain_backward(dx.bfloat16(), dA, B.bfloat16(), C.bfloat16(),
                             None, dy.bfloat16())
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    f64 = ssd.plain_backward(dx.double(), dA.double(), B.double(),
                             C.double(), None, dy.double())
    assert all(t.dtype == torch.float64 for t in f64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (1, 96, 64, 64, 1, 128),    # mamba2-1.3b's heads at a served prefill
    (1, 272, 64, 64, 1, 128),   # a ragged last chunk
    (2, 40, 8, 16, 1, 16),      # reduced mamba2-1.3b
    (2, 128, 4, 32, 2, 16),     # G > 1
])
def test_kernel_matches_plain_on_card(cuda, dtype, b, s, h, p, g, n):
    """Kernel (its own chunk of 64) against the plain version (the JAX chunk
    rule), with and without an initial state. y and the fp32 state: 1e-4 +
    2^-17 max|plain|, since the plain version's running log-decay over up
    to 256 steps carries a few 1e-6 of relative error into each decay
    factor; bf16 y: that plus one bf16 rounding, 2^-7 |plain|."""
    gen = torch.Generator(cuda).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    dx, B, C = rn(b, s, h, p).to(dtype), rn(b, s, g, n).to(dtype), \
        rn(b, s, g, n).to(dtype)
    dA = -rn(b, s, h).abs() * 0.2
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for init in (None, rn(b, h, n, p)):
        y, st = ssd.ssd_scan(dx, dA, B, C, init)
        yp, stp = ssd.plain(dx, dA, B, C, init, chunk=ssd.model_chunk(s))
        for got, want, r in ((y, yp, rtol), (st, stp, 0.0)):
            want = want.float()
            torch.testing.assert_close(
                got.float(), want, rtol=r,
                atol=1e-4 + 2.0 ** -17 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("s", [272, 2048])
def test_kernel_matches_fp64_recurrence_on_card(cuda, s):
    """The kernel's fp32 y and state against the sequential recurrence in
    fp64 at mamba2-1.3b's heads: 1e-4 + 2^-19 max|f64|, the limit
    ``chip_smoke.py`` holds it to (the plain version, whose running
    log-decay spans up to 256 steps, is off by up to ~2^-18 max|y|)."""
    gen = torch.Generator(cuda).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    h, p, n = 64, 64, 128
    dx, B, C, init = rn(1, s, h, p), rn(1, s, 1, n), rn(1, s, 1, n), \
        rn(1, h, n, p)
    dA = -rn(1, s, h).abs() * 0.2
    for state in (None, init):
        got = ssd.ssd_scan(dx, dA, B, C, state)
        exact = ref.ssd_ref(dx.double(), dA.double(), B.double(), C.double(),
                            None if state is None else state.double())
        for g, e in zip(got, exact):
            torch.testing.assert_close(
                g.double(), e, rtol=0,
                atol=1e-4 + 2.0 ** -19 * e.abs().max().item())


def bwd_inputs(gen, b, s, heads, dtype, init, dstate):
    """Random inputs of the scan's backward on the card: the forward's
    inputs (``test_kernels.py``'s scales), y's gradient, and optional
    initial state and final-state gradient."""
    h, p, g, n = heads

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device)
    return (rn(b, s, h, p).to(dtype), -rn(b, s, h).abs() * 0.2,
            rn(b, s, g, n).to(dtype), rn(b, s, g, n).to(dtype),
            rn(b, h, n, p) if init else None, rn(b, s, h, p).to(dtype),
            rn(b, h, n, p) if dstate else None)


# (B, S, (H, P, G, N), with an initial state, with a final-state gradient):
# mamba2-1.3b's training shape and heads, a ragged S with both, reduced
# mamba2's heads, two groups, and hymba-1.5b's heads (N = 16)
BWD_SSD_CASES = [(8, 512, (64, 64, 1, 128), False, False),
                 (1, 272, (64, 64, 1, 128), True, True),
                 (2, 40, (8, 16, 1, 16), True, False),
                 (2, 128, (4, 32, 2, 16), False, True),
                 (1, 200, (50, 64, 1, 16), False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,init,dstate", BWD_SSD_CASES)
def test_backward_kernel_matches_plain_on_card(cuda, dtype, b, s, heads,
                                               init, dstate):
    """The backward kernel against ``plain_backward`` on the same inputs:
    each leaf within 1e-5 (fp32) of its largest |value|, plus one rounding
    of the input's type, 2^-7 |plain|, for ddx, dB and dC in bf16; two
    launches give the same bits (no atomics)."""
    args = bwd_inputs(torch.Generator(cuda).manual_seed(s), b, s, heads,
                      dtype, init, dstate)
    got = ssd.ssd_scan_backward(*args)
    want = ssd.plain_backward(*args)
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for name, x, w in zip(("ddx", "ddA", "dB", "dC", "dinit"), got, want):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        w = w.float()
        lim = 1e-5 * w.abs().max() + (rtol if name in ("ddx", "dB", "dC")
                                      else 0.0) * w.abs()
        assert bool(((x.float() - w).abs() <= lim).all()), name
    again = ssd.ssd_scan_backward(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_scan_gradient_through_kernels_on_card(cuda):
    """``ops.ssd_scan`` under grad on the card: one forward and one backward
    launch, the gradients equal to the CPU's autograd of the plain version
    within 1e-5 of each leaf's largest |value|."""
    from repro_torch.kernels import ops
    gen = torch.Generator(cuda).manual_seed(3)
    dx, dA, B, C, init, dy, _ = bwd_inputs(gen, 2, 96, (8, 16, 1, 16),
                                           torch.float32, True, False)
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (dx, dA, B, C, init)]
    y, _ = ops.ssd_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == counts["ssd_scan_bwd"] == 1
    cpu = [t.cpu().requires_grad_() for t in (dx, dA, B, C, init)]
    want = torch.autograd.grad(ops.ssd_scan(*cpu)[0], cpu, dy.cpu())
    for x, w in zip(grads, want):
        torch.testing.assert_close(x.cpu(), w, rtol=0,
                                   atol=1e-5 * w.abs().max().item())
