"""The port's dry-run against the JAX package's: the input shapes and
cells, the active parameter counts, each cell's input specs, the model
FLOPs, the roofline arithmetic, the kernel ops' fake implementations and
costs, and small cells traced over fake process groups against the
reference's compiled ones.

The reference's ``repro.launch.dryrun`` forces 512 host devices when it is
imported, so its cells compile in a process of their own
(``tests/torch_dryrun_reference.py``), which writes a JSON file; the port's
run here over fake groups of 1 and 4 ranks, on the CPU (the kernels' plain
versions: their matmuls compute the full Sq x Sk, as the reference's
chunked einsum does).

Tolerances, each with its reason:

* shapes, cells, parameter counts, specs, model FLOPs, argument bytes,
  the ring factors: equal;
* matmul FLOPs a device at (1, 1): within 2% of ``parse_hlo``'s dot FLOPs
  (both count every product of the step: forward, remat's recompute,
  backward); at (2, 2) within 2% as well: the port's local products
  (``sharding.contract``, ``ssm._sharded_core``) split as GSPMD's do but
  for the SSM's, 1.2% more a rank, and the MoE's, 0.1% more (the
  difference was measured, its op not traced further; the port's MoE runs
  split through the gather path, whose (E, C) slots are split as GSPMD
  splits them: the experts over model, the slots over data);
* the MoE cells under each ``moe_impl``: the path asked for runs; the
  shard_map path's trace equal to what it was before the gather path ran
  split (``SHARDMAP_TRACES``), the gather path's counts table and slots
  of the sizes its capacity gives.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as jrl  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import SUBQUADRATIC as JSUBQUADRATIC  # noqa: E402
from repro.configs import cells as jcells  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.analysis import recompute  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, SUBQUADRATIC,  # noqa: E402
                                 InputShape, cells, get_config,
                                 list_configs)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from torch_parity import time_limit  # noqa: E402
import torch_dryrun_reference as reference  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ALL_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture(autouse=True)
def limit():
    with time_limit(120):
        yield


# ---------------------------------------------------------------------------
# Shapes, cells, parameter counts, input specs, model FLOPs
# ---------------------------------------------------------------------------

def test_shapes_and_cells_equal_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in JSHAPES.items()}
    assert SUBQUADRATIC == JSUBQUADRATIC
    assert sorted(cells()) == sorted(jcells())
    assert len(list(cells())) == 40
    assert sorted(cells(include_skipped=False)) == \
        sorted(jcells(include_skipped=False))
    assert sorted(list_configs()) == sorted(JARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_count_equals_reference(arch):
    assert get_config(arch).active_param_count() == \
        jget_config(arch).active_param_count()
    assert get_config(arch).param_count() == jget_config(arch).param_count()


TORCH_DTYPE = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_batch_specs_equal_reference(arch, shape):
    got = registry.build(get_config(arch)).batch_specs(SHAPES[shape])
    want = jregistry.build(jget_config(arch)).batch_specs(JSHAPES[shape])
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == tuple(want[name].shape), name
        assert spec.dtype == TORCH_DTYPE[want[name].dtype.type], name
    assert dryrun.input_specs(arch, shape).keys() == got.keys()


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_model_flops_estimate_equals_reference(arch, shape):
    assert rl.model_flops_estimate(get_config(arch), SHAPES[shape]) == \
        jrl.model_flops_estimate(jget_config(arch), JSHAPES[shape])


# ---------------------------------------------------------------------------
# The roofline arithmetic, at the H100's constants
# ---------------------------------------------------------------------------

def test_roofline_terms():
    coll = rl.CollectiveStats(bytes_per_chip=50e9)
    r = rl.compute_roofline({"flops": 989e12, "bytes accessed": 3.35e12},
                            coll, chips=256, model_flops=989e12 * 256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(1.0)
    r = rl.compute_roofline({"flops": 1.0, "bytes accessed": 2 * 3.35e12},
                            coll, chips=4, model_flops=0.0,
                            flops_override=2 * 989e12)
    assert r.dominant == "compute" and r.step_time_s == pytest.approx(2.0)


def test_collective_bytes_by_the_reference_ring_factors():
    """The trace entries of the reference's HLO case (an all-reduce of
    bf16[128, 256] over 16 ranks 32 times, an all-gather to bf16[64, 512]
    once), then a reduce-scatter and an all-to-all, at the reference's
    factors (``_KIND_FACTOR``)."""
    entries = [
        {"kind": "all-reduce", "result_bytes": 128 * 256 * 2, "group": 16,
         "count": 32},
        {"kind": "all-gather", "result_bytes": 64 * 512 * 2, "group": 16,
         "count": 1},
        {"kind": "", "result_bytes": 0, "group": 0, "count": 9},
    ]
    st = rl.collective_stats(entries)
    ar_bytes = 128 * 256 * 2 * 2 * 15 / 16 * 32
    ag_bytes = 64 * 512 * 2 * 15 / 16
    assert st.counts == {"all-reduce": 32, "all-gather": 1}
    assert st.bytes_per_chip == pytest.approx(ar_bytes + ag_bytes)
    assert st.bytes_by_kind["all-reduce"] == pytest.approx(ar_bytes)
    for kind in rl._KIND_FACTOR:
        for g in (2, 16, 512):
            assert rl._KIND_FACTOR[kind](g) == jrl._KIND_FACTOR[kind](g)


def test_collectives_record_their_group_size():
    """A c10d all-reduce, a functional all-reduce and a functional
    all-gather over a 16-rank fake group are each recorded at group 16;
    a collective whose group no argument resolves raises."""
    import torch.distributed as dist
    counter = rl.RankCounter()
    with dryrun.fake_group(16), fake_mode():
        group = dist.group.WORLD.group_name
        x = torch.empty(128, 256, dtype=torch.bfloat16)
        with counter:
            dist.all_reduce(x)
            torch.ops._c10d_functional.wait_tensor(
                torch.ops._c10d_functional.all_reduce(x, "sum", group))
            torch.ops._c10d_functional.wait_tensor(
                torch.ops._c10d_functional.all_gather_into_tensor(
                    x, 16, group))
    got = {(e["op"], e["kind"], e["group"]) for e in counter.entries()
           if e["kind"]}
    assert got == {("c10d.allreduce_", "all-reduce", 16),
                   ("_c10d_functional.all_reduce", "all-reduce", 16),
                   ("_c10d_functional.all_gather_into_tensor", "all-gather",
                    16)}
    with pytest.raises(RuntimeError, match="no process group"):
        rl._group_size("_c10d_functional.all_reduce", ["sum", 3])


# ---------------------------------------------------------------------------
# The kernel ops: fake implementations, FLOPs, bytes
# ---------------------------------------------------------------------------

def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


FLASH_CASES = [  # (b, sq, sk, heads, causal, dtype, lse)
    (8, 512, 512, (14, 2, 64), True, torch.bfloat16, True),
    (1, 96, 96, (14, 2, 64), True, torch.float32, False),
    (4, 32, 4096, (16, 16, 64), False, torch.float32, False),
    (16, 384, 384, (4, 2, 32), True, torch.float32, True),
    # head_dim 128: codeqwen1.5-7b's training shape, deepseek-67b's 64/8
    # heads, llama4-scout's 40/8 (a group of 5) non-causal
    (8, 512, 512, (32, 32, 128), True, torch.bfloat16, True),
    (2, 129, 129, (64, 8, 128), True, torch.float32, True),
    (2, 73, 73, (40, 8, 128), False, torch.bfloat16, True),
]


@pytest.mark.parametrize("b,sq,sk,heads,causal,dtype,lse", FLASH_CASES)
def test_flash_ops_fake_outputs_and_costs(b, sq, sk, heads, causal, dtype,
                                          lse):
    """The forward's (o, log-sum-exp) and the backward's (dQ, dK, dV) as
    the kernels write them, on fake CUDA tensors; their FLOPs and bytes as
    ``chip_smoke.py``'s bounds count them (``time_flash``,
    ``time_flash_bwd``: 4 D and 10 D FLOPs per attended pair and query
    head)."""
    hq, hkv, d = heads
    fwd = torch.ops.repro_torch.flash_attention_fwd
    bwd = torch.ops.repro_torch.flash_attention_bwd
    with fake_mode():
        q, k, v = empty(b, sq, hq, d, dtype=dtype), \
            empty(b, sk, hkv, d, dtype=dtype), empty(b, sk, hkv, d,
                                                     dtype=dtype)
        out, l = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        assert (out.shape, out.dtype, out.is_cuda) == (q.shape, dtype, True)
        assert (l.shape, l.dtype) == ((b, hq, sq), torch.float32)
        if d in fa.BWD_HEAD_DIMS and sq == sk:
            grads = fa.flash_attention_backward(q, k, v, out, out, l,
                                                causal=causal)
            assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
            assert all(g.dtype == dtype for g in grads)
        args = (q, k, v, causal, 0, (sk - sq) if causal else 0, sk,
                d ** -0.5, lse)
        es = q.element_size()
        pairs = chip_smoke.attended_pairs(b, sq, sk, causal)
        assert rl_flops(fwd, *args) == 4 * d * hq * pairs
        assert _build.OP_BYTES[fwd](*args) == \
            b * (2 * sq * hq * d + 2 * sk * hkv * d) * es \
            + (4 * b * sq * hq if lse else 0)
        if sq == sk:
            bargs = (q, k, v, out, out, l, causal, 0, 0, sk, d ** -0.5)
            assert rl_flops(bwd, *bargs) == 10 * d * hq * pairs
            assert _build.OP_BYTES[bwd](*bargs) == \
                b * sq * (4 * hq + 4 * hkv) * d * es + 4 * b * hq * sq


@pytest.mark.parametrize("d", [8, 96])
def test_flash_backward_refuses_an_unsupported_head_dim(d):
    """A head_dim the kernels are not built for raises before any launch,
    on fake tensors as on the card."""
    assert fa.BWD_HEAD_DIMS == (16, 32, 64, 128)
    with fake_mode():
        q, k = empty(2, 16, 4, d), empty(2, 16, 2, d)
        lse = empty(2, 4, 16)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            fa.flash_attention_backward(q, k, k, q, q, lse)


def rl_flops(op, *args):
    from torch.utils.flop_counter import flop_registry
    return flop_registry[op](*args, out_val=None)


def test_attended_pairs_count_masks_and_offsets():
    """Causal work counts the rows' own prefixes (a q row at offset o sees
    o + i + 1 keys), the window its last keys, sk_valid the valid keys."""
    assert fa.attended_pairs(4, 4) == 10
    assert fa.attended_pairs(2, 6, q_offset=4) == 5 + 6
    assert fa.attended_pairs(4, 4, causal=False) == 16
    assert fa.attended_pairs(4, 8, causal=False, sk_valid=5) == 20
    assert fa.attended_pairs(6, 6, window=2) == 1 + 2 * 5
    for s in (1, 17, 128):
        assert fa.attended_pairs(s, s) == chip_smoke.attended_pairs(1, s, s,
                                                                    True)


def test_decode_op_fake_output_and_costs():
    """Decode's output, and its work: a fake cache_len counts every slot's
    whole cache (or window); real lengths count their valid rows
    (``time_decode``)."""
    op = torch.ops.repro_torch.decode_attention
    b, s, (hq, hkv, d) = 4, 160, (14, 2, 64)
    lens = [101, 75, 79, 83]
    with fake_mode():
        q, kc = empty(b, 1, hq, d), empty(b, s, hkv, d)
        fake_lens = torch.empty((b,), dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, kc, kc, fake_lens)
        assert (out.shape, out.dtype) == (q.shape, torch.float32)
        assert rl_flops(op, q, kc, kc, fake_lens, 0, 1.0) == 4 * d * hq * b * s
        assert rl_flops(op, q, kc, kc, fake_lens, 64, 1.0) == \
            4 * d * hq * b * 64
    real = torch.tensor(lens, dtype=torch.int32)
    n_valid = sum(lens)
    assert dec.attended(torch.empty(b, s, hkv, d, device="meta"), real,
                        0) == n_valid
    assert dec.attended(torch.empty(b, s, hkv, d, device="meta"), real,
                        64) == 4 * 64
    q, kc = torch.empty(b, 1, hq, d), torch.empty(b, s, hkv, d)
    assert rl_flops(op, q, kc, kc, real, 0, 1.0) == 4 * d * hq * n_valid
    assert _build.OP_BYTES[op](q, kc, kc, real, 0, 1.0) == \
        (2 * b * hq * d + 2 * n_valid * hkv * d) * 4 + 4 * b


def test_cosine_ops_fake_outputs_and_costs():
    rw, mx = torch.ops.repro_torch.rowwise_cosine, \
        torch.ops.repro_torch.cosine_matrix
    with fake_mode():
        a, anchor, b = empty(18891, 256), empty(256), empty(250, 256)
        got = ops.rowwise_cosine(a, anchor)
        assert (got.shape, got.dtype) == ((18891,), torch.float32)
        got = ops.cosine_matrix(b, empty(250, 256))
        assert (got.shape, got.dtype) == ((250, 250), torch.float32)
        assert rl_flops(rw, a, anchor) == 2 * 18891 * 256
        assert _build.OP_BYTES[rw](a, anchor) == (18891 * 256 + 256
                                                  + 18891) * 4
        assert rl_flops(mx, b, b) == 2 * 250 * 250 * 256
        assert _build.OP_BYTES[mx](b, b) == ((250 + 250) * 256
                                             + 250 * 250) * 4


@pytest.mark.parametrize("b,s,heads,dtype", [
    (1, 96, (64, 64, 128, 1), torch.float32),
    (8, 512, (64, 64, 128, 1), torch.bfloat16),
    (2, 2048, (50, 64, 16, 1), torch.bfloat16),
    (1, 272, (4, 32, 16, 2), torch.float32)])
def test_ssd_ops_fake_outputs_and_costs(b, s, heads, dtype):
    """The scan's (y, final state) and its backward's five gradients, and
    their work as ``time_ssd`` and ``time_ssd_bwd`` count it
    (``chip_smoke.ssd_flops``, ``ssd_bwd_flops``)."""
    h, p, n, g = heads
    fwd, bwd = torch.ops.repro_torch.ssd_scan_fwd, \
        torch.ops.repro_torch.ssd_scan_bwd
    with fake_mode():
        dx, dA = empty(b, s, h, p, dtype=dtype), empty(b, s, h)
        B, C = empty(b, s, g, n, dtype=dtype), empty(b, s, g, n, dtype=dtype)
        y, fin = ops.ssd_scan(dx, dA, B, C)
        assert (y.shape, y.dtype) == (dx.shape, dtype)
        assert (fin.shape, fin.dtype) == ((b, h, n, p), torch.float32)
        grads = ssd.ssd_scan_backward(dx, dA, B, C, None, y)
        assert [t.shape for t in grads] == [dx.shape, dA.shape, B.shape,
                                            C.shape, (b, h, n, p)]
        assert [t.dtype for t in grads] == [dtype, torch.float32, dtype,
                                            dtype, torch.float32]
        es = dx.element_size()
        assert rl_flops(fwd, dx, dA, B, C, None) == \
            b * chip_smoke.ssd_flops(s, heads)
        assert _build.OP_BYTES[fwd](dx, dA, B, C, None) == \
            b * ((2 * s * h * p + 2 * s * g * n) * es + (s * h + h * n * p)
                 * 4)
        assert rl_flops(bwd, dx, dA, B, C, None, y, None) == \
            b * chip_smoke.ssd_bwd_flops(s, heads)
        assert _build.OP_BYTES[bwd](dx, dA, B, C, None, y, None) == \
            b * s * ((3 * h * p + 4 * g * n) * es + 2 * h * 4)


OPS = ("flash_attention_fwd", "flash_attention_bwd", "decode_attention",
       "rowwise_cosine", "cosine_matrix", "ssd_scan_fwd", "ssd_scan_bwd",
       "adamw_sumsq", "adamw_update")


def test_every_launch_is_an_op_that_refuses_the_cpu():
    """The nine launches are ``repro_torch::`` ops with a CUDA
    implementation only: a CPU tensor that reaches one raises, nothing
    stands in for the kernel."""
    a = torch.zeros(4, 16)
    for name in OPS:
        assert hasattr(torch.ops.repro_torch, name), name
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.cosine_matrix(a, a)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.rowwise_cosine(a, a)
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.adamw_sumsq([a])


def test_an_op_without_a_fake_implementation_raises_on_fake_tensors():
    """The mechanism the dry-run relies on: an op registered as the
    kernels are, but without ``register_fake``, raises on fake tensors
    instead of running anything."""
    lib = torch.library.Library("repro_torch_test", "FRAGMENT")
    lib.define("nofake(Tensor x) -> Tensor")
    lib.impl("nofake", lambda x: x.clone(), "CUDA")
    with fake_mode():
        x = empty(4)
        with pytest.raises(Exception, match="fake|Meta|meta"):
            torch.ops.repro_torch_test.nofake(x)


def test_kernel_ops_skip_the_dispatcher_only_for_real_tensors_outside_modes():
    """``_build.direct``: a real tensor with no dispatch mode active goes
    straight to the kernel (serving); a fake tensor, or any tensor under a
    mode (a trace's counter), goes through the op."""
    x = torch.zeros(2)
    assert _build.direct(x)
    with fake_mode():
        assert not _build.direct(empty(2))
    with rl.RankCounter():
        assert not _build.direct(x)
    assert _build.direct(x)


def test_a_trace_counts_launches_in_its_own_record():
    """Fake launches land in the trace's record; ``ops.launch_counts()``
    counts real launches only."""
    ops.reset_launch_counts()
    counter = rl.RankCounter()
    with fake_mode():
        q, k = empty(2, 16, 4, 16), empty(2, 16, 2, 16)
        with counter:
            fa.flash_attention(q, k, k)
            fa.flash_attention(q, k, k)
    assert counter.launches == {"flash_attention_fwd": 2}
    assert counter.flops == 2 * 4 * 16 * 4 * 2 * fa.attended_pairs(16, 16)
    assert all(v == 0 for v in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# Small cells against the reference's compiled ones
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_reference") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tests", "torch_dryrun_reference.py"),
                    str(out)], env=env, check=True, timeout=300)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port():
    """The port's records of the reference's cases, traced on the CPU over
    fake groups of 1 and 4 ranks."""
    recs = {}
    for arch, kind, seq, batch in reference.CASES:
        for mesh in reference.MESHES:
            recs[reference.case_key(arch, kind, mesh)] = dryrun.run_cell(
                arch, reference.shape_of(kind, seq, batch), multi_pod=False,
                device="cpu", reduced=True, mesh_shape=mesh)
    return recs


CASE_KEYS = [reference.case_key(a, k, m) for a, k, _, _ in reference.CASES
             for m in reference.MESHES]


@pytest.mark.parametrize("key", CASE_KEYS)
def test_argument_bytes_equal_reference(ref, port, key):
    """The local shard bytes of the state (or bf16 params), the cache and
    the batch: the reference's ``memory_analysis()`` to the byte."""
    rec = port[key]
    assert rec["ok"], rec.get("error")
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        ref[key]["argument_size_in_bytes"]
    assert rec["bytes_per_device"] >= \
        rec["memory_analysis"]["argument_size_in_bytes"]


@pytest.mark.parametrize("key", CASE_KEYS)
def test_matmul_flops_within_2pct_of_reference(ref, port, key):
    got, want = port[key]["dot_flops_per_device"], ref[key]["dot_flops"]
    assert abs(got - want) <= 0.02 * want, (got, want)
    if key.endswith("1x1"):
        assert not port[key]["collectives"]["counts"]


def test_split_cells_run_collectives_and_cost_less_a_rank(port):
    """At (2, 2) a rank holds a quarter of the state and moves bytes over
    the links; at (1, 1) none."""
    for arch, kind, _, _ in reference.CASES:
        one = port[reference.case_key(arch, kind, (1, 1))]
        four = port[reference.case_key(arch, kind, (2, 2))]
        assert four["collectives"]["bytes_per_chip"] > 0
        assert four["memory_analysis"]["argument_size_in_bytes"] < \
            one["memory_analysis"]["argument_size_in_bytes"]
        assert four["roofline"]["dominant"] in ("compute", "memory",
                                                "collective")


# ---------------------------------------------------------------------------
# The MoE cells under each moe_impl
# ---------------------------------------------------------------------------

MOE_KINDS = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}
MOE_BATCH, MOE_SEQ, MOE_MESH = 4, 32, (2, 2)
# reduced granite's cells at (2, 2) traced through the shard_map path
# before the gather path ran split (then every split layer took it)
SHARDMAP_TRACES = {
    "train": {"dot_flops_per_device": 115605504.0, "collectives": {
        "bytes_per_chip": 1170196.0,
        "counts": {"all-gather": 55, "all-reduce": 54, "reduce-scatter": 17},
        "bytes_by_kind": {"all-gather": 471808.0, "all-reduce": 635796.0,
                          "reduce-scatter": 62592.0}},
        "memory_analysis": {"argument_size_in_bytes": 470660,
                            "output_size_in_bytes": 470416,
                            "temp_size_in_bytes": 626552,
                            "alias_size_in_bytes": 0},
        "cost_analysis": {"flops": 115605504.0,
                          "bytes accessed": 32692880.0}},
    "prefill": {"dot_flops_per_device": 27459584.0, "collectives": {
        "bytes_per_chip": 127488.0,
        "counts": {"all-gather": 19, "all-reduce": 2},
        "bytes_by_kind": {"all-gather": 111104.0, "all-reduce": 16384.0}},
        "memory_analysis": {"argument_size_in_bytes": 157056,
                            "output_size_in_bytes": 12292,
                            "temp_size_in_bytes": 325632,
                            "alias_size_in_bytes": 0},
        "cost_analysis": {"flops": 27459584.0,
                          "bytes accessed": 5385712.0}},
    "decode": {"dot_flops_per_device": 919552.0, "collectives": {
        "bytes_per_chip": 8448.0,
        "counts": {"all-gather": 2, "all-reduce": 21},
        "bytes_by_kind": {"all-gather": 512.0, "all-reduce": 7936.0}},
        "memory_analysis": {"argument_size_in_bytes": 165004,
                            "output_size_in_bytes": 10244,
                            "temp_size_in_bytes": 9124,
                            "alias_size_in_bytes": 8192},
        "cost_analysis": {"flops": 919552.0, "bytes accessed": 431284.0}},
}


@pytest.fixture(scope="module")
def moe_traces(tmp_path_factory):
    """Reduced granite's train, prefill and decode cells at (2, 2) under
    each ``moe_impl``: (record, per-op trace)."""
    out = {}
    tmp = tmp_path_factory.mktemp("moe_traces")
    for impl in ("gather", "shardmap"):
        for kind, name in MOE_KINDS.items():
            path = str(tmp / f"{impl}-{kind}.json")
            rec = dryrun.run_cell(
                "granite-moe-1b-a400m",
                InputShape(name, MOE_SEQ, MOE_BATCH, kind),
                multi_pod=False, device="cpu", reduced=True,
                mesh_shape=MOE_MESH, moe_impl=impl, save_trace=path)
            with open(path) as f:
                out[impl, kind] = (rec, json.load(f))
    return out


def c10d(entries, op, result_bytes):
    """How many times the trace ran ``op`` with that result's bytes over a
    group of 2."""
    return sum(e["count"] for e in entries if e["op"] == op
               and e["result_bytes"] == result_bytes and e["group"] == 2)


@pytest.mark.parametrize("kind", MOE_KINDS)
def test_moe_cells_run_the_moe_impl_asked_for(moe_traces, kind):
    """``moe_impl_ran`` is what was asked, in every kind of cell. The
    shard_map trace is what it was. The gather trace holds, per MoE layer
    and forward (training runs each twice: remat's recompute), the
    all-gather of the counts table (int32, B x n_seq x E, n_seq the
    sequence's split: 2 under the ZeRO-3 prefill rules), the reduce-scatter
    of the (E / 2, C, d) bf16 slot buffer to its (E / 2, C / 2, d) half
    (C the global capacity of B x S tokens) and the experts' products over
    that half, with two of its blocks' all-gathered back; the record's
    ``moe_slot_transport`` holds those collectives' link bytes, a part of
    the cell's."""
    from repro_torch.models import ffn
    cfg = dryrun.config_of("granite-moe-1b-a400m", reduced=True)
    moe, d, layers = cfg.moe, cfg.d_model, cfg.n_layers
    for impl in ("gather", "shardmap"):
        rec, _ = moe_traces[impl, kind]
        assert rec["ok"], rec.get("error")
        assert rec["moe_impl"] == rec["moe_impl_ran"] == impl
    rec, _ = moe_traces["shardmap", kind]
    assert {k: rec[k] for k in SHARDMAP_TRACES[kind]} == \
        SHARDMAP_TRACES[kind]
    assert "moe_slot_transport" not in rec
    rec, entries = moe_traces["gather", kind]
    transport = rec["moe_slot_transport"]
    assert set(transport["bytes_by_kind"]) == {"all-gather",
                                               "reduce-scatter"}
    assert 0 < transport["bytes_per_chip"] < \
        rec["collectives"]["bytes_per_chip"]
    seq = 1 if kind == "decode" else MOE_SEQ
    n_seq = 2 if kind == "prefill" else 1
    forwards = layers * (2 if kind == "train" else 1)
    table = MOE_BATCH * n_seq * moe.num_experts * 4
    assert c10d(entries, "c10d.allgather_", table) == forwards
    cap = ffn.capacity(MOE_BATCH * seq, moe)
    half = moe.num_experts // 2 * (cap // 2) * d * 2
    assert c10d(entries, "c10d.reduce_scatter_", half) >= forwards
    assert c10d(entries, "c10d.allgather_", 2 * half) >= forwards
    products = [e for e in entries if e["op"] == "aten.bmm"
                and e["flops"] == 2 * (moe.num_experts // 2) * (cap // 2)
                * d * cfg.d_ff]
    assert sum(e["count"] for e in products) >= 3 * forwards


# ---------------------------------------------------------------------------
# The CLI, the records, recompute
# ---------------------------------------------------------------------------

REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "moe_impl",
                  "microbatches", "kv_int8", "ok", "memory_analysis",
                  "bytes_per_device", "cost_analysis", "collectives",
                  "dot_flops_per_device", "roofline", "total_s"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops", "flops_per_device", "useful_flops_ratio",
                 "roofline_fraction", "step_time_s"}


def test_cli_writes_the_reference_records(tmp_path):
    """``main`` on one cell of the single-pod mesh (256 fake ranks), the
    config reduced to a CPU size (``--reduced``), and on long_500k of a
    full-attention arch: the reference's record keys (``trace_s`` for
    its ``lower_s`` and ``compile_s``) and its skip record;
    ``--save-trace`` writes the per-op trace that ``recompute`` reads back
    to the same terms."""
    out = tmp_path / "records"
    for shape in ("decode_32k", "long_500k"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "qwen2-0.5b", "--shape", shape, "--mesh",
                         "single", "--out", str(out), "--device", "cpu",
                         "--reduced", "--save-trace"])
        assert e.value.code == 0
    rec = json.loads((out / "qwen2-0.5b__decode_32k__single.json")
                     .read_text())
    assert rec["ok"] and rec["chips"] == 256 and rec["mesh"] == "single"
    assert rec["reduced"]
    assert REFERENCE_KEYS | {"trace_s"} <= set(rec)
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["memory_analysis"]) >= {"argument_size_in_bytes",
                                           "output_size_in_bytes",
                                           "temp_size_in_bytes"}
    skip = json.loads((out / "qwen2-0.5b__long_500k__single.json")
                      .read_text())
    assert skip["ok"] and skip["skipped"]
    assert skip["skip_reason"].startswith("full-attention arch")
    before = rec["roofline"]
    assert recompute.recompute_dir(str(out)) == 1
    after = json.loads((out / "qwen2-0.5b__decode_32k__single.json")
                       .read_text())["roofline"]
    assert after == pytest.approx(before)


def test_a_failed_cell_is_recorded_and_the_sweep_exits_1(tmp_path,
                                                         monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no such cell")
    monkeypatch.setattr(dryrun, "trace_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path),
                     "--device", "cpu", "--reduced"])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json")
                     .read_text())
    assert not rec["ok"] and "no such cell" in rec["error"]
    assert "Traceback" in rec["traceback"]


def test_dryrun_entry_points_default_to_cuda():
    import inspect
    for fn in (dryrun.build_cell, dryrun.trace_cell, dryrun.run_cell):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert np.isclose(rl.PEAK_FLOPS, 989e12) and rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 50e9
