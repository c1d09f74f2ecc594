"""Roofline terms of one rank's step, from a trace of the ops it runs (the
port of ``repro.analysis.roofline``).

The reference reads a compiled HLO module (``parse_hlo``); torch compiles
none, so the port counts the ops one rank runs eagerly: ``RankCounter``, a
``TorchDispatchMode`` under the DTensor layer, sees each rank-local op
(matmuls, the kernel ops of ``kernels``, elementwise ops, the functional
collectives DTensor inserts, the c10d collectives of the MoE on a mesh) on
local shapes, over real or fake tensors, and records per op:

* FLOPs, from torch's flop counter's formulas
  (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions, and
  the kernel ops' own, ``kernels._build.register_costs``);
* bytes read and written: every input and output tensor of a non-view op
  once (a kernel op: its own formula, ``kernels._build.OP_BYTES``). Eager
  and unfused, so this is more than XLA's fused "bytes accessed";
* each collective's kind, result bytes and group size, whose link bytes a
  chip are the reference's ring estimates (``_KIND_FACTOR``):
      all-gather          (g-1)/g * result_bytes
      all-reduce        2*(g-1)/g * result_bytes
      reduce-scatter      (g-1)   * result_bytes   (input is g * result)
      all-to-all          (g-1)/g * result_bytes
      collective-permute            result_bytes
* kernel launches by name;
* the bytes of the tensors the step allocates that are alive at once, at
  their peak (each output's storage counted once, from its op until it is
  freed; the arguments' storages not at all).

The ops DTensor runs on global shapes to infer its outputs' metadata are
not a rank's work and are left out. One rank's trace stands for the
busiest one: the caller picks the rank (a causal kernel's work depends on
its shard's offset, and the last one does the most).

Three roofline terms (seconds), per device:
    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = link_bytes_per_device / LINK_BW

The constants are one NVIDIA H100 80GB HBM3's (SXM, power limit 700.00 W
as ``nvidia-smi --query-gpu=name,power.limit`` gives it): 989 TFLOP/s of
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and 50 GB/s of link a
GPU: one 400 Gb/s InfiniBand port, since every 16-rank axis of the
production meshes spans two 8-GPU NVLink nodes. The reference's two
corrections for its CPU backend's fp32 carriers (``MEM_DTYPE_FACTOR`` and
the bf16 override of collective bytes) do not apply: fake and real tensors
keep their dtypes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 50e9               # bytes/s a GPU

_KIND_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

# the collective ops a rank's trace meets, by kind: the functional ones
# DTensor inserts, and the c10d ones that ``distributed.sharding``'s
# ``all_reduce``, ``all_gather`` and ``reduce_scatter`` run
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
}

# ops that move no bytes: views, metadata, waits, allocations
_NO_BYTES = {
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.t",
    "aten.transpose", "aten.permute", "aten.expand", "aten.select",
    "aten.slice", "aten.as_strided", "aten.detach", "aten.alias",
    "aten.unsqueeze", "aten.squeeze", "aten.split", "aten.split_with_sizes",
    "aten.unbind", "aten.chunk", "aten.narrow", "aten.diagonal",
    "aten.view_as_real", "aten.view_as_complex", "aten.unfold",
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.lift_fresh", "aten._to_copy_meta",
    "prim.device", "prim.layout", "aten.sym_size", "aten.sym_stride",
    "aten.sym_numel", "aten.is_same_size", "aten._local_scalar_dense",
    "_c10d_functional.wait_tensor", "aten.set_", "aten.resize_",
}


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(name: str, args) -> int:
    """The size of the process group a collective runs over: its group's
    name (a functional collective's) or the group itself (a c10d one's).
    Raises where no argument resolves to a group: a guessed size would give
    wrong link bytes."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, torch.ScriptObject) and \
                a._type().name() == "ProcessGroup":
            return dist.ProcessGroup.unbox(a).size()
    raise RuntimeError(f"{name}: no process group among its arguments")


@dataclasses.dataclass
class CollectiveStats:
    bytes_per_chip: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)


def collective_stats(entries) -> CollectiveStats:
    """Link bytes a chip of trace entries ({"kind", "result_bytes",
    "group", "count"}) by the ring estimates."""
    coll = CollectiveStats()
    for e in entries:
        if not e.get("kind"):
            continue
        kind, n = e["kind"], e.get("count", 1)
        link = e["result_bytes"] * _KIND_FACTOR[kind](e["group"]) * n
        coll.bytes_per_chip += link
        coll.counts[kind] = coll.counts.get(kind, 0) + n
        coll.bytes_by_kind[kind] = coll.bytes_by_kind.get(kind, 0.0) + link
    return coll


class RankCounter(TorchDispatchMode):
    """Counts one rank's ops while it is entered (above). ``entries()``:
    the trace, identical ops merged with a count; ``flops``, ``bytes``,
    ``launches`` ({kernel: n}) and ``collectives()`` sum it."""

    def __init__(self):
        super().__init__()
        self._ops = collections.Counter()
        self._skip = 0
        self._largest = {}
        self._storages = {}
        self.live = self.peak = 0

    def track_external(self, tree) -> None:
        """Storages that exist before the step (its arguments): their views
        and in-place updates allocate nothing."""
        for t in _tensors(tree):
            self._storages.setdefault(id(t.untyped_storage()), 0)

    def _track(self, out) -> None:
        import weakref
        for t in _tensors(out):
            if t.device.type == "meta":  # shapes only (a cache's template)
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    @contextlib.contextmanager
    def _propagation_skipped(self):
        """While entered, DTensor's metadata propagation (an op run on
        global shapes) is not counted."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def wrapped(prop, *args, **kwargs):
            self._skip += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._skip -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._propagation_skipped())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # let DTensor run its local ops
        out = func(*args, **kwargs)
        if not self._skip:
            self._record(func, args, kwargs, out)
            self._track(out)
        return out

    def _record(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels import _build
        packet = func._overloadpacket
        name = str(packet)
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        kind, group, result = "", 0, 0
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            group = _group_size(name, list(args) + list(kwargs.values()))
            result = _nbytes(out) if name.startswith("_c10d_functional") \
                else _nbytes(args[0])
            nbytes = 0
        elif packet in _build.OP_BYTES:
            nbytes = int(_build.OP_BYTES[packet](*args, **kwargs))
        elif name in _NO_BYTES:
            nbytes = 0
        else:
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        self._ops[(name, flops, nbytes, kind, result, group)] += 1
        for t in _tensors(out):
            key = (name, tuple(t.shape), str(t.dtype))
            self._largest[key] = t.numel() * t.element_size()
        if len(self._largest) > 64:
            top = sorted(self._largest.items(), key=lambda kv: -kv[1])[:16]
            self._largest = dict(top)

    def entries(self):
        return [{"op": name, "flops": f, "bytes": b, "kind": k,
                 "result_bytes": r, "group": g, "count": n}
                for (name, f, b, k, r, g), n in sorted(self._ops.items())]

    def largest(self, n=8):
        """The ``n`` largest outputs by bytes: [op, shape, dtype, bytes]."""
        top = sorted(self._largest.items(), key=lambda kv: -kv[1])[:n]
        return [[name, list(shape), dt, b] for (name, shape, dt), b in top]

    def by_op(self, n=10):
        """The ``n`` ops moving the most bytes: {op: [bytes, flops]}."""
        acc = collections.defaultdict(lambda: [0, 0])
        for (name, f, b, *_), k in self._ops.items():
            acc[name][0] += b * k
            acc[name][1] += f * k
        return dict(sorted(acc.items(), key=lambda kv: -kv[1][0])[:n])

    @property
    def flops(self) -> int:
        return sum(f * n for (_, f, *_), n in self._ops.items())

    @property
    def bytes(self) -> int:
        return sum(b * n for (_, _, b, *_), n in self._ops.items())

    @property
    def launches(self) -> dict:
        out = collections.Counter()
        for (name, *_), n in self._ops.items():
            if name.startswith("repro_torch."):
                out[name.split(".", 1)[1]] += n
        return dict(out)

    def collectives(self) -> CollectiveStats:
        return collective_stats(self.entries())


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    link_bytes_per_device: float
    chips: int
    model_flops: float           # global useful flops (6ND / 2ND)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline-limited step:
        (MODEL_FLOPS / chips / peak) / max(term)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.step_time_s if self.step_time_s else 0.0


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D train, 2*N_active*D forward-only."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch  # decode: 1 token / sequence


def compute_roofline(cost: dict, coll: CollectiveStats, chips: int,
                     model_flops: float,
                     flops_override: float = 0.0) -> Roofline:
    """cost: {"flops", "bytes accessed"} of one rank; ``flops_override``
    raises the FLOPs to at least that (the reference's dot parser)."""
    flops = max(float(cost.get("flops", 0.0)), float(flops_override))
    byts = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll.bytes_per_chip / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=byts,
        link_bytes_per_device=coll.bytes_per_chip,
        chips=chips,
        model_flops=model_flops,
    )
