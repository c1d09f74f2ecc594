"""Multi-pod dry-run: trace one rank of every (arch x input-shape) cell on
the production meshes and record its memory, FLOPs, bytes and collectives
(the port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out artifacts/dryrun_torch

A fake process group (``torch.testing._internal.distributed.fake_pg``) of
256 or 512 ranks holds the mesh (``launch.mesh.make_production_mesh``),
which is built first; then, under ``FakeTensorMode``, the cell's state (or
bf16 params), cache and batch are made at full size as DTensors placed by
the sharding rules, and one step (train, prefill or decode) runs through
the port's own code inside ``sharding.activation_sharding``: the layers on
each rank's blocks, the kernels as ``torch.library`` ops on their fake
implementations (on the card, ``--device cuda``, the default; ``--device
cpu`` traces the kernels' plain versions instead). Nothing is allocated
and nothing runs on a device. This process is the mesh's last rank, the
busiest one (``analysis.roofline``).

Each record keeps the reference's keys; ``trace_s`` replaces ``lower_s``
and ``compile_s``. A MoE's ``moe_impl_ran`` says which path ran, which is
the one ``--moe-impl`` asks for in every kind of cell: ``gather`` (the
default) runs the gather path split over the ranks
(``ffn.moe_forward_gather_split``: one global capacity, the reference's
function; a one-rank train step computes on the local tensors, so there
the unsplit one), ``shardmap`` the shard_map path, in training as the
reference's and, beyond it, in the prefill and decode cells (the
reference's serve the gather path alone). ``moe_slot_transport`` holds the
split gather path's own all-gathers and reduce-scatters (its counts
table, slots and products; a part of ``collectives``): whole (E / ep, C,
d) buffers, of which a rank fills about 1 / n, so this link term is the
port's transport and not the reference's cost (GSPMD moves the rows by
all-to-alls). ``memory_analysis`` holds the local shard bytes of the
state or params, the cache and the batch (``argument_size_in_bytes``), of
the outputs (``output_size_in_bytes``; those written in place into an
argument, a decode's cache, are ``alias_size_in_bytes``), and the peak of
the tensors the step allocates alive at once, less the outputs it
allocates (``temp_size_in_bytes``, ``analysis.roofline.RankCounter``;
torch's ``MemTracker`` would also count the global-shape tensors DTensor's
sharding propagation makes). ``--save-trace`` writes each cell's per-op
trace beside its record (``analysis.recompute`` reads it). A cell that
fails is recorded with its error and traceback and the sweep goes on; the
exit code is 1 if any failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCH_IDS, SHAPES, SUBQUADRATIC, get_config
from repro_torch.configs import reduced as reduce_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_loop

SKIP_REASON = ("full-attention arch; long_500k requires sub-quadratic "
               "context (see DESIGN.md)")


@contextlib.contextmanager
def fake_group(world: int, rank: int = -1):
    """A fake process group of ``world`` ranks, this process rank ``rank``
    (the last by default), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(),
                            rank=rank % world, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _planning_unfaked():
    """DTensor plans its shardings and redistributions with small real
    tensors (the shard offsets), which the fake mode would make fake and
    data-dependent: while entered, that planning runs with the fake mode
    unset (the metadata it infers on fake tensors still uses one)."""
    import torch.distributed.tensor._redistribute as redistribute
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    targets = [(ShardingPropagator, "propagate_op_sharding_non_cached"),
               (redistribute, "_gen_transform_infos_non_cached"),
               (_StridedShard, "local_shard_size_and_offset")]
    originals = [getattr(obj, name) for obj, name in targets]

    def unfaked(fn):
        def call(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return call
    for (obj, name), fn in zip(targets, originals):
        setattr(obj, name, unfaked(fn))
    try:
        yield
    finally:
        for (obj, name), fn in zip(targets, originals):
            setattr(obj, name, fn)


def config_of(arch: str, reduced: bool = False):
    cfg = get_config(arch)
    return reduce_config(cfg) if reduced else cfg


def input_specs(arch: str, shape_name: str):
    """Meta tensors standing for every model input of this cell."""
    return registry.build(get_config(arch)).batch_specs(SHAPES[shape_name])


def shardings_like(tree, axes, rules, mesh):
    """Shardings for a tree and its axes tree: leaves by their logical
    axes, a leaf without axes replicated."""
    return shd.sharding_for_tree(tree, axes, rules, mesh)


def _empty_like(tree, device):
    """Tensors shaped as a tree's (meta) leaves on ``device``: made inside
    ``FakeTensorMode``, they hold no memory."""
    return shd.map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), tree)


def build_cell(cfg, shape, mesh, *, moe_impl="gather", microbatches=1,
               kv_int8=False, device="cuda"):
    """(fn, args, rules) of one cell: ``fn(*args)`` runs its step on the
    placed arguments. Call inside ``FakeTensorMode`` (or on real tensors
    at a small size)."""
    bundle = registry.build(cfg)
    mode = {"train": "train", "prefill": "prefill",
            "decode": "serve"}[shape.kind]
    rules = shd.make_rules(cfg, mesh, mode)
    specs = bundle.batch_specs(shape)
    batch = shd.place(_empty_like(specs, device),
                      shd.batch_sharding(specs, rules, mesh))

    moe_ctx, moe_kw = None, {}
    if cfg.moe is not None and moe_impl == "shardmap":
        moe_ctx = {"impl": "shardmap", "mesh": mesh,
                   "dp_axes": shd.dp_axes(mesh)}
        moe_kw = {"moe_ctx": moe_ctx}
    if shape.kind == "train":
        step = train_loop.make_train_step(
            bundle, opt_mod.AdamWConfig(), dtype=torch.bfloat16, remat=True,
            moe_ctx=moe_ctx, microbatches=microbatches)
        state = _empty_like(train_loop.init_train_state(bundle,
                                                        device="meta"),
                            device)
        axes = train_loop.state_axes(bundle.param_axes())
        state = shd.place(state, shardings_like(state, axes, rules, mesh))
        return step, (state, batch), rules

    params = _empty_like(bundle.init(device="meta", dtype=torch.bfloat16),
                         device)
    params = shd.place(params, shardings_like(params, bundle.param_axes(),
                                              rules, mesh))
    if shape.kind == "prefill":
        def prefill(params, batch):
            return bundle.prefill(params, batch, max_len=None,
                                  dtype=torch.bfloat16, **moe_kw)
        return prefill, (params, batch), rules

    kv = {"kv_dtype": torch.int8} if kv_int8 else {}
    cache = _empty_like(bundle.init_cache(shape.global_batch, shape.seq_len,
                                          dtype=torch.bfloat16,
                                          device="meta", **kv), device)
    cache = shd.place(cache, shardings_like(
        cache, bundle.cache_axes(shape.global_batch, shape.seq_len, **kv),
        rules, mesh))

    def decode(params, cache, token):
        return bundle.decode_step(params, cache, token, dtype=torch.bfloat16,
                                  **moe_kw)
    return decode, (params, cache, batch["token"]), rules


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def trace_cell(cfg, shape, mesh, *, moe_impl="gather", microbatches=1,
               kv_int8=False, device="cuda"):
    """Trace one rank's step of a cell over fake tensors on ``mesh``.
    Returns (memory_analysis, the rank's ``RankCounter``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._collective_utils import MeshTopoInfo
    # DTensor's redistribution costs read the mesh's topology from real
    # tensors (cached per mesh): built here, before the fake mode
    MeshTopoInfo.build_from_mesh(mesh)
    with _planning_unfaked(), FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, rules = build_cell(cfg, shape, mesh, moe_impl=moe_impl,
                                     microbatches=microbatches,
                                     kv_int8=kv_int8, device=device)
        arg_b = local_bytes(args)
        arg_locals = _locals(args)
        counter = rl.RankCounter()
        counter.track_external(arg_locals)
        with shd.activation_sharding(mesh, rules), counter:
            out = fn(*args)
        out_b = local_bytes(out)
        # outputs written in place into an argument (a decode's cache)
        arg_ids = {id(t.untyped_storage()) for t in arg_locals}
        alias_b = local_bytes([t for t in _locals(out)
                               if id(t.untyped_storage()) in arg_ids])
    ma = {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
          "temp_size_in_bytes": max(0, counter.peak - (out_b - alias_b)),
          "alias_size_in_bytes": alias_b}
    return ma, counter


def _locals(tree):
    """This rank's local tensors of a tree's tensors and DTensors."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


# the c10d all-gathers and reduce-scatters of ``sharding.all_gather`` and
# ``reduce_scatter``, which the split gather MoE alone runs (its counts
# table, its slots and their products)
MOE_TRANSPORT_OPS = ("c10d.allgather_", "c10d.reduce_scatter_")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             moe_impl="gather", microbatches=1, save_trace=None,
             kv_int8=False, device="cuda", reduced=False, mesh_shape=None):
    """One cell's record. ``reduced``: the arch's reduced config;
    ``mesh_shape`` ((data, model) or (pod, data, model)) replaces the
    production mesh (the smoke's cross-check, tests)."""
    cfg = config_of(arch, reduced)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    name = shape.name
    chips = 512 if multi_pod else 256
    if mesh_shape is not None:
        chips = int(torch.tensor(mesh_shape).prod())
    rec = {"arch": arch, "shape": name,
           "mesh": "multi" if multi_pod else "single", "chips": chips,
           "moe_impl": moe_impl, "microbatches": microbatches,
           "kv_int8": kv_int8, "reduced": reduced, "ok": False}
    if cfg.moe is not None:
        # the path asked for runs in every kind of cell, split or not
        rec["moe_impl_ran"] = moe_impl
    if name == "long_500k" and arch not in SUBQUADRATIC:
        rec.update(ok=True, skipped=True, skip_reason=SKIP_REASON)
        return rec
    t0 = time.time()
    try:
        with fake_group(chips):
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device=device)
            else:
                from torch.distributed.device_mesh import DeviceMesh
                names = (("pod", "data", "model") if len(mesh_shape) == 3
                         else ("data", "model"))
                mesh = DeviceMesh(device, torch.arange(chips).reshape(
                    tuple(mesh_shape)), mesh_dim_names=names)
            ma, counter = trace_cell(cfg, shape, mesh, moe_impl=moe_impl,
                                     microbatches=microbatches,
                                     kv_int8=kv_int8, device=device)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["memory_analysis"] = ma
        rec["bytes_per_device"] = int(ma["argument_size_in_bytes"]
                                      + ma["temp_size_in_bytes"]
                                      + ma["output_size_in_bytes"]
                                      - ma["alias_size_in_bytes"])
        entries = counter.entries()
        if save_trace:
            with open(save_trace, "w") as f:
                json.dump(entries, f)
        rec.update(analyse(cfg, shape, chips, entries))
        transport = rl.collective_stats([e for e in entries
                                         if e["op"] in MOE_TRANSPORT_OPS])
        if transport.counts:
            rec["moe_slot_transport"] = {
                "bytes_per_chip": transport.bytes_per_chip,
                "bytes_by_kind": transport.bytes_by_kind,
                "collective_s": transport.bytes_per_chip / rl.LINK_BW}
        rec["launches"] = counter.launches
        rec["largest_outputs"] = counter.largest()
        rec["bytes_by_op"] = counter.by_op()
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=-12)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def analyse(cfg, shape, chips, entries) -> dict:
    """The record's cost, collective and roofline keys from a per-op
    trace (``RankCounter.entries()``)."""
    flops = sum(e["flops"] * e["count"] for e in entries)
    byts = sum(e["bytes"] * e["count"] for e in entries)
    coll = rl.collective_stats(entries)
    mf = rl.model_flops_estimate(cfg, shape)
    roof = rl.compute_roofline({"flops": flops, "bytes accessed": byts},
                               coll, chips, mf)
    return {
        "cost_analysis": {"flops": float(flops),
                          "bytes accessed": float(byts)},
        "collectives": {"bytes_per_chip": coll.bytes_per_chip,
                        "counts": coll.counts,
                        "bytes_by_kind": coll.bytes_by_kind},
        "dot_flops_per_device": float(flops),
        "roofline": {
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s, "dominant": roof.dominant,
            "model_flops": mf, "flops_per_device": roof.flops_per_device,
            "useful_flops_ratio": roof.useful_flops_ratio,
            "roofline_fraction": roof.roofline_fraction,
            "step_time_s": roof.step_time_s,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--moe-impl", default="gather",
                    choices=["gather", "shardmap"])
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized decode KV cache")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--save-trace", action="store_true",
                    help="write each cell's per-op trace beside its record")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernels' ops; cpu: their plain versions")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config (a CPU's size)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tagp = f"-{args.tag}" if args.tag else ""
                name = f"{arch}__{shape}__{'multi' if mp else 'single'}{tagp}"
                trace_path = (os.path.join(args.out, name + ".trace.json")
                              if args.save_trace else None)
                rec = run_cell(arch, shape, multi_pod=mp,
                               moe_impl=args.moe_impl,
                               microbatches=args.microbatches,
                               save_trace=trace_path, kv_int8=args.kv_int8,
                               device=args.device, reduced=args.reduced)
                with open(os.path.join(args.out, name + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = ("SKIP" if rec.get("skipped")
                          else "OK" if rec["ok"] else "FAIL")
                n_fail += status == "FAIL"
                dom = rec.get("roofline", {}).get("dominant", "-")
                print(f"[{status:4s}] {name:60s} "
                      f"t={rec.get('total_s', 0):8.1f}s dom={dom}",
                      flush=True)
                if status == "FAIL":
                    print(rec.get("error"), flush=True)
    print(f"done; failures={n_fail}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
