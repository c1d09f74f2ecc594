"""Ranks of ``tests/test_torch_mesh.py``: the port's side of the mesh at
real splits, each rank one process of a gloo group on the CPU.

``run_ranks(job, world, out_dir, ref_dir)`` spawns ``world`` processes
(the ``spawn`` start method: each imports torch afresh), each of which joins
a gloo group through a ``FileStore`` in ``out_dir``, runs ``JOBS[job]`` and
writes what it returns to ``out_dir/<job>-<rank>.pt``; a rank that raises
writes its traceback instead. Returns the ranks' results in rank order.
The MoE cases read their weights and inputs from the JAX package's
``ref_dir/reference.npz`` (``tests/torch_mesh_reference.py``). The cases
that hold the shard_map path ask for it through ``moe_ctx``; the others
run the MoE's default, the gather path split over the ranks.
"""
import datetime
import math
import multiprocessing
import os
import traceback
from dataclasses import replace
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")


def moe_config(arch):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=1.25))


def moe_params(ref, arch):
    """{"router/w": ..., "gate/w": ..., ["shared/..."]} of the reference's
    weights, as tensors."""
    pre = f"{arch}/p/"
    return {k[len(pre):]: torch.tensor(ref[k]) for k in ref.files
            if k.startswith(pre)}


def nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def moe_case(ref, arch, mesh, device="cpu", gather=False):
    """``moe_forward_shardmap`` (``moe_forward_gather_split`` where
    ``gather``) on this rank's block of the reference's x on ``device``,
    and the gradient of ``sum(y * ct)``, as numpy arrays, with the
    collectives it made."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import ffn
    cfg = moe_config(arch)
    sizes = shd.axis_sizes(mesh)
    di = mesh.get_local_rank("data")
    flat = {k: v.to(device) for k, v in moe_params(ref, arch).items()}
    for v in flat.values():
        v.requires_grad_(True)
    bl = ref[f"{arch}/x"].shape[0] // sizes["data"]
    rows = slice(di * bl, (di + 1) * bl)
    x = torch.tensor(ref[f"{arch}/x"][rows], device=device,
                     requires_grad=True)
    ct = torch.tensor(ref[f"{arch}/ct"][rows], device=device)
    shd.reset_collective_counts()
    fn = ffn.moe_forward_gather_split if gather else partial(
        ffn.moe_forward_shardmap, dp_axes=("data",))
    y = fn(nest(flat), x, cfg, mesh)
    names = sorted(flat)
    grads = torch.autograd.grad((y * ct).sum(), [x] + [flat[k]
                                                       for k in names])
    out = {"y": y.detach().cpu().numpy(), "dx": grads[0].cpu().numpy(),
           "rows": (rows.start, rows.stop),
           "counts": shd.collective_counts()}
    out.update({f"g/{k}": g.cpu().numpy()
                for k, g in zip(names, grads[1:])})
    return out


def dropped(ref, arch, mesh):
    """Assignments this rank's local dispatch drops past its capacity."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import ffn
    cfg = moe_config(arch)
    ep = shd.axis_sizes(mesh)["model"]
    el = cfg.moe.num_experts // ep
    x = torch.tensor(ref[f"{arch}/x"])
    bl = x.shape[0] // shd.axis_sizes(mesh)["data"]
    x2d = x[mesh.get_local_rank("data") * bl:][:bl].reshape(-1, x.shape[-1])
    _, experts = ffn.route({"w": torch.tensor(ref[f"{arch}/p/router/w"])},
                           x2d, cfg.moe)
    lo = mesh.get_local_rank("model") * el
    mine = experts[(experts >= lo) & (experts < lo + el)] - lo
    cap = max(8, ffn.capacity(x2d.shape[0], cfg.moe) // ep * 2)
    counts = torch.bincount(mine, minlength=el)
    return int((counts - cap).clamp_min(0).sum())


def moe_job(ref_dir, model):
    from repro_torch.launch.mesh import make_host_mesh
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=model, device="cpu")
    out = {}
    for arch in MOE_ARCHS:
        out[arch] = moe_case(ref, arch, mesh)
        out[(arch, "dropped")] = dropped(ref, arch, mesh)
    return out


def psum_job(ref_dir):
    from repro_torch.training import compression
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.tensor(ref[f"psum{world}/x"][rank])
    return compression.compressed_psum(x).numpy()


def tiny_state(seed=0):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    from repro_torch.training import train_loop
    bundle = registry.build(reduced(get_config("granite-moe-1b-a400m")))
    state = train_loop.init_train_state(
        bundle, torch.Generator().manual_seed(seed), device="cpu")
    return bundle, state, train_loop.state_axes(bundle.param_axes())


def remesh_job():
    """A reduced granite train state placed on a (4, 1) mesh by the train
    rules, then remeshed to (2, 2): every leaf's local shard the block its
    placements give, every leaf whole again equal to the original."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_block
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.optimizer import leaves
    bundle, state, axes = tiny_state()
    old = make_host_mesh(model=1, device="cpu")
    new = make_host_mesh(model=2, device="cpu")
    rules = shd.make_rules(bundle.cfg, old, "train")
    placed = shd.place(state, shd.sharding_for_tree(state, axes, rules, old))
    new_rules = shd.make_rules(bundle.cfg, new, "train")
    moved = elastic.remesh(placed, old, new, new_rules, axes=axes)
    blocks_ok, whole_ok, split = True, True, 0
    coord = [new.get_local_rank(a) for a in ("data", "model")]
    for t, want in zip(leaves(moved), leaves(state)):
        shape, offset = local_block(want.shape, (2, 2), coord, t.placements)
        block = want[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        blocks_ok &= torch.equal(t.to_local(), block.detach())
        whole_ok &= torch.equal(t.full_tensor(), want.detach())
        split += tuple(t.to_local().shape) != tuple(want.shape)
    return {"blocks": blocks_ok, "whole": whole_ok, "split_leaves": split,
            "leaves": len(leaves(state))}


def adamw_job():
    """A reduced granite train state placed on a (2, 2) mesh by the train
    rules, with gradients of random values placed as the params: AdamW's
    passes on each rank's blocks (``kernels.sharded``; the kernels' plain
    versions stand in for them, which have no CPU mode) against the chain
    on the DTensors. The norm and the new leaves, gathered whole; the
    groups of leaves the norm pass was called on."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import adamw, sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.optimizer import AdamWConfig, leaves, schedule
    bundle, state, axes = tiny_state()
    mesh = make_host_mesh(model=2, device="cpu")
    rules = shd.make_rules(bundle.cfg, mesh, "train")
    placed = shd.place(state, shd.sharding_for_tree(state, axes, rules,
                                                    mesh))
    ps = leaves(placed["params"])
    gen = torch.Generator().manual_seed(3)
    gs = [shd.from_whole(torch.randn(p.shape, generator=gen) * 1e-2,
                         p.device_mesh, p.placements) for p in ps]
    ms = leaves(placed["opt"]["m"])
    vs = leaves(placed["opt"]["v"])
    calls = []

    def sumsq(blocks):
        calls.append(len(blocks))
        return sum(torch.sum(torch.square(b.double())) for b in blocks)

    def update(ps, gs, ms, vs, *sc, **kw):
        out = [adamw.plain(*leaf, *sc, **kw) for leaf in zip(ps, gs, ms, vs)]
        return tuple([o[i] for o in out] for i in range(3))
    cfg = AdamWConfig()
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay)
    norm = sharded.adamw_norm(gs, fn=sumsq)
    chain_norm = adamw.plain_norm(gs)
    step = torch.tensor(2, dtype=torch.int32)
    sc = (torch.tensor(0.5), schedule(cfg, step),
          1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float())
    new = sharded.adamw_update(ps, gs, ms, vs, *sc, fn=update, **kw)
    want = [adamw.plain(*leaf, *sc, **kw) for leaf in zip(ps, gs, ms, vs)]
    return {"norm": norm.full_tensor(), "chain_norm": chain_norm.full_tensor(),
            "fp64_norm": math.sqrt(sum(float(torch.sum(
                g.full_tensor().double() ** 2)) for g in gs)),
            "placed": all(isinstance(t, type(p)) and t.placements ==
                          p.placements for ts in new
                          for t, p in zip(ts, ps)),
            "bit_equal": all(torch.equal(t.full_tensor(), w[i].full_tensor())
                             for i, ts in enumerate(new)
                             for t, w in zip(ts, want)),
            "split_leaves": sum(tuple(p.to_local().shape) != tuple(p.shape)
                                for p in ps),
            "calls": calls, "leaves": len(ps)}


def ref_params(ref, prefix):
    """The reference's weights under ``prefix`` (``.../p/...``) as the
    port's nested dict of tensors."""
    pre = prefix + "/p/"
    return nest({k[len(pre):]: torch.tensor(ref[k]) for k in ref.files
                 if k.startswith(pre)})


def split_config(arch):
    """The reduced config of ``torch_mesh_reference.split_config``: granite
    at the published capacity factor 1.25."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=1.25))


def gather_layer_case(ref, arch, mesh, mode):
    """One MoE layer of the reference's weights on ``mesh``, placed by the
    ``mode`` rules (train: the experts over model, the batch over data;
    prefill: the ZeRO-3 rules, the experts over data, the sequence over
    model), on DTensors with no ``moe_ctx``: its output and the gradients
    of ``sum(y * ct)`` gathered whole, the collectives it made, its and
    the input's placements, the assignments the reference's unsplit
    dispatch drops, and the shard_map path's output on the same blocks."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import ffn
    cfg = moe_config(arch)
    rules = shd.make_rules(cfg, mesh, mode)
    params = nest(moe_params(ref, arch))
    placed = shd.place(params, shd.sharding_for_tree(
        params, ffn.moe_axes(cfg), rules, mesh))
    x_np = ref[f"{arch}/x"]
    act = shd.Sharding(mesh, shd.spec_for(x_np.shape, ("batch", "seq",
                                                       "embed_act"),
                                          rules, mesh))
    x = act.place(torch.tensor(x_np)).requires_grad_(True)
    ct = act.place(torch.tensor(ref[f"{arch}/ct"]))
    leaves_ = flat_tree(placed)
    for v in leaves_.values():
        v.requires_grad_(True)
    shd.reset_collective_counts()
    with shd.activation_sharding(mesh, rules):
        y = ffn.moe_forward(placed, x, cfg)
        names = sorted(leaves_)
        grads = torch.autograd.grad((y * ct).sum(),
                                    [x] + [leaves_[k] for k in names])
    counts = shd.collective_counts()
    with torch.no_grad(), shd.activation_sharding(mesh, rules):
        y_sm = ffn.moe_forward(placed, x, cfg, {"impl": "shardmap"})
    x2d = torch.tensor(x_np).reshape(-1, x_np.shape[-1])
    _, experts = ffn.route({"w": torch.tensor(ref[f"{arch}/p/router/w"])},
                           x2d, cfg.moe)
    loads = torch.bincount(experts.reshape(-1),
                           minlength=cfg.moe.num_experts)
    cap = ffn.capacity(x2d.shape[0], cfg.moe)
    out = {"y": y.full_tensor().detach().numpy(),
           "dx": grads[0].full_tensor().numpy(),
           "y_shardmap": y_sm.full_tensor().numpy(), "counts": counts,
           "x_placements": str(x.placements),
           "stack_placements": str(placed["gate"]["w"].placements),
           "dropped": int((loads - cap).clamp_min(0).sum())}
    out.update({f"g/{k}": g.full_tensor().numpy()
                for k, g in zip(names, grads[1:])})
    return out


def gather_layer_job(ref_dir, model, modes):
    from repro_torch.launch.mesh import make_host_mesh
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=model, device="cpu")
    return {(arch, mode): gather_layer_case(ref, arch, mesh, mode)
            for arch in MOE_ARCHS for mode in modes}


def split_gather_job(ref_dir, model=2):
    """Reduced granite's loss and every gradient leaf (gathered whole) at
    the published capacity factor 1.25 on this group's (data, ``model``)
    mesh, the state placed by the train rules, fp32, on the reference's
    batch of few distinct tokens, with no ``moe_ctx``: each MoE layer
    through the split gather path; the assignments it
    dropped past the global capacity; and one train step's loss."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ffn, registry
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_loop
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=model, device="cpu")
    arch = "granite-moe-1b-a400m"
    cfg = split_config(arch)
    bundle = registry.build(cfg)
    params = ref_params(ref, f"split/{arch}")
    rules = shd.make_rules(cfg, mesh, "train")
    placed = shd.place(params, shd.sharding_for_tree(
        params, bundle.param_axes(), rules, mesh))
    toks = torch.tensor(ref[f"split_gather/{arch}/tokens"]).long()
    batch = shd.place({"tokens": toks},
                      shd.batch_sharding({"tokens": toks}, rules, mesh))
    for p in opt_mod.leaves(placed):
        p.requires_grad_(True)
    drops = [0]
    dispatch = count_drops(ffn, drops)
    try:
        with shd.activation_sharding(mesh, rules):
            loss = bundle.loss_fn(placed, batch, dtype=torch.float32,
                                  remat=True)
            grads = train_loop.reduce_grads(
                train_loop.grad_tree(loss, placed), placed)
    finally:
        ffn.dispatch = dispatch
    res = {"loss": float(loss.full_tensor()), "dropped": drops[0]}
    res.update({f"g/{k}": g.full_tensor().detach().numpy()
                for k, g in flat_tree(grads).items()})
    state = train_loop.init_train_state(bundle, device="cpu")
    state["params"] = params
    state = shd.place(state, shd.sharding_for_tree(
        state, train_loop.state_axes(bundle.param_axes()), rules, mesh))
    step = train_loop.make_train_step(bundle, opt_mod.AdamWConfig(),
                                      dtype=torch.float32)
    with shd.activation_sharding(mesh, rules):
        _, metrics = step(state, batch)
    res["step_loss"] = float(metrics["loss"].full_tensor())
    return res


def serve_gather_job(ref_dir):
    """Reduced granite at the published capacity factor 1.25 on the
    (1, 2) mesh: the prefill's logits at max_len 16 and one decode step's
    on params placed by the serve rules (the experts and the cache's KV
    heads split over model), and the prefill's by the ZeRO-3 prefill
    rules (the sequence split over model), each MoE layer through the
    split gather path, with the assignments it dropped; and that prefill
    through the shard_map path."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ffn, registry
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=2, device="cpu")
    cfg = split_config("granite-moe-1b-a400m")
    bundle = registry.build(cfg)
    params = ref_params(ref, "serve/granite125")
    prompt = torch.tensor(ref["serve/granite125/prompt"]).long()
    token = torch.tensor(ref["serve/granite125/token"]).long()
    out = {}
    drops = [0]
    for mode in ("serve", "prefill"):
        rules = shd.make_rules(cfg, mesh, mode)
        placed = shd.place(params, shd.sharding_for_tree(
            params, bundle.param_axes(), rules, mesh))
        with torch.no_grad(), shd.activation_sharding(mesh, rules):
            dispatch = count_drops(ffn, drops)
            try:
                logits, cache = bundle.prefill(placed, {"tokens": prompt},
                                               max_len=16,
                                               dtype=torch.float32)
                if mode == "serve":
                    step, _ = bundle.decode_step(placed, cache, token,
                                                 dtype=torch.float32)
                    out["serve/decode"] = step.full_tensor().numpy()
            finally:
                ffn.dispatch = dispatch
            out[f"{mode}/prefill"] = logits.full_tensor().numpy()
            if mode == "prefill":
                sm, _ = bundle.prefill(
                    placed, {"tokens": prompt}, max_len=16,
                    dtype=torch.float32, moe_ctx={"impl": "shardmap"})
                out["prefill/shardmap"] = sm.full_tensor().numpy()
        out[f"{mode}/stack_placements"] = str(
            placed["layers"]["ffn"]["gate"]["w"].placements)
    out["dropped"] = drops[0]
    return out


def count_drops(ffn, counter):
    """Wraps ``ffn.dispatch`` so that ``counter[0]`` adds the assignments
    to real (not phantom) experts each dispatch drops (on a mesh, each
    rank those to its own experts)."""
    dispatch = ffn.dispatch

    def counted(experts, cap, num_experts, n_tokens, *rest):
        out = dispatch(experts, cap, num_experts, n_tokens, *rest)
        real = experts.reshape(-1) < num_experts - 1
        cols = out[0].shape[1]
        counter[0] += int(((out[2] == num_experts * cols) & real).sum())
        return out
    ffn.dispatch = counted
    return dispatch


def split_job(ref_dir):
    """The loss and every gradient leaf (gathered whole) of reduced qwen2
    and reduced granite (its MoE at capacity factor 1.25, through the
    shard_map path, which ``moe_ctx`` asks for) on this group's
    (data, model = 2) mesh, the state placed by the train rules so that the
    dense layers run split, fp32, with the assignments the MoE dropped;
    AdamW on the placed weights given the reference's gradients (its new
    weights, moments, step and gradient norm); then one whole train step
    on the placed state (its loss, new leaves, their placements and its
    moments), one in two microbatches (each rank's rows halved: the same
    loss), and the errors of microbatch counts that do not divide every
    rank's rows."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ffn, registry
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_loop
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=2, device="cpu")
    data = shd.axis_sizes(mesh)["data"]
    out = {}
    ctx = {"impl": "shardmap"}
    for arch in ("qwen2-0.5b", "granite-moe-1b-a400m"):
        cfg = split_config(arch)
        bundle = registry.build(cfg)
        key = f"split/{arch}/{data}x2"
        params = ref_params(ref, f"split/{arch}")
        rules = shd.make_rules(cfg, mesh, "train")
        axes = bundle.param_axes()
        shardings = shd.sharding_for_tree(params, axes, rules, mesh)
        placed = shd.place(params, shardings)
        toks = torch.tensor(ref[f"split/{arch}/tokens"]).long()
        batch = shd.place({"tokens": toks},
                          shd.batch_sharding({"tokens": toks}, rules, mesh))
        for p in opt_mod.leaves(placed):
            p.requires_grad_(True)
        drops = [0]
        dispatch = count_drops(ffn, drops)
        try:
            with shd.activation_sharding(mesh, rules):
                loss = bundle.loss_fn(placed, batch, dtype=torch.float32,
                                      remat=True, moe_ctx=ctx)
                grads = train_loop.reduce_grads(
                    train_loop.grad_tree(loss, placed), placed)
        finally:
            ffn.dispatch = dispatch
        res = {"loss": float(loss.full_tensor()), "dropped": drops[0],
               "split_leaves": sum(
                   tuple(p.to_local().shape) != tuple(p.shape)
                   for p in opt_mod.leaves(placed))}
        res.update({f"g/{k}": g.full_tensor().detach().numpy()
                    for k, g in flat_tree(grads).items()})
        state = train_loop.init_train_state(bundle, device="cpu")
        state["params"] = params
        state_axes = train_loop.state_axes(axes)
        state = shd.place(state, shd.sharding_for_tree(state, state_axes,
                                                        rules, mesh))
        ref_grads = shd.place(nest({
            k[len(key) + 3:]: torch.tensor(ref[k]) for k in ref.files
            if k.startswith(f"{key}/g/")}), shardings)
        with torch.no_grad(), implicit_replication():
            new_p, new_opt, metrics = opt_mod.apply_updates(
                opt_mod.AdamWConfig(), state["params"], ref_grads,
                state["opt"])
        res["given/grad_norm"] = float(metrics["grad_norm"].full_tensor())
        res["given/step"] = int(new_opt["step"].full_tensor())
        for part, tree in (("p", new_p), ("m", new_opt["m"]),
                           ("v", new_opt["v"])):
            res.update({f"given/{part}/{k}": t.full_tensor().numpy()
                        for k, t in flat_tree(tree).items()})
        step = train_loop.make_train_step(bundle, opt_mod.AdamWConfig(),
                                          dtype=torch.float32, moe_ctx=ctx)
        with shd.activation_sharding(mesh, rules):
            new, metrics = step(state, batch)
        res["step_loss"] = float(metrics["loss"].full_tensor())
        res["step_placements_kept"] = all(
            a.placements == b.placements for a, b in zip(
                opt_mod.leaves(new), opt_mod.leaves(state)))
        res["step_finite"] = all(
            bool(torch.isfinite(x.full_tensor()).all())
            for x in opt_mod.leaves(new["params"]))
        res["step/step"] = int(new["opt"]["step"].full_tensor())
        for part in ("m", "v"):
            res.update({f"step/{part}/{k}": t.full_tensor().detach().numpy()
                        for k, t in flat_tree(new["opt"][part]).items()})
        two = train_loop.make_train_step(bundle, opt_mod.AdamWConfig(),
                                         dtype=torch.float32, microbatches=2,
                                         moe_ctx=ctx)
        with shd.activation_sharding(mesh, rules):
            _, metrics = two(state, batch)
        res["microbatched_loss"] = float(metrics["loss"].full_tensor())
        # 3 divides no rank's rows; 4 divides the batch of 4 but not the 2
        # rows a rank holds at data = 2
        res["microbatch_errors"] = {}
        for n in (3, 4) if data > 1 else (3,):
            bad = train_loop.make_train_step(
                bundle, opt_mod.AdamWConfig(), dtype=torch.float32,
                microbatches=n, moe_ctx=ctx)
            try:
                with shd.activation_sharding(mesh, rules):
                    bad(state, batch)
            except ValueError as e:
                res["microbatch_errors"][n] = str(e)
        out[arch] = res
    return out


def flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def serve_job(ref_dir):
    """Reduced qwen2 with 2 KV heads (the cache split on its KV heads) and
    with 1 (split on its sequence, the ``kv_seq`` rule) on the (1, 2)
    mesh by the serve rules: the prefill's logits at max_len 16 and one
    decode step's, which writes position 12, in rank 1's block of the
    sequence-split cache."""
    from dataclasses import replace

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=2, device="cpu")
    out = {}
    for name, kv in (("kv_heads", 2), ("kv_seq", 1)):
        cfg = replace(reduced(get_config("qwen2-0.5b")), n_kv_heads=kv)
        bundle = registry.build(cfg)
        params = ref_params(ref, f"serve/{name}")
        rules = shd.make_rules(cfg, mesh, "serve")
        placed = shd.place(params, shd.sharding_for_tree(
            params, bundle.param_axes(), rules, mesh))
        prompt = torch.tensor(ref[f"serve/{name}/prompt"]).long()
        token = torch.tensor(ref[f"serve/{name}/token"]).long()
        with torch.no_grad(), shd.activation_sharding(mesh, rules):
            logits, cache = bundle.prefill(placed, {"tokens": prompt},
                                           max_len=16, dtype=torch.float32)
            placements = str(cache["k"].placements)
            step, cache = bundle.decode_step(placed, cache, token,
                                             dtype=torch.float32)
        out[name] = {"prefill": logits.full_tensor().numpy(),
                     "decode": step.full_tensor().numpy(),
                     "cache_placements": placements,
                     "pos": int(cache["pos"].full_tensor())}
    return out


def moe_prefill_job(ref_dir):
    """Reduced granite's prefill logits at max_len 16 on this group's
    (data = 2, model = 2) mesh by the ZeRO-3 prefill rules: the expert
    stacks split over data, the sequence over model, each layer's MoE
    through the shard_map path (``moe_ctx``) with data as its expert
    axis."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    ref = np.load(os.path.join(ref_dir, "reference.npz"))
    mesh = make_host_mesh(model=2, device="cpu")
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    bundle = registry.build(cfg)
    params = ref_params(ref, "serve/granite")
    rules = shd.make_rules(cfg, mesh, "prefill")
    placed = shd.place(params, shd.sharding_for_tree(
        params, bundle.param_axes(), rules, mesh))
    prompt = torch.tensor(ref["serve/granite/prompt"]).long()
    with torch.no_grad(), shd.activation_sharding(mesh, rules):
        logits, _ = bundle.prefill(placed, {"tokens": prompt}, max_len=16,
                                   dtype=torch.float32,
                                   moe_ctx={"impl": "shardmap"})
    return {"prefill": logits.full_tensor().numpy(),
            "stack_placements": str(
                placed["layers"]["ffn"]["gate"]["w"].placements)}


def production_job():
    """The production meshes over fake process groups of 256 and 512 ranks
    (this rank is rank 0): their shapes, names and data axes, and the
    placements of a batch sharded over them; and the error of a mesh asked
    for before any group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    out = {}
    try:
        make_host_mesh(device="cpu")
    except RuntimeError as e:
        out["no_group"] = str(e)
    for multi_pod, n in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            spec = (shd.dp_axes(mesh) if multi_pod else "data", None)
            out[n] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                      shd.dp_axes(mesh), shd.placements(spec, mesh))
        finally:
            dist.destroy_process_group()
    return out


JOBS = {
    "ranks2": lambda ref_dir: {"moe": moe_job(ref_dir, 2),
                               "psum": psum_job(ref_dir),
                               "split": split_job(ref_dir),
                               "serve": serve_job(ref_dir),
                               "gather": gather_layer_job(
                                   ref_dir, 2, ("train", "prefill")),
                               "split_gather": split_gather_job(ref_dir),
                               "gather_2x1": gather_layer_job(
                                   ref_dir, 1, ("train",)),
                               "split_gather_2x1": split_gather_job(
                                   ref_dir, model=1),
                               "serve_gather": serve_gather_job(ref_dir)},
    "ranks4": lambda ref_dir: {"moe_1x4": moe_job(ref_dir, 4),
                               "moe_2x2": moe_job(ref_dir, 2),
                               "psum": psum_job(ref_dir),
                               "remesh": remesh_job(),
                               "adamw": adamw_job(),
                               "split": split_job(ref_dir),
                               "moe_prefill": moe_prefill_job(ref_dir),
                               "gather": gather_layer_job(
                                   ref_dir, 2, ("train", "prefill")),
                               "split_gather": split_gather_job(ref_dir)},
    "production": lambda ref_dir: production_job(),
}


def _rank(job, rank, world, out_dir, ref_dir):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"{job}-{rank}.pt")
    try:
        if job == "production":     # its own fake groups
            result = {"ok": JOBS[job](ref_dir)}
        else:
            dist.init_process_group(
                "gloo", rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=120),
                store=dist.FileStore(os.path.join(out_dir, f"{job}.store"),
                                     world))
            try:
                result = {"ok": JOBS[job](ref_dir)}
            finally:
                dist.destroy_process_group()
    except Exception:
        result = {"error": traceback.format_exc()}
    torch.save(result, path)


def run_ranks(job, world, out_dir, ref_dir=None, timeout=240):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(job, r, world, out_dir,
                                             ref_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    out = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"{job}-{r}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"{job} rank {r} wrote nothing "
                               f"(exit code {p.exitcode})")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            raise RuntimeError(f"{job} rank {r}:\n{res['error']}")
        out.append(res["ok"])
    return out
