"""Logical axes -> placements on a ``DeviceMesh`` (DP / FSDP / TP / EP / SP),
the port of ``repro.distributed.sharding``.

The port's params are tensors with no axes; ``bundle.param_axes()`` and
``bundle.cache_axes()`` give the tree of logical axis names the reference's
``Param.axes`` hold. ``make_rules`` maps those names to mesh axes per
(config, mode), exactly as the reference does, and ``spec_for`` gives the
reference's ``PartitionSpec`` as a tuple, one entry per tensor dim: None,
a mesh axis name, or a tuple of names. A dim whose size does not divide its
mesh axes, or whose mesh axis an earlier dim took, falls back to
replication. ``placements`` turns that spec into DTensor's placements, one
per mesh dim: ``Shard(tensor_dim)`` or ``Replicate()``. A dim sharded over
two mesh axes (the batch over ``("pod", "data")``) is split over them in
mesh order, the earlier axis major, which is the slice JAX gives each
device for ``P(("pod", "data"))``.

The reference's counterparts: ``Mesh`` is a ``DeviceMesh``,
``NamedSharding(mesh, P(...))`` is :class:`Sharding` (the mesh and its
placements), ``jax.device_put(arr, sharding)`` is ``Sharding.place``
(``distribute_tensor``), and ``psum`` over a mesh axis is an all-reduce on
that axis's process group (``all_reduce``, which counts its calls by axis).
``copy_to``, ``reduce_from`` and ``shard_of`` carry those collectives
through autograd for the MoE on a mesh (``models.ffn.moe_forward_shardmap``
and ``moe_forward_gather_split``), and ``scatter_sum`` and
``gather_blocks`` a reduce-scatter and an all-gather along a dim split
over mesh axes (the split gather path's slots).

Modes:
  train  FSDP (embed dim over `data`) x TP (heads/mlp/vocab/expert over
         `model`); batch over (`pod`, `data`).
  serve  TP only; params replicated over `data`; decode KV cache sharded on
         kv_heads when divisible, else on the sequence dim (SP fallback).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

# ---------------------------------------------------------------------------
# Meshes by axis name
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple:
    """A ``DeviceMesh``'s dim names, or the ``axis_names`` of a stand-in
    (the reference tests' ``FakeMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}; a stand-in's ``shape`` is already that dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# Rules and specs
# ---------------------------------------------------------------------------

def make_rules(cfg, mesh, mode: str = "train",
               overrides: Optional[dict] = None) -> dict:
    """mode: train | prefill | serve (decode). The reference's rules, branch
    for branch: heads, kv_heads, vocab, mlp and expert over `model` (over
    `data` in the ZeRO-3 prefill of attention-only archs, whose sequence
    then goes over `model`); the embed dim over `data` in training; the
    attention q-chunk over `model` in training where the query heads divide
    it and the KV heads do not; the KV sequence over `model` where the KV
    heads do not divide it (serve), in the ZeRO-3 prefill, and in training
    where neither head count divides it."""
    model_n = axis_sizes(mesh)["model"]
    kv_shardable = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_n == 0
    heads_shardable = cfg.n_heads > 0 and cfg.n_heads % model_n == 0
    zero3_prefill = (mode == "prefill" and cfg.n_heads > 0
                     and cfg.ssm is None)
    park = "data" if zero3_prefill else "model"
    rules = {
        "layer": None,
        "embed": "data" if mode == "train" else None,
        "embed2": park,
        "vocab": park,
        "heads": park,
        "kv_heads": park,
        "head_dim": None,
        "mlp": park,
        "expert": park,
        "q_lora": None,
        "kv_lora": None,
        "ssm_inner": "model",
        "ssm_conv_ch": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv": None,
        "batch": dp_axes(mesh),
        "seq": "model" if zero3_prefill else None,
        "attn_q": ("model" if (zero3_prefill or
                               (mode == "train" and heads_shardable
                                and not kv_shardable)) else None),
        "kv_seq": ("model" if (not kv_shardable and mode == "serve")
                   else ("model" if zero3_prefill else
                         ("model" if (mode == "train" and not kv_shardable
                                      and not heads_shardable) else None))),
        "enc_seq": None,
        "embed_act": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


def spec_for(shape, axes, rules: dict, mesh) -> tuple:
    """The reference's PartitionSpec as a tuple, one entry per dim: a mesh
    axis is used by the first dim that asks for it and divides by it; later
    dims, and dims that do not divide, are replicated (None)."""
    sizes = axis_sizes(mesh)
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        assign = rules.get(ax)
        if assign is None:
            parts.append(None)
            continue
        assign_t = assign if isinstance(assign, tuple) else (assign,)
        size = math.prod(sizes[a] for a in assign_t)
        if any(a in used for a in assign_t) or dim % size != 0:
            parts.append(None)
            continue
        used.update(assign_t)
        parts.append(assign_t if len(assign_t) > 1 else assign_t[0])
    return tuple(parts)


def placements(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    spec entry names that axis, else ``Replicate()``. A dim over several
    axes must name them in mesh order: DTensor splits it over the mesh dims
    in that order, which is JAX's slice only then."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        entry = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in entry]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}: DTensor would place it "
                             f"otherwise than JAX")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass
class Sharding:
    """The reference's ``NamedSharding(mesh, P(*spec))``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, tensor) -> DTensor:
        """``jax.device_put``: the whole tensor onto the mesh's device, each
        rank keeping its shard. Every rank passes the same tensor."""
        return distribute_tensor(tensor.detach().to(self.mesh.device_type),
                                 self.mesh, self.placements)


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def sharding_for_tree(tree, axes, rules: dict, mesh):
    """A tree of tensors (or shapes) and its axes tree -> a tree of
    :class:`Sharding`. A leaf whose axes are None (the optimizer's step
    count) is replicated."""
    def leaf(t, ax):
        shape = t.shape if isinstance(t, torch.Tensor) else tuple(t)
        return Sharding(mesh, () if ax is None
                        else spec_for(shape, ax, rules, mesh))
    return map_tree(leaf, tree, axes)


def place(tree, shardings):
    """Each leaf placed by its :class:`Sharding` (a tree of DTensors)."""
    return map_tree(lambda t, s: s.place(t), tree, shardings)


def batch_sharding(specs: dict, rules: dict, mesh) -> dict:
    """Input batch (name -> tensor or shape) -> shardings; dim 0 is the
    batch, the rest replicated."""
    out = {}
    for name, t in specs.items():
        shape = t.shape if isinstance(t, torch.Tensor) else tuple(t)
        axes = ("batch",) + (None,) * (len(shape) - 1)
        out[name] = Sharding(mesh, spec_for(shape, axes, rules, mesh))
    return out


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


# ---------------------------------------------------------------------------
# Activation sharding context: ``constrain(x, axes)`` places a hot
# intermediate by logical axis names inside ``activation_sharding``, and is
# the identity outside it (the CPU tests, the port's eager model).
# ---------------------------------------------------------------------------

_ACT = contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """``constrain`` places by ``rules`` on ``mesh`` inside; a plain tensor
    met by a DTensor (a mask, the positions) counts as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    token = _ACT.set((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _ACT.reset(token)


@contextlib.contextmanager
def without_activation_sharding():
    """``constrain`` is the identity inside, whatever context is around
    (a one-rank train step computing on the local tensors)."""
    token = _ACT.set(None)
    try:
        yield
    finally:
        _ACT.reset(token)


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs in
    the forward's activation-sharding context (the backward may run on
    another thread, which does not see it)."""
    ctx = _ACT.get()
    return (contextlib.nullcontext(), contextlib.nullcontext()
            if ctx is None else activation_sharding(*ctx))


def constrain(x, axes: tuple):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    a DTensor is redistributed to the spec's placements, a whole tensor is
    placed by them (``from_whole``); without an active context, ``x``
    itself."""
    ctx = _ACT.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    pl = placements(spec_for(x.shape, axes, rules, mesh), mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return from_whole(x, mesh, pl)


def from_whole(x, mesh, pl):
    """A tensor every rank holds whole (a fresh cache, a constant) as a
    DTensor of placements ``pl``: each rank keeps its block, with no
    communication."""
    shape, offset = local_block(x.shape, mesh, pl)
    local = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def zeros_tree(tree, axes, device):
    """Zeros shaped as the leaves of ``tree`` (tensors of any device, the
    meta device included), on ``device``; inside ``activation_sharding``
    each leaf a DTensor placed by its axes, each rank allocating its block
    alone."""
    ctx = _ACT.get()

    def leaf(t, ax):
        if ctx is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        mesh, rules = ctx
        pl = placements(spec_for(t.shape, ax, rules, mesh), mesh)
        shape, _ = local_block(t.shape, mesh, pl)
        return DTensor.from_local(
            torch.zeros(shape, dtype=t.dtype, device=device), mesh, pl,
            run_check=False, shape=t.shape, stride=_contiguous(t.shape))
    return map_tree(leaf, tree, axes)


def constrain_if(x, axes: tuple, key: str):
    """constrain(), but only when rule ``key`` is mapped."""
    ctx = _ACT.get()
    if ctx is None or ctx[1].get(key) is None:
        return x
    return constrain(x, axes)


# ---------------------------------------------------------------------------
# In-place writes into a (possibly sharded) cache, and the label's logit of
# vocab-split logits: each rank writes or reads its own block, computed on
# its local tensor, so nothing is written or read silently wrong.
# ---------------------------------------------------------------------------

def local_block(shape, mesh, pl):
    """(this rank's block's shape, its offset in the whole) of a tensor of
    ``shape`` placed by ``pl`` on ``mesh``: DTensor's split, each mesh dim
    in order cutting the block so far as ``torch.chunk`` does. Plain
    integers from the mesh coordinate, so it runs under ``FakeTensorMode``
    too."""
    coord = mesh.get_coordinate()
    shape, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            d, n = p.dim, mesh.size(i)
            full = -(-shape[d] // n)
            start = min(coord[i] * full, shape[d])
            offset[d] += start
            shape[d] = max(0, min(full, shape[d] - start))
    return tuple(shape), tuple(offset)


def as_dtensor(t, mesh):
    """A plain tensor (the same on every rank) as a replicated DTensor; a
    DTensor or a non-tensor as it is."""
    if isinstance(t, DTensor) or not isinstance(t, torch.Tensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _placed(t, mesh, pl):
    return as_dtensor(t, mesh).redistribute(mesh, pl)


def _seq_block(cache, dim=1):
    """(the placements a write into ``cache`` reads its new rows with:
    the cache's, whole along ``dim``; this rank's offset along ``dim``)."""
    mesh, cp = cache.device_mesh, cache.placements
    if any(isinstance(p, Partial) for p in cp):
        raise ValueError(f"a cache placed as a partial sum {cp}")
    _, offset = local_block(cache.shape, mesh, cp)
    new_pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in cp]
    return new_pl, offset[dim]


def assign(dst, src):
    """``dst.copy_(src)``; a DTensor ``dst`` takes ``src`` redistributed to
    its own placements, each rank its block."""
    if not isinstance(dst, DTensor):
        return dst.copy_(src)
    dst.to_local().copy_(_placed(src, dst.device_mesh,
                                 dst.placements).to_local())
    return dst


def write_prefix(cache, new):
    """``cache[:, :n] = new`` (n = new.shape[1]), in place. A DTensor cache
    split along its sequence writes, on each rank, the new rows that fall
    in its block."""
    n = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, :n] = new
        return cache
    if cache.shape == new.shape:
        return assign(cache, new)
    pl, lo = _seq_block(cache)
    new_l = _placed(new, cache.device_mesh, pl).to_local()
    local = cache.to_local()
    m = max(0, min(n - lo, local.shape[1]))
    if m:
        local[:, :m].copy_(new_l[:, lo:lo + m])
    return cache


def write_at(cache, new, pos):
    """One position per sequence of ``new`` (B, 1, ...) into the (B, S,
    ...) ``cache``, in place: ``pos`` 0-dim (one shared position) or (B,)
    (every slot at its own depth); 0 <= pos < S. The JAX model blends a
    one-hot over the whole cache and returns a new one; this writes only
    the new rows. A DTensor cache split along its sequence is written only
    on the rank whose block holds the position (the others write their own
    rows back), each batch block with its own positions."""
    if not isinstance(cache, DTensor):
        new = new[:, 0].to(cache.dtype)
        if pos.dim() == 0:
            cache.index_copy_(1, pos.reshape(1).long(), new[:, None])
        else:
            cache[torch.arange(cache.shape[0], device=cache.device),
                  pos.long()] = new
        return cache
    mesh = cache.device_mesh
    pl, lo = _seq_block(cache)
    new_l = _placed(new, mesh, pl).to_local()[:, 0].to(cache.dtype)
    pos_pl = [p if pos.dim() and isinstance(p, Shard) and p.dim == 0
              else Replicate() for p in cache.placements]
    pos_l = _placed(pos, mesh, pos_pl).to_local().long() - lo
    local = cache.to_local()
    n = local.shape[1]
    valid = (pos_l >= 0) & (pos_l < n)
    idx = pos_l.clamp(0, n - 1)
    if pos_l.dim() == 0:
        idx = idx.reshape(1)
        local.index_copy_(1, idx, torch.where(
            valid, new_l[:, None], local.index_select(1, idx)))
    else:
        rows = torch.arange(local.shape[0], device=local.device)
        keep = valid.view((-1,) + (1,) * (new_l.dim() - 1))
        local[rows, idx] = torch.where(keep, new_l, local[rows, idx])
    return cache


def contract(x, w, in_dims: int = 1):
    """``tensordot(x, w, in_dims)`` of DTensors, each rank on its blocks
    (``local_map``), by Megatron's and FSDP's rules per mesh dim:

    * x split along a batch dim: w gathered there (FSDP), out split as x;
    * else w split along an output dim (column-parallel): x gathered, out
      split along that dim;
    * else w split along a contracted dim (row-parallel), or x split along
      one: the other split to match, out a partial sum;
    * else out as x (replicated, or a partial sum carried through).

    So no view of a split dim is ever taken (tensordot flattens its
    operands). Gradients: w's a partial sum over the mesh dims that split
    x's batch, x's a partial sum over those that split w's outputs. A
    plain x: ``torch.tensordot``."""
    if not isinstance(x, DTensor):
        return torch.tensordot(x, w, dims=in_dims)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    w = as_dtensor(w, mesh)
    nb = x.dim() - in_dims
    xs, ws, outs, xg, wg = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < nb:           # batch split
            xi, wi, oi = xp, Replicate(), xp
            xgi, wgi = xp, Partial()
        elif isinstance(wp, Shard) and wp.dim >= in_dims:    # column split
            xi, wi, oi = Replicate(), wp, Shard(nb + wp.dim - in_dims)
            xgi, wgi = Partial(), wp
        elif isinstance(wp, Shard):                          # row split
            xi, wi, oi = Shard(nb + wp.dim), wp, Partial()
            xgi, wgi = xi, wp
        elif isinstance(xp, Shard):                          # x's contraction
            xi, wi, oi = xp, Shard(xp.dim - nb), Partial()
            xgi, wgi = xp, wi
        elif isinstance(xp, Partial):
            xi, wi, oi = xp, Replicate(), Partial()
            xgi, wgi = Replicate(), Partial()
        else:
            xi = wi = oi = xgi = wgi = Replicate()
        xs.append(xi)
        ws.append(wi)
        outs.append(oi)
        xg.append(xgi)
        wg.append(wgi)
    return local_map(lambda a, b: torch.tensordot(a, b, dims=in_dims),
                     out_placements=outs, in_placements=(xs, ws),
                     in_grad_placements=(xg, wg), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def embedding(tokens, table):
    """``table[tokens]`` of a DTensor table (V, d), each rank on its blocks
    (``local_map``), per mesh dim: the tokens' batch split kept (the table
    gathered there, FSDP), else a vocab split read as masked rows summed
    over the dim (the rows outside a rank's block read zero), else an
    embed split kept. A plain table: ``F.embedding``."""
    if not isinstance(table, DTensor):
        return torch.nn.functional.embedding(tokens.long(), table)
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    ts, ws, outs, wg = [], [], [], []
    for tp, wp in zip(tokens.placements, table.placements):
        if isinstance(tp, Shard) and tp.dim == 0:
            ti, wi, oi, wgi = tp, Replicate(), Shard(0), Partial()
        elif isinstance(wp, Shard) and wp.dim == 0:
            ti, wi, oi, wgi = Replicate(), wp, Partial(), wp
        elif isinstance(wp, Shard):
            ti, wi, oi, wgi = Replicate(), wp, Shard(tokens.dim()), wp
        else:
            ti = wi = oi = wgi = Replicate()
        ts.append(ti)
        ws.append(wi)
        outs.append(oi)
        wg.append(wgi)
    lo = local_block(table.shape, mesh, ws)[1][0]

    def local(tok, w):
        idx = tok.long() - lo
        valid = (idx >= 0) & (idx < w.shape[0])
        rows = torch.nn.functional.embedding(idx.clamp(0, w.shape[0] - 1), w)
        return rows * valid[..., None].to(rows.dtype)
    return local_map(local, out_placements=outs, in_placements=(ts, ws),
                     in_grad_placements=(ts, wg), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, table)


def log_z_and_label(logits, labels):
    """(logsumexp over the last dim, the label's logit) of fp32 logits.
    DTensor logits, whose vocab may be split: the logsumexp by its parts,
    so that only (..., 1) maxima and sums cross the ranks, not the logits;
    the label's logit by ``label_logits``."""
    if not isinstance(logits, DTensor):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels.long()[..., None])[..., 0])
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    return logz, label_logits(logits, labels)


def on_blocks(fn, args, placements, out_placements):
    """``fn`` on each rank's local blocks of the DTensors ``args``, each
    redistributed to its ``placements`` first (``local_map``); its output
    placed by ``out_placements``. Each block's gradient is declared with
    the same placements: ``fn``'s own collectives must make it whole over
    every mesh dim its block is replicated on."""
    from torch.distributed.tensor.experimental import local_map
    pls = tuple(list(p) for p in placements)
    return local_map(fn, out_placements=list(out_placements),
                     in_placements=pls, in_grad_placements=pls,
                     device_mesh=args[0].device_mesh,
                     redistribute_inputs=True)(*args)


def label_logits(logits, labels):
    """``logits[..., labels]`` of DTensor logits whose last (vocab) dim may
    be split: each rank reads the labels that fall in its vocab block, a
    partial sum over the mesh dims that split it; the gradient is each
    rank's block."""
    from torch.distributed.tensor.experimental import local_map
    mesh, nd = logits.device_mesh, logits.dim()
    lp = [Replicate() if isinstance(p, Partial) else p
          for p in logits.placements]
    lab_pl = [p if isinstance(p, Shard) and p.dim < nd - 1 else Replicate()
              for p in lp]
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == nd - 1 else b
              for p, b in zip(lp, lab_pl)]
    _, offset = local_block(logits.shape, mesh, lp)
    lo = offset[-1]

    def local(lg, lab):
        idx = lab.long() - lo
        valid = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(valid, got[..., 0], torch.zeros_like(got[..., 0]))
    return local_map(local, out_placements=out_pl,
                     in_placements=(lp, lab_pl), in_grad_placements=(lp,
                                                                    lab_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, as_dtensor(labels, mesh))


# ---------------------------------------------------------------------------
# Collectives over mesh axes
# ---------------------------------------------------------------------------

_COUNT_LOCK = threading.Lock()
_COUNTS: dict = {}


def collective_counts() -> dict:
    """Collectives since the last reset: all-reduces by mesh axis name,
    all-gathers and reduce-scatters by ``"all_gather:<axis>"`` and
    ``"reduce_scatter:<axis>"``."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def reset_collective_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


def _count(key):
    with _COUNT_LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + 1


def all_reduce(t, mesh, axes):
    """``psum`` over each mesh axis of ``axes`` (a name or a tuple), in
    place on ``t``, which is returned; one counted all-reduce per axis,
    whatever its size."""
    for ax in (axes,) if isinstance(axes, str) else axes:
        dist.all_reduce(t, group=mesh.get_group(ax))
        _count(ax)
    return t


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_gather(t, mesh, axes, dim: int = 0):
    """The blocks of a tensor split along ``dim`` over the mesh axes
    ``axes`` (the earlier axis major, as DTensor splits a dim over several
    mesh dims), joined in their order: one counted all-gather per axis,
    the inner axis first. No gradient flows through it."""
    for ax in reversed(_axes(axes)):
        group = mesh.get_group(ax)
        parts = [torch.empty_like(t) for _ in range(group.size())]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts, dim)
        _count(f"all_gather:{ax}")
    return t


def reduce_scatter(t, mesh, axes, dim: int = 0):
    """``t`` summed over the mesh axes ``axes``, each rank keeping its
    block along ``dim`` (the earlier axis major; the axes' sizes must
    divide the dim): one counted reduce-scatter per axis, the outer axis
    first. No gradient flows through it."""
    for ax in _axes(axes):
        group = mesh.get_group(ax)
        n = group.size()
        if t.shape[dim] % n:
            raise ValueError(f"a dim of {t.shape[dim]} does not split over "
                             f"{ax}={n}")
        parts = [c.contiguous() for c in t.chunk(n, dim)]
        t = torch.empty_like(parts[0])
        dist.reduce_scatter(t, parts, group=group)
        _count(f"reduce_scatter:{ax}")
    return t


class _ScatterSum(torch.autograd.Function):
    """``reduce_scatter`` forward; its transpose, ``all_gather`` of the
    gradient, backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherBlocks(torch.autograd.Function):
    """``all_gather`` forward; its transpose, ``reduce_scatter`` of the
    gradient, backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


def scatter_sum(x, mesh, axes, dim: int = 0):
    return _ScatterSum.apply(x, mesh, _axes(axes), dim)


def gather_blocks(x, mesh, axes, dim: int = 0):
    return _GatherBlocks.apply(x, mesh, _axes(axes), dim)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``axes``: the input
    is replicated over them and each rank's gradient is a partial sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward over ``axes``; identity backward: every rank
    holds the same loss of the sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ShardOf(torch.autograd.Function):
    """This rank's block of ``dim`` along mesh axis ``axis`` (shard_map's
    in_spec on a whole input); the gradient is the block's, zero elsewhere,
    all-reduced over the axis, so every rank gets the whole gradient (the
    blocks are disjoint: each value is one rank's, exactly)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        n = x.shape[dim] // axis_sizes(mesh)[axis]
        lo = mesh.get_local_rank(axis) * n
        ctx.mesh, ctx.axis, ctx.dim, ctx.lo = mesh, axis, dim, lo
        ctx.shape = x.shape
        return x.narrow(dim, lo, n).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
        return all_reduce(full, ctx.mesh, ctx.axis), None, None, None


def copy_to(x, mesh, axes):
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    return _ReduceFrom.apply(x, mesh, axes)


def shard_of(x, mesh, axis: str, dim: int = 0):
    return _ShardOf.apply(x, mesh, axis, dim)
