"""The kernels on DTensors: each call goes through ``local_map`` with
placements the kernel computes on locally, so that a layer run sharded
(``distributed.sharding.activation_sharding``) launches each kernel on its
rank's block, as the card would. ``kernels.ops`` and the models call the
kernels through here; plain tensors go straight to the kernel's function.
``ssm_core`` does the same for the Mamba2 mixer's core around its scan.

Per mesh dim, an attention call keeps:

* the batch split (``Shard(0)``) of q, and of k and v with it;
* the heads split (``Shard(2)``), where the KV heads split as the query
  heads do (their count divides the mesh dims'), so a rank's query heads
  read its own KV heads; else q's heads are gathered;
* the sequence split of q (``Shard(1)``: the ZeRO-3 prefill, ``attn_q``):
  the kernel runs on the rank's rows at their causal offset, K and V whole.

Every other split is gathered first: a sequence-split K/V or KV cache (the
``kv_seq`` rule) is all-gathered, which the dry-run counts, and so is a
split head_dim or a partial sum. The SSD scan keeps the batch and heads
splits (a group's B/C are gathered unless the groups split with the
heads); its sequence is gathered whole.

A gradient comes back with the placements its rank holds: dK and dV of a
sequence-split q are partial sums over that mesh dim, as are dB and dC of
heads that share their group.

AdamW's two passes (``adamw_norm``, ``adamw_update``) need no
``local_map``: the update is elementwise, so each rank steps its blocks of
the params, gradients and moments (placed alike) as they are, made dense,
and the norm all-reduces its blocks' sums of squares over the mesh dims
that split them.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import as_dtensor, local_block


def _kept(placements, keep):
    """Placements with every split not in ``keep`` (tensor dims), and every
    partial sum, replaced by ``Replicate()``."""
    return [p if isinstance(p, Shard) and p.dim in keep else Replicate()
            for p in placements]


def _heads_split(placements, mesh, n_heads, dim=2):
    """The mesh dims that split ``dim`` (heads), if their sizes' product
    divides ``n_heads``; else none."""
    dims = [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]
    n = math.prod(mesh.size(i) for i in dims)
    return dims if n_heads % n == 0 else []


def _offset(t: DTensor, placements, dim):
    """This rank's global offset along ``dim`` of ``t`` placed so."""
    return local_block(t.shape, t.device_mesh, placements)[1][dim]


class _DenseGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a kernel's
    (or its plain version's) input gradient leaves ``local_map`` as a
    DTensor, whose views in the backward need a dense layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense_grads(*ts):
    return tuple(_DenseGrad.apply(t) if isinstance(t, torch.Tensor)
                 and t.requires_grad else t for t in ts)


def flash(q, k, v, *, causal, window, fn):
    """``fn(q, k, v, q_offset, sk_valid)`` on each rank's block of DTensors
    q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D); returns o placed as q. Plain
    tensors: ``fn`` on them, at the causal offset Sk - Sq."""
    sq, sk = q.shape[1], k.shape[1]
    if not isinstance(q, DTensor):
        return fn(q, k, v, (sk - sq) if causal else 0, sk)
    mesh = q.device_mesh
    k, v = as_dtensor(k, mesh), as_dtensor(v, mesh)
    qp = _kept(q.placements, (0, 1, 2))
    heads = _heads_split(qp, mesh, k.shape[2])
    qp = [Replicate() if isinstance(p, Shard) and p.dim == 2
          and i not in heads else p for i, p in enumerate(qp)]
    kvp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
           for p in qp]
    # dK, dV: partial over the dims that split q's rows
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim == 1 else kp
               for p, kp in zip(qp, kvp)]
    offset = ((sk - sq) + _offset(q, qp, 1)) if causal else 0

    def local(ql, kl, vl):
        return fn(*_dense_grads(ql, kl, vl), offset, sk)
    return local_map(local, out_placements=qp,
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def decode(q, k_cache, v_cache, cache_len, *, fn):
    """``fn(q, k_cache, v_cache, cache_len)`` on each rank's block of q
    (B, 1, Hq, D) and the caches (B, S, Hkv, D): the batch and heads
    splits kept, a sequence-split cache gathered whole. ``cache_len``: an
    int, a 0-dim or (B,) tensor or DTensor. Plain tensors: ``fn`` on
    them."""
    if not isinstance(q, DTensor):
        return fn(q, k_cache, v_cache, cache_len)
    mesh = q.device_mesh
    k_cache, v_cache = (as_dtensor(t, mesh) for t in (k_cache, v_cache))
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.tensor(cache_len, dtype=torch.int32)
    cache_len = as_dtensor(cache_len.to(torch.int32), mesh)
    qp = _kept(q.placements, (0, 2))
    heads = _heads_split(qp, mesh, k_cache.shape[2])
    qp = [Replicate() if isinstance(p, Shard) and p.dim == 2
          and i not in heads else p for i, p in enumerate(qp)]
    lp = [p if cache_len.dim() and isinstance(p, Shard) and p.dim == 0
          else Replicate() for p in qp]
    return local_map(fn, out_placements=qp,
                     in_placements=(qp, qp, qp, lp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_cache, v_cache,
                                               cache_len)


def ssd(dx, dA, B, C, initial_state, *, fn):
    """``fn(dx, dA, B, C, initial_state)`` -> (y, final state) on each
    rank's block: dx (B, S, H, P), dA (B, S, H), B/C (B, S, G, N), the
    initial state None or (B, H, N, P). The batch and heads splits of dx
    are kept (the groups split with the heads where G divides the mesh
    dims; else B and C are whole on every rank). Plain tensors: ``fn`` on
    them."""
    if not isinstance(dx, DTensor):
        return fn(dx, dA, B, C, initial_state)
    mesh = dx.device_mesh
    dA, B, C = (as_dtensor(t, mesh) for t in (dA, B, C))
    xp = _kept(dx.placements, (0, 2))
    heads = _heads_split(xp, mesh, dx.shape[2])
    xp = [Replicate() if isinstance(p, Shard) and p.dim == 2
          and i not in heads else p for i, p in enumerate(xp)]
    groups = _heads_split(xp, mesh, B.shape[2])
    bp = [p if isinstance(p, Shard) and (p.dim == 0 or i in groups)
          else Replicate() for i, p in enumerate(xp)]
    # dB, dC: partial over the dims that split heads sharing a group
    bgrad = [Partial() if isinstance(p, Shard) and p.dim == 2
             and i not in groups else b for i, (p, b) in enumerate(zip(xp,
                                                                     bp))]
    sp = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
          for p in xp]                  # the state (B, H, N, P)
    args = (dx, dA, B, C)
    in_pl = (xp, xp, bp, bp)
    grad_pl = (xp, xp, bgrad, bgrad)
    if initial_state is not None:
        args += (as_dtensor(initial_state, mesh),)
        in_pl += (sp,)
        grad_pl += (sp,)

    def local(*t):
        return fn(*_dense_grads(*t), *(None,) * (5 - len(t)))
    return local_map(local, out_placements=(xp, sp), in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def ssm_core(core, args, cfg, *, step):
    """``core`` (``_scan_core`` or ``_step_core``) on each rank's block of
    DTensors: the batch split of the tokens kept, the heads split of the
    ``ssm_heads`` leaves (A_log's placements) kept, xbc and the conv tail
    gathered whole along their channels (the conv and the B/C slices need
    them). Gradients: xbc's, conv_w's and the per-head leaves' are partial
    sums over the mesh dims that split the heads or the batch. Plain
    tensors: ``core`` on them."""
    z = args[0]
    if not isinstance(z, DTensor):
        return core(*args, cfg=cfg)
    mesh = z.device_mesh
    a_log = args[-2]
    batch = [i for i, pl in enumerate(z.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    heads = [i for i, pl in enumerate(a_log.placements)
             if isinstance(pl, Shard) and i not in batch]
    head_pl = [Shard(0) if i in heads else Replicate()
               for i in range(mesh.ndim)]
    head_lo = local_block(a_log.shape, mesh, head_pl)[1][0]

    def pl(split_dim, head_dim=None, partial=False):
        return [Shard(split_dim) if i in batch else
                Shard(head_dim) if i in heads and head_dim is not None else
                Partial() if partial and i in heads else Replicate()
                for i in range(mesh.ndim)]
    wide, per_head = z.dim() - 1, 1 if step else 2   # z's channel dim
    vec = [Shard(0) if i in heads else Replicate() for i in range(mesh.ndim)]
    vec_grad = [Shard(0) if i in heads else Partial() if i in batch
                else Replicate() for i in range(mesh.ndim)]
    conv_grad = [Partial() if i in batch or i in heads else Replicate()
                 for i in range(mesh.ndim)]
    in_pl = [pl(0, wide), pl(0), pl(0, per_head)]
    in_grad = [pl(0, wide), pl(0, partial=True), pl(0, per_head)]
    if step:   # the conv tail and the state, from the cache
        in_pl += [pl(0), pl(0, 1)]
        in_grad += [pl(0), pl(0, 1)]
    in_pl += [[Replicate()] * mesh.ndim, vec, vec, vec]
    in_grad += [conv_grad, vec_grad, vec_grad, vec_grad]
    out_pl = (pl(0, wide), pl(0, 1), pl(0))

    def local(*t):
        return core(*t, cfg=cfg, head_lo=head_lo)
    return local_map(local, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(in_grad), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _block(t):
    """A DTensor's local block, dense (a block its sharding left strided,
    such as a tied embedding's transposed gradient, is copied), or the
    tensor itself."""
    if not isinstance(t, DTensor):
        return t
    b = t.to_local()
    return b if b.is_contiguous() else b.clone(
        memory_format=torch.contiguous_format)


def _split_dims(t):
    """The dims of more than one rank of a DTensor's mesh that split it;
    a partial sum raises (a gradient is reduced to its leaf's placements
    before AdamW)."""
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"AdamW takes no partial sums: {t.placements}")
    return tuple(i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and t.device_mesh.size(i) > 1)


def adamw_norm(grads, *, fn):
    """The global norm of ``grads`` (tensors or DTensors) as a 0-dim fp32
    tensor: ``fn`` (a list of plain tensors -> their fp64 sum of squares,
    0-dim) on this rank's blocks, one call for the leaves split over the
    same dims of more than one rank of a mesh, its sum all-reduced over
    those dims; the calls' sums added in the leaves' order, then the root.
    Plain tensors and leaves split over no such dim: one call, no
    collective. Of DTensors the norm is replicated on the first one's
    mesh."""
    groups = {}
    for g in grads:
        key = (g.device_mesh, _split_dims(g)) if isinstance(g, DTensor) \
            else (None, ())
        groups.setdefault(key, []).append(_block(g))
    total = None
    for (mesh, dims), blocks in groups.items():
        s = fn(blocks)
        if dims:
            s = DTensor.from_local(
                s, mesh, [Partial() if i in dims else Replicate()
                          for i in range(mesh.ndim)],
                run_check=False).full_tensor()
        total = s if total is None else total + s
    norm = torch.sqrt(total).float()
    mesh = next((g.device_mesh for g in grads if isinstance(g, DTensor)),
                None)
    if mesh is None:
        return norm
    return DTensor.from_local(norm, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def adamw_update(params, grads, m, v, scale, lr, b1c, b2c, *, fn, **kw):
    """``fn(params, grads, m, v, scale, lr, b1c, b2c, **kw)`` -> (new params,
    new m, new v) on this rank's blocks: the i-th gradient and moments
    placed as the i-th param, the 0-dim scale, lr and bias corrections
    tensors or replicated DTensors; each new leaf placed as its param.
    Plain tensors: ``fn`` on them."""
    for name, ts in (("grads", grads), ("m", m), ("v", v)):
        for i, (t, p) in enumerate(zip(ts, params)):
            if isinstance(t, DTensor) != isinstance(p, DTensor) or (
                    isinstance(p, DTensor)
                    and (t.device_mesh, t.placements)
                    != (p.device_mesh, p.placements)):
                raise ValueError(f"{name}[{i}] is not placed as its param")
    for name, t in (("scale", scale), ("lr", lr), ("b1c", b1c),
                    ("b2c", b2c)):
        if isinstance(t, DTensor) and not all(p.is_replicate()
                                              for p in t.placements):
            raise ValueError(f"{name} must be replicated: {t.placements}")
    new = fn(*([_block(t) for t in ts] for ts in (params, grads, m, v)),
             *(_block(t) for t in (scale, lr, b1c, b2c)), **kw)

    def placed(ts):
        return [DTensor.from_local(t, p.device_mesh, p.placements,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride())
                if isinstance(p, DTensor) else t for t, p in zip(ts, params)]
    return tuple(placed(ts) for ts in new)
