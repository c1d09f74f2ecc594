"""Feed-forward mixers: SwiGLU and the MoE, its gather path (whole and
split over ranks) and its shard_map path.

The gather path is ``repro.models.ffn.moe_forward_gather``: sort-based
dispatch of each token's top-k experts into an (E, C, d) buffer, the
experts' SwiGLU as batched products, and a weighted combine; an optional
shared expert adds a dense SwiGLU. The reference computes it in jnp outside
any Pallas kernel, so the port keeps it in plain PyTorch. Every detail that
decides which assignment is dropped follows the reference: softmax in fp32,
top-k, renormalised weights; a stable sort of the flat expert ids; the
capacity rule; assignments past it go to a dropped column; a zero pad row
``t``. Tokens move into the slots and back by gathers alone, both ways
(``_Rows``), so the backward has no atomic adds and a step's gradient is
the same bits every time; a token's rows sum in order of expert id, the
order of the reference's scatter-add.

``moe_forward_gather_split`` is that path with its tokens and experts split
over a ``DeviceMesh``, computing what the reference's computes under
``pjit``: one global capacity over all B * S tokens, each assignment's
slot its place in the global order, the (E, C, d) buffer split over the
ranks (the experts over the expert axis, the slots over the token axes),
and one all-reduce combining them. ``moe_forward_shardmap`` is the
reference's shard_map MoE: the experts sharded over the model axis, the
tokens over the data axes, each model rank dispatching its token block to
its own experts (the others' choices go to a phantom expert that is not
computed) under a local capacity, and one all-reduce over the model axis
combining them. ``moe_forward`` picks one: a layer run split (DTensor
activations) runs the split gather path on each rank's blocks unless
``moe_ctx`` asks for shard_map.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
from repro_torch.models import common as cm
from repro_torch.trace import backward_span, span


def swiglu_init(generator, d_model, d_ff, *, lead=(), device="cuda",
                dtype=torch.float32):
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "gate": cm.dense(generator, d_model, d_ff, **kw),
        "up": cm.dense(generator, d_model, d_ff, **kw),
        "down": cm.dense(generator, d_ff, d_model, **kw),
    }


def swiglu_axes():
    return {"gate": cm.dense_axes(("embed", "mlp")),
            "up": cm.dense_axes(("embed", "mlp")),
            "down": cm.dense_axes(("mlp", "embed"))}


def swiglu(p, x):
    # the reference's constraint on the hidden: under the sequence-split
    # prefill it stays split along the sequence
    axes = ("batch",) + ("seq",) * (x.dim() - 2) + ("mlp",)
    g = shd.constrain(cm.apply_dense(p["gate"], x), axes)
    u = cm.apply_dense(p["up"], x)
    return cm.apply_dense(p["down"], F.silu(g) * u)


def moe_init(generator, cfg, *, lead=(), device="cuda", dtype=torch.float32):
    """Router (d, E), the experts' gate, up (E, d, ff) and down (E, ff, d),
    each expert's weights scaled by its fan-in; with ``shared_expert_ff``
    a dense SwiGLU beside them."""
    moe = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, moe.num_experts
    kw = dict(device=device, dtype=dtype)
    experts = tuple(lead) + (e,)
    p = {
        "router": cm.dense(generator, d, e, lead=lead, **kw),
        "gate": cm.dense(generator, d, ff, lead=experts, **kw),
        "up": cm.dense(generator, d, ff, lead=experts, **kw),
        "down": cm.dense(generator, ff, d, lead=experts, **kw),
    }
    if moe.shared_expert_ff:
        p["shared"] = swiglu_init(generator, d, moe.shared_expert_ff,
                                  lead=lead, **kw)
    return p


def moe_axes(cfg):
    """``moe_init``'s logical axes."""
    p = {"router": cm.dense_axes(("embed", "expert")),
         "gate": {"w": ("expert", "embed", "mlp")},
         "up": {"w": ("expert", "embed", "mlp")},
         "down": {"w": ("expert", "mlp", "embed")}}
    if cfg.moe.shared_expert_ff:
        p["shared"] = swiglu_axes()
    return p


def route(router_p, x2d, moe):
    """x2d (T, d) -> (weights (T, k) fp32, experts (T, k))."""
    logits = cm.apply_dense(router_p, x2d).float()                 # (T, E)
    weights, experts = torch.topk(torch.softmax(logits, dim=-1), moe.top_k,
                                  dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, experts


def capacity(n_tokens, moe):
    """Slots per expert: top_k / E of the tokens times the capacity factor,
    rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _ranks(keys, n_keys):
    """A stable sort of the flat int ``keys`` (each in [0, n_keys)): (the
    order, the sorted keys, each sorted entry's place among the entries of
    its key, the lower index first)."""
    order = torch.sort(keys, stable=True).indices
    sorted_keys = keys[order]
    # bincount would wait for the device to size its output
    counts = keys.new_zeros(n_keys).index_add_(0, keys,
                                               torch.ones_like(keys))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(keys.numel(), device=keys.device) - \
        starts[sorted_keys]
    return order, sorted_keys, pos


def dispatch(experts, cap, num_experts, n_tokens, offsets=None, cols=None):
    """The slots of a dispatch: (slot_tok (E, cols), slot_src (E, cols),
    assign (T * k,)). In a stable sort of the flat assignments by expert
    id, an assignment's place in its expert's block is its slot, so within
    an expert the lower token comes first; those at or past ``cap`` are
    dropped. With ``offsets`` (rows, E) the T tokens are ``rows`` rows of
    a block of a larger batch: an assignment's slot is its row's offset
    for its expert (the assignments to that expert before this block's
    part of the row) plus its place among the row's assignments to it
    here. ``cols`` (``cap`` by default) slots an expert are laid out.
    ``slot_src`` holds each slot's flat assignment ``t * k + j`` (``T * k``
    where the slot is empty) and ``slot_tok`` its token (the pad row ``T``
    where empty); ``assign`` holds each flat assignment's slot
    ``e * cols + c``, ``E * cols`` where it was dropped."""
    k = experts.shape[1]
    n = n_tokens * k
    cols = cap if cols is None else cols
    if offsets is None:
        order, sorted_e, pos = _ranks(experts.reshape(n), num_experts)
    else:
        row = torch.arange(n, device=experts.device) // (
            n // offsets.shape[0])
        order, sorted_key, pos = _ranks(
            row * num_experts + experts.reshape(n), offsets.numel())
        sorted_e = sorted_key % num_experts
        pos = pos + offsets.reshape(-1)[sorted_key]
    keep = pos < cap
    # overflow goes to column ``cols``, which is cut off below
    dest = torch.where(keep, pos, torch.full_like(pos, cols))
    slot_src = torch.full((num_experts, cols + 1), n, dtype=torch.long,
                          device=experts.device)
    slot_src[sorted_e, dest] = order
    slot_src = slot_src[:, :cols]
    assign = torch.empty_like(order)
    assign[order] = torch.where(keep, sorted_e * cols + pos,
                                torch.full_like(pos, num_experts * cols))
    return slot_src // k, slot_src, assign


def _pad(x):
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def _to_slots(x, slot_tok):
    """(T, d) -> (slots, d): each slot's token row, zero where empty."""
    return _pad(x)[slot_tok]


def _to_tokens(x, assign):
    """(slots, d) -> (T, d): the sum of each token's slot rows, in the
    order of ``assign`` (a dropped assignment adds the zero pad row)."""
    xp = _pad(x)
    y = xp[assign[:, 0]]
    for j in range(1, assign.shape[1]):
        y = y + xp[assign[:, j]]
    return y


class _Rows(torch.autograd.Function):
    """Rows moved between the token layout (T, d) and the slot layout
    (slots, d), each way the other's transpose, by gathers only: the
    gradient of a move into the slots sums each token's slot rows in a
    fixed order, and that of a move back gathers each slot's token row.
    (An index's own backward would scatter-add, which on the card sums
    repeated rows in no fixed order, and runs the empty slots' repeats of
    the pad row one after another.)"""

    @staticmethod
    def forward(ctx, x, slot_tok, assign, to_slots):
        ctx.save_for_backward(slot_tok, assign)
        ctx.to_slots = to_slots
        return _to_slots(x, slot_tok) if to_slots else _to_tokens(x, assign)

    @staticmethod
    def backward(ctx, g):
        slot_tok, assign = ctx.saved_tensors
        g = _to_tokens(g, assign) if ctx.to_slots else _to_slots(g, slot_tok)
        return g, None, None, None


def dispatch_compute_combine(p, x2d, weights, experts, cap, moe, *,
                             offsets=None, cols=None, mesh=None,
                             token_axes=()):
    """Sort-based dispatch -> the experts' SwiGLU -> weighted combine.
    x2d (T, d); weights / experts (T, k). Returns (T, d). Where the weights
    hold fewer experts than ``moe.num_experts`` (the MoE on a mesh), the
    last expert id is the phantom one: its slots are dropped, not
    computed. ``offsets`` and ``cols``: ``dispatch``'s; ``mesh`` and
    ``token_axes``: ``_experts_at_slots``'."""
    e = p["gate"]["w"].shape[0]
    cols = cap if cols is None else cols
    layout = () if offsets is None else (offsets, cols)
    with span("moe.dispatch"):
        slot_tok, slot_src, assign = dispatch(experts, cap, moe.num_experts,
                                              x2d.shape[0], *layout)
        slot_tok = slot_tok[:e].reshape(-1)
        slot_src = slot_src[:e].reshape(-1)
        assign = assign.clamp(max=e * cols)     # phantom slots: dropped
    return _experts_at_slots(p, x2d, weights, slot_tok, slot_src, assign, e,
                             cols, mesh, token_axes)


def _experts_at_slots(p, x2d, weights, slot_tok, slot_src, assign, e, cap,
                      mesh=None, token_axes=()):
    """The experts' SwiGLU over (e, cap) slots, weighted, back on the
    tokens: ``slot_tok`` / ``slot_src`` hold each slot's token and flat
    assignment (``dispatch``'s), ``assign`` each flat assignment's slot,
    ``e * cap`` where it is not computed. The rows and weights move into
    the slots and back by ``_Rows``. With ``token_axes`` the slots are
    split over them: the slot buffer is reduce-scattered along its slots,
    each rank computing its block, and the products all-gathered back.
    Returns the (T, d) sum of each token's rows in order of its slots
    (of expert id; a dropped one adds the zero pad row last)."""
    t, d = x2d.shape
    with span("moe.dispatch"):
        by_token = assign.view(t, -1).sort(dim=1)[0]
        xs = _Rows.apply(x2d, slot_tok, by_token, True).view(e, cap, d)
        # each slot's weight: a move of the (T * k, 1) weights into the slots
        slot_w = _Rows.apply(weights.reshape(-1, 1), slot_src,
                             assign[:, None], True).view(e, cap, 1)
        if token_axes:
            xs = shd.scatter_sum(xs, mesh, token_axes, 1)
            slot_w = shd.scatter_sum(slot_w, mesh, token_axes, 1)
    with span("moe.experts"):
        wg, wu, wd = (p[n]["w"].to(xs.dtype) for n in ("gate", "up", "down"))
        h = F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu)          # (E, C, ff)
        out = torch.bmm(h, wd) * slot_w.to(xs.dtype)              # (E, C, d)
    with span("moe.combine"):
        if token_axes:
            out = shd.gather_blocks(out, mesh, token_axes, 1)
        return _Rows.apply(out.reshape(-1, d), slot_tok, by_token, False)


def moe_forward_gather(p, x, cfg):
    """x: (B, S, d). Every row of x routes, pads included: they raise the
    token count and so the capacity, and sort after the real tokens of
    their batch row in each expert's block. Its backward is the span
    ``moe.backward`` of a trace."""
    return backward_span("moe.backward", _gather, x, p, cfg)


def _gather(x, p, cfg):
    moe = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    with span("moe.route"):
        weights, experts = route(p["router"], x2d, moe)
    y = dispatch_compute_combine(p, x2d, weights, experts,
                                 capacity(b * s, moe), moe)
    if "shared" in p:
        with span("moe.experts"):
            y = y + swiglu(p["shared"], x2d)
    return y.reshape(b, s, d)


def moe_forward(p, x, cfg, moe_ctx=None):
    """The MoE by ``moe_ctx``, as the reference's transformer picks it:
    ``{"impl": "shardmap", ...}`` the shard_map path, anything else the
    gather path. A DTensor ``x`` (a layer run split) runs the path on each
    rank's blocks of its own mesh (``_on_blocks``: the gather path split
    over the ranks, ``moe_forward_gather_split``); a whole tensor runs
    ``moe_forward_shardmap`` on ``moe_ctx["mesh"]``, else
    ``moe_forward_gather``."""
    impl = (moe_ctx or {}).get("impl", "gather")
    if isinstance(x, DTensor):
        return _on_blocks(p, x, cfg, impl)
    if impl == "shardmap":
        return moe_forward_shardmap(p, x, cfg, moe_ctx["mesh"],
                                    dp_axes=moe_ctx["dp_axes"])
    return moe_forward_gather(p, x, cfg)


class _LocalMoE:
    """The MoE config inside the shard_map path's local block: one phantom
    expert id (``e_local``) absorbs the choices of other ranks' experts."""

    def __init__(self, e_local, top_k):
        self.num_experts = e_local + 1
        self.top_k = top_k


def _on_mesh(p, x, cfg, mesh, token_axes, ep_axis):
    """What both MoE paths on a mesh share, on this rank's (B, S, d) block
    ``x`` of the tokens (split over ``token_axes``, the same on every rank
    of ``ep_axis``): the router whole and this rank's block of E / ep
    experts of each stack (taken from the whole stack, or that block
    already), as shard_map's in_specs place them. Returns (x as (T, d),
    the routing weights and experts (T, k), the first expert of this
    rank's block, its size ``e_local``, the block's {"gate", "up", "down"}
    stacks, and ``finish(y)``: the rank's (T, d) output summed over
    ``ep_axis``, the shared expert added after the sum, as (B, S, d)).

    Gradients are the whole function's, as ``jax.grad`` through the
    reference gives them: the summed output takes an identity backward; the
    routed branch's gradients of x and of the router, partial on each
    expert rank, are summed over ``ep_axis``; the router's, the shared
    expert's and the experts' are summed over ``token_axes`` (the weights
    are replicated there); an expert stack's gradient, one block an expert
    rank, is gathered whole on every rank where the whole stack was given.
    dx stays this rank's block."""
    moe = cfg.moe
    ep = shd.axis_sizes(mesh)[ep_axis]
    e_local = moe.num_experts // ep
    if e_local * ep != moe.num_experts:
        raise ValueError(f"{moe.num_experts} experts do not divide over "
                         f"{ep_axis}={ep}")

    def experts_w(name):
        w = p[name]["w"]
        if w.shape[0] not in (moe.num_experts, e_local):
            raise ValueError(f"{name}: {w.shape[0]} experts, not the stack "
                             f"of {moe.num_experts} or its block of "
                             f"{e_local}")
        if w.shape[0] != e_local:
            w = shd.shard_of(w, mesh, ep_axis, 0)
        return {"w": shd.copy_to(w, mesh, token_axes)}

    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    xr = shd.copy_to(x2d, mesh, ep_axis)
    router = {"w": shd.copy_to(p["router"]["w"], mesh,
                               token_axes + (ep_axis,))}
    with span("moe.route"):
        weights, experts = route(router, xr, moe)
    lo = mesh.get_local_rank(ep_axis) * e_local
    local = {n: experts_w(n) for n in ("gate", "up", "down")}

    def finish(y):
        y = shd.reduce_from(y, mesh, ep_axis)
        if "shared" in p:
            shared = shd.map_tree(lambda w: shd.copy_to(w, mesh, token_axes),
                                  p["shared"])
            y = y + swiglu(shared, x2d)
        return y.reshape(b, s, d)
    return xr, weights, experts, lo, e_local, local, finish


def moe_forward_shardmap(p, x, cfg, mesh, *, dp_axes=("data",),
                         ep_axis="model"):
    """The reference's shard_map MoE. ``x``: this rank's (B, S, d) block of
    the tokens (split over ``dp_axes``, the same on every rank of
    ``ep_axis``). The experts' weights are the whole (E, ...) stacks, of
    which this rank takes its block (shard_map's in_spec), or that block
    already. Each model rank routes its token block against the full
    router and keeps the (token, k) choices that fall in its E / ep
    experts; the rest go to the phantom id. Its local capacity is
    ``max(8, capacity(T) // ep * 2)``, not rounded to 8. One all-reduce
    over ``ep_axis`` sums the ranks' outputs; the shared expert is added
    after it. Gradients: ``_on_mesh``'s."""
    xr, weights, experts, lo, e_local, local, finish = _on_mesh(
        p, x, cfg, mesh, tuple(dp_axes), ep_axis)
    ep = shd.axis_sizes(mesh)[ep_axis]
    mine = (experts >= lo) & (experts < lo + e_local)
    local_experts = torch.where(mine, experts - lo,
                                torch.full_like(experts, e_local))
    local_weights = torch.where(mine, weights, torch.zeros_like(weights))
    cap = max(8, capacity(x.shape[0] * x.shape[1], cfg.moe) // ep * 2)
    return finish(dispatch_compute_combine(
        local, xr, local_weights, local_experts, cap,
        _LocalMoE(e_local, cfg.moe.top_k)))


def moe_forward_gather_split(p, x, cfg, mesh, *, batch_axes=("data",),
                             seq_axes=(), ep_axis="model"):
    """``moe_forward_gather`` of the whole (B, S, d) input, computed by the
    ranks of ``mesh`` each on its block. ``x``: this rank's (b, s, d) block
    of the tokens, its batch split over ``batch_axes`` and its sequence
    over ``seq_axes`` (each dim evenly, the earlier axis major), the same
    on every rank of ``ep_axis``; the weights as ``moe_forward_shardmap``
    takes them.

    Every rank routes its block with the router whole. The capacity C is
    the global one, ``capacity(B * S)``, every token of the batch counted,
    pads included. An assignment's slot is its place among all assignments
    to its expert in the global flat order (batch row, position, k), the
    order the reference's stable sort gives: ``dispatch`` with each row's
    offsets (``_row_offsets``); it is kept if and only if its slot is
    below C. The (E, C, d) buffer is split over the ranks: the experts
    over ``ep_axis``, the C slots (padded to a multiple of the token ranks
    n) over the token axes, so a rank computes the SwiGLU of (E / ep, C /
    n) slots, as many as GSPMD's partition of the reference's. Each rank
    writes its kept assignments to its experts into an (E / ep, C, d)
    buffer at their global slots, zero elsewhere, and one reduce-scatter
    over the token axes (one per mesh axis) leaves each rank its C / n
    slots, each written by one rank; the slots' outputs, times their
    weights, come back by an all-gather over the token axes. These two
    move whole buffers of which a rank fills about 1 / n: the port's
    transport (GSPMD moves the rows by all-to-alls). A token's output sums
    its kept experts' rows in order of expert id on each rank, then one
    all-reduce over ``ep_axis`` sums the ranks'; the shared expert is
    added after it. Gradients: ``_on_mesh``'s, the reduce-scatter and the
    all-gather each the other's transpose; the integer slots carry
    none."""
    batch_axes, seq_axes = tuple(batch_axes), tuple(seq_axes)
    token_axes = tuple(a for a in shd.axis_names(mesh)
                       if a in batch_axes + seq_axes)
    xr, weights, experts, lo, e_local, local, finish = _on_mesh(
        p, x, cfg, mesh, token_axes, ep_axis)
    sizes = shd.axis_sizes(mesh)
    n = math.prod(sizes[a] for a in token_axes)
    b, s = x.shape[0], x.shape[1]
    cap = capacity(b * s * n, cfg.moe)
    offsets = _row_offsets(experts, cfg.moe.num_experts, mesh, batch_axes,
                           seq_axes, b, s)
    mine = (experts >= lo) & (experts < lo + e_local)
    local_experts = torch.where(mine, experts - lo,
                                torch.full_like(experts, e_local))
    # the other ranks' experts are the phantom one, all past the capacity
    offsets = torch.cat([offsets[:, lo:lo + e_local],
                         torch.full_like(offsets[:, :1], cap)], 1)
    return finish(dispatch_compute_combine(
        local, xr, weights, local_experts, cap,
        _LocalMoE(e_local, cfg.moe.top_k), offsets=offsets,
        cols=-(-cap // n) * n, mesh=mesh, token_axes=token_axes))


def _block_index(mesh, axes):
    """This rank's block along a dim split over the mesh ``axes``, the
    earlier axis major."""
    sizes, idx = shd.axis_sizes(mesh), 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _row_offsets(experts, num_experts, mesh, batch_axes, seq_axes, b, s):
    """(b, E): for each row of this rank's (b, s) block of the tokens and
    each expert, the assignments to that expert before the block's part of
    the row in the global flat order (batch row, position, k): those in
    every earlier row and in the row's earlier sequence blocks. Read from
    a table of counts per (row, sequence block, expert) gathered over the
    token axes (int32: 4 B x B x n_seq x E)."""
    k = experts.shape[1]
    row = torch.arange(b * s * k, device=experts.device) // (s * k)
    key = row * num_experts + experts.reshape(-1)
    counts = torch.zeros(b * num_experts, dtype=torch.int32,
                         device=experts.device).index_add_(
        0, key, torch.ones_like(key, dtype=torch.int32))
    table = shd.all_gather(counts.view(b, 1, num_experts), mesh, seq_axes, 1)
    table = shd.all_gather(table, mesh, batch_axes, 0).long()
    flat = table.reshape(-1, num_experts)
    before = (torch.cumsum(flat, 0) - flat).view(table.shape)
    r0 = _block_index(mesh, batch_axes) * b
    return before[r0:r0 + b, _block_index(mesh, seq_axes)]


def _on_blocks(p, x, cfg, impl):
    """The MoE path ``impl`` ("shardmap": ``moe_forward_shardmap``, else
    ``moe_forward_gather_split``) on each rank's blocks of DTensors
    (``sharding.on_blocks``). Its expert axis is the mesh axis that splits
    the expert stacks (``model``; ``data`` in the ZeRO-3 prefill), else
    ``model``; its token axes are the others that split x's batch or
    sequence, whose splits are kept (x is gathered along the expert axis
    and every other); the stacks are split over the expert axis alone and
    the router is whole, as shard_map's in_specs place them. Its
    collectives make each block's gradient whole over the axes it is
    replicated on, as those placements declare. The shared expert runs on
    the DTensors beside it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = shd.axis_names(mesh)
    split = [i for i, pl in enumerate(p["gate"]["w"].placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    ep = split[0] if len(split) == 1 else names.index("model")
    x_pl = [pl if i != ep and isinstance(pl, Shard) and pl.dim in (0, 1)
            else Replicate() for i, pl in enumerate(x.placements)]
    along = {dim: tuple(names[i] for i, pl in enumerate(x_pl)
                        if isinstance(pl, Shard) and pl.dim == dim)
             for dim in (0, 1)}
    stacks = ("gate", "up", "down")

    def local(xl, router, *ws):
        lp = {"router": {"w": router}}
        lp.update({n: {"w": w} for n, w in zip(stacks, ws)})
        if impl == "shardmap":
            return moe_forward_shardmap(
                lp, xl, cfg, mesh, ep_axis=names[ep],
                dp_axes=tuple(a for a in names if a in along[0] + along[1]))
        return moe_forward_gather_split(lp, xl, cfg, mesh,
                                        batch_axes=along[0],
                                        seq_axes=along[1],
                                        ep_axis=names[ep])
    w_pl = shd.placements((names[ep], None, None), mesh)
    y = shd.on_blocks(
        local, (x, p["router"]["w"]) + tuple(p[n]["w"] for n in stacks),
        (x_pl, shd.placements((None, None), mesh)) + (w_pl,) * 3, x_pl)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    return y
