"""Gradient compression: blockwise int8 quantization with a per-block fp32
scale (``repro.training.compression``), the error model of an
int8-compressed all-reduce. ``compress_decompress`` quantizes and
dequantizes each gradient leaf in place of the reduction;
``compressed_psum`` is the compressed all-reduce itself, over a process
group (a mesh axis's: ``mesh.get_group("data")``)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import tree_map

BLOCK = 256


def _quant(g):
    """(int8 blocks (n, BLOCK), fp32 scales (n, 1)): each block's values
    over its max |value| / 127, rounded half to even and clipped to ±127."""
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def _dequant(q, scale, shape):
    deq = (q.float() * scale).reshape(-1)
    return deq[:_size(shape)].reshape(shape)


def _size(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def compress_decompress(grads):
    """Quantize -> dequantize each gradient leaf (error model of the int8
    all-reduce)."""
    def leaf(g):
        q, scale = _quant(g)
        return _dequant(q, scale, g.shape).to(g.dtype)
    return tree_map(leaf, grads)


def compressed_psum(x, group=None):
    """The reference's int8-compressed psum over ``group``: quantize
    locally, all-reduce the int8 values as int32, sum the scales, divide
    them by the group's size, dequantize. So the result is the summed
    integers times the *mean* of the ranks' scales, not the sum of each
    rank's dequantized values (the reference's arithmetic, kept). The
    integers' sum is exact in any order; the scales are gathered and summed
    in rank order, as the reference's psum sums them on the CPU, so the
    result is the same bits whatever order the backend reduces in. Over a
    group of one it is ``compress_decompress`` bit for bit."""
    q, scale = _quant(x)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    scales = [torch.empty_like(scale)
              for _ in range(dist.get_world_size(group))]
    dist.all_gather(scales, scale, group=group)
    ssum = scales[0]
    for s in scales[1:]:
        ssum = ssum + s
    deq = (qsum.float() * (ssum / float(len(scales)))).reshape(-1)
    return deq[:_size(x.shape)].reshape(x.shape).to(x.dtype)
