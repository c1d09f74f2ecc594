"""Gradient compression: blockwise int8 quantization with a per-block fp32
scale (``repro.training.compression``), the error model of an
int8-compressed all-reduce. ``compress_decompress`` quantizes and
dequantizes each gradient leaf in place of the reduction. The compressed
all-reduce itself (``compressed_psum``) waits for the port's mesh slice."""
from __future__ import annotations

import torch

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


def compressed_psum(x, axis_name):
    """The int8-compressed all-reduce across a mesh axis."""
    raise NotImplementedError(
        "compressed_psum runs inside a collective across cards: it waits "
        "for the port's mesh slice")
