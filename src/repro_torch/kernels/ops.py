"""Public attention entry points of the port, in the model layout.

Signatures follow ``repro.kernels.ops``: q (B, Sq, Hq, D), k/v (B, Sk,
Hkv, D). Dispatch is by device: a CPU tensor goes to the kernel's plain
version, a CUDA tensor to the Hopper kernel, which raises on what it cannot
take. The JAX wrappers pad to block multiples and slice back; the Hopper
kernels mask their ragged edges themselves, so the only pad rules carried
over are the ones that change the answer: a causal query block sits at
``q_offset = Sk - Sq`` (prefill continuation) and keys at or beyond the
unpadded ``Sk`` are masked.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod

_KERNELS = {"flash_attention": fa_mod, "decode_attention": dec_mod}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: mod.stats["launches"] for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.stats["launches"] = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D).
    Returns (B, Sq, Hq, D)."""
    sq, sk = q.shape[1], k.shape[1]
    kw = dict(causal=causal, window=int(window),
              q_offset=(sk - sq) if causal else 0, sk_valid=sk)
    if q.is_cuda:
        return fa_mod.flash_attention(q, k, v, **kw)
    return fa_mod.plain(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Model layout: q (B, 1, Hq, D); caches (B, S, Hkv, D); cache_len int
    or (B,) count of valid entries per sequence. Returns (B, 1, Hq, D)."""
    if not q.is_cuda:
        return dec_mod.plain(q, k_cache, v_cache, cache_len)
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    lens = lens.reshape(-1).expand(q.shape[0]).contiguous()
    return dec_mod.decode_attention(q, k_cache, v_cache, lens)
