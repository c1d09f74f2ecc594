"""Public kernel entry points of the port: attention in the model layout,
the SSD scan, and cosine similarity.

Signatures follow ``repro.kernels.ops``: q (B, Sq, Hq, D), k/v (B, Sk,
Hkv, D); dx (B, S, H, P), dA (B, S, H), B/C (B, S, G, N); a (M, D), b (M, D)
or (N, D). Dispatch is by device: a CPU tensor goes to the kernel's plain
version, a CUDA tensor to the Hopper kernel, which raises on what it cannot
take. The JAX wrappers pad to block multiples and slice back; the Hopper
kernels mask their ragged edges themselves, so the only pad rules carried
over are the ones that change the answer: a causal query block sits at
``q_offset = Sk - Sq`` (prefill continuation) and keys at or beyond the
unpadded ``Sk`` are masked. Attention and the SSD scan go through
``kernels.sharded``, which runs each rank's kernel on its block of DTensor
inputs (a layer run sharded) and passes plain tensors straight on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, sharded
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import similarity as sim_mod
from repro_torch.kernels import ssd_scan as ssd_mod

# each kernel's launch count, by kernel name
_KERNELS = {"flash_attention": fa_mod.stats,
            "flash_attention_bwd": fa_mod.bwd_stats,
            "decode_attention": dec_mod.stats,
            "rowwise_cosine": sim_mod.stats,
            "cosine_matrix": sim_mod.matrix_stats, "ssd_scan": ssd_mod.stats,
            "ssd_scan_bwd": ssd_mod.bwd_stats, "adamw": adamw_mod.stats}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: st["launches"] for name, st in _KERNELS.items()}


def reset_launch_counts() -> None:
    with _build.LAUNCH_LOCK:
        for st in _KERNELS.values():
            st["launches"] = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D).
    Returns (B, Sq, Hq, D). Differentiable on both devices: on the card
    through the backward kernel (``flash_attention.attention``), on the CPU
    by autograd of the plain version."""
    window = int(window)

    def local(q, k, v, q_offset, sk_valid):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  sk_valid=sk_valid)
        if q.is_cuda:
            return fa_mod.attention(q, k, v, **kw)
        return fa_mod.plain(q, k, v, **kw)
    return sharded.flash(q, k, v, causal=causal, window=window, fn=local)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Model layout: q (B, 1, Hq, D); caches (B, S, Hkv, D); cache_len int
    or (B,) count of valid entries per sequence; ``window > 0`` attends to
    the last ``window`` of them only. Returns (B, 1, Hq, D)."""
    return sharded.decode(q, k_cache, v_cache, cache_len,
                          fn=lambda *a: _decode(*a, window=window))


def _decode(q, k_cache, v_cache, cache_len, *, window):
    if not q.is_cuda:
        return dec_mod.plain(q, k_cache, v_cache, cache_len, window=window)
    lens = cache_len
    # the engine's tick passes (B,) int32 lengths on the card, taken as
    # they are; anything else is made so
    if not (isinstance(lens, torch.Tensor) and lens.dtype == torch.int32
            and lens.shape == (q.shape[0],) and lens.device == q.device
            and lens.is_contiguous()):
        lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
        lens = lens.reshape(-1).expand(q.shape[0]).contiguous()
    return dec_mod.decode_attention(q, k_cache, v_cache, lens, window=window)


def rowwise_cosine(a, b):
    """Aligned pairs (M, D), (M, D) -> (M,) fp32 cosine (rows
    pre-normalized); b may be one (D,) row read against every row of a."""
    if a.is_cuda:
        return sim_mod.rowwise_cosine(a, b)
    return sim_mod.plain(a, b)


def ssd_scan(dx, dA, B, C, initial_state=None, *, chunk: int = 0):
    """dx (B, S, H, P); dA (B, S, H); B/C (B, S, G, N). Returns (y,
    final_state (B, H, N, P) fp32). The plain version takes the JAX chunk
    rule (``chunk`` or min(256, S), halved until it divides S); the kernel
    takes any S with its own chunk, and ignores ``chunk``. Differentiable
    on both devices: on the card through the backward kernel
    (``ssd_scan.scan``), on the CPU by autograd of the plain version."""
    return sharded.ssd(dx, dA, B, C, initial_state,
                       fn=lambda *a: _ssd(*a, chunk=chunk))


def _ssd(dx, dA, B, C, initial_state, *, chunk):
    if dx.is_cuda:
        return ssd_mod.scan(dx, dA, B, C, initial_state)
    return ssd_mod.plain(dx, dA, B, C, initial_state,
                         chunk=ssd_mod.model_chunk(dx.shape[1], chunk))


def cosine_matrix(a, b):
    """(M, D) x (N, D) -> (M, N) fp32 cosine (rows pre-normalized)."""
    if a.is_cuda:
        return sim_mod.cosine_matrix(a, b)
    return sim_mod.plain_matrix(a, b)
