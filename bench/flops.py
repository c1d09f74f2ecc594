"""The benchmark's own count of the work: model FLOPs of a prefill, a
decode tick and a training step, and the operations and bytes of each
attention kernel call, from the architecture's counts (its reference's
``counts``) and the call's shapes. Peaks are the published dense rates of
one H100 SXM (NVIDIA's data sheet, at the full 700 W): the figures a share
of a peak or of a roofline is held against.

Attention counts the (query, key) pairs it attends, not the tiles a
kernel visits: causal over S rows is S (S + 1) / 2 pairs. A kernel's bytes
count each input read once and each output written once, and of a decode
call only the valid cache rows.
"""
from __future__ import annotations

from bench import spec

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}   # bf16; TF32 for fp32
HBM_BYTES_S = 3.35e12
ELEM = {"bfloat16": 2, "float32": 4}


def counts(cfg) -> dict:
    """The architecture's counts, as its reference's ``counts(cfg)`` gives
    them (``bench/reference/__init__.py``): what a layer holds belongs to
    the architecture, not to this file."""
    return spec.reference(cfg).counts(cfg)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attn_flops(cfg, pairs: int) -> float:
    """Forward attention of every attention layer over ``pairs`` pairs: Q
    K^T and P V, 2 FLOPs a pair, head and qk or v head dim."""
    c = counts(cfg)
    return (2.0 * c["attn_layers"] * c["heads"]
            * (c["qk_head_dim"] + c["v_head_dim"]) * pairs)


def prefill_flops(cfg, padded: int) -> float:
    """A prefill of ``padded`` rows at B = 1; the unembedding of the last
    row only, as the engine reads only that one."""
    c = counts(cfg)
    return (2.0 * c["matmul_params"] * padded
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
            + attn_flops(cfg, causal_pairs(padded))
            + c["mixer_flops"] * padded)


def tick_flops(cfg, active_lens) -> float:
    """A decode tick's useful work: one row for each active slot, each
    attending its valid cache rows."""
    c = counts(cfg)
    rows = len(active_lens)
    per_row = c["matmul_params"] + cfg["hidden_size"] * cfg["vocab_size"]
    return (2.0 * per_row * rows + attn_flops(cfg, sum(active_lens))
            + c["mixer_flops"] * rows)


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Forward and backward, 3x the forward: 6 FLOPs a matmul parameter and
    token, causal attention and the other mixers; recomputation not
    counted."""
    c = counts(cfg)
    matmul = c["matmul_params"] + cfg["hidden_size"] * cfg["vocab_size"]
    return (6.0 * matmul * batch * seq
            + 3.0 * batch * attn_flops(cfg, causal_pairs(seq))
            + 3.0 * c["mixer_flops"] * batch * seq)


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline's bound: the larger of operations over the peak and
    bytes over HBM bandwidth, in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S)


def _heads(cfg):
    """An attention layer's (heads, KV heads, qk head dim, v head dim)."""
    c = counts(cfg)
    return c["heads"], c["kv_heads"], c["qk_head_dim"], c["v_head_dim"]


def flash_fwd_cost(cfg, batch: int, seq: int, dtype: str, lse: bool):
    """(FLOPs, bytes) of one layer's causal flash forward over (batch,
    seq): read q, k, v, write o (and each row's fp32 log-sum-exp)."""
    h, kv, qk, v = _heads(cfg)
    flops = 2.0 * batch * h * (qk + v) * causal_pairs(seq)
    nbytes = ELEM[dtype] * batch * seq * (h * qk + kv * qk + kv * v + h * v)
    return flops, nbytes + (4 * batch * h * seq if lse else 0)


def flash_bwd_cost(cfg, batch: int, seq: int, dtype: str):
    """(FLOPs, bytes) of one layer's causal flash backward: Q K^T again,
    dP = dO V^T, dV, dQ and dK, 2 FLOPs a pair and head for each of their
    (3 qk + 2 v) head dims; read q, k, v, o, dO and the log-sum-exp, write
    dQ, dK, dV."""
    h, kv, qk, v = _heads(cfg)
    flops = 2.0 * batch * h * (3 * qk + 2 * v) * causal_pairs(seq)
    nbytes = (ELEM[dtype] * batch * seq * (h * qk + kv * qk + kv * v
                                           + 2 * h * v)
              + 4 * batch * h * seq
              + ELEM[dtype] * batch * seq * (h * qk + kv * qk + kv * v))
    return flops, nbytes


def decode_cost(cfg, lens, dtype: str):
    """(FLOPs, bytes) of one layer's decode attention over slots whose
    valid cache rows are ``lens``: read each valid K and V row, q and the
    lengths, write o."""
    h, kv, qk, v = _heads(cfg)
    rows = sum(lens)
    flops = 2.0 * h * (qk + v) * rows
    nbytes = (ELEM[dtype] * (kv * (qk + v) * rows + len(lens) * h * (qk + v))
              + 4 * len(lens))
    return flops, nbytes
