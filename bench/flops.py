"""The benchmark's own count of the work: model FLOPs of a prefill, a
decode tick and a training step, and the operations and bytes of each
attention kernel call, from the configuration's dims and the call's
shapes. Peaks are the published dense rates of one H100 SXM (NVIDIA's data
sheet, at the full 700 W): the figures a share of a peak or of a roofline
is held against.

Attention counts the (query, key) pairs it attends, not the tiles a
kernel visits: causal over S rows is S (S + 1) / 2 pairs. A kernel's bytes
count each input read once and each output written once, and of a decode
call only the valid cache rows.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}   # bf16; TF32 for fp32
HBM_BYTES_S = 3.35e12
ELEM = {"bfloat16": 2, "float32": 4}


def dims(cfg):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return d, h, cfg["num_key_value_heads"], cfg.get("head_dim") or d // h


def layer_matmul_params(cfg) -> int:
    """One layer's parameters that a token meets in products: the
    projections, and the feed-forward (a MoE's router and top-k experts)."""
    d, h, kv, hd = dims(cfg)
    attn = d * hd * (2 * h + 2 * kv)
    if "num_local_experts" in cfg:
        ffn = (d * cfg["num_local_experts"]
               + cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attn_flops(cfg, pairs: int) -> float:
    """Forward attention of every layer over ``pairs`` pairs: Q K^T and
    P V, 4 FLOPs a pair, head and head dim."""
    _, h, _, hd = dims(cfg)
    return 4.0 * cfg["num_hidden_layers"] * h * hd * pairs


def prefill_flops(cfg, padded: int) -> float:
    """A prefill of ``padded`` rows at B = 1; the unembedding of the last
    row only, as the engine reads only that one."""
    return (2.0 * cfg["num_hidden_layers"] * layer_matmul_params(cfg) * padded
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
            + attn_flops(cfg, causal_pairs(padded)))


def tick_flops(cfg, active_lens) -> float:
    """A decode tick's useful work: one row for each active slot, each
    attending its valid cache rows."""
    rows = len(active_lens)
    per_row = (cfg["num_hidden_layers"] * layer_matmul_params(cfg)
               + cfg["hidden_size"] * cfg["vocab_size"])
    return 2.0 * per_row * rows + attn_flops(cfg, sum(active_lens))


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Forward and backward, 3x the forward: 6 FLOPs a matmul parameter and
    token, and causal attention; recomputation not counted."""
    matmul = (cfg["num_hidden_layers"] * layer_matmul_params(cfg)
              + cfg["hidden_size"] * cfg["vocab_size"])
    return (6.0 * matmul * batch * seq
            + 3.0 * batch * attn_flops(cfg, causal_pairs(seq)))


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline's bound: the larger of operations over the peak and
    bytes over HBM bandwidth, in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S)


def flash_fwd_cost(cfg, batch: int, seq: int, dtype: str, lse: bool):
    """(FLOPs, bytes) of one layer's causal flash forward over (batch,
    seq): read q, k, v, write o (and each row's fp32 log-sum-exp)."""
    _, h, kv, hd = dims(cfg)
    flops = 4.0 * batch * h * hd * causal_pairs(seq)
    nbytes = ELEM[dtype] * batch * seq * hd * (2 * h + 2 * kv)
    return flops, nbytes + (4 * batch * h * seq if lse else 0)


def flash_bwd_cost(cfg, batch: int, seq: int, dtype: str):
    """(FLOPs, bytes) of one layer's causal flash backward: Q K^T again,
    dP = dO V^T, dV, dQ and dK, 10 FLOPs a pair, head and head dim; read q,
    k, v, o, dO and the log-sum-exp, write dQ, dK, dV."""
    _, h, kv, hd = dims(cfg)
    flops = 10.0 * batch * h * hd * causal_pairs(seq)
    nbytes = (ELEM[dtype] * batch * seq * hd * (3 * h + 2 * kv)
              + 4 * batch * h * seq
              + ELEM[dtype] * batch * seq * hd * (h + 2 * kv))
    return flops, nbytes


def decode_cost(cfg, lens, dtype: str):
    """(FLOPs, bytes) of one layer's decode attention over slots whose
    valid cache rows are ``lens``: read each valid K and V row, q and the
    lengths, write o."""
    _, h, kv, hd = dims(cfg)
    rows = sum(lens)
    flops = 4.0 * h * hd * rows
    nbytes = (ELEM[dtype] * (2 * kv * hd * rows + 2 * len(lens) * h * hd)
              + 4 * len(lens))
    return flops, nbytes
