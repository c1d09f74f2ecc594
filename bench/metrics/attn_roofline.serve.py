"""Kernels (``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``
through ``kernels/ops.py``): the attention kernels' share of their
roofline in the serving window, the sum of each call's least time over
the sum of their device time. Each prefill and tick makes one call in
each of the architecture's attention layers (``flops.counts``); a call's
shape comes from the host's lengths: a prefill at its padded length,
causal; a tick over each slot's valid cache rows (one for a parked
slot). Least time and fp32's peak of 495 TFLOP/s: ``bench/flops.py``.
Moves ``serve_tok_s``."""
from bench import flops

KERNELS = ("flash_fwd", "decode_kernel")
OPS = ("flash_attention", "decode_attention")


def read(run):
    trace = run.get("trace")
    if trace is None or run.get("kind") != "serve" or not run["tick_lens"]:
        return None
    cfg, dtype = run["cfg"], run["mix"]["dtype"]
    layers = flops.counts(cfg)["attn_layers"]
    device_us = sum(t - s for s, t, n in trace["device"]
                    if any(k in n for k in KERNELS))
    launched = sum(run["launches"].get(op, 0) for op in OPS)
    if launched and not device_us:
        raise RuntimeError("attn_roofline.serve: the attention ops launched "
                           f"{launched} times and no device kernel matched "
                           f"{KERNELS}")
    want = layers * (len(run["prefill_lens"]) + len(run["tick_lens"]))
    if launched != want:
        raise RuntimeError(f"attn_roofline.serve: {launched} attention "
                           f"launches, the host's lengths give {want}")
    least = sum(flops.least_time(*flops.flash_fwd_cost(cfg, 1, n, dtype,
                                                       False), dtype)
                for n in run["prefill_lens"])
    least += sum(flops.least_time(*flops.decode_cost(
        cfg, [max(n, 1) for n in lens], dtype), dtype)
        for lens in run["tick_lens"])
    return 100.0 * layers * least / (device_us / 1e6)
