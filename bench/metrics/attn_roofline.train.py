"""Kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``
through ``kernels/ops.py``): the flash forward's and backward's share of
their roofline in the training window, the sum of each launch's least time
over the sum of their device time. Each launch is a layer of the cell's
(batch, seq), causal; the forward writes each row's log-sum-exp and runs
twice a layer and step (the backward recomputes each layer). Least time and
bf16's peak of 989 TFLOP/s: ``bench/flops.py``. Moves ``train_tok_s``."""
from bench import flops

KERNELS = ("flash_fwd", "bwd_delta", "bwd_dq_", "bwd_dkdv_")


def read(run):
    trace = run.get("trace")
    if trace is None or run.get("kind") != "train" or not run["steps"]:
        return None
    cfg, mix = run["cfg"], run["mix"]
    fwd = run["launches"].get("flash_attention", 0)
    bwd = run["launches"].get("flash_attention_bwd", 0)
    device_us = sum(t - s for s, t, n in trace["device"]
                    if any(k in n for k in KERNELS))
    if (fwd or bwd) and not device_us:
        raise RuntimeError("attn_roofline.train: the flash ops launched and "
                           f"no device kernel matched {KERNELS}")
    b, s, dtype = mix["batch"], mix["seq"], mix["dtype"]
    least = (fwd * flops.least_time(*flops.flash_fwd_cost(cfg, b, s, dtype,
                                                          True), dtype)
             + bwd * flops.least_time(*flops.flash_bwd_cost(cfg, b, s,
                                                            dtype), dtype))
    return 100.0 * least / (device_us / 1e6)
