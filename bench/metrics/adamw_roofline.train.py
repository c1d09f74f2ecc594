"""Optimizer (``training/optimizer.py`` ``apply_updates`` through
``csrc/adamw.cu``): AdamW's share of its roofline in the training window.
The least time of the window's steps, 32 bytes a parameter (the norm reads
each gradient once; the update reads p, g, m and v and writes p, m and v)
over 3.35 TB/s, against the summed device time of the kernels named
``adamw_sumsq...`` and ``adamw_update...``. 32 bytes is the least any
implementation moves, so the share cannot pass 100%. None where the window
launched no ``adamw`` op (an optimizer of PyTorch's own elementwise ops).
Moves ``train_tok_s``."""
from bench import flops

KERNELS = ("adamw_sumsq", "adamw_update")
BYTES_PER_PARAM = 32


def params(cfg) -> int:
    """The configuration's parameters, as its architecture counts them
    (``flops.counts``)."""
    return flops.counts(cfg)["params"]


def read(run):
    trace = run.get("trace")
    if trace is None or run.get("kind") != "train" or not run["steps"] \
            or not run["launches"].get("adamw"):
        return None
    device_us = sum(t - s for s, t, n in trace["device"]
                    if any(k in n for k in KERNELS))
    if not device_us:
        raise RuntimeError("adamw_roofline.train: the adamw ops launched and "
                           f"no device kernel matched {KERNELS}")
    least = (run["steps"] * BYTES_PER_PARAM * params(run["cfg"])
             / flops.HBM_BYTES_S)
    return 100.0 * least / (device_us / 1e6)
