"""Train step: device milliseconds a step in kernels that are neither
products (cuBLAS GEMMs), nor the port's own kernels, nor collectives:
elementwise work, the zero-gradient adds of each layer's views of the
stacked weights, the embedding's gradient, AdamW. Read from the traced
window's device kernels by name (the classification of the repository's
``chip_smoke.profiled``). Moves ``train_tok_s``."""
PORT = ("flash_fwd", "decode_kernel", "bwd_delta", "bwd_dq_", "bwd_dkdv_",
        "ssd_scan_kernel", "bwd_walk", "bwd_chunk", "bwd_group_sum",
        "rowwise_", "matrix_kernel")
GEMM = ("gemm", "gemv", "nvjet", "xmma")


def kind(name: str) -> str:
    low = name.lower()
    if any(k in name for k in PORT):
        return "port"
    if any(k in low for k in GEMM):
        return "matmul"
    if "nccl" in low:
        return "collective"
    return "other"


def read(run):
    trace = run.get("trace")
    if trace is None or run.get("kind") != "train" or not run["steps"]:
        return None
    other = sum(t - s for s, t, n in trace["device"] if kind(n) == "other")
    return other / 1e3 / run["steps"]
