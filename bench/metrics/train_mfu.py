"""The train step as a whole: model FLOPs a step (``bench/flops.py``: 6
FLOPs a matmul parameter and token, and causal attention; recomputation not
counted) times the steps of the window, over the window, against the
H100's bf16 peak of 989 TFLOP/s. Moves ``train_tok_s``."""
from bench import flops


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    mix = run["mix"]
    per_step = flops.train_step_flops(run["cfg"], mix["batch"], mix["seq"])
    return 100.0 * per_step * run["steps"] / run["window_s"] / \
        flops.PEAK_FLOPS[mix["dtype"]]
