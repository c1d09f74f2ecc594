"""The serving model step as a whole: model FLOPs of the window's prefills
(each at its padded length) and decode ticks (a row for each active slot,
attending its valid cache rows), counted by ``bench/flops.py`` from the
host's lengths, over the window, against 495 TFLOP/s: the H100's TF32
peak, the fastest it multiplies fp32 operands. Moves ``serve_tok_s``."""
from bench import flops


def read(run):
    if run.get("kind") != "serve" or not run["tick_lens"]:
        return None
    cfg = run["cfg"]
    total = sum(flops.prefill_flops(cfg, n) for n in run["prefill_lens"])
    total += sum(flops.tick_flops(cfg, [n for n in lens if n])
                 for lens in run["tick_lens"])
    return 100.0 * total / run["window_s"] / flops.PEAK_FLOPS[
        run["mix"]["dtype"]]
