"""Device (H100): the share of the traced train window in which no
kernel or copy ran on the card, one minus the union of its device
intervals over the window. Moves train_tok_s."""
from bench import tracing as tr


def read(run):
    trace = run.get("trace")
    if trace is None or run.get("kind") != "train":
        return None
    lo, hi = trace["window"]
    return 100.0 * (1.0 - tr.busy_us(trace["device"]) / (hi - lo))
