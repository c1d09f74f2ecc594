"""Engine (``engine/engine.py``): the mean time of a decode tick in the
window, from the engine's own counters (``stats["decode_s"]`` over
``stats["decode_steps"]``; each tick ends at a host read of its tokens).
Moves ``serve_tok_s``."""


def read(run):
    stats = run.get("stats")
    if not stats or not stats["decode_steps"]:
        return None
    return 1e3 * stats["decode_s"] / stats["decode_steps"]
