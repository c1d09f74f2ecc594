"""Engine scheduler (``engine/engine.py``): the mean time a request waited
in the ``ContinuousBatcher``'s queue, from its submission to its insert
into a slot, over the requests inserted in the window (the engine's
``stats["queue_wait_s"]`` over ``stats["queued"]``). Moves
``request_p95_s``."""


def read(run):
    stats = run.get("stats")
    if not stats or not stats.get("queued"):
        return None
    return 1e3 * stats["queue_wait_s"] / stats["queued"]
