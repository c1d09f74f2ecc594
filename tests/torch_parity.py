"""Helpers shared by the port's parity tests: carry a JAX Param tree and
arrays over to torch through numpy; a time limit for tests that wait on
threads or processes."""
import contextlib
import faulthandler
import signal

import numpy as np


@contextlib.contextmanager
def time_limit(seconds, grace_s=60):
    """Fail a test that runs past ``seconds`` instead of letting it hang: an
    alarm raises ``TimeoutError`` in the test (which runs in the main
    thread). A deadlocked dispatcher's pool threads would keep the process
    from exiting, so the alarm also sets the process to print every
    thread's stack and exit ``grace_s`` later."""
    def expire(signum, frame):
        faulthandler.dump_traceback_later(grace_s, exit=True)
        raise TimeoutError(f"the test ran past its limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def flatten_params(tree, prefix=()):
    """repro Param tree -> {"a/b/c": (numpy array, axes)}."""
    from repro.models import common as cm
    if cm.is_param(tree):
        return {"/".join(prefix): (np.asarray(tree.value), tree.axes)}
    flat = {}
    for k, v in tree.items():
        flat.update(flatten_params(v, prefix + (k,)))
    return flat


def to_torch(x, dtype=None):
    import torch
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)
