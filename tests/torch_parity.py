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


def model_pair(arch, key=0, **reduce_kw):
    """The JAX model ``reduced(arch, **reduce_kw)`` with ``PRNGKey(key)``
    weights and the port's, the weights carried over by
    ``repro_torch.convert``: (jcfg, jbundle, jparams, cfg, bundle,
    params)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import registry as jregistry
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import registry
    jcfg = jreduced(jget_config(arch), **reduce_kw)
    jbundle = jregistry.build(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(key))
    cfg = reduced(get_config(arch), **reduce_kw)
    params = convert.params_from_numpy(flatten_params(jparams), device="cpu")
    return jcfg, jbundle, jparams, cfg, registry.build(cfg), params


def random_tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s),
                                                dtype=np.int32)


def greedy_decode(bundle, params, prompt, max_len):
    """Prefill ``prompt`` (1, S) and decode greedily up to ``max_len``
    positions in fp32; returns (the decode steps' logits, the full token
    sequence they were fed)."""
    import torch
    logits, cache = bundle.prefill(params, {"tokens": prompt},
                                   max_len=max_len, dtype=torch.float32)
    toks = [int(logits[0, -1].argmax())]
    dec = []
    for _ in range(max_len - prompt.shape[1] - 1):
        lg, cache = bundle.decode_step(params, cache,
                                       torch.tensor([[toks[-1]]]),
                                       dtype=torch.float32)
        dec.append(lg[0, 0])
        toks.append(int(lg[0, 0].argmax()))
    full = torch.cat([prompt, torch.tensor([toks[:-1]], dtype=prompt.dtype)],
                     dim=1)
    return dec, full


def greedy_engines(jbundle, jparams, bundle, params, prompts, *, max_len=96,
                   n_slots=2, max_new=24):
    """The prompts through the JAX engine and the port's (CPU), each behind
    a ContinuousBatcher; returns (JAX's finished requests, the port's)."""
    from repro.engine import ContinuousBatcher as JBatcher
    from repro.engine import GenerationEngine as JEngine
    from repro_torch.engine import ContinuousBatcher, GenerationEngine
    jcb = JBatcher(JEngine(jbundle, jparams, max_len=max_len,
                           n_slots=n_slots))
    cb = ContinuousBatcher(GenerationEngine(bundle, params, max_len=max_len,
                                            n_slots=n_slots, device="cpu"))
    for p in prompts:
        jcb.submit(p, max_new_tokens=max_new)
        cb.submit(p, max_new_tokens=max_new)
    return jcb.run(), cb.run()
