"""The port's serving engine: greedy tokens equal to the JAX engine's on the
same weights, and the scheduler cases of ``tests/test_engine.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.engine import ContinuousBatcher as JBatcher  # noqa: E402
from repro.engine import GenerationEngine as JEngine  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.engine import ContinuousBatcher, GenerationEngine  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from torch_parity import flatten_params  # noqa: E402


@pytest.fixture(scope="module")
def served():
    """The JAX bundle and PRNGKey(0) weights, and the port's bundle with the
    same weights carried over."""
    jcfg = jreduced(jget_config("qwen2-0.5b"))
    jbundle = jregistry.build(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = registry.build(reduced(get_config("qwen2-0.5b")))
    params = convert.params_from_numpy(flatten_params(jparams), device="cpu")
    return jbundle, jparams, bundle, params


def engine(bundle, params, **kw):
    return GenerationEngine(bundle, params, device="cpu", **kw)


def gen_sequential(bundle, params, prompt, max_new, max_len=96):
    """Reference: single-request engine (n_slots=1)."""
    cb = ContinuousBatcher(engine(bundle, params, max_len=max_len, n_slots=1))
    rid = cb.submit(prompt, max_new_tokens=max_new)
    return cb.run()[rid].output_ids


def test_greedy_tokens_equal_jax_engine(served):
    """Prompt lengths 16 (a multiple of PREFILL_ALIGN) and 7, 12, 30, 45
    (not): in the reference the first token comes from the last padded
    position, and the port must do the same."""
    jbundle, jparams, bundle, params = served
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29,
               "semantic query number 4 about movies"]
    jcb = JBatcher(JEngine(jbundle, jparams, max_len=64, n_slots=2))
    cb = ContinuousBatcher(engine(bundle, params, max_len=64, n_slots=2))
    for p in prompts:
        jcb.submit(p, max_new_tokens=10)
        cb.submit(p, max_new_tokens=10)
    want, got = jcb.run(), cb.run()
    assert sorted(len(r.prompt_ids) for r in got.values()) == [7, 12, 16, 30,
                                                               37]
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_continuous_batching_matches_sequential(served):
    bundle, params = served[2:]
    prompts = [f"semantic query number {i} about movies" for i in range(5)]
    want = [gen_sequential(bundle, params, p, 8) for p in prompts]
    cb = ContinuousBatcher(engine(bundle, params, max_len=96, n_slots=3))
    rids = [cb.submit(p, max_new_tokens=8) for p in prompts]
    got = cb.run()
    for rid, w in zip(rids, want):
        assert got[rid].output_ids == w, rid


def test_more_requests_than_slots(served):
    bundle, params = served[2:]
    eng = engine(bundle, params, max_len=64, n_slots=2)
    cb = ContinuousBatcher(eng)
    rids = [cb.submit(f"req {i}", max_new_tokens=5) for i in range(9)]
    finished = cb.run()
    assert len(finished) == 9
    assert all(len(finished[r].output_ids) == 5 for r in rids)
    assert eng.stats["prefills"] == 9


def test_occupancy_improves_with_load(served):
    bundle, params = served[2:]
    eng1 = engine(bundle, params, max_len=64, n_slots=4)
    cb1 = ContinuousBatcher(eng1)
    cb1.submit("only one request", max_new_tokens=6)
    cb1.run()
    eng2 = engine(bundle, params, max_len=64, n_slots=4)
    cb2 = ContinuousBatcher(eng2)
    for i in range(12):
        cb2.submit(f"request {i}", max_new_tokens=6)
    cb2.run()
    assert eng2.occupancy > eng1.occupancy


def test_max_len_respected(served):
    bundle, params = served[2:]
    cb = ContinuousBatcher(engine(bundle, params, max_len=48, n_slots=1))
    rid = cb.submit("x" * 200, max_new_tokens=64)    # prompt+gen > max_len
    req = cb.run()[rid]
    assert len(req.prompt_ids) + len(req.output_ids) <= 48


def test_temperature_sampling_differs(served):
    bundle, params = served[2:]
    outs = []
    for seed in (0, 9):
        cb = ContinuousBatcher(engine(bundle, params, max_len=64, n_slots=1))
        rid = cb.submit("hello", max_new_tokens=12, temperature=1.5)
        outs.append(cb.run(torch.Generator().manual_seed(seed))[rid].output_ids)
    assert outs[0] != outs[1]


def test_serve_main_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    finished = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                           "--slots", "2", "--max-new", "4"])
    assert len(finished) == 3
    assert all(len(r.output_ids) == 4 for r in finished.values())
    out = capsys.readouterr().out
    assert "new tok/s" in out and "p99=" in out and "device=cpu" in out
