"""The port's semantic path against the JAX package's, on the CPU.

(a) every workload query of the three datasets through the executor over
    simulated backends, and one optimizer run per dataset;
(b) the same with the tier-0 embedding cascade, whose scores come from the
    port's row-wise cosine (plain version here) and from the Pallas kernel
    in interpret mode;
(c) ``TorchBackend`` against ``JAXBackend``: the same reduced qwen2 weights
    served by both engines, answers parsed from the generated text;
(d) ``serve.main`` in streaming semantic mode with the cascade;
(e) the flags the port does not serve yet are refused.

Results compare on every column of the result table (or the reduce
scalar); meters compare per tier on calls, tokens, price and modeled
latency. The workload tables are cut to 24 rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import backends as jbk  # noqa: E402
from repro.core import cascade as jcasc  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core.dataframe import SemanticDataFrame as JFrame  # noqa: E402
from repro.data import WORKLOADS as JWORKLOADS  # noqa: E402
from repro.data import load_dataset as jload  # noqa: E402
from repro_torch.core import backends as bk  # noqa: E402
from repro_torch.core import cascade as casc  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.core.dataframe import SemanticDataFrame  # noqa: E402
from repro_torch.data import WORKLOADS, load_dataset  # noqa: E402

MAX_ROWS = 24
DATASETS = ("movie", "estate", "game")
QUERIES = [(ds, i) for ds in DATASETS for i in range(len(WORKLOADS[ds]))]


def fingerprint(res):
    if res.is_reduce:
        return ("reduce", repr(res.scalar))
    return ("table", {k: tuple(map(repr, v))
                      for k, v in sorted(res.table.columns.items())})


def meter_key(meter):
    return {t: (u.calls, round(u.tok_in, 6), round(u.tok_out, 6),
                round(u.usd, 9), round(u.latency_s, 6))
            for t, u in sorted(meter.by_tier.items())}


def run_both(ds, i, **kw):
    """Query i of dataset ds through the port's executor and the JAX one;
    ``kw`` maps to a (port, jax) pair of extra keyword arguments."""
    table, oracle = load_dataset(ds, max_rows=MAX_ROWS)
    jtable, joracle = jload(ds, max_rows=MAX_ROWS)
    port_kw = {k: v[0] for k, v in kw.items()}
    jax_kw = {k: v[1] for k, v in kw.items()}
    meter, jmeter = bk.UsageMeter(), jbk.UsageMeter()
    res = ex.execute(WORKLOADS[ds][i].plan_for(table), table,
                     bk.make_backends(oracle), default_tier="m1",
                     morsel_size=8, meter=meter, **port_kw)
    jres = jex.execute(JWORKLOADS[ds][i].plan_for(jtable), jtable,
                       jbk.make_backends(joracle), default_tier="m1",
                       morsel_size=8, meter=jmeter, **jax_kw)
    return (res, meter), (jres, jmeter)


@pytest.mark.parametrize("ds,i", QUERIES,
                         ids=[f"{ds}-q{i + 1}" for ds, i in QUERIES])
def test_workload_query_matches_jax(ds, i):
    (res, meter), (jres, jmeter) = run_both(ds, i)
    assert fingerprint(res) == fingerprint(jres)
    assert res.rows_processed == jres.rows_processed
    assert meter_key(meter) == meter_key(jmeter)


@pytest.mark.parametrize("ds", DATASETS)
def test_optimized_query_matches_jax(ds):
    """One full optimizer pass (logical + physical) per dataset, on its
    first medium query: the same plan, answer and bill."""
    table, oracle = load_dataset(ds, max_rows=MAX_ROWS)
    jtable, joracle = jload(ds, max_rows=MAX_ROWS)
    q, jq = WORKLOADS[ds][4], JWORKLOADS[ds][4]
    rep = q.build(SemanticDataFrame(table)).execute(bk.make_backends(oracle))
    jrep = jq.build(JFrame(jtable)).execute(jbk.make_backends(joracle))
    assert rep.plan.describe() == jrep.plan.describe()
    assert repr(rep.result) == repr(jrep.result)
    assert round(rep.total_usd, 9) == round(jrep.total_usd, 9)


# Queries with a filter or rank predicate the cascade scores: every query
# but movie q1, estate q2 and game q2 (one map each) and estate q4 (its one
# filter is a UDF).
CASCADE_QUERIES = [(ds, i) for ds, i in QUERIES if (ds, i) not in {
    ("movie", 0), ("estate", 1), ("estate", 3), ("game", 1)}]


@pytest.mark.parametrize("ds,i", CASCADE_QUERIES,
                         ids=[f"{ds}-q{i + 1}" for ds, i in CASCADE_QUERIES])
def test_cascade_query_matches_jax(ds, i):
    router = casc.CascadeRouter(casc.EmbeddingBackend(device="cpu"),
                                default_bands=casc.DEFAULT_BANDS)
    jrouter = jcasc.CascadeRouter(default_bands=jcasc.DEFAULT_BANDS)
    (res, meter), (jres, jmeter) = run_both(ds, i, cascade=(router, jrouter))
    assert any(router.active_for(op) for op in
               WORKLOADS[ds][i].plan_for(load_dataset(ds, max_rows=4)[0]).ops)
    assert fingerprint(res) == fingerprint(jres)
    assert res.cascade_stats == jres.cascade_stats
    assert res.cascade_stats["embed_calls"] > 0
    assert res.cascade_stats["embed_failures"] == 0
    assert meter_key(meter) == meter_key(jmeter)


def test_cascade_scores_match_jax():
    """The cosine scores themselves, not only the bands they fall in."""
    from repro.core import plan as jplan
    from repro_torch.core import plan
    table, _ = load_dataset("movie", max_rows=MAX_ROWS)
    values = table.columns["Director"]
    op = plan.Operator(plan.FILTER, "The movie is directed by Nolan.",
                       "Director")
    jop = jplan.Operator(jplan.FILTER, "The movie is directed by Nolan.",
                         "Director")
    got = casc.EmbeddingBackend(device="cpu").scores(op, values)
    want = jcasc.EmbeddingBackend().scores(jop, values)
    assert got.dtype == np.float32 and got.shape == (len(values),)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# (c) TorchBackend against JAXBackend on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine over the same reduced qwen2 weights."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.engine import GenerationEngine as JEngine
    from repro.models import registry as jregistry
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import GenerationEngine
    from repro_torch.models import registry
    from torch_parity import flatten_params
    jbundle = jregistry.build(jreduced(jget_config("qwen2-0.5b")))
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = registry.build(reduced(get_config("qwen2-0.5b")))
    params = convert.params_from_numpy(flatten_params(jparams), device="cpu")
    return (JEngine(jbundle, jparams, max_len=160, n_slots=2),
            GenerationEngine(bundle, params, max_len=160, n_slots=2,
                             device="cpu"))


def test_torch_backend_matches_jax_backend(engines):
    """Answers parsed from the generated text (no oracle echo): equal
    results and equal tok_out show both engines generated the same tokens.
    Movie q2 filters on short director names (prompts that decode); q1 maps
    long plots (prompts cut at max_len that finish at prefill)."""
    from repro.core.cost_model import DEFAULT_TIERS as JTIERS
    from repro.engine import JAXBackend
    from repro_torch.core.cost_model import DEFAULT_TIERS
    from repro_torch.engine import TorchBackend
    jeng, eng = engines
    be = TorchBackend(DEFAULT_TIERS["m1"], eng, max_new_tokens=4)
    jbe = JAXBackend(JTIERS["m1"], jeng, max_new_tokens=4)
    table, _ = load_dataset("movie", max_rows=4)
    jtable, _ = jload("movie", max_rows=4)
    for i in (1, 0):
        meter, jmeter = bk.UsageMeter(), jbk.UsageMeter()
        res = ex.execute(WORKLOADS["movie"][i].plan_for(table), table,
                         {"m1": be}, default_tier="m1", meter=meter)
        jres = jex.execute(JWORKLOADS["movie"][i].plan_for(jtable), jtable,
                           {"m1": jbe}, default_tier="m1", meter=jmeter)
        assert fingerprint(res) == fingerprint(jres)
        u, ju = meter.by_tier["m1"], jmeter.by_tier["m1"]
        assert (u.calls, u.tok_in, u.tok_out) == (ju.calls, ju.tok_in,
                                                  ju.tok_out)
        assert u.calls == 4 and u.latency_s > 0
    assert eng.stats["decode_steps"] > 0   # q2's prompts decoded


# ---------------------------------------------------------------------------
# (d), (e) the semantic serve launcher
# ---------------------------------------------------------------------------

SERVE_FLAGS = ["--semantic", "movie", "--serve", "4", "--cascade",
               "--requests", "2", "--max-new", "4"]


def test_serve_semantic_matches_jax(capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    handles = serve.main(SERVE_FLAGS + ["--device", "cpu"])
    jhandles = jserve.main(SERVE_FLAGS)
    assert [h.name for h in handles] == ["q1", "q2", "q3", "q4"]
    for h, jh in zip(handles, jhandles):
        assert h.done() and not h.failed() and not h.rejected()
        assert fingerprint(h.result()) == fingerprint(jh.result())
        assert h.result().cascade_stats == jh.result().cascade_stats
        assert {t: u.calls for t, u in h.meter.by_tier.items()} \
            == {t: u.calls for t, u in jh.meter.by_tier.items()}
    assert handles[1].meter.calls("tier0-embed") > 0
    assert "makespan=" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--shards", "2"], ["--procs", "1"]])
def test_serve_refuses_worker_flags(flags, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--semantic", "movie"] + flags)
    assert "distribution slice" in capsys.readouterr().err
    ok = serve.build_parser().parse_args(["--shards", "1", "--procs", "0"])
    assert (ok.shards, ok.procs) == (1, 0)
