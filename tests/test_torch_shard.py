"""The port's shard workers (``repro_torch.distributed.morsel_shards``)
against the reference's contracts, on the CPU.

* shard-count invariance of results, call counts and per-tier meter totals
  under both drivers, and equality with the JAX package's sharded run;
* per-shard serving quotas; deterministic merged call logs;
* the shard-local cache, and failure isolation;
* shard kill and morsel requeue, including a staged run where the
  requeued morsel sits behind later morsels that wait for its turn to
  claim the cache (the port's executor claims in morsel order);
* the launcher's ``--shards`` and the context's wiring.

Every test runs under a time limit of its own (``torch_parity.time_limit``):
a deadlock fails the test instead of hanging the suite.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

from repro.core import backends as jbk  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core import plan as JP  # noqa: E402
from repro.data import load_dataset as jload  # noqa: E402
from repro_torch import testing as tg  # noqa: E402
from repro_torch.core import backends as bk  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core import runtime as rt  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.data import load_dataset  # noqa: E402
from repro_torch.distributed.morsel_shards import (  # noqa: E402
    ShardedDispatcher, ShardEventScheduler, _compose, split_quota)
from torch_parity import time_limit  # noqa: E402

SHARD_COUNTS = (1, 2, 4)
LIMIT_S = 60


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(LIMIT_S):
        yield


@pytest.fixture(scope="module")
def movie_small():
    return load_dataset("movie", max_rows=48)


def _chain_ops(mod):
    return (
        mod.Operator(mod.FILTER, "The rating is higher than 1.",
                     "IMDB_rating"),
        mod.Operator(mod.MAP, "According to the movie plot, extract the "
                     "genre(s) of each movie.", "Plot", "Genre"),
        mod.Operator(mod.REDUCE, "Count the number of movies.", "Title"),
    )


def _meter_key(meter):
    return {t: (u.calls, round(u.tok_in, 6), round(u.tok_out, 6),
                round(u.usd, 9), round(u.latency_s, 6))
            for t, u in sorted(meter.by_tier.items())}


def _log_key(meter):
    """Byte-comparable merged call log: (logical key, tier, latency)."""
    return sorted(zip(meter.call_keys, [t for t, _ in meter.call_log],
                      [round(l, 9) for _, l in meter.call_log]))


# ---------------------------------------------------------------------------
# Shard-count invariance, and the reference's sharded run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", rt.DRIVERS)
def test_shard_invariance_results_and_meters(movie_small, driver):
    """Results, call counts and per-tier meter totals are identical for
    shards in {1, 2, 4}."""
    table, oracle = movie_small
    plan = P.LogicalPlan(_chain_ops(P))
    ref = None
    for shards in SHARD_COUNTS:
        meter = bk.UsageMeter()
        res = ex.execute(plan, table, bk.make_backends(oracle),
                         default_tier="m*", morsel_size=8, driver=driver,
                         shards=shards, meter=meter, cache=rt.OutputCache())
        key = (res.scalar, res.is_reduce, res.rows_processed,
               meter.total.calls, _meter_key(meter))
        ref = key if ref is None else ref
        assert key == ref, (driver, shards)


@pytest.mark.parametrize("driver", rt.DRIVERS)
@pytest.mark.parametrize("shards", (2, 4))
def test_shard_run_equals_reference_sharded_run(driver, shards):
    """The same filter -> map over 48 movie rows through the port's
    sharded dispatcher and the JAX package's: equal rows, outputs and
    per-tier meter totals (both sides are pure Python here)."""
    table, oracle = load_dataset("movie", max_rows=48)
    jtable, joracle = jload("movie", max_rows=48)
    runs = []
    for mod, bkm, exm, tbl, orc in ((P, bk, ex, table, oracle),
                                    (JP, jbk, jex, jtable, joracle)):
        meter = bkm.UsageMeter()
        res = exm.execute(mod.LogicalPlan(_chain_ops(mod)[:2]), tbl,
                          bkm.make_backends(orc), default_tier="m*",
                          morsel_size=8, driver=driver, shards=shards,
                          meter=meter)
        runs.append((res.table.columns[ex.ROWID], res.table.columns["Genre"],
                     _meter_key(meter)))
    assert runs[0] == runs[1]


def test_shard_invariance_table_outputs(movie_small):
    table, oracle = movie_small
    plan = P.LogicalPlan(_chain_ops(P)[:2])     # filter -> map
    ref = None
    for driver in rt.DRIVERS:
        for shards in SHARD_COUNTS:
            res = ex.execute(plan, table, bk.make_backends(oracle),
                             default_tier="m*", morsel_size=8,
                             driver=driver, shards=shards)
            key = (res.table.columns[ex.ROWID], res.table.columns["Genre"])
            ref = key if ref is None else ref
            assert key == ref, (driver, shards)


def test_shard_invariance_batched_shared_cache_duplicates():
    """batch_size > 1, a shared cache and duplicate values split across
    morsels on different shards: identical call grouping, billing and
    outputs for every shard count and driver."""
    oracle = tg.EchoOracle()
    table = Table({"v": [str(i % 8) for i in range(32)]}, name="dups")
    plan = P.LogicalPlan((P.Operator(P.MAP, "annotate", "v", "a"),))
    ref = None
    for driver in rt.DRIVERS:
        for shards in SHARD_COUNTS:
            backend = tg.SleepBackend(oracle, delay_s=0.003)
            cache = rt.OutputCache()
            meter = bk.UsageMeter()
            res = ex.execute(plan, table, {"m*": backend},
                             default_tier="m*", batch_size=4,
                             morsel_size=8, cache=cache, meter=meter,
                             driver=driver, shards=shards)
            key = (sorted(backend.groups), backend.calls_made,
                   cache.misses, cache.hits, meter.total.calls,
                   res.table.columns["a"])
            ref = key if ref is None else ref
            assert key == ref, (driver, shards)
    groups, calls, misses, hits, metered, _ = ref
    assert calls == metered == 2
    assert groups == [("0", "1", "2", "3"), ("4", "5", "6", "7")]
    assert misses == 8 and hits == 24


def test_shard_uncoalesced_duplicates_bill_as_simulated():
    """batch_size 1 (no coalescer): the port's executor claims the shared
    cache in morsel order, also across shards, so the threaded sharded
    bill equals the simulated unsharded one, value by value."""
    oracle = tg.EchoOracle()
    table = Table({"v": [str(i % 5) for i in range(40)]}, name="dups1")
    plan = P.LogicalPlan((P.Operator(P.MAP, "annotate", "v", "a"),
                          P.Operator(P.MAP, "again", "a", "b")))
    ref = None
    for driver, shards in (("simulated", 1), ("threads", 2),
                           ("threads", 4), ("simulated", 4)):
        meter = bk.UsageMeter()
        res = ex.execute(plan, table,
                         {"m*": tg.SleepBackend(oracle, delay_s=0.002)},
                         default_tier="m*", morsel_size=4, meter=meter,
                         cache=rt.OutputCache(), driver=driver,
                         shards=shards)
        key = (res.table.columns["b"], _meter_key(meter))
        ref = key if ref is None else ref
        assert key == ref, (driver, shards)
    assert ref[1]["m*"][0] == 10          # 5 values x 2 operators


def test_shard_coalesced_matches_barrier_batching(movie_small):
    table, oracle = movie_small
    plan = P.LogicalPlan((
        P.Operator(P.FILTER, "The rating is higher than 8.", "IMDB_rating"),
        P.Operator(P.MAP, "According to the movie plot, extract the "
                   "genre(s) of each movie.", "Plot", "Genre"),
    ))
    want_meter = bk.UsageMeter()
    want = ex.execute(plan, table, bk.make_backends(oracle),
                      default_tier="m*", batch_size=8, morsel_size=0,
                      coalesce=False, meter=want_meter)
    for driver in rt.DRIVERS:
        for shards in (2, 4):
            meter = bk.UsageMeter()
            res = ex.execute(plan, table, bk.make_backends(oracle),
                             default_tier="m*", batch_size=8,
                             morsel_size=8, driver=driver, shards=shards,
                             meter=meter)
            assert res.table.columns[ex.ROWID] \
                == want.table.columns[ex.ROWID], (driver, shards)
            assert res.table.columns["Genre"] \
                == want.table.columns["Genre"], (driver, shards)
            assert _meter_key(meter) == _meter_key(want_meter)


# ---------------------------------------------------------------------------
# Quotas
# ---------------------------------------------------------------------------

def test_shard_quota_split_remainder_to_shard_zero():
    assert split_quota(8, 4) == [2, 2, 2, 2]
    assert split_quota(7, 4) == [4, 1, 1, 1]
    assert split_quota(2, 4) == [2, 1, 1, 1]
    assert split_quota(16, 1) == [16]


class _PeakBackend(tg.SleepBackend):
    """SleepBackend that tracks the peak number of concurrent calls."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.inflight = 0
        self.peak = 0

    def run_values(self, op, values, meter=None, batch_size=1):
        with self._lock:
            self.inflight += 1
            self.peak = max(self.peak, self.inflight)
        try:
            return super().run_values(op, values, meter=meter,
                                      batch_size=batch_size)
        finally:
            with self._lock:
                self.inflight -= 1


def test_shard_quota_bound_never_exceeded(movie_small):
    """A per-tier cap is a global quota split across shards: in-flight
    calls never exceed it, and each shard's share serializes."""
    table, oracle = movie_small
    plan = P.LogicalPlan((P.Operator(P.FILTER, "The rating is higher "
                                     "than 1.", "IMDB_rating"),))
    backend = _PeakBackend(oracle, delay_s=0.03)
    ctx = rt.ExecutionContext(
        backends={"m*": backend}, default_tier="m*", concurrency=16,
        morsel_size=4, per_tier_concurrency={"m*": 4}, driver="threads",
        shards=4)
    res = ex.execute(plan, table, ctx)
    assert res.table.n_rows > 0
    assert backend.peak <= 4
    assert res.wall_s > 48 / 4 * 0.03 * 0.8
    disp = ctx.make_dispatcher()
    try:
        assert [disp.shard_quota("m*", s) for s in range(4)] == [1, 1, 1, 1]
        assert disp.shard_quota("other", 2) == 16
    finally:
        disp.close()


def test_shard_event_scheduler_pools_split_quota():
    sched = ShardEventScheduler(4, concurrency=16, per_tier={"m*": 8})
    assert sched.workers(_compose(0, "m*")) == 2
    assert sched.workers(_compose(3, "m*")) == 2
    assert sched.workers(_compose(1, "other")) == 16
    assert sched.workers(rt.HOST_TIER) == 1
    sync = ShardEventScheduler(4, concurrency=16, mode="sync")
    assert sync.workers(_compose(2, "m*")) == 1


# ---------------------------------------------------------------------------
# Merged logs
# ---------------------------------------------------------------------------

def test_shard_threads_merged_log_is_deterministic():
    """Two threaded sharded runs report identical merged call logs."""
    oracle = tg.EchoOracle()
    table = Table({"v": [f"x{i}" for i in range(64)]}, name="wide")
    plan = P.LogicalPlan((P.Operator(P.MAP, "annotate", "v", "a"),))
    logs = []
    for _ in range(2):
        meter = bk.UsageMeter()
        ex.execute(plan, table,
                   {"m*": tg.SleepBackend(oracle, delay_s=0.002)},
                   default_tier="m*", morsel_size=8, driver="threads",
                   shards=4, meter=meter, cache=rt.OutputCache())
        logs.append((list(meter.call_log), list(meter.call_keys)))
    assert logs[0] == logs[1]
    assert all(k is not None for k in logs[0][1])


def test_shard_simulated_runs_are_deterministic(movie_small):
    table, oracle = movie_small
    runs = []
    for _ in range(2):
        meter = bk.UsageMeter()
        res = ex.execute(P.LogicalPlan(_chain_ops(P)), table,
                         bk.make_backends(oracle), default_tier="m*",
                         batch_size=8, morsel_size=8, meter=meter,
                         driver="simulated", shards=4)
        runs.append((list(meter.call_log), list(meter.call_keys),
                     res.wall_s, res.scalar))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# Shard-local cache
# ---------------------------------------------------------------------------

def test_shard_local_cache_trades_invariance_for_isolation():
    """shard_cache="local": cross-shard duplicates bill once per shard."""
    oracle = tg.EchoOracle()
    table = Table({"v": [str(i % 8) for i in range(32)]}, name="dups")
    plan = P.LogicalPlan((P.Operator(P.MAP, "annotate", "v", "a"),))
    calls = {}
    for mode in ("shared", "local"):
        backend = tg.SleepBackend(oracle, delay_s=0.0)
        res = ex.execute(plan, table, {"m*": backend}, default_tier="m*",
                         morsel_size=8, driver="threads", shards=2,
                         cache=rt.OutputCache(), shard_cache=mode)
        calls[mode] = backend.calls_made
        assert res.table.columns["a"] == [f"A:{i % 8}" for i in range(32)]
    assert calls["shared"] == 8
    assert calls["local"] == 16


def _narrow_chains(disp):
    """Give every shard of a threaded ShardedDispatcher a chain pool one
    thread wide: a blocked morsel step then blocks its whole shard."""
    for inner in disp._inner:
        inner._chain.shutdown()
        inner._chain = ThreadPoolExecutor(max_workers=1)


def test_shard_local_cache_passes_each_turn_when_the_step_ends():
    """With a shard-local cache a morsel's claim bypasses the morsel
    order (the shard's own OutputCache is claimed), so its turn passes
    when its step ends. One-wide chain pools: a turn that never passed
    would block the later morsels of both shards for ever."""
    oracle = tg.EchoOracle()
    table = Table({"v": [str(i % 8) for i in range(64)]}, name="dups")
    plan = P.LogicalPlan((P.Operator(P.MAP, "annotate", "v", "a"),
                          P.Operator(P.MAP, "again", "a", "b")))
    ctx = rt.ExecutionContext(
        backends={"m*": tg.SleepBackend(oracle, delay_s=0.001)},
        default_tier="m*", morsel_size=4, driver="threads", shards=2,
        cache=rt.OutputCache(), shard_cache="local")
    disp = ctx.make_dispatcher()
    _narrow_chains(disp)
    try:
        res = ex.execute(plan, table, ctx, dispatcher=disp)
    finally:
        disp.close()
    assert res.table.columns["b"] == [f"A:A:{i % 8}" for i in range(64)]


# ---------------------------------------------------------------------------
# Failure isolation, kill and requeue
# ---------------------------------------------------------------------------

class _BoomOracle(tg.EchoOracle):
    def answer(self, op, value):
        if "BOOM" in str(value):
            raise RuntimeError("shard backend down")
        return True if op.kind == P.FILTER else f"A:{value}"


@pytest.mark.parametrize("driver", rt.DRIVERS)
def test_shard_worker_failure_poisons_only_its_morsels(driver):
    """A backend failure inside one shard's morsels raises (not hangs);
    the other shards' morsels still run."""
    table = Table({"v": [f"BOOM{i}" if 8 <= i < 16 else f"x{i}"
                         for i in range(32)]}, name="boom")
    plan = P.LogicalPlan((P.Operator(P.FILTER, "keep", "v"),
                          P.Operator(P.MAP, "annotate", "v", "a")))
    for shards in (2, 4):
        backend = tg.SleepBackend(_BoomOracle(), delay_s=0.0)
        with pytest.raises(RuntimeError, match="shard backend down"):
            ex.execute(plan, table, {"m*": backend}, default_tier="m*",
                       batch_size=8, morsel_size=8, driver=driver,
                       shards=shards, coalesce=True)
        flat = [v for g in backend.groups for v in g]
        assert any(v.startswith("x") for v in flat)


class _KillerBackend:
    """Kills one shard of its dispatcher at its ``kill_after``-th call."""

    def __init__(self, inner, kill_after=4, shard=2):
        self.inner = inner
        self.tier = inner.tier
        self.kill_after = kill_after
        self.shard = shard
        self.disp = None
        self._n = 0
        self._lock = threading.Lock()

    def run_values(self, op, values, meter=None, batch_size=1):
        with self._lock:
            self._n += 1
            fire = self._n == self.kill_after
        if fire and self.disp is not None:
            self.disp.kill_shard(self.shard)
        return self.inner.run_values(op, values, meter=meter,
                                     batch_size=batch_size)


def _sim_backend():
    from repro_torch.core.cost import TierSpec
    return bk.SimulatedBackend(TierSpec("m*", 1.01, 2.0, 8.0, 0.01, 0.0),
                               tg.KindOracle(), violation_rate=0.0)


@pytest.mark.parametrize("driver", rt.DRIVERS)
def test_shard_kill_requeues_morsels_query_completes(driver):
    """Killing one shard of four mid-run: the query completes on the
    survivors with the healthy run's results and exactly-once billing."""
    plan, table = tg.tagged_plan("skl"), tg.tagged_table("skl", 48)
    kw = dict(default_tier="m*", batch_size=4, morsel_size=8,
              driver=driver)
    m0 = bk.UsageMeter()
    r0 = ex.execute(plan, table, {"m*": _sim_backend()}, meter=m0, **kw)
    kb = _KillerBackend(_sim_backend())
    ctx = rt.ExecutionContext(backends={"m*": kb}, shards=4,
                              meter=bk.UsageMeter(), **kw)
    disp = ctx.make_dispatcher()
    kb.disp = disp
    try:
        res = ex.execute(plan, table, ctx, dispatcher=disp)
        assert disp.is_dead(2)
        assert disp.live_shards() == [0, 1, 3]
    finally:
        disp.close()
    assert tg.result_fingerprint(res) == tg.result_fingerprint(r0)
    assert _meter_key(ctx.meter) == _meter_key(m0)


def test_shard_kill_merged_log_matches_healthy_run():
    plan, table = tg.tagged_plan("skl2"), tg.tagged_table("skl2", 48)
    kw = dict(default_tier="m*", batch_size=4, morsel_size=8)
    m0 = bk.UsageMeter()
    ex.execute(plan, table, {"m*": _sim_backend()}, meter=m0, **kw)
    kb = _KillerBackend(_sim_backend(), kill_after=3, shard=1)
    ctx = rt.ExecutionContext(backends={"m*": kb}, shards=4,
                              meter=bk.UsageMeter(), **kw)
    disp = ctx.make_dispatcher()
    kb.disp = disp
    try:
        ex.execute(plan, table, ctx, dispatcher=disp)
    finally:
        disp.close()
    assert _log_key(ctx.meter) == _log_key(m0)


def test_shard_kill_last_live_shard_is_refused():
    ctx = rt.ExecutionContext(backends={"m*": _sim_backend()},
                              default_tier="m*", shards=2)
    disp = ctx.make_dispatcher()
    try:
        disp.kill_shard(0)
        with pytest.raises(ValueError, match="last live shard"):
            disp.kill_shard(1)
        with pytest.raises(ValueError):
            disp.kill_shard(7)
    finally:
        disp.close()


class _KillOnFirstCall(tg.SleepBackend):
    """Kills shard ``victim`` of its dispatcher at its first call."""

    disp = None
    victim = 1

    def run_values(self, op, values, meter=None, batch_size=1):
        if self.disp is not None and not self.disp.is_dead(self.victim):
            self.disp.kill_shard(self.victim)
        return super().run_values(op, values, meter=meter,
                                  batch_size=batch_size)


@pytest.mark.parametrize("ops", (1, 2, 3))
def test_requeued_morsel_behind_waiting_turns_completes(ops):
    """Staged: two shards, each with a chain pool one thread wide; shard
    1's thread is held, so its morsels (1, 3, ...) stay queued. Morsel 0
    runs on shard 0 and kills shard 1 at its first call, which cancels
    shard 1's queued steps. Morsel 2 then blocks shard 0's only thread
    waiting for morsel 1's turn to claim the cache, and every later step
    of shard 0, the requeued ones too, queues behind it. The cancelled
    morsels must re-run on their own and the query finish with the
    healthy run's results and bill."""
    table = tg.tagged_table("rq", 32)
    plan = P.LogicalPlan(tuple(P.Operator(P.MAP, f"step{j}-rq", "v" if j
                                          == 0 else f"c{j - 1}", f"c{j}")
                               for j in range(ops)))
    kw = dict(default_tier="m*", morsel_size=4, driver="threads")
    m0 = bk.UsageMeter()
    r0 = ex.execute(plan, table, {"m*": tg.SleepBackend(
        tg.EchoOracle(), delay_s=0.002)}, meter=m0,
        cache=rt.OutputCache(), **kw)
    backend = _KillOnFirstCall(tg.EchoOracle(), delay_s=0.002)
    ctx = rt.ExecutionContext(backends={"m*": backend}, shards=2,
                              cache=rt.OutputCache(), meter=bk.UsageMeter(),
                              **kw)
    disp = ctx.make_dispatcher()
    _narrow_chains(disp)
    hold = threading.Event()
    disp._inner[1]._chain.submit(hold.wait)
    backend.disp = disp
    try:
        res = ex.execute(plan, table, ctx, dispatcher=disp)
        assert disp.live_shards() == [0]
    finally:
        hold.set()
        disp.close()
    assert res.table.columns == r0.table.columns
    assert res.table.columns[f"c{ops - 1}"][5] == "A:" * ops + "rq-5"
    assert _meter_key(ctx.meter) == _meter_key(m0)


def test_cancelled_tasks_rerun_exactly_once_under_contention():
    """Stress: 64 tasks queued on a shard held busy; the shard is killed,
    which starts one re-run thread per cancelled task while 16 threads
    ask every task for its result, with a tiny switch interval. Each
    task's ``fn`` runs exactly once and every caller gets its value."""
    import sys
    disp = ShardedDispatcher(shards=2, driver="threads", concurrency=4)
    _narrow_chains(disp)
    hold = threading.Event()
    disp._inner[1]._chain.submit(hold.wait)
    runs, lock = {}, threading.Lock()

    def fn(i):
        def step(value, ready):
            with lock:
                runs[i] = runs.get(i, 0) + 1
            return value + i, ready
        return step

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tasks = [disp.defer(disp.done(1000), fn(i), shard=1)
                 for i in range(64)]
        got = [[] for _ in range(16)]

        def ask(k):
            got[k] = [t.result()[0] for t in reversed(tasks)]
        askers = [threading.Thread(target=ask, args=(k,)) for k in range(16)]
        disp.kill_shard(1)
        for t in askers:
            t.start()
        for t in askers:
            t.join(LIMIT_S)
        assert not any(t.is_alive() for t in askers)
    finally:
        sys.setswitchinterval(old)
        hold.set()
        disp.close()
    assert runs == {i: 1 for i in range(64)}
    assert all(g == [1000 + i for i in reversed(range(64))] for g in got)


# ---------------------------------------------------------------------------
# Launcher and context wiring
# ---------------------------------------------------------------------------

def test_shard_serve_parser_and_dispatcher_wiring():
    from repro_torch.launch import serve
    ap = serve.build_parser()
    assert ap.parse_args([]).shards == 1
    assert ap.parse_args(["--shards", "4"]).shards == 4
    ctx = rt.ExecutionContext(backends={}, shards=3, driver="threads",
                              per_tier_concurrency={"m*": 7})
    disp = ctx.make_dispatcher()
    try:
        assert isinstance(disp, ShardedDispatcher)
        assert disp.n_shards == 3 and disp.kind == "threads"
        assert [disp.shard_of(i) for i in range(5)] == [0, 1, 2, 0, 1]
        assert [disp.shard_quota("m*", s) for s in range(3)] == [3, 2, 2]
    finally:
        disp.close()
    assert isinstance(rt.ExecutionContext(backends={}).make_dispatcher(),
                      rt.SimulatedDispatcher)


def _serve_keys(handles):
    from test_torch_semantic import fingerprint
    return [(h.name, fingerprint(h.result()),
             {t: u.calls for t, u in sorted(h.meter.by_tier.items())},
             h.result().cascade_stats) for h in handles]


SERVE = ["--semantic", "movie", "--slots", "4", "--requests", "8",
         "--serve", "4", "--cascade", "--device", "cpu", "--max-new", "4"]


def test_serve_streaming_with_shards_equals_unsharded():
    """``serve --semantic movie --serve 4 --cascade --shards 2`` on the
    CPU (reduced m1 on the engine, the cascade's plain scoring): results,
    per-tier calls and cascade stats equal the unsharded run's."""
    from repro_torch.launch import serve
    want = _serve_keys(serve.main(SERVE))
    assert _serve_keys(serve.main(SERVE + ["--shards", "2"])) == want
