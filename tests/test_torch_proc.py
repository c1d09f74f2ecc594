"""The port's process shard workers
(``repro_torch.distributed.process_workers``) against the reference's
contracts, on the CPU: ``procs`` invariance, UDF steps in the workers, the
death ladder (SIGKILL and a missed heartbeat), graceful close, chaos over
the wire, the serialization boundary, and the wiring. Added for the port:
the engine-backed ``TorchBackend`` and the cascade's ``EmbeddingBackend``
stay in the coordinator (they hold the model and score on its device), and
``serve --procs`` equals the unsharded run.

Every test runs under a time limit of its own (``torch_parity.time_limit``):
spawning a worker imports ``torch``, and a lost worker must not hang the
suite.
"""
import os
import pickle
import signal
import threading
import time

import pytest

pytest.importorskip("torch")

from repro_torch import testing as tg  # noqa: E402
from repro_torch.core import backends as bk  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.core import plan as plan_ir  # noqa: E402
from repro_torch.core import runtime as rt  # noqa: E402
from repro_torch.distributed.morsel_shards import (  # noqa: E402
    ShardedDispatcher, _compose)
from repro_torch.distributed.process_workers import (  # noqa: E402
    ProcessShardDispatcher, shippable_backends)
from torch_parity import time_limit  # noqa: E402

pytestmark = pytest.mark.proc

MORSEL = 8
LIMIT_S = 120


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(LIMIT_S):
        yield


def _totals(meter):
    return {t: (u.calls, round(u.tok_in, 6), round(u.tok_out, 6),
                round(u.usd, 9), round(u.latency_s, 6))
            for t, u in sorted(meter.by_tier.items())}


def _log_key(meter):
    return sorted(zip(meter.call_keys,
                      [t for t, _ in meter.call_log],
                      [round(l, 9) for _, l in meter.call_log]))


def _run_inproc(plan, table, backend, driver, **kw):
    meter = bk.UsageMeter()
    res = ex.execute(plan, table, {"m*": backend}, default_tier="m*",
                     batch_size=1, morsel_size=MORSEL, meter=meter,
                     driver=driver, **kw)
    return res, meter


def _run_procs(plan, table, backend, n, cache=None, **disp_kw):
    meter = bk.UsageMeter()
    disp = ShardedDispatcher(shards=n, driver="procs", concurrency=4,
                             backends={"m*": backend}, **disp_kw)
    try:
        res = ex.execute(plan, table, {"m*": backend}, default_tier="m*",
                         batch_size=1, morsel_size=MORSEL, meter=meter,
                         cache=cache, dispatcher=disp)
        live = disp.live_shards()
        stats = [d.client.stats.copy() for d in disp._inner]
    finally:
        disp.close()
    return res, meter, live, stats


def _mk():
    return tg.SleepBackend(tg.KindOracle(), delay_s=0.01, sleep_s=0.0)


# -- invariance ------------------------------------------------------------

@pytest.mark.parametrize("n", (1, 2, 4))
def test_proc_shard_count_invariance_results_and_meters(n):
    """procs in {1, 2, 4}: results and per-tier totals equal both
    in-process drivers'; the merged logical-key log equals the threads
    driver's."""
    table, plan = tg.tagged_table("pi", 32), tg.tagged_plan("pi")
    res_sim, m_sim = _run_inproc(plan, table, _mk(), "simulated")
    res_thr, m_thr = _run_inproc(plan, table, _mk(), "threads")
    ref_fp = tg.result_fingerprint(res_sim)
    assert tg.result_fingerprint(res_thr) == ref_fp
    assert _totals(m_thr) == _totals(m_sim)
    res, m, live, stats = _run_procs(plan, table, _mk(), n)
    assert tg.result_fingerprint(res) == ref_fp
    assert live == list(range(n))
    assert _totals(m) == _totals(m_sim)
    assert _log_key(m) == _log_key(m_thr)
    assert sum(s["llm"] for s in stats) > 0       # the calls went remote


def test_proc_claims_in_morsel_order_with_a_shared_cache():
    """Duplicate values across morsels and workers, with the shared cache:
    the coordinator claims in morsel order before any request ships, so
    the procs bill equals the simulated driver's."""
    from repro_torch.core.table import Table
    table = Table({"v": [str(i % 5) for i in range(40)]}, name="pdup")
    plan = plan_ir.LogicalPlan((
        plan_ir.Operator(plan_ir.MAP, "annotate", "v", "a"),))
    _, m_sim = _run_inproc(plan, table, _mk(), "simulated",
                           cache=rt.OutputCache())
    res, m, _, _ = _run_procs(plan, table, _mk(), 2,
                              cache=rt.OutputCache())
    assert res.table.columns["a"] == [f"A:{i % 5}" for i in range(40)]
    assert _totals(m) == _totals(m_sim)
    # morsel 0 holds 0-4 and then 0-2 again, each billed within its own
    # claim; every later morsel finds its values claimed
    assert m.calls("m*") == 8


def test_proc_udf_steps_run_in_worker_processes():
    table = tg.tagged_table("pu", 32)
    plan = plan_ir.LogicalPlan((
        plan_ir.Operator(plan_ir.FILTER, "keep-pu", "v"),
        plan_ir.Operator(plan_ir.MAP, "annotate-pu", "v", "a"),
        plan_ir.Operator(plan_ir.MAP, "shout", "a", "b",
                         udf="lambda x: str(x).upper()"),
    ))

    def fp(res):
        return (tuple(res.table.columns[ex.ROWID]),
                tuple(map(str, res.table.columns["b"])))

    res_thr, m_thr = _run_inproc(plan, table, _mk(), "threads")
    res, m, _, stats = _run_procs(plan, table, _mk(), 2)
    assert fp(res) == fp(res_thr)
    assert _totals(m) == _totals(m_thr)
    assert _log_key(m) == _log_key(m_thr)
    assert sum(s["udf"] for s in stats) >= 4
    assert sum(s["llm"] for s in stats) > 0


# -- death ladder ----------------------------------------------------------

class SuicideBackend(tg.SleepBackend):
    """SIGKILLs its own *worker* process the first time it sees the
    trigger value (one-shot via a flag file, so the survivor's retry of
    the same logical call proceeds; never fires in the coordinator)."""

    def __init__(self, oracle, flag_path, parent_pid, trigger, **kw):
        super().__init__(oracle, **kw)
        self.flag_path = flag_path
        self.parent_pid = parent_pid
        self.trigger = trigger

    def run_values(self, op, values, meter=None, batch_size=1):
        if (os.getpid() != self.parent_pid
                and any(str(v) == self.trigger for v in values)
                and not os.path.exists(self.flag_path)):
            open(self.flag_path, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return super().run_values(op, values, meter=meter,
                                  batch_size=batch_size)


def test_proc_worker_sigkill_requeues_and_bills_exactly_once(tmp_path):
    """A SIGKILLed worker: its shard goes dead, its morsels requeue onto
    the survivor, and with the shared cache the merged totals and log
    equal a healthy run's."""
    table, plan = tg.tagged_table("pk", 32), tg.tagged_plan("pk")
    res_h, m_h, live_h, _ = _run_procs(plan, table, _mk(), 2,
                                       cache=rt.OutputCache())
    assert live_h == [0, 1]
    sb = SuicideBackend(tg.KindOracle(), str(tmp_path / "boom"),
                        os.getpid(), "pk-17", delay_s=0.01, sleep_s=0.0)
    res_k, m_k, live_k, _ = _run_procs(plan, table, sb, 2,
                                       cache=rt.OutputCache())
    assert len(live_k) == 1
    assert tg.result_fingerprint(res_k) == tg.result_fingerprint(res_h)
    assert _totals(m_k) == _totals(m_h)
    assert _log_key(m_k) == _log_key(m_h)


class FlagBackend(tg.SleepBackend):
    """Touches ``flag_path`` at every call (in the worker that runs it)."""

    def __init__(self, oracle, flag_path, **kw):
        super().__init__(oracle, **kw)
        self.flag_path = flag_path

    def run_values(self, op, values, meter=None, batch_size=1):
        open(self.flag_path, "w").close()
        return super().run_values(op, values, meter=meter,
                                  batch_size=batch_size)


def test_proc_worker_death_requeues_behind_waiting_turns(tmp_path):
    """``test_torch_shard``'s staged requeue with a worker's death in place
    of ``kill_shard``: one-wide chain pools, shard 1's held, so its morsels
    stay queued; once morsel 0 calls (in worker 0), worker 1 is SIGKILLed.
    The monitor kills the shard, its queued steps are cancelled while
    morsel 2 blocks shard 0's only chain thread waiting for morsel 1's
    turn; the cancelled steps must re-run on their own, and the run end
    with the healthy run's results and bill."""
    from repro_torch.core.table import Table
    from test_torch_shard import _narrow_chains
    table = Table({"v": [f"pw-{i}" for i in range(32)]}, name="pw")
    plan = plan_ir.LogicalPlan((
        plan_ir.Operator(plan_ir.MAP, "one-pw", "v", "a"),
        plan_ir.Operator(plan_ir.MAP, "two-pw", "a", "b")))
    m_h = bk.UsageMeter()
    res_h = ex.execute(plan, table, {"m*": _mk()}, default_tier="m*",
                       morsel_size=4, meter=m_h, cache=rt.OutputCache())
    flag = tmp_path / "called"
    backend = FlagBackend(tg.KindOracle(), str(flag), delay_s=0.01,
                          sleep_s=0.0)
    disp = ShardedDispatcher(shards=2, driver="procs", concurrency=4,
                             backends={"m*": backend})
    _narrow_chains(disp)
    hold = threading.Event()
    disp._inner[1]._chain.submit(hold.wait)
    victim = disp._inner[1].client.pid

    def kill_worker_1():
        while not flag.exists():
            time.sleep(0.01)
        os.kill(victim, signal.SIGKILL)

    killer = threading.Thread(target=kill_worker_1, daemon=True)
    killer.start()
    meter = bk.UsageMeter()
    try:
        res = ex.execute(plan, table, {"m*": backend}, default_tier="m*",
                         batch_size=1, morsel_size=4, meter=meter,
                         cache=rt.OutputCache(), dispatcher=disp)
        assert disp.live_shards() == [0]
    finally:
        hold.set()
        disp.close()
    killer.join(LIMIT_S)
    assert not killer.is_alive()
    assert res.table.columns["b"] == res_h.table.columns["b"]
    assert _totals(meter) == _totals(m_h)


def test_proc_missed_heartbeat_declares_shard_dead():
    """SIGSTOP freezes a worker without closing its pipe: the heartbeat
    monitor declares the shard dead and the run completes on the
    survivor."""
    table, plan = tg.tagged_table("ph", 32), tg.tagged_plan("ph")
    backend = _mk()
    meter = bk.UsageMeter()
    disp = ShardedDispatcher(shards=2, driver="procs", concurrency=4,
                             backends={"m*": backend},
                             heartbeat_s=0.05, heartbeat_timeout_s=0.5)
    try:
        os.kill(disp._inner[0].client.pid, signal.SIGSTOP)
        res = ex.execute(plan, table, {"m*": backend}, default_tier="m*",
                         batch_size=1, morsel_size=MORSEL, meter=meter,
                         cache=rt.OutputCache(), dispatcher=disp)
        deadline = time.perf_counter() + 10.0
        while not disp.is_dead(0) and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert disp.is_dead(0)
        assert disp.live_shards() == [1]
    finally:
        disp.close()
    ref, m_ref = _run_inproc(plan, table, backend, "simulated")
    assert tg.result_fingerprint(res) == tg.result_fingerprint(ref)
    assert _totals(meter) == _totals(m_ref)


def test_proc_heartbeat_holds_through_a_torch_importing_boot():
    """A worker imports ``repro_torch.core``, and so ``torch``, before it
    reports ready; the silence clock starts only then. With a heartbeat
    timeout far below the boot time both workers still come up alive and
    stay so through a run."""
    table, plan = tg.tagged_table("pb", 16), tg.tagged_plan("pb")
    t0 = time.perf_counter()
    disp = ShardedDispatcher(shards=2, driver="procs", concurrency=4,
                             backends={"m*": _mk()}, heartbeat_s=0.05,
                             heartbeat_timeout_s=0.3)
    boot_s = time.perf_counter() - t0
    try:
        res = ex.execute(plan, table, {"m*": _mk()}, default_tier="m*",
                         morsel_size=MORSEL, dispatcher=disp)
        assert disp.live_shards() == [0, 1]
    finally:
        disp.close()
    assert boot_s > 0.3
    assert res.table.n_rows == 16


def test_proc_graceful_close_terminates_workers():
    disp = ShardedDispatcher(shards=2, driver="procs", concurrency=4,
                             backends={"m*": tg.SleepBackend(
                                 tg.KindOracle(), delay_s=0.0)})
    procs = [d.client._proc for d in disp._inner]
    assert all(p.is_alive() for p in procs)
    disp.close()
    assert all(not p.is_alive() for p in procs)
    disp.close()


# -- chaos over the wire ---------------------------------------------------

def test_proc_chaos_run_matches_in_process_chaos():
    table, plan = tg.tagged_table("pc", 32), tg.tagged_plan("pc")
    policy = rt.CallPolicy(retries=3)

    def mk():
        return tg.FlakyBackend(_mk(), error_rate=0.2, seed=7)

    res_thr, m_thr = _run_inproc(plan, table, mk(), "threads",
                                 call_policy=policy)
    meter = bk.UsageMeter()
    ctx = rt.ExecutionContext(backends={"m*": mk()}, default_tier="m*",
                              batch_size=1, morsel_size=MORSEL,
                              meter=meter, procs=2, call_policy=policy)
    disp = ctx.make_dispatcher()
    try:
        res = ex.execute(plan, table, ctx, dispatcher=disp)
    finally:
        disp.close()
    assert tg.result_fingerprint(res) == tg.result_fingerprint(res_thr)
    assert _totals(meter) == _totals(m_thr)
    assert _log_key(meter) == _log_key(m_thr)


# -- serialization boundary ------------------------------------------------

def test_proc_fakes_pickle_roundtrip_and_seed_stability():
    import numpy as np
    oracle = tg.KindOracle()
    op = plan_ir.Operator(plan_ir.MAP, "annotate", "v", "a")
    sb = _mk()
    assert pickle.loads(pickle.dumps(sb)).run_values(op, ["x"]) \
        == sb.run_values(op, ["x"])
    gb = tg.GilBoundBackend(oracle, work_s=0.0)
    assert pickle.loads(pickle.dumps(gb)).run_values(op, ["x"]) \
        == gb.run_values(op, ["x"])
    fb = tg.FlakyBackend(sb, error_rate=0.5, seed=3)
    fb2 = pickle.loads(pickle.dumps(fb))

    def draws(b):
        out = []
        for i in range(16):
            m = bk.UsageMeter()
            with m.keyed((0, i)):
                try:
                    b.run_values(op, [f"v{i}"], meter=m)
                    out.append("ok")
                except rt.TransientCallError:
                    out.append("err")
        return out

    assert draws(fb2) == draws(fb)
    assert "err" in draws(fb) and "ok" in draws(fb)
    eo = tg.EmbeddingOracle(oracle, seed=5)
    eo2 = pickle.loads(pickle.dumps(eo))
    np.testing.assert_array_equal(eo2.encode_values(op, ["a", "b"]),
                                  eo.encode_values(op, ["a", "b"]))


def test_proc_usage_meter_pickles_with_logs_and_keys():
    m = bk.UsageMeter()
    with m.keyed((1, 2)):
        m.record("m*", bk.Usage(calls=2, tok_in=16.0, tok_out=8.0,
                                usd=0.01, latency_s=0.2),
                 per_call_latency_s=[0.1, 0.1], op_kind=plan_ir.MAP)
    m2 = pickle.loads(pickle.dumps(m))
    assert _totals(m2) == _totals(m)
    assert m2.call_log == m.call_log
    assert m2.call_keys == m.call_keys
    assert m2.call_ops == m.call_ops
    with m2.keyed((9,)):
        m2.record("m*", bk.Usage(calls=1, latency_s=0.1))
    assert m2.call_keys[-1] == (9, 0)


def test_proc_unpicklable_backends_stay_coordinator_side():
    class Unpicklable(tg.SleepBackend):
        def __getstate__(self):
            raise TypeError("cannot pickle engine state")

    backend = Unpicklable(tg.KindOracle(), delay_s=0.01, sleep_s=0.0)
    assert shippable_backends({"m*": backend}) == {}
    table, plan = tg.tagged_table("px", 16), tg.tagged_plan("px")
    res_ref, m_ref = _run_inproc(plan, table, backend, "simulated")
    res, m, _, stats = _run_procs(plan, table, backend, 2)
    assert tg.result_fingerprint(res) == tg.result_fingerprint(res_ref)
    assert _totals(m) == _totals(m_ref)
    assert sum(s["llm"] for s in stats) == 0


class _Sentinel:
    """Records being pickled: a stand-in for the engine's weights."""
    pickled = threading.Event()

    def __reduce__(self):
        _Sentinel.pickled.set()
        return (_Sentinel, ())


def test_proc_device_backends_stay_coordinator_side():
    """``shippable_backends`` keeps ``TorchBackend`` (the engine, its
    weights and cache) and the cascade's ``EmbeddingBackend`` (scores on
    its process's device) in the coordinator, like the reference's
    ``JAXBackend``; the probe refuses them before serializing anything of
    the engine. The simulated tiers ship."""
    from repro_torch.core import cascade as casc
    from repro_torch.core.cost_model import DEFAULT_TIERS
    from repro_torch.engine.torch_backend import TorchBackend
    _Sentinel.pickled.clear()
    m1 = TorchBackend(DEFAULT_TIERS["m1"], engine=_Sentinel())
    embed = casc.EmbeddingBackend(device="cpu")
    backends = {**bk.make_backends(tg.KindOracle()), "m1": m1,
                "tier0-embed": embed}
    ship = shippable_backends(backends)
    assert "m1" not in ship and "tier0-embed" not in ship
    assert set(ship) == set(backends) - {"m1", "tier0-embed"}
    assert not _Sentinel.pickled.is_set()
    for b in (m1, embed):
        with pytest.raises(TypeError, match="stays"):
            pickle.dumps(b)


# -- occupancy -------------------------------------------------------------

def test_proc_sharded_simulated_occupancy_merges_base_tiers():
    disp = ShardedDispatcher(shards=2, driver="simulated", concurrency=4)
    try:
        assert disp.occupancy() == {}
        disp._sched.submit(_compose(0, "m*"), 5.0)
        disp._sched.submit(_compose(1, "m*"), 3.0)
        disp._sched.submit(_compose(0, "m2"), 1.0)
        occ = disp.occupancy()
        assert occ["m*"] == [pytest.approx(3.0), pytest.approx(5.0)]
        assert occ["m2"] == [pytest.approx(1.0)]
    finally:
        disp.close()


# -- wiring ----------------------------------------------------------------

def test_proc_serve_parser_and_context_wiring():
    from repro_torch.launch import serve
    ap = serve.build_parser()
    assert ap.parse_args([]).procs == 0
    assert ap.parse_args(["--procs", "4"]).procs == 4
    with pytest.raises(ValueError, match="mutually exclusive"):
        rt.ExecutionContext(backends={}, procs=2, shards=2) \
            .make_dispatcher()
    ctx = rt.ExecutionContext(backends={"m*": _mk()}, procs=3,
                              per_tier_concurrency={"m*": 7})
    disp = ctx.make_dispatcher()
    try:
        assert isinstance(disp, ShardedDispatcher)
        assert disp.n_shards == 3 and disp.kind == "procs"
        assert all(isinstance(d, ProcessShardDispatcher)
                   for d in disp._inner)
        assert [disp.shard_of(i) for i in range(5)] == [0, 1, 2, 0, 1]
        assert [disp.shard_quota("m*", s) for s in range(3)] == [3, 2, 2]
    finally:
        disp.close()


def test_serve_streaming_with_procs_equals_unsharded():
    """``serve --semantic movie --serve 4 --cascade --procs 2`` on the CPU:
    m1 (the reduced engine) and the cascade stay in the coordinator, the
    simulated tiers run in two workers; results, per-tier calls and
    cascade stats equal the unsharded run's."""
    from repro_torch.launch import serve
    from test_torch_shard import SERVE, _serve_keys
    want = _serve_keys(serve.main(SERVE))
    assert _serve_keys(serve.main(SERVE + ["--procs", "2"])) == want
