"""Streaming semantic serve: continuous query admission onto one shared
sharded dispatcher.

``executor.execute`` runs one query and tears its worker pools down; a
:class:`QueryServer` is the long-lived form — the analytics-level analog
of continuous batching at the token level (``engine.ContinuousBatcher``
fills decode slots across requests; the server fills **dispatcher
capacity** across queries). One server owns

* ONE :class:`runtime.ExecutionContext` — shared backends, one shared
  single-flight ``OutputCache`` (cross-query duplicate values bill once),
  and the server-lifetime ``UsageMeter`` that accumulates every admitted
  query's spend;
* ONE long-lived dispatcher (``ctx.dispatcher()``) — under
  ``driver="threads"`` the per-tier worker pools (or, with
  ``ctx.shards > 1``, the pool-per-(shard, tier) grid of the
  ``ShardedDispatcher``) persist across queries, so
  ``per_tier_concurrency`` caps act as true serving quotas **across
  tenants**: two in-flight queries' calls against one tier queue on the
  same bounded pool.

``submit(plan, table)`` admits a query from any caller thread and
returns a :class:`QueryHandle` immediately; the query's morsel stream is
fed into the shared dispatcher, interleaving with every other in-flight
query. Each handle carries its own per-query ``UsageMeter`` (finalized
independently via the dispatcher's per-execution staging merge) and its
own **measured** latency/exec wall; the server context's meter absorbs
each query's totals as it finishes, so ``server.ctx.meter`` is the
server-lifetime bill.

Isolation contract (test-enforced in ``tests/test_serve.py``):

* admission-order invariance — a query's results and per-query meter
  totals are byte-identical to running it solo on a fresh context
  (concurrent tenants only change *when* calls run, never what they
  answer or bill; shared-cache hits across queries require overlapping
  cache keys, which distinct instructions never produce);
* failure isolation — a backend failure inside one query poisons only
  that query's handle; other in-flight queries and later submissions
  are unaffected.

Per-query state that used to be per-process: the coalescer (one
``BatchCoalescer`` per execution, so one query's linger watermark cannot
stall another's), the sharded round-robin cursor (``shard_of(query=)``
offsets each query), and meter staging (keyed by the query's own meter
object, merged per-execution by ``disp.finalize``). The logical meter
keys are prefixed with the query id (``execute(query_key=...)``), so
every query's call log is internally sorted and disjoint from its
neighbours'.

Multi-tenant QoS (``QueryServer(admission=AdmissionController(...))``):
``submit(plan, table, tenant=, lane=, deadline_s=)`` routes through an
admission controller that (a) bounds per-tenant in-flight rows and
queue depth with backpressure (reject-or-queue; FIFO within each lane),
(b) runs two priority lanes — ``interactive`` preempts ``batch`` at
*dequeue* time, never mid-morsel, so admission-order invariance holds
within a lane — and (c) gates admission on a *predicted* makespan under
current load: the candidate's ``plan_cost`` calls replay onto an
``EventScheduler`` seeded with the live ``Dispatcher.occupancy()``
snapshot (the simulated driver as a free digital twin of the serving
fleet), and a query whose predicted completion busts its ``deadline_s``
is denied up front instead of burning capacity it cannot use. Completed
queries feed their predicted-vs-actual makespan back to
``CostModel.observe_makespan``, so the gate's estimates calibrate
online (``--explain-cost`` reports the accuracy). Admission control
changes only *when* a query starts — never what it answers or bills —
so the solo-identity contract above extends verbatim to admitted
queries.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.core import backends as bk
from repro_torch.core import executor as ex
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core.table import Table

LANES = ("interactive", "batch")


class AdmissionError(RuntimeError):
    """A query was refused admission: ``reason`` is ``"backpressure"``
    (per-tenant queue depth exhausted) or ``"deadline"`` (predicted
    completion under current load busts the query's ``deadline_s``)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class QueryHandle:
    """One admitted query: its future result, per-query meter, and
    measured timings. ``latency_s`` counts from admission (queueing
    included); ``exec_wall_s`` counts from the moment execution started
    on the shared dispatcher."""

    def __init__(self, qid: int, name: str, tenant: str = "default",
                 lane: str = "batch", deadline_s: Optional[float] = None):
        self.qid = qid
        self.name = name
        self.tenant = tenant
        self.lane = lane
        self.deadline_s = deadline_s
        self.state = "queued"   # queued -> running -> completed | failed
        #                         \-> rejected (admission denial)
        self.predicted_makespan_s: Optional[float] = None
        self.predicted_completion_s: Optional[float] = None
        self.meter = bk.UsageMeter()
        self.submitted_s = time.perf_counter()
        self.started_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self._fut: Future = Future()
        # retained while queued so the admission pump can start the query
        # later; dropped at dequeue so a long queue does not pin tables
        self._work: Optional[Tuple[plan_ir.LogicalPlan, Table]] = None

    def result(self, timeout: Optional[float] = None) -> ex.ExecutionResult:
        """Block for the query's :class:`executor.ExecutionResult`;
        re-raises the query's own failure (and only its own)."""
        return self._fut.result(timeout)

    def done(self) -> bool:
        return self._fut.done()

    def failed(self) -> bool:
        return self._fut.done() and self._fut.exception() is not None

    def rejected(self) -> bool:
        """True when admission control denied this query (its
        :meth:`result` raises :class:`AdmissionError`)."""
        return self.state == "rejected"

    @property
    def latency_s(self) -> float:
        """Admission-to-completion measured wall (includes queue wait)."""
        if self.finished_s is None:
            return 0.0
        return self.finished_s - self.submitted_s

    @property
    def exec_wall_s(self) -> float:
        """Execution-start-to-completion measured wall for THIS query
        (the shared dispatcher's ``wall_s`` is server-cumulative)."""
        if self.finished_s is None or self.started_s is None:
            return 0.0
        return self.finished_s - self.started_s


class AdmissionController:
    """Makespan-gated multi-tenant admission for a :class:`QueryServer`.

    Three mechanisms, all decided at *admission or dequeue time* (a
    running query is never preempted mid-morsel, so per-call batching,
    caching, and metering are untouched):

    * **bounded tenants** — ``max_tenant_rows`` caps the summed table
      rows a tenant may have executing at once (a query larger than the
      cap still runs when its tenant is otherwise idle, so big queries
      cannot starve); ``max_queue_depth`` caps how many queries a tenant
      may have *waiting* per submission — one more is rejected with
      ``AdmissionError("backpressure")`` instead of queueing unboundedly;
    * **priority lanes** — two FIFO queues, ``interactive`` and
      ``batch``; whenever an execution slot frees, the interactive queue
      is offered it first. Order *within* a lane is strict submission
      order (head-of-line blocking on a tenant cap lets the other lane
      overtake — that is the preemption — but never a later query in the
      same lane);
    * **makespan gate** — a query carrying ``deadline_s`` is admitted
      only if its *predicted* completion (queue wait plus
      ``CostModel.admission_estimate`` replayed onto an
      ``EventScheduler`` seeded with the live dispatcher occupancy)
      meets the deadline; otherwise ``AdmissionError("deadline")``.
      Predictions are corrected by the online ratio learned from
      completed queries (``CostModel.observe_makespan``).

    All mutable state is guarded by the owning server's lock; the
    controller is bound to exactly one server."""

    def __init__(self, *, max_tenant_rows: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 max_concurrent: Optional[int] = None,
                 default_lane: str = "batch"):
        if default_lane not in LANES:
            raise ValueError(f"unknown lane {default_lane!r}; "
                             f"expected one of {LANES}")
        self.max_tenant_rows = max_tenant_rows
        self.max_queue_depth = max_queue_depth
        self.max_concurrent = max_concurrent
        self.default_lane = default_lane
        self._server: Optional["QueryServer"] = None
        self._queues: Dict[str, Deque[QueryHandle]] = {
            lane: collections.deque() for lane in LANES}
        self._tenant_rows: Dict[str, int] = collections.defaultdict(int)
        self._tenant_queued: Dict[str, int] = collections.defaultdict(int)
        self._running = 0
        self._rejected_backpressure = 0
        self._rejected_deadline = 0
        self._served_by_lane: Dict[str, int] = {lane: 0 for lane in LANES}

    def _bind(self, server: "QueryServer") -> None:
        if self._server is not None:
            raise RuntimeError("AdmissionController is already bound "
                               "to a QueryServer")
        self._server = server
        if self.max_concurrent is None:
            self.max_concurrent = server.max_inflight

    # -- gate ------------------------------------------------------------
    def _tenant_ok(self, handle: QueryHandle, n_rows: int) -> bool:
        if self.max_tenant_rows is None:
            return True
        busy = self._tenant_rows[handle.tenant]
        return busy == 0 or busy + n_rows <= self.max_tenant_rows

    def _queued_ahead(self, lane: str) -> List[QueryHandle]:
        """Queued handles that dequeue before a new arrival to ``lane``:
        its whole lane queue, plus — for a batch arrival — every queued
        interactive query (interactive wins each free slot)."""
        ahead = list(self._queues[lane])
        if lane == "batch":
            ahead = list(self._queues["interactive"]) + ahead
        return ahead

    def _predict(self, server: "QueryServer", plan: plan_ir.LogicalPlan,
                 table: Table, lane: str) -> Tuple[Optional[float],
                                                   Optional[float]]:
        """(predicted exec makespan, predicted completion) for a
        candidate, or ``(None, None)`` when no cost model is wired."""
        model = server.ctx.cost_model
        if model is None:
            return None, None
        ctx = server.ctx
        shards = max(1, ctx.shards, ctx.procs)
        exec_s = model.admission_estimate(
            plan, table.n_rows,
            occupancy=server._disp.occupancy(),
            default_tier=ctx.default_tier,
            concurrency=ctx.concurrency,
            batch_size=ctx.batch_size,
            shards=shards)
        # queue wait: everyone who dequeues first, spread over the
        # execution slots (a deliberate fluid approximation — it is
        # deterministic given the queue snapshot, which is what the
        # denial-determinism contract needs)
        width = max(1, int(self.max_concurrent or 1))
        wait_s = sum(h.predicted_makespan_s or 0.0
                     for h in self._queued_ahead(lane)) / width
        return exec_s, wait_s + exec_s

    # -- admission (called by the server, under its lock) ----------------
    def _admit_locked(self, server: "QueryServer", handle: QueryHandle,
                      plan: plan_ir.LogicalPlan,
                      table: Table) -> Tuple[List[QueryHandle],
                                             Optional[AdmissionError]]:
        """Decide one submission: returns (queries to start now, denial).
        The handle is either queued/started (denial None) or left
        untracked with a denial to set on its future."""
        pred_exec, pred_done = self._predict(server, plan, table,
                                             handle.lane)
        handle.predicted_makespan_s = pred_exec
        handle.predicted_completion_s = pred_done
        if (handle.deadline_s is not None and pred_done is not None
                and pred_done > handle.deadline_s):
            self._rejected_deadline += 1
            return [], AdmissionError(
                "deadline",
                f"query {handle.name!r}: predicted completion "
                f"{pred_done:.3f}s busts deadline {handle.deadline_s:.3f}s "
                f"under current load")
        handle._work = (plan, table)
        self._queues[handle.lane].append(handle)
        self._tenant_queued[handle.tenant] += 1
        started = self._pump_locked(server)
        if handle.state == "queued" and self.max_queue_depth is not None \
                and self._tenant_queued[handle.tenant] > self.max_queue_depth:
            # could not start and the tenant's waiting allowance is spent:
            # shed THIS arrival (never an earlier one — FIFO is sacred)
            self._queues[handle.lane].remove(handle)
            self._tenant_queued[handle.tenant] -= 1
            handle._work = None
            self._rejected_backpressure += 1
            return started, AdmissionError(
                "backpressure",
                f"tenant {handle.tenant!r} already has "
                f"{self._tenant_queued[handle.tenant]} queries queued "
                f"(max_queue_depth={self.max_queue_depth})")
        return started, None

    def _pump_locked(self, server: "QueryServer") -> List[QueryHandle]:
        """Fill free execution slots: the interactive queue is offered
        each slot first, then batch. Within a lane the scan is FIFO, but
        an entry blocked by its *tenant's* cap is skipped — a capped
        tenant must not convoy other tenants behind it (when no cap
        binds, within-lane order is therefore strict submission order)."""
        started: List[QueryHandle] = []
        width = max(1, int(self.max_concurrent or 1))
        while self._running < width:
            picked: Optional[QueryHandle] = None
            for lane in LANES:
                q = self._queues[lane]
                for h in q:
                    if self._tenant_ok(h, h._work[1].n_rows):
                        picked = h
                        q.remove(h)
                        break
                if picked is not None:
                    break
            if picked is None:
                break
            self._tenant_queued[picked.tenant] -= 1
            self._tenant_rows[picked.tenant] += picked._work[1].n_rows
            self._running += 1
            self._served_by_lane[picked.lane] += 1
            picked.state = "dispatched"
            started.append(picked)
        return started

    def _release_locked(self, server: "QueryServer",
                        handle: QueryHandle,
                        n_rows: int) -> List[QueryHandle]:
        """Return a finished query's capacity and refill the slots."""
        self._running -= 1
        self._tenant_rows[handle.tenant] -= n_rows
        if self._tenant_rows[handle.tenant] <= 0:
            self._tenant_rows.pop(handle.tenant, None)
        if self._tenant_queued.get(handle.tenant) == 0:
            self._tenant_queued.pop(handle.tenant, None)
        return self._pump_locked(server)

    def stats(self) -> dict:
        """QoS counters (callers hold no lock: point-in-time snapshot)."""
        return {
            "running": self._running,
            "queued": {lane: len(q) for lane, q in self._queues.items()},
            "tenant_rows": dict(self._tenant_rows),
            "served_by_lane": dict(self._served_by_lane),
            "rejected_backpressure": self._rejected_backpressure,
            "rejected_deadline": self._rejected_deadline,
            "max_tenant_rows": self.max_tenant_rows,
            "max_queue_depth": self.max_queue_depth,
            "max_concurrent": self.max_concurrent,
        }


class QueryServer:
    """Long-lived semantic query server over one shared dispatcher.

    ::

        ctx = rt.ExecutionContext(backends=..., driver="threads",
                                  shards=2, concurrency=8)
        with QueryServer(ctx) as server:
            h1 = server.submit(plan1, table1)
            h2 = server.submit(plan2, table2)     # interleaves with h1
            res1, res2 = h1.result(), h2.result()

    ``max_inflight`` bounds how many admitted queries execute at once
    (later submissions queue in admission order); backend-call
    parallelism *within* each query is still governed by the context's
    ``concurrency`` / ``per_tier_concurrency`` / ``shards`` knobs.
    Passing ``admission=AdmissionController(...)`` upgrades the flat
    FIFO into multi-tenant QoS: per-tenant caps, priority lanes, and the
    makespan-gated deadline check (see :class:`AdmissionController`);
    without it, behaviour is byte-for-byte the pre-QoS server.
    ``close()`` drains in-flight queries, then releases the dispatcher's
    pools and the cache's in-flight reservations (idempotent; also the
    context-manager exit)."""

    def __init__(self, ctx_or_backends, *, max_inflight: int = 8,
                 admission: Optional[AdmissionController] = None,
                 **ctx_overrides):
        ctx = rt.as_context(ctx_or_backends, **ctx_overrides)
        self._owns_cache = ctx.cache is None
        if self._owns_cache:
            # the serving default: one shared single-flight cache, so
            # repeated values across queries bill once, server-lifetime
            ctx = ctx.fork(cache=rt.OutputCache())
        self.ctx = ctx
        self.max_inflight = max(1, max_inflight)
        self._admission = admission
        if admission is not None:
            admission._bind(self)   # before any resource allocation:
            #                         a double-bind raises cleanly
        self._disp = ctx.dispatcher()
        workers = self.max_inflight
        if admission is not None and admission.max_concurrent:
            workers = max(workers, int(admission.max_concurrent))
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="query-admit")
        self._lock = threading.Lock()
        self._seq = 0
        # only in-flight handles are retained (a long-lived server must
        # not pin every finished query's result table + call log forever);
        # completed/failed queries survive as counters, and the caller
        # keeps the handle it got from submit()
        self._inflight: Dict[int, QueryHandle] = {}
        self._completed = 0
        self._failed = 0
        self._closed = False

    # -- admission -------------------------------------------------------
    def submit(self, plan: plan_ir.LogicalPlan, table: Table,
               name: Optional[str] = None, *,
               tenant: str = "default", lane: Optional[str] = None,
               deadline_s: Optional[float] = None) -> QueryHandle:
        """Admit one query (thread-safe, non-blocking): returns a
        :class:`QueryHandle` whose execution interleaves with every
        other in-flight query on the shared dispatcher.

        ``tenant`` / ``lane`` / ``deadline_s`` are QoS hints consumed by
        the server's :class:`AdmissionController`; without one they are
        recorded on the handle but do not gate anything. A denied query
        still returns its handle — ``handle.rejected()`` is true and
        ``handle.result()`` raises :class:`AdmissionError` — so callers
        keep one code path for admitted and shed work."""
        ctl = self._admission
        if lane is None:
            lane = ctl.default_lane if ctl is not None else "batch"
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; "
                             f"expected one of {LANES}")
        to_start: List[QueryHandle] = []
        denial: Optional[AdmissionError] = None
        with self._lock:
            if self._closed:
                raise RuntimeError("QueryServer is closed")
            qid = self._seq
            self._seq += 1
            handle = QueryHandle(qid, name or f"q{qid}", tenant=tenant,
                                 lane=lane, deadline_s=deadline_s)
            if ctl is None:
                handle.state = "dispatched"
                handle._work = (plan, table)
                self._inflight[qid] = handle
                to_start = [handle]
            else:
                to_start, denial = ctl._admit_locked(self, handle,
                                                     plan, table)
                if denial is None:
                    self._inflight[qid] = handle
                else:
                    handle.state = "rejected"
                    handle.finished_s = time.perf_counter()
        for h in to_start:
            self._launch(h)
        if denial is not None:
            handle._fut.set_exception(denial)
        return handle

    def _launch(self, handle: QueryHandle) -> None:
        """Hand a dequeued query to the execution pool (outside the
        admission lock — pool submission can block on interpreter state)."""
        plan, table = handle._work  # type: ignore[misc]
        handle._work = None
        self._pool.submit(self._run_query, handle, plan, table)

    def _run_query(self, handle: QueryHandle, plan: plan_ir.LogicalPlan,
                   table: Table) -> None:
        handle.state = "running"
        handle.started_s = time.perf_counter()
        qctx = self.ctx.fork(meter=handle.meter)
        try:
            res = ex.execute(plan, table, qctx, dispatcher=self._disp,
                             query_key=handle.qid)
        except BaseException as e:
            handle.finished_s = time.perf_counter()
            handle.state = "failed"
            # failed queries still billed whatever ran before the error —
            # and still observed: per-query finalize is a calibration sync
            # point (idempotent via the model's per-meter cursor, so the
            # executor's own observe of the same meter is not re-counted)
            if self.ctx.cost_model is not None:
                self.ctx.cost_model.observe(handle.meter)
            self.ctx.meter.absorb(handle.meter)
            handle._fut.set_exception(e)
            self._retire(handle, table.n_rows, failed=True)
        else:
            handle.finished_s = time.perf_counter()
            handle.state = "completed"
            if self.ctx.cost_model is not None:
                self.ctx.cost_model.observe(handle.meter)
                # close the admission loop: predicted-vs-actual makespan
                # feeds the gate's online ratio + q-error telemetry
                # (completed queries only — a failed query's wall is not
                # a makespan measurement)
                if (self._admission is not None
                        and handle.predicted_makespan_s is not None
                        and handle.exec_wall_s > 0.0):
                    self.ctx.cost_model.observe_makespan(
                        handle.predicted_makespan_s, handle.exec_wall_s)
            self.ctx.meter.absorb(handle.meter)
            handle._fut.set_result(res)
            self._retire(handle, table.n_rows, failed=False)

    def _retire(self, handle: QueryHandle, n_rows: int,
                failed: bool) -> None:
        to_start: List[QueryHandle] = []
        with self._lock:
            self._inflight.pop(handle.qid, None)
            if failed:
                self._failed += 1
            else:
                self._completed += 1
            if self._admission is not None:
                to_start = self._admission._release_locked(self, handle,
                                                           n_rows)
        for h in to_start:
            self._launch(h)

    # -- lifecycle -------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait for every admitted query (including ones admitted while
        draining) to finish. ONE deadline is shared by the whole drain:
        every per-handle wait gets the *remaining* budget
        (``deadline - now``), and every loop iteration — including the
        retirement-pending spin — re-checks it, so the drain returns or
        raises within ``timeout`` of the call no matter how many handles
        it waits through. Failures do not raise here — read them
        per-handle."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        while True:
            with self._lock:
                # checking emptiness under the admission lock makes this
                # drain's linearization point race-free: a submit either
                # registered its handle before the check (and is waited
                # on) or is ordered after the drain
                pending = list(self._inflight.values())
                if not pending:
                    return
            left = None if deadline is None \
                else deadline - time.perf_counter()
            if left is not None and left <= 0.0:
                raise TimeoutError(
                    f"{len(pending)} queries still in flight")
            waitable = [h for h in pending if not h.done()]
            if not waitable:
                time.sleep(0.001)   # resolved, retirement imminent
                continue
            try:
                waitable[0]._fut.exception(left)
            except (_FutureTimeout, TimeoutError):
                raise TimeoutError(
                    f"{len(pending)} queries still in flight") from None

    def close(self) -> None:
        """Drain, then release the shared dispatcher's pools — and, when
        the server created its own cache, that cache's reservations (a
        caller-supplied cache is left alone: other contexts may still be
        executing against it). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.drain()
        self._pool.shutdown(wait=True)
        self.ctx.close()
        if self._owns_cache and self.ctx.cache is not None:
            self.ctx.cache.close()

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting -------------------------------------------------------
    @property
    def wall_s(self) -> float:
        """Server-lifetime wall (the shared dispatcher's clock)."""
        return self._disp.wall_s

    def stats(self) -> dict:
        total: Any = self.ctx.meter.total
        with self._lock:
            out = {
                "admitted": self._seq,
                "completed": self._completed,
                "failed": self._failed,
                "inflight": len(self._inflight),
                "calls": total.calls,
                "usd": total.usd,
                "wall_s": self.wall_s,
            }
        # fault-policy counters (retries, breaker trips, fallback calls);
        # absent when the server runs fail-fast so existing consumers of
        # the stats shape see no new key by default
        faults = self._disp.fault_stats()
        if faults is not None:
            out["faults"] = faults
        # QoS counters appear only when an AdmissionController is wired,
        # same additive-key convention as "faults"
        if self._admission is not None:
            with self._lock:
                out["qos"] = self._admission.stats()
        return out
