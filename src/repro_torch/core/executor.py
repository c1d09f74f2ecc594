"""Physical-plan executor (paper §2.2 "query executor") — morsel-driven.

Runs a plan over a :class:`Table`: UDF operators execute as native compute;
LLM operators dispatch to the backend tier assigned by the physical plan
(default tier when unassigned — the paper uses the strongest model as the
default backbone).

The table is split into row **morsels** so operators pipeline: a downstream
map starts on rows an upstream filter has already passed instead of waiting
for the whole column (``morsel_size=0`` restores the per-operator barrier).
Reduce and rank are pipeline barriers — they need every surviving row.

*How* morsels run is the execution context's **driver**
(``runtime.Dispatcher``):

* ``driver="simulated"`` — backend calls execute inline; every call reports
  its latency into the meter's call log and is placed on the earliest-free
  worker of its tier by the event scheduler. ``wall_s`` is the modeled
  makespan (deterministic; Table-9 accounting).
* ``driver="threads"`` — backend calls run on per-tier bounded worker
  pools and morsel chains advance concurrently, so independent operators'
  morsels genuinely overlap. ``wall_s`` is **measured** wall time.

With ``batch_size > 1`` and coalescing enabled (``ctx.coalesce``, the
default), streamable LLM operators run through a
``runtime.BatchCoalescer``: each morsel submits its surviving rows into a
per-operator accumulation queue and receives a *future* that resolves as
soon as the batches containing its rows flush — so downstream morsels
still start early, but batch slots fill across morsel boundaries
(``ceil(survivors/batch)`` calls, like whole-table batching, instead of
``sum(ceil(s_i/batch))`` per-morsel ceilings).

With ``ctx.shards > 1`` the morsel stream fans out round-robin across
shard workers (``distributed.morsel_shards.ShardedDispatcher``): each
morsel's chain runs on its shard's pools, coalesced batch *formation*
stays global, and shard outputs merge back in logical morsel order
(``Table.concat`` via ``_merge``); per-shard staging meters combine into
``ctx.meter`` with a deterministic call log (``disp.finalize``).

Monetary cost comes from tier token prices; both axes accumulate in a
UsageMeter so benchmarks can break costs down per model tier (paper
Fig. 10). Neither morsel pipelining, coalescing, the driver, nor the
shard count changes the answer — results, call counts, and per-tier
meter totals are identical across barrier/morsel/coalesced,
simulated/threaded, and shards in {1, 2, 4} execution.

Unlike the reference executor, this port makes an uncoalesced LLM
operator's morsels claim the output cache in morsel order
(``_ClaimOrder``). The reference's threaded driver lets the first morsel
to arrive claim a value, so a value held by two in-flight morsels a
different number of times was billed by whichever came first; here it is
billed as the simulated driver bills it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, List, Optional, Tuple

from repro_torch.core import backends as bk
from repro_torch.core import plan as plan_ir
from repro_torch.core import runtime as rt
from repro_torch.core.table import Table

# re-exported for backwards compatibility (they live in runtime now)
from repro_torch.core.runtime import OutputCache, run_llm_op   # noqa: F401

ROWID = "_rowid"


def with_rowids(table: Table) -> Table:
    if ROWID in table.columns:
        return table
    t = table.with_column(ROWID, list(range(table.n_rows)), "numeric")
    return t


@dataclasses.dataclass
class ExecutionResult:
    table: Optional[Table]          # surviving rows (None after reduce)
    scalar: Any                     # reduce output (None unless is_reduce)
    meter: bk.UsageMeter
    wall_s: float                   # simulated (event-model) or measured
    cpu_s: float                    # real python time spent
    rows_processed: float = 0.0     # LLM-processed records (Fig. 13 metric)
    # whether the plan ended in a reduce — carried explicitly because a
    # crashed/unanswerable reduce legitimately yields ``scalar=None`` and
    # sniffing ``scalar is not None`` would misclassify the query's kind
    is_reduce: bool = False
    # BatchCoalescer.stats for this run (None when coalescing was inactive)
    coalesce_stats: Optional[dict] = None
    # tier-0 cascade routing counters (None when no cascade was configured):
    # embed_calls / passed / dropped / escalated
    cascade_stats: Optional[dict] = None

    def value(self):
        """The query answer: reduce scalar, else the surviving table."""
        return self.scalar if self.is_reduce else self.table


def _split_morsels(table: Table, morsel_size: int,
                   batch_size: int) -> List[Tuple[Table, float]]:
    """Split into (morsel, ready_time) pairs. Full morsels are multiples of
    the batch size, so batch-prompting call counts match the barrier
    executor exactly: sum(ceil(s_i/b)) == ceil(n/b)."""
    if morsel_size <= 0 or table.n_rows <= morsel_size:
        return [(table, 0.0)]
    step = max(morsel_size, batch_size)
    step = ((step + batch_size - 1) // batch_size) * batch_size
    return [(table.take(range(i, min(i + step, table.n_rows))), 0.0)
            for i in range(0, table.n_rows, step)]


def _merge(parts: List[Tuple[Table, float]]) -> Tuple[Table, float]:
    tables = [t for t, _ in parts]
    ready = max((r for _, r in parts), default=0.0)
    return (tables[0] if len(tables) == 1 else Table.concat(tables)), ready


class _PendingMorsel:
    """A morsel whose LLM outputs are still inside the batch coalescer.

    The chain carries this placeholder instead of a table; the *next*
    stage that needs the rows forces it (waits on the coalescer future and
    folds the outputs in). Deferring the wait downstream keeps submission
    tasks non-blocking, which preserves the chain pool's FIFO liveness
    argument: a submitter never holds a worker while waiting on a batch
    another queued task must complete.

    ``fold`` (a tier-0 cascade partition's ``merge``) maps the coalescer
    future's outputs — the *escalated* rows only — back to a full per-row
    output list before ``apply_outputs``."""

    __slots__ = ("op", "tbl", "fut", "fold")

    def __init__(self, op: plan_ir.Operator, tbl: Table, fut, fold=None):
        self.op = op
        self.tbl = tbl
        self.fut = fut
        self.fold = fold


class _FailedMorsel:
    """Poison value carried down a morsel chain after a failure while
    coalescing is active. Raising inside the chain would leave downstream
    accumulation queues short of their morsel-boundary watermark — and
    every *other* morsel's future would then wait forever — so the error
    flows as a value instead: each later step still advances its group's
    watermark with an empty submission, and the exception re-raises at the
    next point the morsel is forced (barrier or final merge)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _ClaimOrder:
    """Admits one streamable operator's per-morsel cache claims in morsel
    order, the order the simulated driver makes them in.

    Duplicate values inside one claim are each billed (the sequential
    path's rule), while a value another morsel has in flight is waited
    for. So when two morsels hold the same value a different number of
    times, the morsel that claims first sets the bill, and under the
    threaded driver that was thread timing. Claims are instant next to
    the backend calls they start, so only the claims are ordered: each
    morsel still computes concurrently once it has claimed. A morsel
    that makes no claim (empty, failed, answered by its cascade pass)
    passes its turn when its step ends.

    Liveness: morsel ``i``'s step waits only for morsel ``i - 1``'s step
    of the same operator, which sits earlier in the chain pool's FIFO
    queue, so the dispatcher's liveness argument still holds. Sharded,
    morsel ``i - 1`` sits on another shard's pool, ahead of every step
    there that waits on it, so the lowest morsel that has not passed is
    always running. A shard that dies cancels its queued steps, and
    ``distributed.morsel_shards`` re-runs each at once on a thread of its
    own, not behind the survivors' waiting steps."""

    def __init__(self, n: int):
        self._cv = threading.Condition()
        self._passed = [False] * n
        self._next = 0          # every morsel below this one has passed

    def wait(self, i: int) -> None:
        with self._cv:
            self._cv.wait_for(lambda: self._next >= i)

    def passed(self, i: int) -> None:
        with self._cv:
            self._passed[i] = True
            while (self._next < len(self._passed)
                   and self._passed[self._next]):
                self._next += 1
            self._cv.notify_all()


class _OrderedCache:
    """``cache`` as one morsel's LLM call sees it: its first claim waits
    for the morsel's turn in ``order`` and then passes it."""

    def __init__(self, cache: OutputCache, order: _ClaimOrder, idx: int):
        self._cache = cache
        self._order = order
        self._idx = idx

    def claim(self, keys, token):
        self._order.wait(self._idx)
        try:
            return self._cache.claim(keys, token)
        finally:
            self._order.passed(self._idx)

    def __getattr__(self, name):
        return getattr(self._cache, name)


def _force(value, ready: float) -> Tuple[Table, float]:
    """Materialize a (possibly pending) morsel into its output table."""
    if isinstance(value, _FailedMorsel):
        raise value.exc
    if isinstance(value, _PendingMorsel):
        outs, finish = value.fut.result()
        if value.fold is not None:
            outs = value.fold(outs)
        tbl, _ = rt.apply_outputs(value.op, value.tbl, outs)
        return tbl, max(ready, finish)
    return value, ready


def _settle(parts) -> List[Tuple[Table, float]]:
    """Resolve EVERY morsel task, then surface the first failure (in
    morsel order). Waiting for all tasks — instead of raising at the
    first failed one — is what makes the executor's cleanup safe on a
    shared (server) dispatcher: ``finalize``/``release_query`` must not
    run while sibling morsels of the same query are still billing, or
    stragglers would resurrect released routing state and their calls
    would miss the per-query meter merge."""
    settled: List[Tuple[Table, float]] = []
    first_exc: Optional[BaseException] = None
    for p in parts:
        try:
            settled.append(_force(*p.result()))
        except BaseException as e:
            if first_exc is None:
                first_exc = e
    if first_exc is not None:
        raise first_exc
    return settled


def execute(plan: plan_ir.LogicalPlan, table: Table,
            backends, *, default_tier: Optional[str] = None,
            concurrency: Optional[int] = None,
            batch_size: Optional[int] = None,
            cache: Optional[OutputCache] = None,
            meter: Optional[bk.UsageMeter] = None,
            morsel_size: Optional[int] = None,
            driver: Optional[str] = None,
            coalesce: Optional[bool] = None,
            linger_s: Optional[float] = None,
            shards: Optional[int] = None,
            shard_cache: Optional[str] = None,
            procs: Optional[int] = None,
            cascade=None,
            call_policy: Optional[rt.CallPolicy] = None,
            scheduler: Optional[rt.EventScheduler] = None,
            dispatcher: Optional[rt.Dispatcher] = None,
            query_key=None
            ) -> ExecutionResult:
    """Execute ``plan`` over ``table``.

    ``backends`` is either a ``{tier: Backend}`` dict (legacy call shape;
    the keyword arguments then configure the run, with the
    ``ExecutionContext`` field defaults filling the gaps) or a
    :class:`runtime.ExecutionContext` (every keyword argument given here
    overrides the matching context field). A caller-supplied ``dispatcher``
    shares its worker pools across executions — the judge overlaps both
    sample runs on one pool this way, and ``launch.query_server`` admits
    every query onto one server-lifetime dispatcher — and ``wall_s`` then
    reports the dispatcher's cumulative makespan. ``scheduler`` is the
    legacy form of the same: it is wrapped in a
    :class:`runtime.SimulatedDispatcher`.

    ``cascade`` (a ``core.cascade.CascadeRouter``) enables the tier-0
    embedding cascade for this execution: eligible SEM_FILTER/RANK
    operators resolve their confident bands in one batched device pass per
    morsel and escalate only the uncertain band to the LLM tier (see
    ``ExecutionResult.cascade_stats``).

    ``query_key`` scopes this execution on a *shared* dispatcher: it
    prefixes every logical meter key (``(query, op, morsel, ...)``) so
    concurrently admitted queries' call logs stay disjoint and
    per-query-sortable, and it gives the execution its own round-robin
    shard cursor (concurrent queries spread across shards instead of all
    starting on shard 0). Solo executions leave it ``None`` — their key
    shapes are unchanged.
    """
    t0 = time.perf_counter()
    over = {k: v for k, v in (("default_tier", default_tier),
                              ("concurrency", concurrency),
                              ("batch_size", batch_size),
                              ("cache", cache), ("meter", meter),
                              ("morsel_size", morsel_size),
                              ("driver", driver),
                              ("coalesce", coalesce),
                              ("linger_s", linger_s),
                              ("shards", shards),
                              ("shard_cache", shard_cache),
                              ("procs", procs),
                              ("cascade", cascade),
                              ("call_policy", call_policy))
            if v is not None}
    ctx = rt.as_context(backends, **over)

    owns_dispatcher = dispatcher is None
    if dispatcher is None:
        dispatcher = rt.SimulatedDispatcher(scheduler) \
            if scheduler is not None else ctx.make_dispatcher()
    try:
        return _run(plan, table, ctx, dispatcher, t0, query_key=query_key)
    finally:
        if owns_dispatcher:
            dispatcher.close()


def _run(plan: plan_ir.LogicalPlan, table: Table, ctx: rt.ExecutionContext,
         disp: rt.Dispatcher, t0: float, query_key=None) -> ExecutionResult:
    meter = ctx.meter
    # logical meter-key prefix: () solo, (query_id,) on a shared server —
    # keys within one execution keep one shape, so per-query merge sorts
    kp = () if query_key is None else (query_key,)
    table = with_rowids(table)
    # Morsel boundaries do NOT depend on the shard count: a sharded
    # dispatcher only changes *where* each morsel runs (round-robin by
    # morsel index), so results and per-morsel call grouping are
    # shard-count invariant by construction.
    parts = [disp.done(t) for t, _ in
             _split_morsels(table, ctx.morsel_size, ctx.batch_size)]
    scalar = None
    is_reduce = False
    rows_lock = threading.Lock()
    rows_processed = [0.0]
    coal: Optional[rt.BatchCoalescer] = None
    if ctx.coalesce and ctx.batch_size > 1 and any(
            op.udf is None and op.kind in (plan_ir.FILTER, plan_ir.MAP)
            for op in plan.ops):
        coal = rt.BatchCoalescer(disp, meter, batch_size=ctx.batch_size,
                                 cache=ctx.cache, linger_s=ctx.linger_s)
    casc = ctx.cascade
    casc_stats = {"embed_calls": 0, "passed": 0, "dropped": 0,
                  "escalated": 0, "embed_failures": 0} \
        if casc is not None else None

    def cascade_partition(op, oi, idx, values, ready):
        """Run the tier-0 embedding pass over one morsel's values (one
        metered ``tier0-embed`` call on the morsel's shard; chunk ``-1``
        in the logical key sorts the device pass ahead of the operator's
        LLM chunks) and band-route every row. The partition is a pure
        function of (op, values), so routing — and therefore which rows
        the LLM tiers see — is driver-, shard-, and order-invariant.

        Returns None when the embed pass *fails*: graceful degradation —
        the caller escalates the whole morsel to the LLM tier, so a
        tier-0 outage costs the cascade's savings, not the query (results
        are byte-identical to a no-cascade run, since escalate-everything
        is exactly what no cascade does). The failure count is reported
        in ``cascade_stats["embed_failures"]``."""
        try:
            part = casc.partition(op, values, disp, meter, ready=ready,
                                  shard=disp.shard_of(idx, query_key),
                                  key=kp + (oi, idx, -1))
        except Exception:
            with rows_lock:
                casc_stats["embed_failures"] += 1
            return None
        with rows_lock:
            casc_stats["embed_calls"] += 1
            casc_stats["passed"] += part.n_pass
            casc_stats["dropped"] += part.n_drop
            casc_stats["escalated"] += len(part.escalate)
        return part

    def llm_calls(op, oi, idx, values, ready, order=None):
        """Dispatch one operator over one morsel's values on the morsel's
        shard; (op index, morsel index) is the call's logical meter key.
        ``order`` (a :class:`_ClaimOrder`) makes the morsel claim its
        cache keys in its turn."""
        backend = ctx.backend(op.tier)
        cache = ctx.cache if order is None \
            else _OrderedCache(ctx.cache, order, idx)
        # account under the backend's own tier name (a dict key like "m*"
        # may map to a differently-named backend, e.g. a TorchBackend tier)
        outs, finish = disp.run_llm(op, values, backend, backend.tier.name,
                                    meter, batch_size=ctx.batch_size,
                                    cache=cache, ready_s=ready,
                                    shard=disp.shard_of(idx, query_key),
                                    key=kp + (oi, idx))
        with rows_lock:
            rows_processed[0] += len(values)
        return outs, finish

    def step(op, oi, group, idx, value, ready, order=None):
        """Advance one morsel through one streamable (filter/map) operator;
        runs on a chain-pool thread under the threaded driver. ``value``
        may be a _PendingMorsel from an upstream coalesced operator, or a
        _FailedMorsel poison (then only keep the watermark moving). The
        morsel's turn in ``order`` passes however the step ends."""
        try:
            return advance(op, oi, group, idx, value, ready, order)
        finally:
            if order is not None:
                order.passed(idx)

    def advance(op, oi, group, idx, value, ready, order):
        if isinstance(value, _FailedMorsel):
            if group is not None:
                group.submit(idx, [], ready)
            return value, ready
        try:
            tbl, ready = _force(value, ready)
            if group is not None:
                # coalesced LLM operator: hand the surviving rows to the
                # accumulation queue (empty morsels still advance the
                # watermark) and resume downstream when their batches flush
                values = tbl.resolve(op.input_column) if tbl.n_rows else []
                if casc is not None and values and casc.active_for(op):
                    # tier-0 cascade: resolve the confident bands on
                    # device, submit ONLY the uncertain band to the batch
                    # queue; the partition's merge folds the escalated
                    # outputs back when the morsel is forced. A failed
                    # embed pass (part is None) degrades: fall through
                    # and submit every row, exactly as if no cascade
                    # were configured for this morsel.
                    part = cascade_partition(op, oi, idx, values, ready)
                    if part is not None:
                        with rows_lock:
                            rows_processed[0] += len(part.escalate)
                        fut = group.submit(
                            idx, [values[i] for i in part.escalate],
                            max(ready, part.finish))
                        return (_PendingMorsel(op, tbl, fut,
                                               fold=part.merge),
                                ready)
                with rows_lock:
                    rows_processed[0] += len(values)
                return (_PendingMorsel(op, tbl,
                                       group.submit(idx, values, ready)),
                        ready)
            if tbl.n_rows == 0:
                # an upstream filter emptied this morsel: maps must still
                # define their output column (downstream reads it)
                if op.kind == plan_ir.MAP:
                    tbl = tbl.with_column(op.output_column, [])
                return tbl, ready
            values = tbl.resolve(op.input_column)
            if op.udf is not None:
                # host UDF morsels pipeline against LLM work; threaded
                # shards serialize them through one host lock (one
                # interpreter), process shards run them GIL-free
                (out_tbl, _), finish = disp.run_udf(
                    op, tbl, values, ready_s=ready,
                    shard=disp.shard_of(idx, query_key))
                return out_tbl, finish
            if casc is not None and casc.active_for(op):
                part = cascade_partition(op, oi, idx, values, ready)
                if part is not None:
                    if part.escalate:
                        esc, finish = llm_calls(
                            op, oi, idx,
                            [values[i] for i in part.escalate],
                            max(ready, part.finish), order)
                    else:
                        esc, finish = [], part.finish
                    out_tbl, _ = rt.apply_outputs(op, tbl,
                                                  part.merge(esc))
                    return out_tbl, finish
                # degraded: the LLM tier answers the whole morsel
            outs, finish = llm_calls(op, oi, idx, values, ready, order)
            out_tbl, _ = rt.apply_outputs(op, tbl, outs)
            return out_tbl, finish
        except BaseException as e:
            if coal is None:
                raise               # no accumulation queues to keep alive
            if group is not None:
                group.submit(idx, [], ready)
            return _FailedMorsel(e), ready

    try:
        for oi, op in enumerate(plan.ops):
            if op.kind in (plan_ir.REDUCE, plan_ir.RANK):
                # pipeline barrier: needs every surviving row
                tbl, ready = _merge(_settle(parts))
                if op.kind == plan_ir.RANK and tbl.n_rows == 0:
                    parts = [disp.done(tbl, ready)]
                    continue
                values = tbl.columns.get(op.input_column, []) \
                    if tbl.n_rows == 0 else tbl.resolve(op.input_column)
                if op.udf is not None:
                    (tbl, out), finish = disp.run_udf(
                        op, tbl, values, ready_s=ready)
                else:
                    part = None
                    if (casc is not None and tbl.n_rows > 0
                            and casc.active_for(op)):
                        # cascaded RANK: the pass/drop tails keep their
                        # embedding order; only the middle band is
                        # re-ranked by the LLM tier. A failed embed pass
                        # (part None) degrades to a full LLM re-rank.
                        part = cascade_partition(op, oi, 0, values, ready)
                    if part is not None:
                        if part.escalate:
                            esc, finish = llm_calls(
                                op, oi, 0,
                                [values[i] for i in part.escalate],
                                max(ready, part.finish))
                        else:
                            esc, finish = [], part.finish
                        tbl, out = rt.apply_outputs(op, tbl,
                                                    part.merge(esc))
                    else:
                        outs, finish = llm_calls(op, oi, 0, values, ready)
                        tbl, out = rt.apply_outputs(op, tbl, outs)
                if op.kind == plan_ir.REDUCE:
                    scalar = out
                    is_reduce = True
                # everything downstream restarts from the barrier's output
                parts = [disp.done(t, finish) for t, _ in
                         _split_morsels(tbl, ctx.morsel_size,
                                        ctx.batch_size)]
                continue

            # streamable operator (filter / map): advance each morsel on
            # its shard (round-robin morsel fan-out under a sharded
            # dispatcher; everything lands on shard 0 otherwise)
            group = None
            if coal is not None and op.udf is None:
                backend = ctx.backend(op.tier)
                group = coal.open(op, backend, backend.tier.name,
                                  expected=len(parts), op_key=kp + (oi,))
            # uncoalesced LLM operators claim the shared cache in morsel
            # order, so the bill does not depend on thread timing
            order = _ClaimOrder(len(parts)) \
                if (group is None and op.udf is None
                    and ctx.cache is not None) else None
            parts = [
                disp.defer(p,
                           lambda value, ready, op=op, oi=oi, group=group,
                           i=i, order=order: step(op, oi, group, i, value,
                                                  ready, order),
                           shard=disp.shard_of(i, query_key))
                for i, p in enumerate(parts)]

        out_table, _ = _merge(_settle(parts))
    finally:
        if coal is not None:
            # normal exit: a no-op (every group is watermarked and
            # drained). On error it fails pending futures so blocked chain
            # tasks unwind before the dispatcher's pool shutdown.
            coal.close()
        # sharded dispatch: merge per-shard staging meters into ctx.meter
        # (deterministic combined call log); no-op on single-host drivers.
        # finalize is per-execution, not terminal — a shared dispatcher
        # keeps serving other in-flight queries' staging untouched.
        disp.finalize(meter)
        # calibration sync point: the meter's call log is complete for
        # this execution and (when sharded) deterministically merged, so
        # the cost model may fold it in now — never mid-execution. The
        # per-meter cursor makes this idempotent if an outer layer (e.g.
        # the query server) observes the same meter again.
        if ctx.cost_model is not None:
            ctx.cost_model.observe(meter)
        if query_key is not None:
            disp.release_query(query_key)
    return ExecutionResult(
        table=None if is_reduce else out_table,
        scalar=scalar, meter=meter, wall_s=disp.wall_s,
        cpu_s=time.perf_counter() - t0, rows_processed=rows_processed[0],
        is_reduce=is_reduce,
        coalesce_stats=dict(coal.stats) if coal is not None else None,
        cascade_stats=dict(casc_stats) if casc_stats is not None else None)
