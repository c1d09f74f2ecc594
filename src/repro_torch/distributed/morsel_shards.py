"""Morsel-parallel sharded execution: pool-per-(shard, tier) dispatch.

The port's counterpart of ``repro.distributed.morsel_shards``, ported
rather than copied in one place: a chain task cancelled by a shard's death
re-runs at once on a thread of its own (:class:`_ResilientTask`), because
the port's executor orders an operator's cache claims by morsel.

The single-host ``runtime.ThreadPoolDispatcher`` overlaps one
execution's backend calls on per-tier worker pools; this module
generalizes that shape to **N shard workers**: the executor's morsel
stream is partitioned round-robin by morsel index, each shard runs behind
the existing :class:`runtime.Dispatcher` interface with its *own* inner
dispatcher, and shard outputs merge back in logical morsel order
(``Table.concat`` in the executor) with per-shard staging meters combined
by ``UsageMeter.merge`` into one deterministic call log.

Concurrency semantics
---------------------
* Explicit ``per_tier_concurrency`` caps are **serving quotas** for a
  model tier — a global resource. They are *split* across shards
  (integer division, remainder to shard 0), so for any quota >= the
  shard count the total in-flight calls against that tier never exceed
  the cap (:func:`split_quota`). A quota *smaller* than the shard count
  cannot be honored exactly: every shard needs at least one worker to
  make progress, so the floor-of-1 deliberately over-subscribes by up to
  ``shards - quota`` calls rather than starving (and deadlocking)
  shards — use fewer shards if the quota is that tight.
* The default ``concurrency`` is a shard-local replica width: each shard
  worker models its own serving replica, so adding shards adds capacity
  for un-quota'd tiers. This is what the shard-scaling benchmark
  (``benchmarks/bench_shard.py``) measures.

Drivers
-------
* ``threads``: one ``ThreadPoolDispatcher`` per shard — a pool per
  (shard, tier) plus a per-shard chain pool; shard workers genuinely
  overlap and ``wall_s`` is measured. Host (UDF) compute still serializes
  process-wide through one shared lock.
* ``simulated``: one shard-aware :class:`ShardEventScheduler` shared by
  every shard (jobs land on composite ``(shard, tier)`` pools; host
  compute stays one global worker), driven through per-shard
  ``SimulatedDispatcher`` views — so Table-9 accounting stays a single
  deterministic event replay.
* ``procs``: one ``distributed.process_workers.ProcessShardDispatcher``
  per shard — the threads topology, but each shard's backend calls and
  host UDFs execute in a spawned worker *subprocess* (GIL-free; no
  shared host lock — each worker is its own interpreter). Worker death
  surfaces through :meth:`kill_shard` exactly like an explicit kill, so
  the requeue/exactly-once story below carries over verbatim. Requires
  ``backends`` so the picklable ones can ship to the workers at spawn.

Shard-count invariance
----------------------
Results, call counts, and per-tier meter totals are identical for any
shard count (test-enforced for shards in {1, 2, 4} under both drivers):
morsel boundaries don't depend on the shard count, batch formation in the
``BatchCoalescer`` stays *global* (one reorder buffer in morsel order —
only batch execution round-robins across shard pools), and the default
process-wide shared ``OutputCache`` bills cross-shard duplicates once
through the single-flight claim/publish protocol. ``shared_cache=False``
(``ctx.shard_cache = "local"``) opts into shard-local memoization —
cheaper coordination, but cross-shard duplicates then bill per shard, so
it deliberately trades the invariance guarantee away.

Metering
--------
Calls bill into per-(target meter, shard) staging meters; the executor
calls :meth:`ShardedDispatcher.finalize` once per execution, which merges
the staging meters into the target with ``UsageMeter.merge`` — entries
sort by their logical (operator, morsel/batch, chunk, call) key, so two
threaded sharded runs that made the same calls report byte-identical
combined logs regardless of thread arrival order.
"""
from __future__ import annotations

import threading
from concurrent.futures import CancelledError, Future
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import backends as bk
from repro_torch.core import runtime as rt

# composite tier-name encoding for the shared event scheduler's
# per-(shard, tier) pools
_SHARD_SEP = "\x1f"
_SHARD_MARK = "\x02"


def split_quota(total: int, shards: int) -> List[int]:
    """Split a per-tier serving quota into per-shard shares: integer
    division with the remainder to shard 0, and a floor of one worker per
    shard (a quota smaller than the shard count over-subscribes rather
    than starving shards)."""
    shards = max(1, int(shards))
    total = max(1, int(total))
    base, rem = divmod(total, shards)
    return [max(1, base + (rem if s == 0 else 0)) for s in range(shards)]


def _compose(shard: int, tier: str) -> str:
    if tier == rt.HOST_TIER:        # one Python process: host work is one
        return tier                 # global resource, never sharded
    return f"{_SHARD_MARK}{shard}{_SHARD_SEP}{tier}"


def _decompose(tier: str) -> Tuple[Optional[int], str]:
    if tier.startswith(_SHARD_MARK) and _SHARD_SEP in tier:
        shard, base = tier[1:].split(_SHARD_SEP, 1)
        return int(shard), base
    return None, tier


class ShardEventScheduler(rt.EventScheduler):
    """An :class:`runtime.EventScheduler` whose pools are keyed by
    composite (shard, tier) names: quota'd tiers get their split share
    per shard, un-quota'd tiers get the full default width per shard
    (each shard is its own replica). ``mode="sync"`` still collapses
    everything onto one worker — sequential accounting is shard-blind."""

    def __init__(self, shards: int, concurrency: int = 16,
                 per_tier: Optional[Dict[str, int]] = None,
                 mode: str = "async"):
        super().__init__(concurrency, per_tier=None, mode=mode)
        self.shards = max(1, int(shards))
        self._base_per_tier = dict(per_tier or {})

    def workers(self, tier: str) -> int:
        if self.mode == "sync" or tier == rt.HOST_TIER:
            return 1
        shard, base = _decompose(tier)
        quota = self._base_per_tier.get(base)
        if quota is not None:
            return split_quota(quota, self.shards)[shard or 0]
        return max(1, int(self.concurrency))


class _ShardSchedulerView:
    """The scheduler one shard's ``SimulatedDispatcher`` sees: submits
    land on the shared :class:`ShardEventScheduler` under composite
    (shard, tier) pool names, so every shard replays onto ONE event
    timeline (deterministic Table-9 accounting) while still respecting
    its own serving quota."""

    def __init__(self, sched: ShardEventScheduler, shard: int):
        self._sched = sched
        self._shard = shard

    def submit(self, tier: str, duration_s: float,
               ready_s: float = 0.0) -> float:
        return self._sched.submit(_compose(self._shard, tier), duration_s,
                                  ready_s=ready_s)

    def drain(self, meter: bk.UsageMeter, cursor: int,
              ready_s: float = 0.0) -> Tuple[int, float]:
        log = meter.call_log
        finish = ready_s
        for tier, lat in log[cursor:]:
            finish = max(finish, self.submit(tier, lat, ready_s))
        return len(log), finish

    def barrier(self) -> float:
        return self._sched.barrier()

    @property
    def makespan(self) -> float:
        return self._sched.makespan


class _ResilientTask:
    """A chain task that survives its shard dying while still queued.

    ``ThreadPoolDispatcher.abandon`` cancels queued (never-started) chain
    tasks; their futures raise ``CancelledError``. Since a cancelled task
    has no side effects, re-running its ``fn`` is exactly-once — and any
    backend calls the re-run makes route through the owning
    :class:`ShardedDispatcher`, which now sends them to surviving shards.
    Already-*running* tasks are untouched by ``abandon`` and complete
    normally (their calls bill exactly once into the dead shard's staging
    meter, which ``finalize`` still merges).

    Unlike the reference, the re-run starts the moment the task is
    cancelled, on a thread of its own, instead of when a caller first asks
    for the result. The port's executor makes an operator's morsels claim
    the output cache in morsel order, so a later morsel's step blocks its
    chain thread until the cancelled morsel has claimed. A re-run queued
    on a survivor's chain pool (or one that waits for a caller stuck
    behind those blocked steps) could wait for ever once the survivor's
    pool is full of them; a thread of its own cannot be queued behind
    anything."""

    __slots__ = ("_disp", "_up", "_fn", "_task", "_lock", "_redo")

    def __init__(self, disp: "ShardedDispatcher", task, fn, shard: int):
        self._disp = disp
        self._up = task
        self._fn = fn
        self._lock = threading.Lock()
        self._redo: Optional[Future] = None
        while True:
            s = disp._route(shard)
            try:
                self._task = disp._inner[s].defer(task, fn)
                break
            except RuntimeError:
                # raced a kill at submit time ("cannot schedule new
                # futures after shutdown"): re-route and try again
                if not disp.is_dead(s):
                    raise
                shard = s
        self._task._fut.add_done_callback(self._requeue)

    def _requeue(self, fut: Future) -> None:
        if fut.cancelled():
            threading.Thread(target=self._rerun, name="morsel-requeue",
                             daemon=True).start()

    def _rerun(self) -> Future:
        """Run ``fn`` once, whoever asks first; every caller gets the
        future of that one run."""
        with self._lock:
            redo, first = self._redo, self._redo is None
            if first:
                redo = self._redo = Future()
        if first:
            try:
                value, ready = self._up.result()
                redo.set_result(self._fn(value, ready))
            except BaseException as e:
                redo.set_exception(e)
        return redo

    def result(self):
        try:
            return self._task.result()
        except CancelledError:
            return self._rerun().result()


class ShardedDispatcher(rt.Dispatcher):
    """N shard workers behind the single ``Dispatcher`` interface.

    The executor routes every morsel task to ``shard_of(morsel_idx)``
    (round-robin); each shard's chains and backend calls run on that
    shard's inner dispatcher. ``kind`` reports the underlying driver so
    driver-conditional logic (coalescer linger mode, ephemeral flush
    threads) behaves identically to the unsharded dispatchers.

    Liveness under threads is the chain-FIFO argument applied per
    shard: the executor defers tasks in operator-major order, so within
    every shard's FIFO a task's intra-shard dependency is earlier in the
    queue, and cross-shard waits (a coalesced batch needing another
    shard's submission, a cache follower awaiting another shard's
    publish) resolve on that *other* shard's pools, which progress
    independently.

    Failed shards: :meth:`kill_shard` marks a shard dead (explicitly, or
    automatically once ``failure_threshold`` consecutive backend-call
    failures land on it). Every entry point re-routes dead-shard work to
    the ring-next live shard; a threads shard's pools are ``abandon``\\ ed
    (running calls finish and bill once, queued tasks cancel), cancelled
    chains re-run via :class:`_ResilientTask`, and cancelled backend
    calls retry on a survivor. With the default shared cache the retried
    call's already-completed chunks resolve as cache hits, so call counts
    and the merged logical-key log stay exactly what an undisturbed run
    produces; the dead shard's staging meter still merges at
    ``finalize``, so no billed call is ever lost or double-counted."""

    def __init__(self, shards: int, driver: str = "threads",
                 concurrency: int = 16,
                 per_tier: Optional[Dict[str, int]] = None,
                 mode: str = "async", shared_cache: bool = True,
                 policy: Optional[rt.FaultPolicyRuntime] = None,
                 failure_threshold: Optional[int] = None,
                 backends: Optional[Dict[str, Any]] = None,
                 heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 10.0):
        if driver not in (*rt.DRIVERS, "procs"):
            raise ValueError(f"unknown driver {driver!r} "
                             f"(expected one of {(*rt.DRIVERS, 'procs')})")
        self.n_shards = max(1, int(shards))
        self.kind = driver
        self.concurrency = max(1, int(concurrency))
        self.per_tier = dict(per_tier or {})
        self.shared_cache = bool(shared_cache)
        self.policy = policy
        self._failure_threshold = failure_threshold
        self._dead: set = set()
        self._consec_fail: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._local_caches: Dict[int, rt.OutputCache] = {}
        # per-query round-robin cursor offsets: concurrently admitted
        # queries each rotate their morsel->shard mapping by their own
        # base, so a multi-tenant server spreads queries across shards
        # instead of every query starting on shard 0
        self._query_base: Dict[object, int] = {}
        self._next_base = 0
        # target-meter id -> (target ref, per-shard staging meters)
        self._staging: Dict[int, Tuple[bk.UsageMeter,
                                       List[bk.UsageMeter]]] = {}
        self._sched: Optional[ShardEventScheduler] = None
        if driver == "simulated":
            self._sched = ShardEventScheduler(self.n_shards,
                                              self.concurrency,
                                              per_tier=self.per_tier,
                                              mode=mode)
            self._inner: List[rt.Dispatcher] = [
                rt.SimulatedDispatcher(_ShardSchedulerView(self._sched, s),
                                       policy=policy)
                for s in range(self.n_shards)]
        elif driver == "procs":
            # local import: process_workers builds on this module's deps
            from repro_torch.distributed.process_workers import (
                ProcessShardDispatcher, shippable_backends)
            ship = shippable_backends(backends or {})
            self._inner = [
                ProcessShardDispatcher(
                    self.concurrency,
                    per_tier={t: split_quota(q, self.n_shards)[s]
                              for t, q in self.per_tier.items()},
                    mode=mode, policy=policy,
                    backends=ship, shard=s,
                    on_death=self._on_worker_death,
                    heartbeat_s=heartbeat_s,
                    heartbeat_timeout_s=heartbeat_timeout_s)
                for s in range(self.n_shards)]
            try:
                for d in self._inner:
                    d.wait_ready()
            except BaseException:
                for d in self._inner:
                    d.close()
                raise
        else:
            host_lock = threading.Lock()
            self._inner = [
                rt.ThreadPoolDispatcher(
                    self.concurrency,
                    per_tier={t: split_quota(q, self.n_shards)[s]
                              for t, q in self.per_tier.items()},
                    mode=mode, host_lock=host_lock, policy=policy)
                for s in range(self.n_shards)]

    # -- shard routing ---------------------------------------------------
    def shard_of(self, morsel_idx: int, query=None) -> int:
        """Round-robin by morsel index; a ``query`` id adds the query's
        own cursor offset (assigned round-robin at first sight). The
        offset only rotates *placement* — results, call counts, and
        meter totals are placement-invariant, so per-query offsets keep
        the shard-count-invariance contract intact."""
        if query is None or self.n_shards == 1:
            return morsel_idx % self.n_shards
        with self._lock:
            base = self._query_base.get(query)
            if base is None:
                base = self._next_base % self.n_shards
                self._query_base[query] = base
                self._next_base += 1
        return (morsel_idx + base) % self.n_shards

    def release_query(self, query) -> None:
        with self._lock:
            self._query_base.pop(query, None)

    # -- shard liveness --------------------------------------------------
    def _route(self, shard: int) -> int:
        """The physical shard that serves logical shard ``shard``: itself
        while alive, else the ring-next live shard (every caller of a
        dead shard deterministically agrees on the replacement)."""
        shard = shard % self.n_shards
        with self._lock:
            if shard not in self._dead:
                return shard
            for k in range(1, self.n_shards):
                s = (shard + k) % self.n_shards
                if s not in self._dead:
                    return s
        raise rt.ShardDeadError("no live shard available")

    def is_dead(self, shard: int) -> bool:
        with self._lock:
            return shard in self._dead

    def live_shards(self) -> List[int]:
        with self._lock:
            return [s for s in range(self.n_shards)
                    if s not in self._dead]

    def kill_shard(self, shard: int) -> None:
        """Declare one shard worker dead: subsequent work re-routes to
        survivors, queued chain tasks and backend calls on the dead
        shard's pools are cancelled (and requeued by the entry points
        that observe the cancellation), already-running calls complete
        and bill exactly once. Idempotent; killing the last live shard
        is refused — an execution with zero workers cannot finish."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")
        with self._lock:
            if shard in self._dead:
                return
            if len(self._dead) + 1 >= self.n_shards:
                raise ValueError("cannot kill the last live shard")
            self._dead.add(shard)
            self._consec_fail.pop(shard, None)
        abandon = getattr(self._inner[shard], "abandon", None)
        if abandon is not None:
            abandon()

    def _on_worker_death(self, shard: int) -> None:
        """Process-worker death callback (crash / SIGKILL / missed
        heartbeat), invoked by the ``ProcessShardClient`` monitor
        *before* it fails the shard's pending call futures — so by the
        time a caller sees ``ShardDeadError``, the shard is already
        marked dead and ``_shard_died_under`` routes the retry to a
        survivor. Losing the last live shard (or dying mid-construction)
        is not recoverable by requeue; those calls then fail with the
        worker's ``ShardDeadError``."""
        try:
            self.kill_shard(shard)
        except (ValueError, AttributeError):
            pass

    def _shard_died_under(self, shard: int, exc: BaseException) -> bool:
        """Whether ``exc`` means "this shard's pools were torn down",
        as opposed to a genuine backend failure."""
        if not self.is_dead(shard):
            return False
        if isinstance(exc, (CancelledError, rt.ShardDeadError)):
            return True
        return (isinstance(exc, RuntimeError)
                and "shutdown" in str(exc))

    def _note_call_result(self, shard: int, ok: bool) -> None:
        """Consecutive-failure shard liveness: ``failure_threshold``
        straight backend-call failures on one shard mark it dead (its
        pending work requeues onto survivors); any success resets the
        count. The failing call itself still raises — the threshold is a
        health signal for *future* routing, not a retry mechanism (the
        CallPolicy layer owns retries)."""
        th = self._failure_threshold
        if th is None or th <= 0:
            return
        with self._lock:
            if ok:
                self._consec_fail[shard] = 0
                return
            n = self._consec_fail.get(shard, 0) + 1
            self._consec_fail[shard] = n
            live = self.n_shards - len(self._dead)
            should_kill = (n >= th and shard not in self._dead
                           and live > 1)
        if should_kill:
            self.kill_shard(shard)

    def shard_quota(self, tier: str, shard: int) -> int:
        """The (shard, tier) pool width actually in force."""
        quota = self.per_tier.get(tier)
        if quota is not None:
            return split_quota(quota, self.n_shards)[shard]
        return self.concurrency

    # -- metering --------------------------------------------------------
    def meter_for(self, meter: bk.UsageMeter, shard: int) -> bk.UsageMeter:
        with self._lock:
            entry = self._staging.get(id(meter))
            if entry is None or entry[0] is not meter:
                entry = (meter, [bk.UsageMeter()
                                 for _ in range(self.n_shards)])
                self._staging[id(meter)] = entry
            return entry[1][shard]

    def finalize(self, meter: bk.UsageMeter) -> None:
        with self._lock:
            entry = self._staging.pop(id(meter), None)
        if entry is not None:
            meter.absorb(bk.UsageMeter.merge(entry[1]))

    def _cache_for(self, cache: Optional[rt.OutputCache],
                   shard: int) -> Optional[rt.OutputCache]:
        if cache is None or self.shared_cache:
            return cache
        with self._lock:
            local = self._local_caches.get(shard)
            if local is None:
                local = self._local_caches[shard] = rt.OutputCache()
            return local

    # -- Dispatcher interface --------------------------------------------
    def defer(self, task, fn, shard: int = 0):
        if self.kind == "simulated":
            # simulated defers execute fn inline at defer time; there is
            # no queue to cancel, so plain routing suffices
            return self._inner[self._route(shard)].defer(task, fn)
        return _ResilientTask(self, task, fn, shard)

    def fanout(self, tier_name: str):
        # non-sharded callers (optimizer sample flows) run on shard 0
        return self._inner[self._route(0)].fanout(tier_name)

    def run_llm(self, op, values, backend, tier_name, meter, *,
                batch_size: int = 1,
                cache: Optional[rt.OutputCache] = None,
                ready_s: float = 0.0, shard: int = 0,
                key: Optional[tuple] = None):
        while True:
            s = self._route(shard)
            try:
                outs = self._inner[s].run_llm(
                    op, values, backend, tier_name,
                    self.meter_for(meter, s),
                    batch_size=batch_size,
                    cache=self._cache_for(cache, s),
                    ready_s=ready_s, shard=s, key=key)
            except BaseException as e:
                if self._shard_died_under(s, e):
                    # the shard died with this call queued/cancelled:
                    # retry on a survivor. Chunks that completed before
                    # the kill already published to the (shared) cache,
                    # so the retry re-bills nothing it shouldn't.
                    shard = s
                    continue
                self._note_call_result(s, ok=False)
                raise
            self._note_call_result(s, ok=True)
            return outs

    def run_host(self, fn, n_rows: int, ready_s: float = 0.0,
                 shard: int = 0):
        return self._inner[self._route(shard)].run_host(
            fn, n_rows, ready_s=ready_s)

    def run_udf(self, op, table, values, ready_s: float = 0.0,
                shard: int = 0):
        """UDF steps route like backend calls — under ``procs`` they run
        in the shard's worker process, and a shard dying mid-step retries
        on the ring-next survivor (UDF steps are pure functions of their
        inputs, so a re-run is exactly-once by construction)."""
        while True:
            s = self._route(shard)
            try:
                return self._inner[s].run_udf(op, table, values,
                                              ready_s=ready_s, shard=s)
            except BaseException as e:
                if self._shard_died_under(s, e):
                    shard = s
                    continue
                raise

    def occupancy(self) -> Dict[str, List[float]]:
        """Merged per-tier busy offsets across all shard pools, under the
        tier's *base* name — a ``CostModel`` makespan replay seeds from
        one tier-wide slot list no matter the shard topology. (The base
        class returns ``{}``, which made occupancy-seeded cost estimates
        assume idle pools exactly on the sharded serving path.)"""
        out: Dict[str, List[float]] = {}
        if self._sched is not None:
            sched = self._sched
            with sched._elock:
                now = sched._floor
                for key, pool in sched._pools.items():
                    if key in (rt.HOST_TIER, "\x00sync"):
                        continue
                    _, base = _decompose(key)
                    busy = [t - now for t in pool if t > now]
                    if busy:
                        out.setdefault(base, []).extend(busy)
        else:
            for d in self._inner:
                for tier, busy in d.occupancy().items():
                    out.setdefault(tier, []).extend(busy)
        return {t: sorted(busy) for t, busy in out.items()}

    def checkpoint(self, meter: bk.UsageMeter, cursor: int) -> int:
        return self._inner[0].checkpoint(meter, cursor)

    @property
    def wall_s(self) -> float:
        if self._sched is not None:
            return self._sched.makespan
        return max(d.wall_s for d in self._inner)

    def close(self) -> None:
        # absorb any staging a caller never finalized so usage is not lost
        with self._lock:
            leftovers = list(self._staging.values())
            self._staging.clear()
        for target, stages in leftovers:
            target.absorb(bk.UsageMeter.merge(stages))
        for d in self._inner:
            d.close()
