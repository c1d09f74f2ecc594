"""Execution runtime: the single scheduling/dispatch surface shared by the
executor, the judge, and both optimizers.

Four pieces:

* :class:`EventScheduler` — a discrete-event makespan model. Every LLM call
  becomes a *job* ``(tier, duration, ready_time)``; each tier owns a pool of
  workers (paper: 16 coroutines) and a job starts on the earliest-free
  worker of its tier, no earlier than its ready time. The resulting
  makespan replaces the old per-operator "waves" formulas (the deleted
  ``executor._makespan`` / ``physical_optimizer._wall``): unlike waves, the
  event model fills ragged-wave idle slots, overlaps operators that run on
  different tiers, and honours per-tier concurrency caps. ``mode="sync"``
  collapses every tier onto one worker, reproducing the paper's Table-9
  sequential accounting.

* :class:`Dispatcher` — how operator work actually *runs*. Two drivers:

  - :class:`SimulatedDispatcher` (``driver="simulated"``): backend calls
    execute inline, one after another; their metered per-call latencies are
    replayed through an :class:`EventScheduler`, so ``wall_s`` is a
    deterministic *model* of overlapped execution (Table-9 accounting, and
    the mode every hand-checkable schedule test uses).
  - :class:`ThreadPoolDispatcher` (``driver="threads"``): backend calls run
    on per-tier **bounded worker pools** (pool caps are serving quotas —
    ``per_tier_concurrency`` wins over the default ``concurrency``), morsel
    chains advance on a separate chain pool, and morsels of independent
    operators genuinely overlap. ``wall_s`` is **measured** wall time.

  Results, call counts, and per-tier meter totals are identical across
  drivers: the :class:`OutputCache` is single-flight (a value computed by
  one in-flight morsel is awaited, not re-billed, by concurrent morsels)
  and ``UsageMeter`` is lock-protected. With ``batch_size > 1`` the
  :class:`BatchCoalescer` forms batches in *logical row order* (morsel
  index, then row position) regardless of thread arrival order, and
  cross-morsel duplicate values dedupe *before* batch formation — so the
  grouping of misses into batched calls is deterministic and identical
  across drivers (this closes PR 2's documented corner where duplicate
  values could land in different batched calls per driver).

  A third layer sits above both drivers:
  ``distributed.morsel_shards.ShardedDispatcher`` (``ctx.shards > 1``)
  partitions the morsel stream round-robin across N shard workers, each
  backed by its own inner dispatcher — pool-per-(shard, tier) under
  threads (explicit ``per_tier_concurrency`` caps are *serving quotas*
  split across shards, remainder to shard 0; the default ``concurrency``
  is each shard's own replica width), one shared event scheduler with
  per-(shard, tier) pools under simulation. Morsel chains advance on
  per-shard chain pools; per-shard staging meters merge deterministically
  (``UsageMeter.merge``, sorted by logical call key) into the context
  meter when the executor finalizes. Batch formation stays *global*
  (one reorder buffer in morsel order, shared cache dedupe) so results,
  call counts, and per-tier totals are shard-count invariant; only batch
  *execution* round-robins across the (shard, tier) pools.

  Above everything sits ``launch.query_server.QueryServer``: ONE
  long-lived dispatcher (``ExecutionContext.dispatcher()``) serves
  continuously admitted queries, each executed with a ``query_key`` that
  scopes its logical meter keys and shard cursor — so per-query meters
  finalize independently while ``per_tier_concurrency`` caps act as
  serving quotas across tenants. ``ExecutionContext.close()`` is the
  matching shutdown path (release pools; the cache's creator closes the
  cache — ``OutputCache.close`` releases its in-flight reservations).

* :class:`BatchCoalescer` — cross-morsel batch packing. With
  ``batch_size > 1`` a selective upstream filter emits ragged morsels
  whose remainder rows each burn a full batch slot downstream
  (``sum(ceil(s_i/b)) > ceil(S/b)``). The coalescer sits between morsel
  fan-out and the backend: per operator it buffers ready rows from
  *different* morsels into an accumulation queue, flushes a batch the
  moment ``batch_size`` slots fill, and flushes partial batches on a
  morsel-boundary **watermark** (every contributing morsel has reported)
  or after a configurable ``linger_s`` — mirroring the slot-fill logic of
  ``engine.ContinuousBatcher``, one level up the stack. A morsel's
  pipeline resumes as soon as the batches containing *its* rows flush (a
  per-morsel future), so downstream operators keep pipelined start times.
  Under the simulated driver the linger is *event-time* (deterministic);
  under threads a timer thread flushes lingering partials in real time.

* :class:`ExecutionContext` — bundles everything an execution needs
  (backends, default tier, batch size, concurrency, morsel size, driver,
  :class:`OutputCache`, ``UsageMeter``) into one object threaded through
  ``executor.execute``, ``judge.Judge``, the logical optimizer's candidate
  evaluation, and the physical optimizer's sample flow. ``as_context``
  upgrades a bare ``{tier: Backend}`` dict, so every public entry point
  accepts either. ``make_dispatcher()`` builds the context's driver.

* shared operator application — ``run_llm_op`` (cache-aware backend
  dispatch, optionally fanned out over a tier pool), ``bool_mask`` (the one
  place LLM filter outputs are parsed), ``apply_outputs`` and
  ``run_udf_op`` (the one place operator outputs mutate a table).

Per-call latencies flow from the backends through ``UsageMeter.call_log``;
the simulated driver consumes new log entries via
:meth:`EventScheduler.drain`, so any backend that meters itself is
automatically schedulable — and the same log can be *replayed* through an
EventScheduler after a threaded run to report measured vs simulated wall
side by side (``launch/serve.py --semantic`` does exactly that).
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import backends as bk
from repro_torch.core import plan as plan_ir
from repro_torch.core import udf as udf_mod
from repro_torch.core.table import Table

# rows per morsel in the pipelined executor; must stay a multiple of the
# batch size so batch-prompting call counts match the barrier executor
DEFAULT_MORSEL_ROWS = 32

# cost of native (UDF) compute per row — matches the seed executor's model
UDF_SECONDS_PER_ROW = 2e-6

# pseudo-tier for host-side (UDF) compute: one Python process, one worker —
# morsels pipeline against LLM calls but serialize against each other
HOST_TIER = "\x00host"


# ---------------------------------------------------------------------------
# Discrete-event scheduler
# ---------------------------------------------------------------------------

class EventScheduler:
    """Per-tier worker pools + greedy earliest-free-worker placement.

    ``submit`` returns the job's finish time; ``makespan`` is the latest
    finish observed so far. ``barrier()`` forbids later jobs from starting
    before everything already submitted has finished (the physical
    optimizer uses it between dependent sample-flow stages).

    ``submit``/``barrier`` are lock-protected: a long-lived server admits
    queries from concurrent threads, and under the simulated driver they
    all replay onto one shared scheduler — placement must not corrupt the
    pool heaps (the *interleaving* of concurrently admitted queries is
    still arrival-dependent; only solo replays are fully deterministic).
    """

    def __init__(self, concurrency: int = 16,
                 per_tier: Optional[Dict[str, int]] = None,
                 mode: str = "async"):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        self.mode = mode
        self.concurrency = max(1, int(concurrency))
        self.per_tier = dict(per_tier or {})
        self._pools: Dict[str, List[float]] = {}
        self._makespan = 0.0
        self._floor = 0.0
        self.n_jobs = 0
        self._elock = threading.Lock()

    def workers(self, tier: str) -> int:
        if self.mode == "sync" or tier == HOST_TIER:
            return 1
        return max(1, int(self.per_tier.get(tier, self.concurrency)))

    def _pool(self, tier: str) -> List[float]:
        # sync mode: one global single-worker pool => pure sequential sum
        # (host compute stays its own resource even then)
        key = tier if (self.mode != "sync" or tier == HOST_TIER) \
            else "\x00sync"
        pool = self._pools.get(key)
        if pool is None:
            pool = [0.0] * self.workers(tier)
            self._pools[key] = pool
        return pool

    def submit(self, tier: str, duration_s: float,
               ready_s: float = 0.0) -> float:
        """Schedule one job; returns its finish time."""
        with self._elock:
            pool = self._pool(tier)
            free = heapq.heappop(pool)
            start = max(free, ready_s, self._floor)
            finish = start + max(0.0, duration_s)
            heapq.heappush(pool, finish)
            self.n_jobs += 1
            if finish > self._makespan:
                self._makespan = finish
            return finish

    def barrier(self) -> float:
        """All later jobs start no earlier than the current makespan."""
        with self._elock:
            self._floor = self._makespan
            return self._floor

    def seed_occupancy(self, occupancy: Optional[Dict[str, List[float]]]
                       ) -> None:
        """Pre-load per-tier busy-until offsets (``Dispatcher.occupancy()``
        shape: tier -> remaining-busy seconds per occupied worker slot) as
        zero-ready jobs, so later submissions see the pools exactly as the
        live dispatcher does — the digital-twin seed every ``CostModel``
        makespan replay and ``QueryServer`` admission estimate uses."""
        for tname, busy in (occupancy or {}).items():
            for b in busy:
                if b > 0:
                    self.submit(tname, float(b), 0.0)

    def drain(self, meter: bk.UsageMeter, cursor: int,
              ready_s: float = 0.0) -> Tuple[int, float]:
        """Submit every call the meter logged since ``cursor``; returns
        (new cursor, latest finish among the drained jobs)."""
        log = meter.call_log
        finish = ready_s
        for tier, lat in log[cursor:]:
            finish = max(finish, self.submit(tier, lat, ready_s))
        return len(log), finish

    @property
    def makespan(self) -> float:
        return self._makespan


# ---------------------------------------------------------------------------
# LLM-output cache
# ---------------------------------------------------------------------------

def _vkey(v) -> str:
    return v if isinstance(v, str) else repr(v)


class OutputCache:
    """LLM-output memo keyed by (tier, op semantics, value) — thread-safe.

    Semantic operators are deterministic per (model, prompt) here, so
    repeated sample executions — the judge runs the original plan once per
    optimizer iteration, rewritten plans share most operators — hit the
    cache instead of re-invoking the backend. This is the executor-level
    analogue of the paper's computation-reuse theme (cf. QuestCache [18]);
    only cache *misses* are billed. Keys are per-value, so morsel-pipelined
    and barrier execution populate and hit the cache identically.

    Under the threaded driver, concurrent morsels may race on a key. The
    cache is **single-flight**: ``claim`` hands the key to exactly one
    caller (the others get an event to wait on), so a value in flight is
    billed once — the same totals a sequential run produces. Duplicate keys
    *within* one claim are deliberately re-owned, matching the sequential
    path's double-billing of within-request duplicates."""

    def __init__(self):
        self.data: Dict[tuple, Any] = {}
        self.hits = 0
        self.misses = 0
        self.closed = False
        self._lock = threading.Lock()
        # key -> (owner token, event set when the owner publishes/releases)
        self._pending: Dict[tuple, Tuple[object, threading.Event]] = {}

    def key(self, op: plan_ir.Operator, tier: str, batch: int, v) -> tuple:
        return (op.kind, op.instruction, op.input_column, tier, batch,
                _vkey(v))

    def claim(self, keys: Sequence[tuple],
              token: object) -> List[Tuple[str, Any]]:
        """Partition ``keys`` in order into ``("hit", value)``,
        ``("own", None)`` (this caller must compute and publish), or
        ``("wait", event)`` (another caller is computing it)."""
        out: List[Tuple[str, Any]] = []
        with self._lock:
            for k in keys:
                if k in self.data:
                    self.hits += 1
                    out.append(("hit", self.data[k]))
                    continue
                pend = self._pending.get(k)
                if pend is not None and pend[0] is not token:
                    self.hits += 1      # a sequential run would hit here
                    out.append(("wait", pend[1]))
                    continue
                if pend is None and not self.closed:
                    # closed caches stop single-flighting: no reservation
                    # is created after close(), so a draining server can
                    # never re-grow waiters it just released (stragglers
                    # compute solo instead of parking on a dead owner)
                    self._pending[k] = (token, threading.Event())
                self.misses += 1
                out.append(("own", None))
        return out

    def peek(self, k: tuple) -> Tuple[bool, Any]:
        """Non-claiming lookup; counts a hit when present (a sequential run
        would hit here). Used by the :class:`BatchCoalescer` at batch
        formation so cached rows never occupy a batch slot."""
        with self._lock:
            if k in self.data:
                self.hits += 1
                return True, self.data[k]
        return False, None

    def note_hits(self, n: int = 1) -> None:
        """Count hits resolved outside ``claim`` (coalescer followers:
        duplicate rows answered by an in-flight batch slot)."""
        with self._lock:
            self.hits += n

    def publish(self, k: tuple, value) -> None:
        with self._lock:
            self.data[k] = value
            pend = self._pending.pop(k, None)
        if pend is not None:
            pend[1].set()

    def release(self, keys: Sequence[tuple], token: object) -> None:
        """Abandon in-flight reservations (owner failed); waiters recompute."""
        events = []
        with self._lock:
            for k in keys:
                pend = self._pending.get(k)
                if pend is not None and pend[0] is token:
                    events.append(self._pending.pop(k)[1])
        for e in events:
            e.set()

    def wait_value(self, k: tuple,
                   event: threading.Event) -> Tuple[bool, Any]:
        event.wait()
        with self._lock:
            if k in self.data:
                return True, self.data[k]
        return False, None

    def close(self) -> None:
        """Terminal, idempotent shutdown — the cache's *creator* calls
        this once nothing should be waiting anymore: every in-flight
        reservation is released (threads blocked in ``wait_value`` on an
        owner that will never publish unblock and recompute solo) and no
        NEW reservation is ever created, so a draining server cannot
        re-grow waiters it just released. Published data stays readable,
        but single-flight dedupe is off from here on — do not close a
        cache other live contexts still execute against."""
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            self.closed = True
        for _, event in pending:
            event.set()


# ---------------------------------------------------------------------------
# Fault tolerance: call policy, retries, circuit breaker, tier fallback
# ---------------------------------------------------------------------------

class TransientCallError(RuntimeError):
    """A backend call failed in a way a retry may fix (the kind of error
    a real LLM endpoint returns for overload / 5xx / connection resets).
    Chaos harnesses (``testing.FlakyBackend``) raise it; policies retry
    any ``Exception``, but this type names the contract."""


class CallTimeoutError(TransientCallError):
    """A backend call exceeded the policy's per-call deadline."""


class ShardDeadError(RuntimeError):
    """Raised when work is routed to a shard marked dead and no live
    shard remains to absorb it."""


# negative-int markers appended to logical meter keys so retried / fallback
# attempts sort deterministically next to their primary attempt in a merged
# log without ever colliding with real chunk ordinals (>= 0). The cascade
# already reserves -1 for its embed pass.
RETRY_KEY_MARK = -2
FALLBACK_KEY_MARK = -3

_CALL_LOCAL = threading.local()


def current_call_timeout() -> Optional[float]:
    """The per-call deadline (seconds) installed by the active
    :class:`CallPolicy` for the backend call running on this thread, or
    None when no policy is enforcing one. Backends that can bound their
    own work (and fault harnesses deciding whether a call "times out")
    read it here — the policy layer cannot preempt a running call, so the
    deadline is cooperative."""
    return getattr(_CALL_LOCAL, "timeout_s", None)


@contextlib.contextmanager
def _call_deadline(timeout_s: Optional[float]):
    prev = getattr(_CALL_LOCAL, "timeout_s", None)
    _CALL_LOCAL.timeout_s = timeout_s
    try:
        yield
    finally:
        _CALL_LOCAL.timeout_s = prev


@dataclasses.dataclass(frozen=True)
class CallPolicy:
    """Per-call fault-tolerance policy (all defaults = fail-fast, i.e.
    today's behaviour; an all-default policy is *inactive* and the
    runtime takes the exact pre-policy code paths, byte for byte).

    ``retries``             extra attempts per backend call after the
                            first failure.
    ``call_timeout_s``      cooperative per-call deadline, surfaced to
                            backends via :func:`current_call_timeout`.
    ``backoff_s``           base backoff between attempts. Sleeps only
                            happen under the threads driver; the delay is
                            deterministic — ``backoff_s * attempt *
                            unit_hash(seed, key, attempt)`` — so a fixed
                            fault plan reproduces the same schedule.
    ``retry_budget``        global cap on retry attempts across the whole
                            dispatcher (None = unlimited). Exhausted
                            budget = no more retries, straight to
                            fallback/raise.
    ``breaker_threshold``   consecutive *exhausted* calls on one
                            (tier, shard) before its circuit opens and
                            calls skip straight to the fallback
                            (0 = breaker disabled). A tripped breaker
                            stays open for the dispatcher's lifetime.
    ``fallback_tier``       sibling tier that serves a call once its
                            primary exhausts retries or its breaker is
                            open (None = re-raise). Fallback calls bill
                            under the fallback tier's own name with a
                            ``FALLBACK_KEY_MARK`` key suffix, so the
                            substitution is visible in the log and the
                            CostModel calibrates the tier that actually
                            served.
    ``shard_failure_threshold``  consecutive failed calls on one shard
                            before ``ShardedDispatcher`` declares the
                            shard dead and requeues its pending work
                            (None = detection off; ``kill_shard`` only).
    ``seed``                seed for the deterministic backoff jitter.
    """

    retries: int = 0
    call_timeout_s: Optional[float] = None
    backoff_s: float = 0.0
    retry_budget: Optional[int] = None
    breaker_threshold: int = 0
    fallback_tier: Optional[str] = None
    shard_failure_threshold: Optional[int] = None
    seed: int = 0

    @property
    def active(self) -> bool:
        """Whether the per-call layer must engage. All-default policies
        (and ones that only set ``shard_failure_threshold``) keep the
        pre-policy call path."""
        return (self.retries > 0 or self.call_timeout_s is not None
                or self.breaker_threshold > 0
                or self.fallback_tier is not None
                or self.retry_budget is not None)


class FaultPolicyRuntime:
    """Shared mutable state enforcing one :class:`CallPolicy` across a
    dispatcher: retry-budget counter, per-(tier, shard) breaker state,
    and fault statistics. One instance is shared by every inner shard
    dispatcher so the budget and breakers are global to the execution.

    ``invoke`` wraps exactly one logical backend call (one chunk). It
    sits *below* the :class:`OutputCache` — retries re-run only the
    failed chunk, and a call ultimately served by the fallback tier still
    publishes under the primary tier's cache key (the cache stores the
    logical call's answer, whatever tier produced it)."""

    def __init__(self, policy: CallPolicy,
                 backends: Optional[Dict[str, Any]] = None,
                 real_time: bool = False):
        self.policy = policy
        self.backends = dict(backends or {})
        self.real_time = bool(real_time)
        self._lock = threading.Lock()
        self._consec: Dict[Tuple[str, int], int] = {}
        self._open: set = set()
        self._retries_spent = 0
        self.stats = {"attempts": 0, "retries": 0, "failures": 0,
                      "exhausted": 0, "breaker_trips": 0,
                      "fallback_calls": 0, "budget_denied": 0}

    # -- breaker ---------------------------------------------------------
    def breaker_open(self, tier_name: str, shard: int) -> bool:
        if self.policy.breaker_threshold <= 0:
            return False
        with self._lock:
            return (tier_name, shard) in self._open

    def _note_result(self, tier_name: str, shard: int, ok: bool) -> None:
        th = self.policy.breaker_threshold
        if th <= 0:
            return
        k = (tier_name, shard)
        with self._lock:
            if ok:
                self._consec[k] = 0
                return
            n = self._consec.get(k, 0) + 1
            self._consec[k] = n
            if n >= th and k not in self._open:
                self._open.add(k)
                self.stats["breaker_trips"] += 1

    def reset_breakers(self) -> None:
        """Close every open breaker (operator intervention; nothing in
        the hot path re-closes one)."""
        with self._lock:
            self._open.clear()
            self._consec.clear()

    # -- retry budget / backoff -----------------------------------------
    def _take_retry_token(self) -> bool:
        budget = self.policy.retry_budget
        with self._lock:
            if budget is not None and self._retries_spent >= budget:
                self.stats["budget_denied"] += 1
                return False
            self._retries_spent += 1
            return True

    def _backoff(self, key: Optional[tuple], attempt: int) -> None:
        base = self.policy.backoff_s
        if base <= 0.0 or not self.real_time:
            return   # simulated driver: backoff is modeled as zero-cost
        jitter = bk._unit_hash("backoff", self.policy.seed,
                               repr(key), attempt)
        time.sleep(base * attempt * (0.5 + 0.5 * jitter))

    # -- fallback --------------------------------------------------------
    def fallback_backend(self, tier_name: str):
        fb = self.policy.fallback_tier
        if fb is None or fb == tier_name:
            return None, None
        backend = self.backends.get(fb)
        if backend is None:
            return None, None
        return fb, backend

    def _run_fallback(self, fb_backend, op, values, meter, batch_size,
                      key: Optional[tuple]):
        with self._lock:
            self.stats["fallback_calls"] += 1
        fkey = None if key is None else tuple(key) + (FALLBACK_KEY_MARK,)
        with _call_deadline(self.policy.call_timeout_s):
            if fkey is None:
                return fb_backend.run_values(op, values, meter=meter,
                                             batch_size=batch_size)
            with meter.keyed(fkey):
                return fb_backend.run_values(op, values, meter=meter,
                                             batch_size=batch_size)

    # -- the call wrapper ------------------------------------------------
    def invoke(self, backend, tier_name: str, op, values, meter,
               batch_size: int, key: Optional[tuple],
               shard: int = 0) -> List[Any]:
        pol = self.policy
        fb_name, fb_backend = self.fallback_backend(tier_name)
        if fb_backend is not None and self.breaker_open(tier_name, shard):
            return self._run_fallback(fb_backend, op, values, meter,
                                      batch_size, key)
        last: Optional[BaseException] = None
        for attempt in range(max(0, pol.retries) + 1):
            if attempt > 0 and not self._take_retry_token():
                break
            self._backoff(key, attempt)
            akey = key if (attempt == 0 or key is None) \
                else tuple(key) + (RETRY_KEY_MARK, attempt)
            with self._lock:
                self.stats["attempts"] += 1
                if attempt > 0:
                    self.stats["retries"] += 1
            try:
                with _call_deadline(pol.call_timeout_s):
                    if akey is None:
                        outs = backend.run_values(op, values, meter=meter,
                                                  batch_size=batch_size)
                    else:
                        with meter.keyed(akey):
                            outs = backend.run_values(
                                op, values, meter=meter,
                                batch_size=batch_size)
                self._note_result(tier_name, shard, ok=True)
                return outs
            except Exception as e:
                last = e
                with self._lock:
                    self.stats["failures"] += 1
        with self._lock:
            self.stats["exhausted"] += 1
        self._note_result(tier_name, shard, ok=False)
        if fb_backend is not None:
            return self._run_fallback(fb_backend, op, values, meter,
                                      batch_size, key)
        assert last is not None
        raise last

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self.stats)
            out["open_breakers"] = sorted(self._open)
            out["retry_budget_spent"] = self._retries_spent
        return out


def run_backend_calls(op: plan_ir.Operator, values: Sequence[Any], backend,
                      meter: bk.UsageMeter, batch_size: int = 1,
                      fanout: Optional[Callable] = None,
                      key: Optional[tuple] = None,
                      policy: Optional[FaultPolicyRuntime] = None,
                      tier_name: str = "", shard: int = 0,
                      positions: Optional[Sequence[int]] = None,
                      on_chunk: Optional[Callable] = None) -> List[Any]:
    """Invoke the backend over ``values``. Without a ``fanout`` the whole
    request is one inline ``run_values`` (the backend batches internally).
    With a ``fanout`` — a callable mapping a list of thunks to their results,
    supplied by :class:`ThreadPoolDispatcher` — each batch-sized chunk
    becomes its own ``run_values`` call on the tier's worker pool, so the
    per-call latencies genuinely overlap. Chunk boundaries equal the
    backend's internal batching, so call counts and meter totals match the
    inline path exactly.

    ``key`` is the call site's logical identity (e.g. ``(op, morsel)``);
    it is re-entered as the meter's ambient key *inside* each thunk so the
    billed entries carry it even when they run on a tier-pool thread —
    ``UsageMeter.merge`` sorts by these keys for deterministic shard-merge
    logs.

    ``policy`` (an *active* :class:`FaultPolicyRuntime`) wraps every chunk
    call in retry/deadline/breaker/fallback enforcement. With a policy the
    inline (no-fanout) path chunks exactly like the fanout path and bills
    each chunk under ``key + (j,)`` — normalizing the per-attempt key shape
    across drivers so a seeded fault plan draws identically under both
    (without a policy the inline path is byte-identical to the pre-policy
    runtime, including key shapes).

    ``positions`` (parallel to ``values``) are each value's index in the
    call site's *full* row set — the cache layer passes the ``own``
    indices so a value set that is a union of whole original chunks
    (e.g. a shard-death requeue whose completed chunks now cache-hit)
    bills each chunk under its ORIGINAL index, keeping the merged log
    byte-identical to a healthy run. When the chunk-aligned grouping
    does not reproduce the compact chunking (cache holes inside a
    chunk), compact indices are kept — exactly the pre-existing
    behaviour. ``on_chunk(chunk_positions, chunk_outputs)`` fires the
    moment each chunk's call returns (on the pool thread under a
    ``fanout``); the cache layer uses it for incremental publishing so
    sibling-chunk failure never discards completed work."""
    values = list(values)
    policed = policy is not None and policy.policy.active
    if fanout is None and not policed:
        if key is None:
            return backend.run_values(op, values, meter=meter,
                                      batch_size=batch_size)
        with meter.keyed(key):
            return backend.run_values(op, values, meter=meter,
                                      batch_size=batch_size)
    if op.kind == plan_ir.REDUCE:
        groups = [(0, list(range(len(values))))]
    else:
        step = max(1, int(batch_size))
        compact = [list(range(i, min(i + step, len(values))))
                   for i in range(0, len(values), step)]
        groups = list(enumerate(compact))
        if positions is not None:
            by_chunk: Dict[int, List[int]] = {}
            for idx, p in enumerate(positions):
                by_chunk.setdefault(p // step, []).append(idx)
            aligned = sorted(by_chunk.items())
            if [g for _, g in aligned] == compact:
                groups = aligned

    def call(idxs, j):
        c = [values[i] for i in idxs]
        ck = None if key is None else tuple(key) + (j,)
        if policed:
            out = policy.invoke(backend, tier_name, op, c, meter,
                                batch_size, ck, shard=shard)
        elif ck is None:
            out = backend.run_values(op, c, meter=meter,
                                     batch_size=batch_size)
        else:
            with meter.keyed(ck):
                out = backend.run_values(op, c, meter=meter,
                                         batch_size=batch_size)
        if on_chunk is not None and positions is not None:
            on_chunk([positions[i] for i in idxs], out)
        return out

    if fanout is None:
        return [o for j, idxs in groups for o in call(idxs, j)]
    thunks = [(lambda idxs=idxs, j=j: call(idxs, j))
              for j, idxs in groups]
    return [o for part in fanout(thunks) for o in part]


def run_llm_op(op: plan_ir.Operator, values, backend, tier_name: str,
               meter: bk.UsageMeter, *, batch_size: int = 1,
               cache: Optional[OutputCache] = None,
               fanout: Optional[Callable] = None,
               key: Optional[tuple] = None,
               policy: Optional[FaultPolicyRuntime] = None,
               shard: int = 0):
    """Execute one LLM operator, via the cache when provided. Returns
    (outputs, n_calls_made, latency_of_calls_made).

    ``fanout`` (see :func:`run_backend_calls`) runs the backend calls on a
    tier worker pool; the returned call/latency deltas are then approximate
    (other threads may bill the same tier concurrently) — callers on the
    threaded path ignore them and read the meter instead.

    ``policy``/``shard`` thread fault-tolerance enforcement down to every
    chunk call (see :class:`FaultPolicyRuntime`). Retries happen *below*
    the cache layer: a call that ultimately succeeds (retried or served by
    the fallback tier) publishes under its primary-tier cache key."""
    values = list(values)
    before_calls = meter.calls(tier_name)
    before_lat = meter.latency(tier_name)

    def deltas(ran_calls: bool):
        if fanout is not None:
            return 0, 0.0
        if not ran_calls:
            return 0, 0.0
        return (meter.calls(tier_name) - before_calls,
                meter.latency(tier_name) - before_lat)

    if cache is None:
        outs = run_backend_calls(op, values, backend, meter, batch_size,
                                 fanout, key=key, policy=policy,
                                 tier_name=tier_name, shard=shard)
        n, lat = deltas(True)
        return outs, n, lat

    token = object()
    if op.kind == plan_ir.REDUCE:
        rkey = cache.key(op, tier_name, batch_size,
                         "\x1e".join(_vkey(v) for v in values))
        state, got = cache.claim([rkey], token)[0]
        if state == "hit":
            return [got], 0, 0.0
        if state == "wait":
            ok, val = cache.wait_value(rkey, got)
            if ok:
                return [val], 0, 0.0
            state, got = cache.claim([rkey], token)[0]  # owner failed
            if state == "hit":
                return [got], 0, 0.0
        try:
            outs = run_backend_calls(op, values, backend, meter, batch_size,
                                     fanout, key=key, policy=policy,
                                     tier_name=tier_name, shard=shard)
        except BaseException:
            cache.release([rkey], token)
            raise
        cache.publish(rkey, outs[0])
        n, lat = deltas(True)
        return [outs[0]], n, lat

    keys = [cache.key(op, tier_name, batch_size, v) for v in values]
    states = cache.claim(keys, token)
    own = [i for i, (s, _) in enumerate(states) if s == "own"]
    outs: List[Any] = [None] * len(values)
    try:
        if own:
            def publish_chunk(poss, got_c):
                # incremental publish: a chunk's outputs become cache
                # hits the moment its call returns, so a requeued morsel
                # whose sibling chunks died (shard loss) re-resolves the
                # completed chunks as hits instead of re-billing them —
                # the exactly-once guarantee for partial fanout failure
                for p, o in zip(poss, got_c):
                    cache.publish(keys[p], o)

            got = run_backend_calls(op, [values[i] for i in own], backend,
                                    meter, batch_size, fanout, key=key,
                                    policy=policy, tier_name=tier_name,
                                    shard=shard, positions=own,
                                    on_chunk=publish_chunk)
            for i, o in zip(own, got):
                outs[i] = o
                cache.publish(keys[i], o)
    except BaseException:
        cache.release([keys[i] for i in own], token)
        raise
    for i, (s, v) in enumerate(states):
        if s == "hit":
            outs[i] = v
        elif s == "wait":
            ok, val = cache.wait_value(keys[i], v)
            if not ok:   # the owning caller failed: compute solo
                val = run_backend_calls(op, [values[i]], backend, meter,
                                        batch_size, fanout, key=key,
                                        policy=policy, tier_name=tier_name,
                                        shard=shard)[0]
                cache.publish(keys[i], val)
            outs[i] = val
    n, lat = deltas(bool(own))
    return outs, n, lat


# ---------------------------------------------------------------------------
# Shared operator application (executor + physical-optimizer sample flow)
# ---------------------------------------------------------------------------

def bool_mask(outs) -> List[bool]:
    """Parse LLM filter outputs into a row mask (the one shared parser)."""
    return [o if isinstance(o, bool) else
            str(o).strip().lower().startswith(("true", "yes"))
            for o in outs]


def rank_scores(outs) -> List[float]:
    """Parse RANK outputs into similarity scores. Real LLMs return digits
    as *strings*, so numeric text parses as a score. ``bool`` is an ``int``
    subclass — True/False are filter-shaped answers, not scores — and any
    unparseable output falls back to the row's input position."""
    sims: List[float] = []
    for i, o in enumerate(outs):
        if isinstance(o, (int, float)) and not isinstance(o, bool):
            sims.append(float(o))
            continue
        try:
            sims.append(float(str(o).strip()))
        except (TypeError, ValueError):
            sims.append(float(i))
    return sims


def _rank_column(sims) -> List[int]:
    order = sorted(range(len(sims)), key=lambda i: sims[i], reverse=True)
    ranks = [0] * len(order)
    for r, i in enumerate(order):
        ranks[i] = r
    return ranks


def apply_outputs(op: plan_ir.Operator, table: Table,
                  outs) -> Tuple[Table, Any]:
    """Fold one LLM operator's outputs into the table.

    Returns ``(table, scalar)``; scalar is meaningful only for reduce."""
    if op.kind == plan_ir.FILTER:
        return table.select(bool_mask(outs)), None
    if op.kind == plan_ir.MAP:
        return table.with_column(op.output_column, outs), None
    if op.kind == plan_ir.REDUCE:
        return table, outs[0]
    return table.with_column(op.output_column or "rank",
                             _rank_column(rank_scores(outs)), "numeric"), None


def run_udf_op(op: plan_ir.Operator, table: Table,
               values) -> Tuple[Table, Any]:
    """Run one compiled-UDF operator natively (no LLM calls).

    Generated UDFs are format-fragile by design (paper Fig. 12b); a row
    that crashes one yields the kind's null answer."""
    compiled = udf_mod.resolve_udf(op)

    def safe(v, default=None):
        try:
            return compiled.fn(v)
        except Exception:
            return default

    if op.kind == plan_ir.FILTER:
        return table.select([bool(safe(v, False)) for v in values]), None
    if op.kind == plan_ir.MAP:
        return table.with_column(op.output_column,
                                 [safe(v) for v in values]), None
    if op.kind == plan_ir.REDUCE:
        return table, safe(list(values))
    order = safe(list(values), list(range(len(values))))
    ranks = [0] * len(order)
    for r, i in enumerate(order):
        ranks[i] = r
    return table.with_column(op.output_column or "rank", ranks,
                             "numeric"), None


# ---------------------------------------------------------------------------
# Dispatchers: simulated (event-model) vs threads (measured)
# ---------------------------------------------------------------------------

class _DoneTask:
    """An already-completed morsel task."""
    __slots__ = ("_value", "finish")

    def __init__(self, value, finish: float = 0.0):
        self._value = value
        self.finish = finish

    def result(self):
        return self._value, self.finish


class _FutureTask:
    """A morsel task running on the chain pool."""
    __slots__ = ("_fut",)

    def __init__(self, fut: Future):
        self._fut = fut

    def result(self):
        return self._fut.result()


class Dispatcher:
    """How operator work runs: the executor hands every morsel step and
    every backend call to a dispatcher, which either simulates overlap
    (:class:`SimulatedDispatcher`) or provides it for real
    (:class:`ThreadPoolDispatcher`). Both expose the same task interface:

      done(value, finish)         wrap an immediate morsel
      defer(task, fn)             fn(value, ready_s) -> (value, finish_s)
                                  after ``task`` completes
      run_llm(...) / run_host(..) one operator's backend / host work
      checkpoint(meter, cursor)   optimizer stage boundary (drain+barrier
                                  under simulation, no-op under threads)
      wall_s                      modeled makespan / measured elapsed

    The shard hooks (``n_shards`` / ``shard_of`` / the ``shard=`` keyword
    on defer/run_llm/run_host, ``meter_for`` and ``finalize``) are no-ops
    on the single-host dispatchers; ``distributed.morsel_shards.
    ShardedDispatcher`` overrides them to route morsels to per-shard
    worker pools and stage per-shard meters.
    """

    kind = "abstract"
    n_shards = 1
    # the dispatcher-wide FaultPolicyRuntime (None = fail-fast); set by
    # the concrete drivers' constructors when an active CallPolicy is
    # configured on the ExecutionContext
    policy: Optional[FaultPolicyRuntime] = None

    def fault_stats(self) -> Optional[Dict[str, Any]]:
        """Snapshot of the fault-policy counters (attempts, retries,
        breaker trips, fallback calls, open breakers); None when no
        policy is active."""
        pol = self.policy
        return None if pol is None else pol.snapshot()

    def shard_of(self, morsel_idx: int, query=None) -> int:
        """Which shard owns morsel ``morsel_idx`` (round-robin when
        sharded; always 0 on single-host dispatchers). ``query`` is the
        admitting query's id on a shared server — a sharded dispatcher
        offsets each query's round-robin cursor so concurrently admitted
        queries spread across shards instead of all starting on shard 0."""
        return 0

    def release_query(self, query) -> None:
        """Drop per-query routing state (the round-robin cursor offset);
        the executor calls this once per keyed execution. No-op on
        single-host dispatchers."""

    def meter_for(self, meter: bk.UsageMeter, shard: int) -> bk.UsageMeter:
        """The meter a call on ``shard`` should bill into (a per-shard
        staging meter when sharded, ``meter`` itself otherwise)."""
        return meter

    def finalize(self, meter: bk.UsageMeter) -> None:
        """Merge any per-shard staging for ``meter`` back into it
        (deterministic combined call log). No-op on single-host
        dispatchers; the executor calls this once per execution."""

    def done(self, value, finish: float = 0.0) -> _DoneTask:
        return _DoneTask(value, finish)

    def run_udf(self, op, table, values, ready_s: float = 0.0,
                shard: int = 0):
        """One compiled-UDF operator step. Default: host work under
        :meth:`run_host` (simulated cost model / host-lock serialization).
        The ``procs`` driver overrides this to execute the step in a
        worker process, GIL-free. Returns ``((table, scalar), finish_s)``."""
        return self.run_host(lambda: run_udf_op(op, table, values),
                             table.n_rows, ready_s=ready_s, shard=shard)

    def occupancy(self) -> Dict[str, List[float]]:
        """Per-tier busy-until offsets (seconds of remaining work per
        occupied worker slot) for seeding a ``CostModel`` makespan replay.
        Empty on dispatchers with no cheap occupancy signal — an empty
        seed just means the replay assumes idle pools."""
        return {}

    def fanout(self, tier_name: str) -> Optional[Callable]:
        """Per-tier call fanout for :func:`run_backend_calls`; None means
        run inline (sequential)."""
        return None

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SimulatedDispatcher(Dispatcher):
    """Inline execution + EventScheduler replay (deterministic wall model)."""

    kind = "simulated"

    def __init__(self, scheduler: EventScheduler,
                 policy: Optional[FaultPolicyRuntime] = None):
        self.sched = scheduler
        self.policy = policy

    def defer(self, task, fn, shard: int = 0):
        value, ready = task.result()
        return _DoneTask(*fn(value, ready))

    def run_llm(self, op, values, backend, tier_name, meter, *,
                batch_size: int = 1, cache: Optional[OutputCache] = None,
                ready_s: float = 0.0, shard: int = 0,
                key: Optional[tuple] = None):
        cursor = len(meter.call_log)
        outs, _, _ = run_llm_op(op, values, backend, tier_name, meter,
                                batch_size=batch_size, cache=cache, key=key,
                                policy=self.policy, shard=shard)
        _, finish = self.sched.drain(meter, cursor, ready_s=ready_s)
        return outs, finish

    def run_host(self, fn, n_rows: int, ready_s: float = 0.0,
                 shard: int = 0):
        finish = self.sched.submit(HOST_TIER,
                                   n_rows * UDF_SECONDS_PER_ROW,
                                   ready_s=ready_s)
        return fn(), finish

    def checkpoint(self, meter: bk.UsageMeter, cursor: int) -> int:
        cursor, _ = self.sched.drain(meter, cursor)
        self.sched.barrier()
        return cursor

    def occupancy(self) -> Dict[str, List[float]]:
        sched = self.sched
        with sched._elock:
            now = sched._floor
            out: Dict[str, List[float]] = {}
            for key, pool in sched._pools.items():
                if key in (HOST_TIER, "\x00sync"):
                    continue
                busy = [t - now for t in pool if t > now]
                if busy:
                    out[key] = sorted(busy)
            return out

    @property
    def wall_s(self) -> float:
        return self.sched.makespan


class ThreadPoolDispatcher(Dispatcher):
    """Real concurrency: per-tier bounded worker pools for backend calls
    (pool caps = serving quotas) plus a chain pool that advances morsel
    pipelines. ``wall_s`` is measured (construction -> last completion).

    Liveness: the executor submits morsel tasks in operator order, so every
    chain task's dependency sits *earlier* in the chain pool's FIFO queue —
    a blocked worker always waits on a task some other worker has already
    dequeued, and tier pools (which never block on chain tasks) guarantee
    progress. ``mode="sync"`` collapses every tier onto one shared
    single-worker pool, the threaded analogue of sequential accounting."""

    kind = "threads"

    def __init__(self, concurrency: int = 16,
                 per_tier: Optional[Dict[str, int]] = None,
                 mode: str = "async", chain_workers: int = 32,
                 host_lock: Optional[threading.Lock] = None,
                 policy: Optional[FaultPolicyRuntime] = None):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown dispatcher mode {mode!r}")
        self.mode = mode
        self.policy = policy
        self.concurrency = max(1, int(concurrency))
        self.per_tier = dict(per_tier or {})
        self._pools: Dict[str, ThreadPoolExecutor] = {}
        self._lock = threading.Lock()
        self._chain = ThreadPoolExecutor(max_workers=max(1, chain_workers),
                                         thread_name_prefix="morsel")
        # shard workers in one process share a host lock (UDF compute is
        # one Python interpreter no matter how many shards dispatch it)
        self._host_lock = host_lock if host_lock is not None \
            else threading.Lock()
        # in-flight backend-call tracking for occupancy(): tier ->
        # {flight id: start perf_counter}, plus a per-tier EWMA of call
        # duration to turn "started t ago" into "busy for ~d more"
        self._inflight: Dict[str, Dict[int, float]] = {}
        self._ewma: Dict[str, float] = {}
        self._seq = 0
        self._t0 = time.perf_counter()
        self._last = self._t0

    def workers(self, tier: str) -> int:
        if self.mode == "sync":
            return 1
        return max(1, int(self.per_tier.get(tier, self.concurrency)))

    def _pool(self, tier: str) -> ThreadPoolExecutor:
        key = tier if self.mode != "sync" else "\x00sync"
        with self._lock:
            pool = self._pools.get(key)
            if pool is None:
                pool = ThreadPoolExecutor(max_workers=self.workers(tier))
                self._pools[key] = pool
            return pool

    def _touch(self) -> None:
        now = time.perf_counter()
        with self._lock:
            if now > self._last:
                self._last = now

    def _tracked(self, tier_name: str, thunk):
        """Wrap a tier-pool thunk so occupancy() can see it in flight."""
        def run():
            with self._lock:
                self._seq += 1
                tid = self._seq
                self._inflight.setdefault(tier_name, {})[tid] = \
                    time.perf_counter()
            try:
                return thunk()
            finally:
                now = time.perf_counter()
                with self._lock:
                    t0 = self._inflight.get(tier_name, {}).pop(tid, now)
                    prev = self._ewma.get(tier_name)
                    dt = now - t0
                    self._ewma[tier_name] = dt if prev is None \
                        else 0.8 * prev + 0.2 * dt
        return run

    def occupancy(self) -> Dict[str, List[float]]:
        """Estimated remaining-busy offsets per tier from calls currently
        in flight: EWMA(call duration) minus elapsed, floored at ~0 —
        the measured-driver analogue of the event scheduler's busy-until
        pool state, good enough to seed a makespan replay."""
        now = time.perf_counter()
        with self._lock:
            out: Dict[str, List[float]] = {}
            for tier, flights in self._inflight.items():
                if not flights:
                    continue
                est = self._ewma.get(tier, 0.0)
                out[tier] = sorted(max(est - (now - t0), 1e-6)
                                   for t0 in flights.values())
            return out

    def fanout(self, tier_name: str) -> Callable:
        pool = self._pool(tier_name)

        def fan(thunks):
            futs = [pool.submit(self._tracked(tier_name, t))
                    for t in thunks]
            # settle EVERY thunk before surfacing the first failure: a
            # caller's cleanup (per-query meter finalize on a shared
            # dispatcher) must not run while sibling chunks of the same
            # call are still billing
            res, first = [], None
            for f in futs:
                try:
                    res.append(f.result())
                except BaseException as e:
                    if first is None:
                        first = e
            self._touch()
            if first is not None:
                raise first
            return res

        return fan

    def defer(self, task, fn, shard: int = 0):
        def chain():
            value, ready = task.result()
            return fn(value, ready)

        return _FutureTask(self._chain.submit(chain))

    def run_llm(self, op, values, backend, tier_name, meter, *,
                batch_size: int = 1, cache: Optional[OutputCache] = None,
                ready_s: float = 0.0, shard: int = 0,
                key: Optional[tuple] = None):
        outs, _, _ = run_llm_op(op, values, backend, tier_name, meter,
                                batch_size=batch_size, cache=cache,
                                fanout=self.fanout(tier_name), key=key,
                                policy=self.policy, shard=shard)
        return outs, 0.0

    def run_host(self, fn, n_rows: int, ready_s: float = 0.0,
                 shard: int = 0):
        # one Python process: host UDF work serializes against itself but
        # overlaps in-flight backend I/O
        with self._host_lock:
            out = fn()
        self._touch()
        return out, 0.0

    def checkpoint(self, meter: bk.UsageMeter, cursor: int) -> int:
        return len(meter.call_log)

    @property
    def wall_s(self) -> float:
        with self._lock:
            return max(0.0, self._last - self._t0)

    def abandon(self) -> None:
        """Non-blocking teardown for a killed shard worker: already
        *running* calls complete (and bill exactly once into their
        staging meter); *queued* tasks are cancelled so the owning
        ``ShardedDispatcher`` can requeue them onto surviving shards.
        Idempotent; a later ``close()`` is a no-op on the same pools."""
        self._chain.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            pools = list(self._pools.values())
            self._pools.clear()
        for p in pools:
            p.shutdown(wait=False, cancel_futures=True)

    def close(self) -> None:
        self._chain.shutdown(wait=True)
        with self._lock:
            pools = list(self._pools.values())
            self._pools.clear()
        for p in pools:
            p.shutdown(wait=True)


DRIVERS = ("simulated", "threads")


# ---------------------------------------------------------------------------
# Cross-morsel batch coalescing
# ---------------------------------------------------------------------------

class _MorselState:
    """Per-(operator, morsel) resolution buffer: row outputs fill in as the
    batches containing them flush; ``fut`` completes with
    ``(outs, finish_s)`` once every row is resolved.

    A failed batch poisons its rows via :meth:`poison_row` — the morsel's
    future then completes *exceptionally*, but only once every one of its
    rows has settled (resolved by a sibling batch or poisoned too). Failing
    the future the moment any batch died would let the poisoned morsel's
    chain unwind — and the whole execution settle — while sibling batches
    holding this morsel's other rows are still billing calls, making the
    final meter racy; waiting for all rows keeps teardown deterministic."""

    __slots__ = ("outs", "remaining", "finish", "fut", "exc", "_lock")

    def __init__(self, n: int, ready: float):
        self.outs: List[Any] = [None] * n
        self.remaining = n
        self.finish = ready
        self.fut: Future = Future()
        self.exc: Optional[BaseException] = None
        self._lock = threading.Lock()

    def _settle(self) -> None:
        if self.fut.done():
            return
        try:
            if self.exc is not None:
                self.fut.set_exception(self.exc)
            else:
                self.fut.set_result((self.outs, self.finish))
        except Exception:
            pass                          # lost a race with fail()

    def resolve(self, pos: int, out, finish: float) -> None:
        with self._lock:
            self.outs[pos] = out
            if finish > self.finish:
                self.finish = finish
            self.remaining -= 1
            done = self.remaining == 0
        if done:
            self._settle()

    def poison_row(self, pos: int, exc: BaseException) -> None:
        with self._lock:
            if self.exc is None:
                self.exc = exc            # first failure wins
            self.remaining -= 1
            done = self.remaining == 0
        if done:
            self._settle()

    def fail(self, exc: BaseException) -> None:
        """Terminal close path (coalescer shutdown): complete the future
        exceptionally NOW, regardless of unsettled rows."""
        if not self.fut.done():
            try:
                self.fut.set_exception(exc)
            except Exception:
                pass                      # lost a race with set_result


class _Slot:
    """One occupied batch slot: a leader value plus every (morsel, row)
    resolved by it — cross-morsel duplicates attach as followers instead
    of taking their own slot (dedupe *before* batch formation)."""

    __slots__ = ("value", "key", "ready", "targets")

    def __init__(self, value, key, ready: float, target):
        self.value = value
        self.key = key
        self.ready = ready
        self.targets = [target]           # [(morsel_state, row_pos)]


class _Batch:
    __slots__ = ("slots", "ready", "seq", "shard")

    def __init__(self, slots: List[_Slot], ready: float, seq: int = 0,
                 shard: int = 0):
        self.slots = slots
        self.ready = ready
        self.seq = seq           # formation ordinal within the op group
        self.shard = shard       # which (shard, tier) pool executes it


class _OpGroup:
    """One operator's accumulation queue inside a :class:`BatchCoalescer`.

    Submissions may arrive in any thread order; a reorder buffer admits
    them into batch formation strictly by morsel index, so the batches are
    the logical-row-order chunks whole-table batching would form —
    deterministic, and identical across drivers *and shard counts* (under
    a sharded dispatcher, formation stays global; only the execution of a
    flushed batch round-robins across the (shard, tier) pools by its
    formation ordinal)."""

    def __init__(self, coal: "BatchCoalescer", op, backend, tier_name: str,
                 expected: int, op_key: Optional[tuple] = None):
        self.coal = coal
        self.op = op
        self.backend = backend
        self.tier = tier_name
        self.op_key = op_key
        self.batch_seq = 0
        self.expected = max(1, int(expected))
        self.lock = threading.Lock()
        self.stash: Dict[int, tuple] = {}      # morsel idx -> (vals, rdy, st)
        self.next_idx = 0
        self.queue: List[_Slot] = []           # formation queue (partial)
        self.queue_ready = 0.0                 # max event-ready of queue
        self.queue_born = 0.0                  # event-ready of its 1st row
        self.queue_since = 0.0                 # wall time queue went nonempty
        self.inflight: Dict[tuple, _Slot] = {}  # cache key -> unresolved slot
        self.states: List[_MorselState] = []
        self.closed = False

    # -- submission ------------------------------------------------------
    def submit(self, idx: int, values: Sequence[Any],
               ready: float = 0.0) -> Future:
        """Register one morsel's surviving rows (possibly empty — empties
        still advance the watermark); returns the morsel's future."""
        values = list(values)
        state = _MorselState(len(values), ready)
        batches: List[_Batch] = []
        with self.lock:
            if self.closed:
                state.fail(RuntimeError("coalescer closed"))
                return state.fut
            if idx < self.next_idx or idx in self.stash:
                # duplicate submission (recovery path after a submit that
                # itself failed): don't wedge the reorder buffer
                state.fail(RuntimeError(f"morsel {idx} already submitted"))
                return state.fut
            self.states.append(state)
            self.stash[idx] = (values, ready, state)
            self._advance(batches)
        self._execute(batches)
        return state.fut

    def _advance(self, batches: List[_Batch]) -> None:
        """Admit contiguous stashed morsels (reorder buffer) into batch
        formation; cut full batches, the watermark partial, and — under
        the simulated driver — event-time linger partials. Lock held."""
        linger = self.coal.linger_s
        while self.next_idx in self.stash:
            values, ready, state = self.stash.pop(self.next_idx)
            self.next_idx += 1
            if (linger is not None and self.queue
                    and self.coal.disp.kind == "simulated"
                    and ready > self.queue_born + linger):
                # the next rows arrive (event time) after the partial's
                # linger deadline — anchored to the *oldest* queued row,
                # so the deadline cannot slide forward with each arrival
                # (mirrors the threads timer, which measures from
                # queue_since): launch the partial at the deadline
                self._cut(batches, partial=True,
                          launch=self.queue_born + linger)
            for pos, v in enumerate(values):
                self._enqueue_row(state, pos, v, ready, batches)
            if not values:
                state.fut.set_result(([], ready))
        if self.next_idx >= self.expected and self.queue:
            self._cut(batches, partial=len(self.queue) < self.coal.batch)

    def _enqueue_row(self, state: _MorselState, pos: int, v, ready: float,
                     batches: List[_Batch]) -> None:
        cache = self.coal.cache
        key = None
        if cache is not None:
            key = cache.key(self.op, self.tier, self.coal.batch, v)
            lead = self.inflight.get(key)
            if lead is not None:           # duplicate of a queued/in-flight
                lead.targets.append((state, pos))   # row: follow, no slot
                cache.note_hits(1)
                self.coal.stats["dedup_follows"] += 1
                return
            hit, val = cache.peek(key)
            if hit:
                state.resolve(pos, val, ready)
                return
        slot = _Slot(v, key, ready, (state, pos))
        if key is not None:
            self.inflight[key] = slot
        if not self.queue:
            self.queue_since = time.perf_counter()
            self.queue_born = ready
        self.queue.append(slot)
        if ready > self.queue_ready:
            self.queue_ready = ready
        self.coal.stats["rows"] += 1
        if len(self.queue) >= self.coal.batch:
            self._cut(batches, partial=False)

    def _cut(self, batches: List[_Batch], partial: bool,
             launch: Optional[float] = None) -> None:
        slots, self.queue = self.queue, []
        ready = launch if launch is not None else \
            max((s.ready for s in slots), default=0.0)
        self.queue_ready = 0.0
        seq = self.batch_seq
        self.batch_seq += 1
        batches.append(_Batch(slots, ready, seq,
                              seq % max(1, self.coal.disp.n_shards)))
        self.coal.stats["flushes"] += 1
        if partial:
            self.coal.stats["partial_flushes"] += 1

    # -- flush execution -------------------------------------------------
    def _execute(self, batches: List[_Batch]) -> None:
        """Run flushed batches outside the group lock. Under threads,
        several batches cut by one submission run concurrently on
        ephemeral threads — each still routes its backend call through the
        tier's bounded pool, so serving quotas hold and cache waits never
        occupy a tier worker (same liveness structure as morsel chains)."""
        if not batches:
            return
        if len(batches) == 1 or self.coal.disp.kind == "simulated":
            for b in batches:
                self._run_batch(b)
            return
        threads = [threading.Thread(target=self._run_batch, args=(b,),
                                    daemon=True) for b in batches]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _run_batch(self, b: _Batch) -> None:
        key = None if self.op_key is None \
            else tuple(self.op_key) + (b.seq,)
        try:
            outs, finish = self.coal.disp.run_llm(
                self.op, [s.value for s in b.slots], self.backend,
                self.tier, self.coal.meter, batch_size=self.coal.batch,
                cache=self.coal.cache, ready_s=b.ready, shard=b.shard,
                key=key)
        except BaseException as e:        # backend failure: poison the rows,
            self._fail_batch(b, e)        # don't hang downstream morsels
            return
        if len(outs) != len(b.slots):
            self._fail_batch(b, RuntimeError(
                f"backend returned {len(outs)} outputs for "
                f"{len(b.slots)} batched rows"))
            return
        with self.lock:
            for s in b.slots:
                if s.key is not None:
                    self.inflight.pop(s.key, None)
            targets = [(s.targets[:], out) for s, out in zip(b.slots, outs)]
        for tgts, out in targets:
            for state, pos in tgts:
                state.resolve(pos, out, finish)

    def _fail_batch(self, b: _Batch, exc: BaseException) -> None:
        """Poison every row this batch held. Row-level (not morsel-level):
        a morsel whose rows straddle several batches keeps its in-flight
        sibling batches running to completion — their calls bill
        deterministically — and its future completes exceptionally only
        once all its rows have settled."""
        with self.lock:
            for s in b.slots:
                if s.key is not None:
                    self.inflight.pop(s.key, None)
            targets = [t for s in b.slots for t in s.targets]
        for state, pos in targets:
            state.poison_row(pos, exc)

    def cut_expired(self, now: float) -> List[_Batch]:
        """Cut (but do not execute) a partial batch whose oldest row has
        waited longer than ``linger_s``. Lock-held and non-blocking, so
        the shared linger ticker can harvest expired batches from every
        group without ever waiting on a backend call."""
        batches: List[_Batch] = []
        with self.lock:
            if (self.queue and not self.closed
                    and self.coal.linger_s is not None
                    and now - self.queue_since >= self.coal.linger_s):
                self._cut(batches, partial=len(self.queue) < self.coal.batch)
        return batches

    def flush_expired(self, now: float) -> None:
        """Timer hook (threads driver): flush a partial batch whose oldest
        row has waited longer than ``linger_s``."""
        self._execute(self.cut_expired(now))

    def close(self, exc: Optional[BaseException] = None) -> None:
        with self.lock:
            self.closed = True
            states = self.states
        err = exc or RuntimeError("coalescer closed with pending rows")
        for st in states:
            if not st.fut.done():
                st.fail(err)


class _LingerTicker:
    """One process-wide ``coalesce-linger`` daemon serving *every*
    registered :class:`BatchCoalescer`.

    Per-coalescer timer threads multiply under sharded execution
    (shards x concurrent executions would each spawn one); instead every
    coalescer with a wall-time linger registers here, the single daemon
    ticks at a quarter of the smallest registered linger, and it parks
    (then exits) when the registry drains so idle processes carry no
    timer thread at all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._coals: Dict[int, "BatchCoalescer"] = {}
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, coal: "BatchCoalescer") -> None:
        with self._lock:
            self._coals[id(coal)] = coal
            self._wake.set()
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                name="coalesce-linger",
                                                daemon=True)
                self._thread.start()

    def unregister(self, coal: "BatchCoalescer") -> None:
        with self._lock:
            self._coals.pop(id(coal), None)

    def stop(self, timeout: float = 2.0) -> None:
        """Deterministic shutdown for long-lived processes: drop every
        registration and join the daemon (it parks, sees the empty
        registry, and exits). Idempotent; a later ``register`` simply
        starts a fresh daemon."""
        with self._lock:
            self._coals.clear()
            thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout)

    def n_threads(self) -> int:
        """Live ticker threads (for tests: must never exceed 1)."""
        return sum(1 for t in threading.enumerate()
                   if t.name == "coalesce-linger" and t.is_alive())

    def _loop(self) -> None:
        while True:
            with self._lock:
                coals = list(self._coals.values())
                if not coals:
                    self._wake.clear()
            if not coals:
                if not self._wake.wait(timeout=0.25):
                    with self._lock:
                        if not self._coals:
                            self._thread = None
                            return
                continue
            tick = min(max(0.002, (c.linger_s or 0.01) / 4.0)
                       for c in coals)
            time.sleep(tick)
            now = time.perf_counter()
            for c in coals:
                c.tick(now)


_LINGER_TICKER = _LingerTicker()


class BatchCoalescer:
    """Cross-morsel batch packing for one execution (see module docstring).

    One instance serves one executor run; ``open`` registers an operator
    with its expected contributor count (= number of morsels entering it),
    and each morsel ``submit``s its rows once. ``stats`` records flushes,
    partial flushes, rows slotted, and follower dedupes — benchmarks and
    tests read it from ``ExecutionResult.coalesce_stats``. Wall-time
    linger flushes (threads driver) are driven by the shared
    :data:`_LINGER_TICKER` daemon, not a per-coalescer thread."""

    def __init__(self, dispatcher: Dispatcher, meter: bk.UsageMeter, *,
                 batch_size: int, cache: Optional[OutputCache] = None,
                 linger_s: Optional[float] = None):
        self.disp = dispatcher
        self.meter = meter
        self.batch = max(1, int(batch_size))
        self.cache = cache
        self.linger_s = linger_s
        self.stats = {"flushes": 0, "partial_flushes": 0, "rows": 0,
                      "dedup_follows": 0}
        self._groups: List[_OpGroup] = []
        self._lock = threading.Lock()
        self._ticking = False

    def open(self, op, backend, tier_name: str, expected: int,
             op_key: Optional[tuple] = None) -> _OpGroup:
        """Register one operator's accumulation group. ``op_key`` is the
        group's logical meter-key prefix — ``(op_index,)`` solo, or
        ``(query_id, op_index)`` under a query server, so concurrently
        admitted queries' batch calls never collide in a merged log."""
        with self._lock:
            if op_key is None:
                op_key = (len(self._groups),)
            g = _OpGroup(self, op, backend, tier_name, expected,
                         op_key=op_key)
            self._groups.append(g)
            need_tick = (self.linger_s is not None
                         and self.disp.kind != "simulated"
                         and not self._ticking)
            if need_tick:
                self._ticking = True
        if need_tick:
            _LINGER_TICKER.register(self)
        return g

    def tick(self, now: float) -> None:
        """Shared-ticker hook: flush partials whose linger expired.

        The cut happens here (cheap, lock-held, non-blocking) but the
        flushed batches execute on an ephemeral thread — the ticker
        daemon is shared by every coalescer in the process, so it must
        never block on one coalescer's backend call (a 2 s call would
        otherwise stall every other coalescer's linger deadline)."""
        with self._lock:
            groups = list(self._groups)
        work = [(g, b) for g in groups for b in [g.cut_expired(now)] if b]
        if not work:
            return

        def execute():
            for g, batches in work:
                g._execute(batches)

        threading.Thread(target=execute, name="coalesce-linger-flush",
                         daemon=True).start()

    def close(self, exc: Optional[BaseException] = None) -> None:
        """Deregister from the shared linger ticker and fail any
        unresolved morsel futures so blocked chain tasks unwind (error
        paths must not deadlock the dispatcher's chain-pool shutdown)."""
        with self._lock:
            was_ticking, self._ticking = self._ticking, False
        if was_ticking:
            _LINGER_TICKER.unregister(self)
        with self._lock:
            groups = list(self._groups)
        for g in groups:
            g.close(exc)


# ---------------------------------------------------------------------------
# Execution context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecutionContext:
    """Everything an execution needs, in one object.

    ``concurrency`` is the default per-tier worker count;
    ``per_tier_concurrency`` overrides it for individual tiers (a weak tier
    served on many replicas can take more simultaneous calls than the
    flagship). ``morsel_size=0`` disables pipelining (whole-table barrier
    between operators — the seed executor's behaviour). ``driver`` selects
    how backend calls run: ``"simulated"`` (inline + event-scheduler wall
    model) or ``"threads"`` (per-tier worker pools, measured wall).

    ``coalesce`` (default on; only active with ``batch_size > 1``) routes
    streamable LLM operators through a :class:`BatchCoalescer`, packing
    rows from different morsels into full batches instead of paying
    per-morsel ragged-remainder calls; ``linger_s`` bounds how long a
    partial batch may wait for more rows before flushing (None = only the
    morsel-boundary watermark flushes partials).

    ``shards > 1`` runs the morsel stream through a
    ``distributed.morsel_shards.ShardedDispatcher``: morsels round-robin
    across shard workers, each with its own pool-per-(shard, tier)
    dispatcher under the selected ``driver``. Explicit
    ``per_tier_concurrency`` caps are treated as global serving quotas
    split across shards (remainder to shard 0); the default
    ``concurrency`` is each shard's own replica width. ``shard_cache``
    selects ``"shared"`` (default: one process-wide ``OutputCache``, so
    cross-shard duplicates bill once through the single-flight protocol
    and results/calls/meters are shard-count invariant) or ``"local"``
    (each shard memoizes independently — cheaper coordination, duplicate
    billing across shards).

    ``procs >= 1`` selects the third execution substrate: a
    ``ShardedDispatcher`` whose per-shard inner workers are spawned
    subprocesses (``distributed.process_workers``) — backend calls and
    host UDFs run GIL-free in the workers while the coordinator keeps
    the shared cache, fault policy, and meter merge. Mutually exclusive
    with ``shards > 1`` (both pick a shard topology).

    ``cascade`` (a ``core.cascade.CascadeRouter`` or None) enables the
    tier-0 embedding cascade: SEM_FILTER/RANK operators with bands score
    every morsel in one batched device pass and only the uncertain band
    escalates to the LLM tier. Typed ``Any`` to keep this module free of
    the kernels import chain."""
    backends: Dict[str, bk.Backend]
    default_tier: str = "m*"
    concurrency: int = 16
    per_tier_concurrency: Optional[Dict[str, int]] = None
    batch_size: int = 1
    morsel_size: int = DEFAULT_MORSEL_ROWS
    mode: str = "async"
    driver: str = "simulated"
    coalesce: bool = True
    linger_s: Optional[float] = None
    shards: int = 1
    shard_cache: str = "shared"
    # > 0: that many process shard workers (GIL-free morsel execution);
    # the `driver` field then only governs any coordinator-side work
    procs: int = 0
    cascade: Optional[Any] = None
    cache: Optional[OutputCache] = None
    # the calibrated estimation surface (core.cost_model.CostModel) this
    # execution's optimizers price with and the executor's finalize sync
    # point feeds (CostModel.observe). None = uncalibrated library default
    # (cost_model.DEFAULT_MODEL) for pricing, and no observation — the
    # default model must stay byte-stable, so it is never fed implicitly.
    # Typed Any only to keep dataclass field ordering simple; forks share
    # the instance, so a judge's sample runs calibrate the same model.
    cost_model: Optional[Any] = None
    # fault-tolerance policy (CallPolicy) enforced by this context's
    # dispatchers: per-call deadline, bounded retries, retry budget,
    # per-(tier, shard) circuit breaker with sibling-tier fallback, and
    # the sharded dispatcher's consecutive-failure shard liveness
    # threshold. None (or an all-default CallPolicy) = fail-fast, with
    # call paths byte-identical to the pre-policy runtime.
    call_policy: Optional[CallPolicy] = None
    meter: bk.UsageMeter = dataclasses.field(default_factory=bk.UsageMeter)
    # long-lived dispatcher owned by this context (see dispatcher()/close();
    # init=False fields are NOT carried across fork(), so every fork starts
    # unopened and close() releases only what this context created)
    _disp: Optional[Dispatcher] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _closed: bool = dataclasses.field(
        default=False, init=False, repr=False, compare=False)
    _dlock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False,
        compare=False)

    def backend(self, tier_name: Optional[str]):
        return self.backends[tier_name or self.default_tier]

    def make_scheduler(self) -> EventScheduler:
        return EventScheduler(self.concurrency,
                              per_tier=self.per_tier_concurrency,
                              mode=self.mode)

    def make_dispatcher(self) -> Dispatcher:
        if self.driver not in DRIVERS:
            raise ValueError(f"unknown driver {self.driver!r} "
                             f"(expected one of {DRIVERS})")
        policy_rt = None
        if self.call_policy is not None and self.call_policy.active:
            policy_rt = FaultPolicyRuntime(
                self.call_policy, backends=self.backends,
                real_time=(self.driver == "threads" or self.procs >= 1))
        if self.procs >= 1:
            if self.shards > 1:
                raise ValueError(
                    "procs and shards are mutually exclusive (both pick "
                    f"a shard topology; got procs={self.procs}, "
                    f"shards={self.shards})")
            from repro_torch.distributed.morsel_shards import ShardedDispatcher
            return ShardedDispatcher(
                shards=self.procs, driver="procs",
                concurrency=self.concurrency,
                per_tier=self.per_tier_concurrency, mode=self.mode,
                shared_cache=self.shard_cache != "local",
                policy=policy_rt,
                failure_threshold=(self.call_policy.shard_failure_threshold
                                   if self.call_policy else None),
                backends=self.backends)
        if self.shards > 1:
            # local import: morsel_shards builds on this module
            from repro_torch.distributed.morsel_shards import ShardedDispatcher
            return ShardedDispatcher(
                shards=self.shards, driver=self.driver,
                concurrency=self.concurrency,
                per_tier=self.per_tier_concurrency, mode=self.mode,
                shared_cache=self.shard_cache != "local",
                policy=policy_rt,
                failure_threshold=(self.call_policy.shard_failure_threshold
                                   if self.call_policy else None))
        if self.driver == "threads":
            return ThreadPoolDispatcher(self.concurrency,
                                        per_tier=self.per_tier_concurrency,
                                        mode=self.mode, policy=policy_rt)
        return SimulatedDispatcher(self.make_scheduler(), policy=policy_rt)

    def dispatcher(self) -> Dispatcher:
        """The context's **long-lived** dispatcher: created on first use,
        reused across executions (pass it to ``executor.execute(...,
        dispatcher=...)``), released by :meth:`close`. This is the serving
        entry point — ``make_dispatcher()`` still builds a fresh throwaway
        dispatcher per call for one-shot executions."""
        with self._dlock:
            if self._closed:
                raise RuntimeError("ExecutionContext is closed")
            if self._disp is None:
                self._disp = self.make_dispatcher()
            return self._disp

    def close(self) -> None:
        """Idempotent shutdown for long-lived use: release the context's
        dispatcher (tier/chain/shard pools). The cache is deliberately
        NOT closed here — ``cache`` may be shared with sibling contexts
        (forks, a judge's sample runs) that are still executing; whoever
        *created* the cache closes it (``OutputCache.close``), which is
        what ``launch.query_server.QueryServer`` does for the serving
        cache it builds. Safe to call twice; a context-manager
        ``with ExecutionContext(...) as ctx:`` calls it on exit."""
        with self._dlock:
            if self._closed:
                return
            self._closed = True
            disp, self._disp = self._disp, None
        if disp is not None:
            disp.close()

    def __enter__(self) -> "ExecutionContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fork(self, **overrides) -> "ExecutionContext":
        """A sibling context; e.g. ``fork(meter=UsageMeter())`` gives an
        optimizer its own accounting while sharing backends and cache.
        Forks never share the parent's long-lived dispatcher (``_disp``
        is ``init=False``) — each fork opens and closes its own."""
        return dataclasses.replace(self, **overrides)


def as_context(backends_or_ctx, **defaults) -> ExecutionContext:
    """Upgrade a ``{tier: Backend}`` dict to an ExecutionContext; pass an
    existing context through (with ``defaults`` applied as overrides)."""
    if isinstance(backends_or_ctx, ExecutionContext):
        return backends_or_ctx.fork(**defaults) if defaults \
            else backends_or_ctx
    return ExecutionContext(backends=backends_or_ctx, **defaults)
