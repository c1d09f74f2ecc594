"""Process shard workers: GIL-free morsel execution behind the
``Dispatcher`` interface.

``ShardedDispatcher(driver="procs")`` builds one
:class:`ProcessShardDispatcher` per shard. Each is a regular
``runtime.ThreadPoolDispatcher`` — chain tasks, tier-pool quotas, the
shared single-flight ``OutputCache``, and the ``CallPolicy``
retry/breaker/fallback ladder all stay coordinator-side, unchanged —
except that every backend call and host-UDF step is serialized over a
pipe to a spawned worker subprocess and executed there, outside the
coordinator's GIL.

Serialization boundary
----------------------
A request ships ``(tier_key, op, values, batch_size, logical_key,
call_timeout)`` (or ``(op, table, values)`` for a UDF step) by pickle;
the reply carries the outputs (or the exception) plus a fresh
``UsageMeter`` holding exactly that call's entries. The worker re-enters
``meter.keyed(logical_key)`` and ``runtime._call_deadline(timeout)``
around the backend invocation, so the billed entries carry the same
logical keys — and fault harnesses draw the same fault plans — as an
in-process run. The coordinator ``absorb``\\ s the reply meter into the
call's per-shard staging meter verbatim (``absorb`` copies keys without
re-keying), and ``UsageMeter.merge``'s logical-key sort then produces a
byte-identical combined log: meter-merge determinism survives the wire
because the *keys* travel with the entries, and the merge order never
depended on arrival time in the first place.

Backends that do not survive a pickle round-trip (an engine-backed
``JAXBackend`` holding device buffers) are simply not shipped
(:func:`shippable_backends`); their calls run coordinator-side exactly
as under the threads driver. The coordinator-side cache + policy layer
is also the cross-process dedupe: duplicate values claim one cache key
*before* any request ships, so cross-process duplicates bill once.

Death ladder
------------
A worker death — crash, SIGKILL, or ``heartbeat_timeout_s`` of silence
(e.g. SIGSTOP) — is detected by the client's monitor/receiver threads
and surfaces as the shard-kill contract: the owning ``ShardedDispatcher``
``kill_shard``\\ s the shard (ring-next routing, morsel requeue onto
survivors), and every pending pipe call raises ``ShardDeadError`` so the
``run_llm``/``run_udf`` retry loops re-route. A call that died with the
worker never shipped its meter back, so the survivor's retry bills it
exactly once; replies already buffered in the pipe are drained before
pending futures are failed, so a completed call is never double-billed.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import backends as bk
from repro_torch.core import runtime as rt


def shippable_backends(backends: Dict[str, Any]) -> Dict[str, Any]:
    """The subset of ``backends`` that survives a pickle round-trip —
    these ship to the worker processes at spawn; the rest keep running
    coordinator-side (the threads-driver path, GIL and all)."""
    out = {}
    for k, b in (backends or {}).items():
        try:
            pickle.dumps(b)
        except Exception:
            continue
        out[k] = b
    return out


def _worker_main(conn, backends: Dict[str, Any], concurrency: int,
                 heartbeat_s: float) -> None:
    """Worker-process entry point: a request loop over the pipe.

    Requests fan out onto a local thread pool (remote callers block on
    their reply, so in-flight depth is bounded by the coordinator's tier
    pools); the main thread stays in ``recv`` so the pipe never wedges.
    Each request bills into a fresh meter that ships back with the reply.
    A heartbeat thread pings ``("hb",)`` every ``heartbeat_s`` so the
    coordinator can tell a stalled worker from a slow call."""
    send_lock = threading.Lock()
    stop = threading.Event()

    def send(msg) -> None:
        try:
            with send_lock:
                conn.send(msg)
        except Exception:
            stop.set()

    def heartbeat() -> None:
        while not stop.wait(heartbeat_s):
            send(("hb",))

    def handle(req_id: int, kind: str, payload) -> None:
        meter = bk.UsageMeter()
        try:
            if kind == "llm":
                tier_key, op, values, batch_size, key, timeout_s = payload
                backend = backends[tier_key]
                with rt._call_deadline(timeout_s):
                    if key is None:
                        outs = backend.run_values(op, values, meter=meter,
                                                  batch_size=batch_size)
                    else:
                        with meter.keyed(key):
                            outs = backend.run_values(
                                op, values, meter=meter,
                                batch_size=batch_size)
            elif kind == "udf":
                op, tbl, values = payload
                outs = rt.run_udf_op(op, tbl, values)
            else:
                raise RuntimeError(f"unknown request kind {kind!r}")
        except BaseException as e:
            try:
                pickle.dumps(e)
            except Exception:
                e = rt.TransientCallError(f"{type(e).__name__}: {e}")
            send(("err", req_id, e, meter))
            return
        send(("ok", req_id, outs, meter))

    threading.Thread(target=heartbeat, daemon=True).start()
    pool = ThreadPoolExecutor(max_workers=max(4, int(concurrency) * 4),
                              thread_name_prefix="proc-worker")
    send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg[0] == "close":
            break
        _, req_id, kind, payload = msg
        pool.submit(handle, req_id, kind, payload)
    stop.set()
    pool.shutdown(wait=True)
    send(("bye",))
    conn.close()


class ProcessShardClient:
    """Coordinator-side handle on one spawned worker subprocess.

    Owns the duplex pipe, a receiver thread that demultiplexes replies
    onto per-request futures, and a monitor thread that declares the
    worker dead after ``heartbeat_timeout_s`` of pipe silence or on
    process exit. Exactly-once resolution: a request future is popped
    from ``_pending`` under the lock by whichever side settles it first
    (reply vs death), so a late reply for an already-failed request is
    dropped *with its meter* — the survivor's retry is the one billing.
    """

    def __init__(self, backends: Dict[str, Any], concurrency: int, *,
                 shard: int = 0,
                 on_death: Optional[Callable[[int], None]] = None,
                 heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 10.0):
        self.shard = shard
        self._on_death = on_death
        self._hb_s = max(0.01, float(heartbeat_s))
        self._hb_timeout = max(self._hb_s * 2, float(heartbeat_timeout_s))
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._next_id = 0
        self._dead = False
        self._closed = False
        self._death_reason = ""
        self._ready = threading.Event()
        self._last_recv = time.perf_counter()
        self.pid: Optional[int] = None
        self.stats = {"llm": 0, "udf": 0}
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child, backends, concurrency, self._hb_s),
            name=f"proc-shard-{shard}", daemon=True)
        self._proc.start()
        child.close()
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name=f"proc-recv-{shard}", daemon=True)
        self._recv_thread.start()
        threading.Thread(target=self._monitor, name=f"proc-mon-{shard}",
                         daemon=True).start()

    # -- receive / liveness ----------------------------------------------
    def _recv_loop(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                with self._lock:
                    closed = self._closed
                if not closed:
                    self._declare_dead("pipe closed")
                return
            self._last_recv = time.perf_counter()
            tag = msg[0]
            if tag == "hb" or tag == "bye":
                continue
            if tag == "ready":
                self.pid = msg[1]
                self._ready.set()
                continue
            _, req_id, payload, meter = msg
            with self._lock:
                fut = self._pending.pop(req_id, None)
            if fut is not None:
                fut.set_result((tag, payload, meter))

    def _monitor(self) -> None:
        # a cold spawn (interpreter boot + module imports) can exceed a
        # test-sized heartbeat timeout: don't start the silence clock
        # until the worker reported ready
        while not self._ready.wait(timeout=0.05):
            with self._lock:
                if self._dead or self._closed:
                    return
            if not self._proc.is_alive():
                self._declare_dead("worker exited before ready "
                                   f"(code {self._proc.exitcode})")
                return
        self._last_recv = time.perf_counter()
        interval = max(0.02, self._hb_s / 2.0)
        while True:
            with self._lock:
                if self._dead or self._closed:
                    return
            silent = time.perf_counter() - self._last_recv
            if silent >= self._hb_timeout:
                self._declare_dead(f"no heartbeat for {silent:.2f}s")
                return
            if not self._proc.is_alive():
                self._declare_dead("worker process exited "
                                   f"(code {self._proc.exitcode})")
                return
            time.sleep(interval)

    def _declare_dead(self, reason: str) -> None:
        """Unplanned death (crash / SIGKILL / missed heartbeat): kill the
        process, let the receiver drain any replies already buffered in
        the pipe (those calls completed — they must bill, not retry),
        notify the owner (``kill_shard`` marks the shard dead *before*
        any pending future raises, so ``_shard_died_under`` classifies
        the failures as requeue-able), then fail whatever is left."""
        with self._lock:
            if self._dead or self._closed:
                return
            self._dead = True
            self._death_reason = reason
        try:
            self._proc.kill()       # SIGKILL: also takes down a SIGSTOPped
        except Exception:           # worker (SIGTERM would stay pending)
            pass
        if threading.current_thread() is not self._recv_thread:
            self._recv_thread.join(timeout=2.0)
        self._ready.set()           # unblock wait_ready (it re-checks _dead)
        if self._on_death is not None:
            try:
                self._on_death(self.shard)
            except Exception:
                pass
        self._fail_pending(reason)

    def _fail_pending(self, reason: str) -> None:
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        exc = rt.ShardDeadError(
            f"process shard {self.shard} died: {reason}")
        for fut in pending:
            fut.set_exception(exc)

    @property
    def is_dead(self) -> bool:
        with self._lock:
            return self._dead

    def kill(self) -> None:
        """Dispatcher-initiated teardown (``kill_shard``/``abandon``):
        same as a detected death but without the ``on_death`` callback —
        the dispatcher already knows. Idempotent."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._death_reason = "killed by dispatcher"
        try:
            self._proc.kill()
        except Exception:
            pass
        self._fail_pending("killed by dispatcher")

    # -- calls -----------------------------------------------------------
    def call(self, kind: str, payload
             ) -> Tuple[str, Any, Optional[bk.UsageMeter]]:
        """Ship one request, block for its reply. Raises
        ``ShardDeadError`` if the worker is (or dies) in between; raises
        the caller's own error (e.g. an unpicklable payload) unchanged."""
        fut: Future = Future()
        with self._lock:
            if self._dead or self._closed:
                raise rt.ShardDeadError(
                    f"process shard {self.shard} is dead: "
                    f"{self._death_reason or 'closed'}")
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = fut
            self.stats[kind] = self.stats.get(kind, 0) + 1
        try:
            with self._send_lock:
                self._conn.send(("req", req_id, kind, payload))
        except (OSError, ValueError, BrokenPipeError):
            with self._lock:
                self._pending.pop(req_id, None)
            self._declare_dead("send failed")
            raise rt.ShardDeadError(
                f"process shard {self.shard} died: send failed")
        except BaseException:
            # e.g. PicklingError: the request never left — a genuine
            # caller error, not a dead worker
            with self._lock:
                self._pending.pop(req_id, None)
            raise
        return fut.result()

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        deadline = time.perf_counter() + timeout_s
        while not self._ready.wait(timeout=0.05):
            if time.perf_counter() > deadline:
                raise rt.ShardDeadError(
                    f"process shard {self.shard} not ready "
                    f"after {timeout_s}s")
        with self._lock:
            if self._dead:
                raise rt.ShardDeadError(
                    f"process shard {self.shard} died during spawn: "
                    f"{self._death_reason}")

    def close(self, timeout_s: float = 10.0) -> None:
        """Graceful drain: tell the worker to finish in-flight requests
        and exit, then join (SIGKILL fallback). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            was_dead = self._dead
        if not was_dead:
            try:
                with self._send_lock:
                    self._conn.send(("close",))
            except Exception:
                pass
        self._proc.join(timeout_s)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout_s)
        self._fail_pending("closed")
        try:
            self._conn.close()
        except Exception:
            pass


class _RemoteBackend:
    """The ``Backend``-protocol proxy a :class:`ProcessShardDispatcher`
    swaps in for a shippable backend: one ``run_values`` = one pipe
    round-trip. The ambient logical key and the cooperative call deadline
    are captured *here*, on the coordinator thread where the policy layer
    installed them, and shipped explicitly; the reply meter is absorbed
    before any error re-raises, so faulted attempts bill exactly like
    in-process ones (retries are not free over the wire either)."""

    def __init__(self, client: ProcessShardClient, tier_key: str, tier):
        self._client = client
        self._tier_key = tier_key
        self.tier = tier

    def run_values(self, op, values, meter=None, batch_size: int = 1):
        key = meter.current_key() if meter is not None else None
        timeout_s = rt.current_call_timeout()
        tag, payload, rmeter = self._client.call(
            "llm",
            (self._tier_key, op, list(values), batch_size, key, timeout_s))
        if meter is not None and rmeter is not None:
            meter.absorb(rmeter)
        if tag == "err":
            raise payload
        return payload


class ProcessShardDispatcher(rt.ThreadPoolDispatcher):
    """One shard's inner dispatcher in ``procs`` mode: a
    ``ThreadPoolDispatcher`` whose backend calls and UDF steps execute in
    a spawned worker subprocess. Everything else — chain pool, tier-pool
    quotas, cache single-flight, policy retries/breakers/fallback, meter
    staging — is inherited unchanged, which is exactly what keeps the
    invariance guarantees: the coordinator still decides *what* runs;
    the worker only supplies GIL-free *where*."""

    kind = "procs"

    def __init__(self, concurrency: int = 16,
                 per_tier: Optional[Dict[str, int]] = None,
                 mode: str = "async",
                 host_lock: Optional[threading.Lock] = None,
                 policy: Optional[rt.FaultPolicyRuntime] = None, *,
                 backends: Dict[str, Any],
                 shard: int = 0,
                 on_death: Optional[Callable[[int], None]] = None,
                 heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 10.0):
        super().__init__(concurrency, per_tier=per_tier, mode=mode,
                         host_lock=host_lock, policy=policy)
        self.shard = shard
        self._by_id = {id(b): k for k, b in backends.items()}
        self._proxies: Dict[int, _RemoteBackend] = {}
        self.client = ProcessShardClient(
            backends, concurrency, shard=shard, on_death=on_death,
            heartbeat_s=heartbeat_s,
            heartbeat_timeout_s=heartbeat_timeout_s)

    def _remote(self, backend) -> Optional[_RemoteBackend]:
        key = self._by_id.get(id(backend))
        if key is None:
            return None       # unshipped (unpicklable/unknown): run local
        proxy = self._proxies.get(id(backend))
        if proxy is None:
            proxy = _RemoteBackend(self.client, key, backend.tier)
            self._proxies[id(backend)] = proxy
        return proxy

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Block until the worker's request loop is up, then reset the
        measured-wall origin so ``wall_s`` excludes spawn cost."""
        self.client.wait_ready(timeout_s)
        now = time.perf_counter()
        with self._lock:
            self._t0 = now
            self._last = now

    def run_llm(self, op, values, backend, tier_name, meter, *,
                batch_size: int = 1,
                cache: Optional[rt.OutputCache] = None,
                ready_s: float = 0.0, shard: int = 0,
                key: Optional[tuple] = None):
        remote = self._remote(backend)
        return super().run_llm(
            op, values, backend if remote is None else remote, tier_name,
            meter, batch_size=batch_size, cache=cache, ready_s=ready_s,
            shard=shard, key=key)

    def run_udf(self, op, table, values, ready_s: float = 0.0,
                shard: int = 0):
        """Host-UDF steps ship to the worker too — they are the
        GIL-bound half of the workload. No host-lock serialization: each
        worker process is its own interpreter."""
        tag, payload, _ = self.client.call("udf",
                                           (op, table, list(values)))
        self._touch()
        if tag == "err":
            raise payload
        return payload, 0.0

    def abandon(self) -> None:
        super().abandon()
        self.client.kill()

    def close(self) -> None:
        # drain the coordinator pools FIRST: their tasks may be blocked
        # on pipe futures, which the still-running receiver resolves;
        # only then ask the worker to exit
        super().close()
        self.client.close()
