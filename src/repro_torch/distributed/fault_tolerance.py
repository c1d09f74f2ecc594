"""Fault-tolerant training supervision (``repro.distributed.
fault_tolerance``): checkpoint/restart, failure injection, straggler
detection.

The training loop is a pure function of (checkpoint, data order): a run
with injected failures restores from the last committed step and reaches
the state of an uninterrupted run, bit for bit where every kernel of the
step is deterministic (the port's flash backward uses no atomics).

``init_state`` may also be a function that builds the state (a port-only
addition): the optimizer builds each step's new state beside the old one,
so a caller that held the initial state through the run would keep a
third copy on the device (24.4 GB for seamless-m4t-large-v2's weights and
moments). Built by the supervisor, the initial state is freed after the
first step, and each restart builds it again.

Straggler mitigation: per-step wall times feed an online median tracker;
steps exceeding ``deadline_factor`` x the running median are flagged. A
step's time ends at a synchronize of its metrics' device, the counterpart
of ``jax.block_until_ready``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.training.optimizer import leaves


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerStats:
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)
    deadline_factor: float = 3.0

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; True if the step was a straggler."""
        med = sorted(self.times)[len(self.times) // 2] if self.times else dt
        self.times.append(dt)
        if len(self.times) >= 5 and dt > self.deadline_factor * med:
            self.flagged.append(step)
            return True
        return False


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 10
    keep_last: int = 3
    async_save: bool = False
    deadline_factor: float = 3.0


def _synchronize(metrics) -> None:
    """Wait for the device that holds the metrics (none on the CPU)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class TrainSupervisor:
    """Runs `train_step(state, batch) -> (state, metrics)` under checkpoint/
    restart. ``fail_at`` injects a crash *after* the step executes but
    before its checkpoint commits — the worst-case window. A restart
    restores onto the device of the initial state's leaves."""

    def __init__(self, train_step: Callable, batch_fn: Callable,
                 cfg: SupervisorConfig):
        self.train_step = train_step
        self.batch_fn = batch_fn      # step -> batch (deterministic!)
        self.cfg = cfg
        self.straggler = StragglerStats(deadline_factor=cfg.deadline_factor)
        self._async = (ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_last)
                       if cfg.async_save else None)

    def _save(self, step: int, state):
        if self._async:
            self._async.save(step, state)
        else:
            ckpt.save(self.cfg.ckpt_dir, step, state,
                      keep_last=self.cfg.keep_last)

    def run(self, init_state, n_steps: int,
            fail_at: Optional[set] = None,
            delay_steps: Optional[dict] = None):
        """Execute steps [resume..n_steps); returns (state, metrics_log).

        ``init_state``: the state, or a function that builds it (called
        once per ``run``). Restarts resume from the last committed
        checkpoint, restored onto the initial state's device; `fail_at`
        steps raise InjectedFailure once each (the caller loops, as a
        cluster controller would). NOTE: `fail_at` is mutated (fired steps
        are discarded) so a controller re-invoking `run` shares the
        ledger."""
        fail_at = fail_at if fail_at is not None else set()
        delay_steps = delay_steps or {}
        state = init_state() if callable(init_state) else init_state
        del init_state
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        start = 0
        if last is not None:
            _, state = ckpt.restore(self.cfg.ckpt_dir, last,
                                    device=leaves(state)[0].device)
            start = last + 1
        log = []
        for step in range(start, n_steps):
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            state, metrics = self.train_step(state, batch)
            if step in delay_steps:
                time.sleep(delay_steps[step])
            _synchronize(metrics)
            dt = time.perf_counter() - t0
            self.straggler.observe(step, dt)
            log.append({"step": step, "seconds": dt,
                        **{k: float(v) for k, v in metrics.items()}})
            if step in fail_at:
                fail_at.discard(step)
                raise InjectedFailure(f"injected failure at step {step}")
            if (step + 1) % self.cfg.ckpt_every == 0:
                self._save(step, state)
        if self._async:
            self._async.wait()
        return state, log

    def run_with_restarts(self, init_state, n_steps: int,
                          fail_at: Optional[set] = None,
                          max_restarts: int = 8):
        """Cluster-controller loop: rerun after every injected failure.
        ``init_state`` as for ``run``."""
        fail_at = set(fail_at or ())
        logs = []
        restarts = 0
        while True:
            try:
                state, log = self.run(init_state, n_steps, fail_at=fail_at)
                logs.extend(log)
                return state, logs, restarts
            except InjectedFailure:
                restarts += 1
                logs.append({"event": "restart", "n": restarts})
                if restarts > max_restarts:
                    raise
