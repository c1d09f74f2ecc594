"""Serving launcher of the port, with the modes and report lines of
``repro.launch.serve``. Runs on the card (``--device cuda``, the default)
through the Hopper kernels; ``--device cpu`` runs the kernels' plain
versions.

**Token serving** (default; no ``--semantic``): continuous-batching
generation over a zoo model (``--arch``: qwen2-0.5b, the default,
mamba2-1.3b, hymba-1.5b, the cost model's other LLM tiers
codeqwen1.5-7b, granite-moe-1b-a400m and minicpm3-4b, or internvl2-76b,
served text only as in the reference; seamless-m4t-large-v2 is refused, as
the engine cannot hold an encoder-decoder's cache) — reports throughput,
slot occupancy and per-request latency percentiles::

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --requests 8 --slots 4 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch codeqwen1.5-7b --no-reduced

**One semantic query** (``--semantic <dataset>``): the dataset's first
workload query runs through the execution runtime
(``core.runtime.ExecutionContext`` + morsel-pipelined executor) with the
default tier (m1) served by THIS engine in oracle-echo mode; the report
shows measured vs event-replay simulated wall side by side::

    PYTHONPATH=src python -m repro_torch.launch.serve --semantic movie \\
        --no-reduced

**Streaming semantic serve** (``--semantic <dataset> --serve N``): a
long-lived ``launch.query_server.QueryServer`` admits N workload queries
onto ONE shared dispatcher and reports per-query latency percentiles and
the concurrent makespan. With ``--cascade`` the tier-0 embedding cascade
scores every filter/rank morsel through the row-wise cosine kernel::

    PYTHONPATH=src python -m repro_torch.launch.serve --semantic movie \\
        --serve 4 --cascade --no-reduced

The execution knobs are those of ``repro.launch.serve`` (see its docstring
and ``docs/SERVING.md``), under the same names and defaults. Among them,
``--shards N`` runs morsel-parallel shard workers and ``--procs N``
spawned process shard workers (``repro_torch.distributed``); results,
per-tier calls and meter totals equal those of ``--shards 1``. m1 (the
engine) and the cascade's scoring stay in the serving process, with the
card; the simulated tiers run in the workers::

    PYTHONPATH=src python -m repro_torch.launch.serve --semantic movie \\
        --serve 4 --cascade --procs 2

One difference: ``--reduced/--no-reduced`` picks m1's width in the
semantic modes too (the reference always serves m1 reduced there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.engine import ContinuousBatcher, GenerationEngine
from repro_torch.models import registry

DEMO_PROMPTS = [
    "Answer true or false. Instruction: The rating is higher than 8.5. "
    "Input: 9.1 Answer:",
    "Extract the genre: A crime story about a heist gone wrong.",
    "Summarize: NEWLY BUILT DUPLEX WITH SWIMMING POOL, PRICE: N250m",
    "Does the game support VR? Platforms: Windows, MacOS, VR supported.",
]


def build_engine(args, arch: str) -> GenerationEngine:
    """``arch`` at full width or reduced (``args.reduced``), seeded random
    weights from ``args.seed``, on ``args.device``."""
    cfg = get_config(arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    bundle = registry.build(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = bundle.init(generator=gen, device=args.device)
    return GenerationEngine(bundle, params, max_len=args.max_len,
                            n_slots=args.slots, device=args.device)


def serve_tokens(args):
    """Build the model from ``args.seed``, serve ``args.requests`` demo
    prompts and return (finished requests by id, engine, seconds)."""
    engine = build_engine(args, args.arch)
    cfg = engine.bundle.cfg
    print(f"[serve] arch={cfg.name} params={cfg.param_count()/1e6:.2f}M "
          f"slots={args.slots} max_len={args.max_len} device={args.device}")
    batcher = ContinuousBatcher(engine)
    t0 = time.time()
    for i in range(args.requests):
        batcher.submit(DEMO_PROMPTS[i % len(DEMO_PROMPTS)] + f" [{i}]",
                       max_new_tokens=args.max_new)
    finished = batcher.run()
    return finished, engine, time.time() - t0


def _semantic_context(args):
    """Build the engine-backed ExecutionContext both semantic modes use:
    the default tier (m1) is served by THIS engine in oracle-echo mode, the
    cascade (``--cascade``) scores on ``args.device``, the other tiers stay
    simulated."""
    from repro_torch.core import backends as bk
    from repro_torch.core import runtime as rt
    from repro_torch.core.cost_model import DEFAULT_TIERS, CostModel
    from repro_torch.data import load_dataset
    from repro_torch.engine.torch_backend import TorchBackend

    table, oracle = load_dataset(args.semantic, max_rows=args.requests * 4)
    tier = DEFAULT_TIERS["m1"]
    engine = build_engine(args, tier.arch)
    backends = bk.make_backends(oracle)
    backends["m1"] = TorchBackend(tier, engine, oracle=oracle,
                                  max_new_tokens=args.max_new)
    router = None
    if args.cascade:
        from repro_torch.core import cascade as casc_mod
        router = casc_mod.CascadeRouter(
            casc_mod.EmbeddingBackend(device=args.device),
            default_bands=casc_mod.CascadeBands(lo=args.cascade_lo,
                                                hi=args.cascade_hi))
    # one calibrated cost model per process: the executor/server observe
    # sync points feed it measured per-call latencies, and --explain-cost
    # prints its q-error table after the run
    model = CostModel(latency_weight=args.latency_weight)
    # fault-tolerance knobs: an all-default policy stays None so the
    # dispatchers keep the byte-identical fail-fast call paths
    policy = None
    if (args.retries > 0 or args.call_timeout is not None
            or args.breaker_threshold > 0 or args.fallback_tier):
        policy = rt.CallPolicy(retries=args.retries,
                               call_timeout_s=args.call_timeout,
                               breaker_threshold=args.breaker_threshold,
                               fallback_tier=args.fallback_tier or None,
                               seed=args.seed)
    ctx = rt.ExecutionContext(backends=backends, default_tier="m1",
                              concurrency=args.slots,
                              morsel_size=args.slots * 4,
                              driver=args.driver,
                              batch_size=args.batch,
                              coalesce=args.coalesce,
                              linger_s=args.linger,
                              shards=args.shards,
                              procs=args.procs,
                              cascade=router,
                              cost_model=model,
                              call_policy=policy)
    return table, engine.bundle.cfg, engine, ctx


def _explain_cost(args, ctx):
    """--explain-cost: print the calibrated model's per-(op, tier)
    q-error table after the run (predictions vs the measured call log
    ingested at the observe sync points)."""
    if not args.explain_cost or ctx.cost_model is None:
        return
    from repro_torch.analysis import qerror
    print("[serve] cost-model calibration (q-error = max(pred/meas, "
          "meas/pred)):")
    print(qerror.render_text(ctx.cost_model))


def serve_semantic(args):
    """Semantic-analytics serving: workload queries executed through the
    event-driven runtime, default tier backed by the real engine. Returns
    the query handles with ``--serve N``, else the one query's result."""
    table, cfg, engine, ctx = _semantic_context(args)
    if args.serve > 0:
        out = serve_queries(args, table, cfg, engine, ctx)
    else:
        out = serve_query(args, table, cfg, engine, ctx)
    _explain_cost(args, ctx)
    return out


def serve_query(args, table, cfg, engine, ctx):
    """One semantic query: the dataset's first workload query, with
    measured and event-replay simulated wall side by side."""
    from repro_torch.core import executor as ex
    from repro_torch.core import runtime as rt
    from repro_torch.data import WORKLOADS

    q = WORKLOADS[args.semantic][0]
    print(f"[serve] semantic query {q.qid} over {table.name} "
          f"({table.n_rows} rows), m1 = {cfg.name} on {args.slots} slots, "
          f"device={args.device} driver={args.driver} shards={args.shards} "
          f"procs={args.procs} batch={args.batch} "
          f"coalesce={args.coalesce} linger={args.linger} "
          f"cascade={args.cascade}")
    t0 = time.time()
    res = ex.execute(q.plan_for(table), table, ctx)
    dt = time.time() - t0
    print(f"[serve] answer: {repr(res.value())[:120]}")
    # measured vs simulated, side by side: replay the metered per-call
    # latencies through the event scheduler regardless of the driver
    replay = rt.EventScheduler(concurrency=args.slots)
    replay.drain(ctx.meter, 0)
    measured = res.wall_s if args.driver == "threads" else dt
    print(f"[serve] wall measured={measured:.2f}s "
          f"(driver={args.driver}, {len(ctx.meter.call_log)} calls)  "
          f"simulated={replay.makespan:.2f}s (event replay)  "
          f"host={dt:.2f}s")
    for tname, u in ctx.meter.by_tier.items():
        print(f"  [{tname}] calls={u.calls} tok_in={u.tok_in:.0f} "
              f"usd=${u.usd:.4f} latency_sum={u.latency_s:.2f}s")
    if res.cascade_stats is not None:
        print(f"[serve] cascade stats={res.cascade_stats}")
    print(f"[serve] engine stats={engine.stats} "
          f"occupancy={engine.occupancy:.2f}")
    return res


def stagger_offsets(n: int, mean_s: float, seed: int = 0):
    """Deterministic Poisson-ish admission offsets: cumulative seeded
    exponential inter-arrival gaps with mean ``mean_s`` (all zeros when
    ``mean_s`` is 0 — admit everything at once). Explicit offsets, not a
    live random process, so a serve run is reproducible."""
    import random
    rng = random.Random(seed)
    offsets, t = [], 0.0
    for _ in range(max(0, n)):
        offsets.append(t)
        if mean_s > 0:
            t += rng.expovariate(1.0 / mean_s)
    return offsets


def parse_admission(spec: str):
    """``--admission`` spec -> :class:`AdmissionController` (or None).
    ``""`` = off; ``on`` = all-default controller; otherwise a
    comma-separated ``rows=R,depth=D,conc=C`` picks the per-tenant
    in-flight-row cap, per-tenant queue depth, and execution width."""
    from repro_torch.launch.query_server import AdmissionController
    spec = (spec or "").strip()
    if not spec:
        return None
    kw = {}
    if spec not in ("on", "1", "true"):
        keys = {"rows": "max_tenant_rows", "depth": "max_queue_depth",
                "conc": "max_concurrent"}
        for part in spec.split(","):
            k, _, v = part.partition("=")
            if k.strip() not in keys:
                raise ValueError(f"bad --admission entry {part!r}; "
                                 f"expected rows=/depth=/conc= or 'on'")
            kw[keys[k.strip()]] = int(v)
    return AdmissionController(**kw)


def serve_queries(args, table, cfg, engine, ctx):
    """Streaming semantic serve: admit ``--serve N`` workload queries
    (staggered by ``--stagger``) onto one shared QueryServer and report
    per-query latency percentiles + makespan vs sequential estimate.
    With ``--admission`` the queries route through the multi-tenant
    admission controller (``--tenants/--lane/--slo`` shape the load).
    Returns the query handles, in admission order."""
    from repro_torch.data import WORKLOADS
    from repro_torch.launch.query_server import QueryServer

    queries = [WORKLOADS[args.semantic][i % len(WORKLOADS[args.semantic])]
               for i in range(args.serve)]
    offsets = stagger_offsets(len(queries), args.stagger, seed=args.seed)
    controller = parse_admission(args.admission)
    print(f"[serve] streaming {len(queries)} queries over {table.name} "
          f"({table.n_rows} rows), m1 = {cfg.name} on {args.slots} slots, "
          f"device={args.device} driver={args.driver} shards={args.shards} "
          f"procs={args.procs} batch={args.batch} "
          f"stagger={args.stagger}s tenants={args.tenants} lane={args.lane} "
          f"admission={'on' if controller else 'off'} slo={args.slo}")
    handles = []
    with QueryServer(ctx, admission=controller) as server:
        t0 = time.perf_counter()
        for i, (q, off) in enumerate(zip(queries, offsets)):
            lead = off - (time.perf_counter() - t0)
            if lead > 0:
                time.sleep(lead)
            lane = args.lane if args.lane in ("batch", "interactive") \
                else ("interactive" if i % 2 == 0 else "batch")
            handles.append(server.submit(
                q.plan_for(table), table, name=q.qid,
                tenant=f"t{i % max(1, args.tenants)}", lane=lane,
                deadline_s=args.slo))
        server.drain()
        makespan = time.perf_counter() - t0
        stats = server.stats()
    served = [h for h in handles if not h.rejected()]
    lats = sorted(h.latency_s for h in served) or [0.0]
    # per-query exec walls are measured UNDER co-tenant contention, so
    # their sum is only an upper bound on back-to-back execution
    seq_bound = sum(h.exec_wall_s for h in served)
    for h in handles:
        if h.rejected():
            res = f"REJECTED ({h._fut.exception().reason})"
        elif h.failed():
            res = "FAILED"
        else:
            res = repr(h.result().value())[:60]
        print(f"  [{h.name}] tenant={h.tenant} lane={h.lane} "
              f"latency={h.latency_s:.2f}s "
              f"exec={h.exec_wall_s:.2f}s calls={h.meter.total.calls} "
              f"-> {res}")
    p = np.percentile
    print(f"[serve] makespan={makespan:.2f}s  sum-of-exec-walls="
          f"{seq_bound:.2f}s  overlap<={seq_bound / max(makespan, 1e-9):.2f}x"
          f" (upper bound)")
    print(f"[serve] latency p50={p(lats, 50):.2f}s p95={p(lats, 95):.2f}s "
          f"max={lats[-1]:.2f}s")
    print(f"[serve] server stats={stats}")
    print(f"[serve] engine stats={engine.stats} "
          f"occupancy={engine.occupancy:.2f}")
    return handles


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced widths (default) or the published ones; "
                         "in the semantic modes it sizes m1")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=160)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the Hopper kernels, cpu "
                         "their plain versions")
    ap.add_argument("--semantic", default="",
                    help="dataset name: serve a semantic workload through "
                         "the execution runtime instead of raw prompts")
    ap.add_argument("--driver", choices=("simulated", "threads"),
                    default="threads",
                    help="--semantic execution driver: real thread pools "
                         "(measured wall) or the event-model simulation")
    ap.add_argument("--shards", type=int, default=1,
                    help="--semantic: morsel-parallel shard workers "
                         "(pool-per-(shard, tier) dispatch; morsels "
                         "round-robin across shards, results identical "
                         "to --shards 1)")
    ap.add_argument("--procs", type=int, default=0,
                    help="--semantic: spawned process shard workers — "
                         "backend calls and host UDFs run GIL-free in "
                         "worker subprocesses, results identical to the "
                         "in-process drivers; mutually exclusive with "
                         "--shards > 1 (unpicklable backends, e.g. the "
                         "engine-backed m1, keep running in-process)")
    ap.add_argument("--batch", type=int, default=1,
                    help="--semantic batch prompting size (records per "
                         "LLM call)")
    ap.add_argument("--coalesce", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--semantic: pack batch slots across morsel "
                         "boundaries (runtime.BatchCoalescer)")
    ap.add_argument("--linger", type=float, default=None,
                    help="--semantic: max seconds a partial coalesced "
                         "batch waits for more rows before flushing "
                         "(default: flush only on morsel watermarks)")
    ap.add_argument("--cascade", action="store_true",
                    help="--semantic: tier-0 embedding cascade — filter/"
                         "rank predicates resolve high-confidence rows in "
                         "one batched device pass; only the uncertain "
                         "band escalates to the LLM tier")
    ap.add_argument("--cascade-lo", type=float, default=-0.35,
                    help="--cascade: drop rows scoring at or below this "
                         "cosine")
    ap.add_argument("--cascade-hi", type=float, default=0.35,
                    help="--cascade: pass rows scoring at or above this "
                         "cosine; lo < score < hi escalates")
    ap.add_argument("--serve", type=int, default=0,
                    help="--semantic: admit N workload queries onto one "
                         "long-lived QueryServer (shared dispatcher, "
                         "per-query meters + latency percentiles); "
                         "0 = execute the first query once and exit")
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="--serve: Poisson-ish mean inter-admission gap "
                         "in seconds (seeded explicit offsets; 0 = admit "
                         "all queries at once)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="--serve: round-robin the served queries across "
                         "N tenant ids (t0..tN-1)")
    ap.add_argument("--lane", choices=("batch", "interactive", "mixed"),
                    default="batch",
                    help="--serve: priority lane for served queries; "
                         "'mixed' alternates interactive/batch")
    ap.add_argument("--admission", default="",
                    help="--serve: multi-tenant admission controller — "
                         "'on' for defaults, or 'rows=R,depth=D,conc=C'; "
                         "empty = FIFO admission")
    ap.add_argument("--slo", type=float, default=None,
                    help="--serve: per-query deadline in seconds; with "
                         "--admission, queries predicted to bust it are "
                         "denied at admission")
    ap.add_argument("--latency-weight", type=float, default=0.0,
                    help="--semantic: cost x makespan weight on the "
                         "context's CostModel (0 = pure USD)")
    ap.add_argument("--explain-cost", action="store_true",
                    help="--semantic: after the run, print the cost "
                         "model's per-(op, tier) q-error table")
    ap.add_argument("--retries", type=int, default=0,
                    help="--semantic: extra attempts per backend call "
                         "after a transient failure (0 = fail fast)")
    ap.add_argument("--call-timeout", type=float, default=None,
                    help="--semantic: cooperative per-call deadline in "
                         "seconds")
    ap.add_argument("--breaker-threshold", type=int, default=0,
                    help="--semantic: consecutive exhausted calls on one "
                         "tier before its circuit opens (0 = off)")
    ap.add_argument("--fallback-tier", default=None,
                    help="--semantic: sibling tier that serves a call once "
                         "its primary exhausts retries or its breaker is "
                         "open (unset = re-raise)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.semantic:
        return serve_semantic(args)
    finished, engine, dt = serve_tokens(args)
    lats = [r.done_s - r.submitted_s for r in finished.values()]
    new_toks = sum(len(r.output_ids) for r in finished.values())
    print(f"[serve] {len(finished)} requests in {dt:.2f}s  "
          f"({new_toks / dt:,.1f} new tok/s)")
    print(f"[serve] occupancy={engine.occupancy:.2f}  "
          f"p50={np.percentile(lats, 50):.2f}s "
          f"p99={np.percentile(lats, 99):.2f}s")
    print(f"[serve] stats={engine.stats}")
    return finished


if __name__ == "__main__":
    main()
