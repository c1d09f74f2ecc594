"""Token-serving launcher of the port: continuous-batching generation over a
zoo model; reports throughput, slot occupancy and per-request latency
percentiles, with the report lines of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --requests 8 --slots 4 --max-new 24

Runs on the card (``--device cuda``, the default) through the Hopper
attention kernels; ``--device cpu`` runs the kernels' plain versions. The
semantic modes (``--semantic``) come with a later slice.
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=160)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the Hopper kernels, cpu "
                         "their plain versions")
    return ap


def serve_tokens(args):
    """Build the model from ``args.seed``, serve ``args.requests`` demo
    prompts and return (finished requests by id, engine, seconds)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    bundle = registry.build(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = bundle.init(generator=gen, device=args.device)
    print(f"[serve] arch={cfg.name} params={cfg.param_count()/1e6:.2f}M "
          f"slots={args.slots} max_len={args.max_len} device={args.device}")

    engine = GenerationEngine(bundle, params, max_len=args.max_len,
                              n_slots=args.slots, device=args.device)
    batcher = ContinuousBatcher(engine)
    t0 = time.time()
    for i in range(args.requests):
        batcher.submit(DEMO_PROMPTS[i % len(DEMO_PROMPTS)] + f" [{i}]",
                       max_new_tokens=args.max_new)
    finished = batcher.run()
    return finished, engine, time.time() - t0


def main(argv=None):
    args = build_parser().parse_args(argv)
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
