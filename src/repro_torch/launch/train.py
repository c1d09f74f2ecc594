"""Training launcher of the port, with the flags and report lines of
``repro.launch.train`` and ``--device`` (the card by default)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 12 --batch 8 --seq 512 --ckpt-every 4 --ckpt-dir CKPT

trains full-width qwen2-0.5b on the card (494M parameters, fp32 weights
and AdamW moments, bf16 activations, each layer recomputed in the
backward); ``--reduced --device cpu`` trains the same-family tiny config on
the CPU. ``--arch seamless-m4t-large-v2`` trains the encoder-decoder
(2.03B parameters; each batch's encoder input is seeded random frame
embeddings as long as its tokens, as in the reference), and a VLM config
(``internvl2-76b``) trains with seeded random prefix embeddings.
``--arch mamba2-1.3b`` and ``--arch hymba-1.5b`` train the SSM and the
hybrid at full width on one card (the scan's backward kernel, and for
hymba the flash backward with its window of 1024). What one card's 80 GB
hold at full width and depth: qwen2-0.5b, mamba2-1.3b, hymba-1.5b,
granite-moe-1b-a400m and seamless-m4t-large-v2. The larger configs
(codeqwen1.5-7b, minicpm3-4b, deepseek-67b, internvl2-76b,
llama4-scout-17b-a16e) need more than one card at full depth, which the
reference only compiles (its dry-run); the port's mesh (``launch.mesh``,
``distributed.sharding``) places their state and its train step trains
split leaves, and ``launch.dryrun`` traces their steps on the production
meshes. One card trains them ``--reduced``, or at full width cut in depth
(``run(args, cfg=...)`` with a config of fewer layers: codeqwen1.5-7b at 4
of its 32 layers). The batches are the pipeline's synthetic ones, uniform random tokens, as the
reference's are: nothing in them can be learnt, so the loss stays near
ln(vocab). ``--corpus movie|estate|game`` feeds the pipeline's
text source instead (``TokenPipeline(documents=...)``: a dataset's longest
text column packed by the byte tokenizer), on which the loss falls. The loop runs under the fault-tolerance supervisor: checkpoint
every ``--ckpt-every`` steps, restart from the last committed one,
straggler flagging on. ``--ckpt-dir`` resumes from what it holds, so give
a fresh one for a fresh run.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.models import registry
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import train_loop


# the text column of each dataset that --corpus packs into sequences
CORPUS_COLUMNS = {"movie": "Plot", "estate": "Details", "game": "description"}


def corpus_documents(name: str):
    from repro_torch.data import load_dataset
    table, _ = load_dataset(name)
    return [str(x) for x in table.columns[CORPUS_COLUMNS[name]]]


def synthetic_batch_fn(cfg, batch: int, seq: int, seed: int = 0,
                       device="cuda", documents=None):
    """Deterministic per-step batches: tokens from the pipeline (uniform
    random, or sequences of ``documents`` packed by the byte tokenizer), a
    pure function of (seed, step), so a restart sees the batches it would
    have seen; the noise of prefix and encoder inputs from a generator
    seeded by the step (an encoder-decoder's ``enc_embeds`` are
    (batch, seq, d_model), as long as the decoder's tokens)."""
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=batch,
                         seq_len=seq, seed=seed, documents=documents)

    def fn(step: int):
        out = {"tokens": torch.as_tensor(pipe.batch_at(step)["tokens"],
                                         device=device)}
        gen = torch.Generator(device).manual_seed(step)
        if cfg.n_prefix_embeds:
            out["prefix_embeds"] = torch.randn(
                (batch, cfg.n_prefix_embeds, cfg.d_model), generator=gen,
                device=device).to(torch.bfloat16)
        if cfg.is_encoder_decoder:
            out = {"tokens": out["tokens"],
                   "enc_embeds": torch.randn(
                       (batch, seq, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)}
        return out
    return fn


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="a config of configs.ARCH_IDS; at full width and "
                         "depth one card trains qwen2-0.5b, mamba2-1.3b, "
                         "hymba-1.5b, granite-moe-1b-a400m and "
                         "seamless-m4t-large-v2")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--corpus", default=None, choices=sorted(CORPUS_COLUMNS),
                    help="train on this dataset's text (default: the "
                         "synthetic random tokens)")
    return ap


def run(args, fail_at=None, cfg=None):
    """Build the model, optimizer and supervisor from ``args`` and train.
    With ``fail_at`` (steps), failures are injected after those steps and
    the supervisor restarts from the last checkpoint (before any, from the
    initial state built anew) until the run ends. ``cfg``: a config built
    already (a full-width one cut in depth) in place of ``--arch`` and
    ``--reduced``'s. Returns {"cfg", "state", "log", "seconds", "restarts",
    "straggler", "train_step", "batch_fn"}; "seconds" is the run's wall,
    the supervisor's build of the initial state included."""
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg)
    bundle = registry.build(cfg)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} "
          f"device={args.device} data={args.corpus or 'synthetic'}")

    def init_state():  # a restart before any checkpoint builds it anew
        gen = torch.Generator(args.device).manual_seed(args.seed)
        return train_loop.init_train_state(bundle, gen, device=args.device)
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=args.steps)
    step_fn = train_loop.make_train_step(
        bundle, opt_cfg, remat=True, microbatches=args.microbatches,
        compress_grads=args.compress_grads)
    batch_fn = synthetic_batch_fn(
        cfg, args.batch, args.seq, device=args.device,
        documents=corpus_documents(args.corpus) if args.corpus else None)
    sup = TrainSupervisor(
        step_fn, batch_fn,
        SupervisorConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         async_save=args.async_ckpt))
    t0 = time.time()
    # the supervisor builds the initial state, so that nothing here holds
    # it once the first step has built the next one beside it
    state, log, restarts = sup.run_with_restarts(init_state, args.steps,
                                                 fail_at=fail_at)
    return {"cfg": cfg, "state": state, "log": log,
            "seconds": time.time() - t0, "restarts": restarts,
            "straggler": sup.straggler, "train_step": step_fn,
            "batch_fn": batch_fn}


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args)
    dt = out["seconds"]
    losses = [e["loss"] for e in out["log"] if "loss" in e]
    print(f"[train] done in {dt:.1f}s  loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}  stragglers={out['straggler'].flagged}")
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"[train] throughput {tok_s:,.0f} tok/s")
    return losses


if __name__ == "__main__":
    main()
