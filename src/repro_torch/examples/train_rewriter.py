"""Train the local rewrite model (paper §3.3) on the port, the counterpart
of ``examples/train_rewriter.py``:

  1. data collection: compile the workloads' analytical queries into
     logical plans, enumerate candidate rewrites, and label each plan with
     the greedy rule teacher's choice;
  2. fine-tune a small LM (qwen2-0.5b reduced to 2 layers, d_model 128:
     4/2 heads of 32) to score (plan, candidate) pairs: input
     "plan \\x1f candidate", a binary Y/N readout at the last position,
     trained on the card through the flash attention kernels (forward and
     backward);
  3. plug the trained policy in as the ``LocalModelRewriter`` and run the
     logical optimizer with no cloud-rewriter call; compare plan cost and
     rewriter cost with the simulated cloud LLM rewriter.

    PYTHONPATH=src python -m repro_torch.examples.train_rewriter --steps 300

``--device cpu`` runs it on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import logical_optimizer as lopt
from repro_torch.core import make_backends
from repro_torch.core import rewriter as rw
from repro_torch.data import WORKLOADS, load_dataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import registry, transformer
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_loop import grad_tree

MAXLEN = 384


def collect_dataset():
    """(plan_json, candidate_desc, label) triples from the rule teacher."""
    rows = []
    for ds in ("movie", "estate", "game"):
        table, _ = load_dataset(ds, max_rows=4)
        plans = [q.plan_for(table) for q in WORKLOADS[ds]]
        for rec in rw.training_pairs(plans):
            cands = rec["candidates"]
            for i, c in enumerate(cands):
                rows.append((rec["plan_json"], c, 1 if i == rec["label"]
                             else 0))
    return rows


def encode_pair(tok, plan_json, cand, maxlen=MAXLEN):
    text = plan_json[-(maxlen - len(cand) - 24):] + "\x1f" + cand
    return tok.encode(text)[:maxlen - 1]


def make_model():
    cfg = reduced(get_config("qwen2-0.5b"), n_layers=2, d_model=128,
                  vocab=512)
    return cfg, registry.build(cfg)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None):
    """Returns {"losses", "initial_eval_acc", "eval_acc", "train_acc",
    "plan_cost": {rewriter: (initial, best)}, "policy_calls",
    "rewriter_calls"}."""
    args = build_parser().parse_args(argv)
    device = args.device
    tok = ByteTokenizer()
    rows = collect_dataset()
    rng = random.Random(args.seed)
    rng.shuffle(rows)
    n_eval = max(8, len(rows) // 6)
    eval_rows, train_rows = rows[:n_eval], rows[n_eval:]
    print(f"[data] {len(train_rows)} train / {len(eval_rows)} eval pairs "
          f"(teacher = greedy rule rewriter)")

    cfg, bundle = make_model()
    params = bundle.init(
        generator=torch.Generator(device).manual_seed(args.seed),
        device=device, requires_grad=True)
    print(f"[model] {cfg.name}: {cfg.param_count()/1e6:.2f}M params, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"on {device}")
    Y, N = tok.encode("Y", bos=False)[0], tok.encode("N", bos=False)[0]
    readout = torch.tensor([N, Y], device=device)

    def logits_of(params, tokens, lengths):
        out = transformer.forward(params, cfg, tokens, dtype=torch.float32,
                                  remat=False)
        idx = torch.clamp(lengths - 1, 0, tokens.shape[1] - 1).long()
        last = out[torch.arange(out.shape[0], device=device), idx]
        return last[:, readout]                      # (B, 2)

    def loss_fn(params, batch):
        lg = logits_of(params, batch["tokens"], batch["lengths"])
        logp = torch.log_softmax(lg, dim=-1)
        return torch.mean(-logp[torch.arange(lg.shape[0], device=device),
                                batch["labels"].long()])

    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps, weight_decay=0.01)
    opt_state = opt_mod.init_state(params)

    def step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        params, opt_state, _ = opt_mod.apply_updates(
            opt_cfg, params, grad_tree(loss, params), opt_state)
        return params, opt_state, loss.detach()

    def make_batch(rows_sel):
        seqs = [encode_pair(tok, p, c) for p, c, _ in rows_sel]
        lengths = np.array([len(s) for s in seqs], np.int32)
        tokens = tok.pad_batch(seqs, length=MAXLEN)
        labels = np.array([l for _, _, l in rows_sel], np.int32)
        return {k: torch.as_tensor(v, device=device) for k, v in
                (("tokens", tokens), ("lengths", lengths),
                 ("labels", labels))}

    @torch.no_grad()
    def accuracy(rows_sel):
        b = make_batch(rows_sel)
        pred = torch.argmax(logits_of(params, b["tokens"], b["lengths"]), -1)
        return float(torch.mean((pred == b["labels"]).float()))

    initial = accuracy(eval_rows)
    print(f"[train] initial eval acc={initial:.2f}")
    losses = []
    for i in range(args.steps):
        sel = [train_rows[rng.randrange(len(train_rows))]
               for _ in range(args.batch)]
        params, opt_state, loss = step(params, opt_state, make_batch(sel))
        losses.append(float(loss))
        if (i + 1) % max(1, args.steps // 5) == 0:
            print(f"[train] step {i+1:4d} loss={losses[-1]:.3f} "
                  f"eval_acc={accuracy(eval_rows):.2f}")
    eval_acc = accuracy(eval_rows)
    train_acc = accuracy(train_rows[:len(eval_rows)])
    print(f"[train] final train acc={train_acc:.2f} eval acc={eval_acc:.2f}")

    # ---- deploy as the LocalModelRewriter --------------------------------
    policy_calls = [0]

    @torch.no_grad()
    def policy(plan_json, candidate_descriptions):
        seqs = [encode_pair(tok, plan_json, c)
                for c in candidate_descriptions]
        lengths = torch.as_tensor([len(s) for s in seqs], device=device)
        tokens = torch.as_tensor(tok.pad_batch(seqs, length=MAXLEN),
                                 device=device)
        score = torch.log_softmax(logits_of(params, tokens, lengths),
                                  dim=-1)[:, 1]
        policy_calls[0] += 1
        return int(torch.argmax(score))

    local = rw.LocalModelRewriter(policy=policy)
    cloud = rw.LLMSimRewriter(error_rate=0.0)

    table, oracle = load_dataset("movie", max_rows=64)
    backends = make_backends(oracle)
    q = WORKLOADS["movie"][9]
    plan = q.plan_for(table)
    costs, rewriter_calls = {}, 0
    for name, rewriter in (("cloud LLM", cloud), ("local model", local)):
        res = lopt.optimize(plan, table, backends, rewriter=rewriter,
                            cfg=lopt.LogicalOptConfig(n_iterations=3))
        u = res.meter.by_tier.get("rewriter")
        costs[name] = (res.initial_cost, res.best_cost)
        if rewriter is local:
            rewriter_calls = u.calls
        print(f"[{name:11s}] plan cost ${res.initial_cost:.3f} -> "
              f"${res.best_cost:.3f}  rewriter: "
              f"{u.latency_s:.2f}s ${u.usd:.4f}")
    return {"losses": losses, "initial_eval_acc": initial,
            "eval_acc": eval_acc, "train_acc": train_acc,
            "plan_cost": costs, "policy_calls": policy_calls[0],
            "rewriter_calls": rewriter_calls}


if __name__ == "__main__":
    main()
