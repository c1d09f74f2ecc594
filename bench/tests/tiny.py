"""A tiny copy of the benchmark for the CPU tests: the two configurations
cut to a few dims, small mixes, written as files under a root of their own
so that the harness finds them by name as it finds the real ones."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench import spec

DENSE = {"arch": "codeqwen1.5-7b", "hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
         "intermediate_size": 96, "vocab_size": 512, "rope_theta": 1e6,
         "rms_norm_eps": 1e-5, "attention_bias": True,
         "tie_word_embeddings": False}
MOE = {"arch": "granite-moe-1b-a400m", "hidden_size": 64,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
       "vocab_size": 512, "num_local_experts": 8, "num_experts_per_tok": 2,
       "capacity_factor": 1.25, "rope_theta": 1e4, "rms_norm_eps": 1e-5,
       "attention_bias": False, "tie_word_embeddings": True}
# the real configuration whose weights' init rules each tiny one takes
REAL = {"dense": "codeqwen1.5-7b", "moe": "granite-moe-1b-a400m"}
SERVE = {"kind": "serve", "slots": 4, "max_len": 160, "callers": 3,
         "morsel": 2, "block": 16, "calls": "calls.jsonl",
         "check": {"every": 1, "max_rows": 400, "tokens": 40}}
# the tiny trace: the real trace's first calls of at most this many bytes,
# each made at most twice and generating at most 4 tokens
TINY_PROMPT, TINY_CALLS = 119, 24
TRAIN = {"kind": "train", "batch": 2, "seq": 32, "remat": True,
         "first_steps": 3,
         "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                       "weight_decay": 0.1, "clip_norm": 1.0,
                       "warmup_steps": 10, "total_steps": 1000,
                       "min_lr_ratio": 0.1}}
# limits set as the real cells' are, from the program's, the control's and
# the faults' readings at these sizes on the CPU (seeds 11-16). At the MoE's
# tiny size one routing choice that bf16 flips moves a whole expert's
# gradient (its grad_gap reads 0.0013-0.031 over those seeds), so the
# control does not separate there: its test is the dense cell's.
CELLS = {"tiny.serve": ("dense", "serve", {"logit_err": 1e-4,
                                          "served_gap": 0.1}),
         "tiny.train": ("dense", "train", {"grad_err": 0.08,
                                          "loss_gap": 1.2e-3,
                                          "grad_gap": 8e-3,
                                          "change_gap": 0.05}),
         "tiny.moe.train": ("moe", "train", {"grad_err": 0.35,
                                            "loss_gap": 2.5e-3,
                                            "grad_gap": 0.045,
                                            "change_gap": 0.015})}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path, dtype: str = "bfloat16") -> Path:
    """A root holding BENCHMARK.json and the tiny cells' files; the real
    metric readers and references copied beside them."""
    real = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for part in ("metrics", "reference"):
        shutil.copytree(spec.ROOT / "bench" / part, tmp / "bench" / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    files = {c["name"]: c["file"] for c in real["configs"]}
    init = {name: json.loads((spec.ROOT / files[real_name]).read_text())[
        "init"] for name, real_name in REAL.items()}
    configs = []
    for name, dims in (("dense", DENSE), ("moe", MOE)):
        _write(tmp / "bench" / "configs" / f"{name}.json",
               dict(dims, init=init[name], serve_dtype="float32",
                    train_dtype=dtype))
        configs.append({"name": name, "source": "tiny",
                        "file": f"bench/configs/{name}.json", "reduced": [],
                        "why": "CPU test"})
    _write(tmp / "bench" / "traffic" / "serve.json", SERVE)
    short = []
    with open(spec.ROOT / "bench" / "traffic" / "ops_calls.jsonl") as f:
        for line in f:
            c = json.loads(line)
            if len(c["prompt"].encode("utf-8")) <= TINY_PROMPT:
                short.append(json.dumps(dict(
                    c, count=min(c["count"], 2),
                    new_tokens=min(c["new_tokens"], 4))))
    (tmp / "bench" / "traffic" / "calls.jsonl").write_text(
        "\n".join(short[:TINY_CALLS]) + "\n")
    _write(tmp / "bench" / "traffic" / "train.json", TRAIN)
    work = []
    for cell, (cfg, mix, limits) in CELLS.items():
        _write(tmp / "bench" / "limits" / f"{cell}.json", limits)
        work.append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                     "why": "CPU test"})
    bench = dict(real, configs=configs, workloads=work)
    by_kind = {k: [c for c, v in CELLS.items() if v[1] == k]
               for k in ("serve", "train")}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serving = "serve" in m.get("moves", m["name"]) or \
                m["name"] == "request_p95_s"
            m["workloads"] = by_kind["serve" if serving else "train"]
    _write(tmp / "BENCHMARK.json", bench)
    return tmp
