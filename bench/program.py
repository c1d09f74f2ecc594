"""The system under test, as the benchmark drives it: the port's
configuration, model, serving engine and training step, and its kernel
launch counters. The only module of the benchmark that imports the
program (``repro_torch``); the reference imports none of it."""
from __future__ import annotations

import dataclasses

import torch

# the configuration file's keys (HF's names) and the port's fields
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "rms_norm_eps": "rms_eps",
          "attention_bias": "qkv_bias",
          "tie_word_embeddings": "tie_embeddings"}
MOE_FIELDS = {"num_local_experts": "num_experts",
              "num_experts_per_tok": "top_k",
              "capacity_factor": "capacity_factor"}
# keys of a configuration file that the benchmark reads itself: the
# source, the precisions, how it was cut, the weights' initialisation, the
# reference of its architecture and where its further keys go
BENCH_KEYS = {"arch", "source", "serve_dtype", "train_dtype", "master_dtype",
              "reduced_from", "deployment", "assumed", "departures",
              "precision", "init", "reference", "port_fields"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(cfg_json: dict):
    """The port's config of ``cfg_json["arch"]`` with every size the file
    states: the file is the configuration as it is run, so a key that maps
    to no field of the port is refused. The keys of ``FIELDS`` and
    ``MOE_FIELDS`` map themselves; the file's ``port_fields``,
    {key: "field" or "group.field"}, maps any other key to a field of the
    arch's config or of one of its groups (``"ssm.d_state"``)."""
    from repro_torch.configs import get_config
    paths = cfg_json.get("port_fields", {})
    unknown = (set(cfg_json) - set(FIELDS) - set(MOE_FIELDS) - BENCH_KEYS
               - set(paths))
    if unknown:
        raise KeyError(f"configuration keys the port does not take: "
                       f"{sorted(unknown)}")
    base = get_config(cfg_json["arch"])
    kw = {FIELDS[k]: v for k, v in cfg_json.items() if k in FIELDS}
    moe = {MOE_FIELDS[k]: v for k, v in cfg_json.items() if k in MOE_FIELDS}
    if moe:
        kw["moe"] = dataclasses.replace(base.moe, **moe)
    run = dataclasses.replace(base, **kw)
    for key, path in paths.items():
        if key in cfg_json:
            run = _set_field(run, path, cfg_json[key], key)
    return run


def _set_field(config, path: str, value, key: str):
    """``config`` with the field at ``path`` (dots into nested dataclasses)
    set to ``value``, a JSON list as a tuple."""
    head, _, rest = path.partition(".")
    if head not in {f.name for f in dataclasses.fields(config)}:
        raise KeyError(f"port_fields: {key!r} -> {path!r}: "
                       f"{type(config).__name__} has no field {head!r}")
    if rest:
        group = getattr(config, head)
        if group is None:
            raise KeyError(f"port_fields: {key!r} -> {path!r}: the arch's "
                           f"config has no {head!r} group (it is None)")
        value = _set_field(group, rest, value, key)
    elif isinstance(value, list):
        value = tuple(value)
    return dataclasses.replace(config, **{head: value})


def build(cfg_json: dict):
    from repro_torch.models import registry
    return registry.build(model_config(cfg_json))


def flatten(tree, prefix="") -> dict:
    """{"a": {"b": t}} -> {"a/b": t}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def nest(flat: dict) -> dict:
    """{"a/b/c": t} -> {"a": {"b": {"c": t}}}."""
    out = {}
    for path, t in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def param_shapes(bundle) -> dict:
    """{leaf path: shape} of the port's parameter tree."""
    return {p: tuple(t.shape)
            for p, t in flatten(bundle.init(device="meta")).items()}


def engine(bundle, params, mix: dict, device):
    from repro_torch.engine.engine import GenerationEngine
    return GenerationEngine(bundle, params, max_len=mix["max_len"],
                            n_slots=mix["slots"],
                            dtype=DTYPES[mix["dtype"]], device=device)


def batcher(eng):
    from repro_torch.engine.engine import ContinuousBatcher
    return ContinuousBatcher(eng)


def prefill_align() -> int:
    from repro_torch.engine.engine import PREFILL_ALIGN
    return PREFILL_ALIGN


def request(prompt: str, max_new_tokens: int):
    from repro_torch.engine.engine import Request
    return Request(-1, prompt, max_new_tokens)


def train_step(bundle, mix: dict):
    """The step ``launch.train.run`` builds (remat, AdamW), with the mix's
    optimizer settings."""
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_loop
    return train_loop.make_train_step(
        bundle, opt_mod.AdamWConfig(**mix["optimizer"]),
        dtype=DTYPES[mix["dtype"]], remat=mix["remat"])


def train_state(params: dict) -> dict:
    from repro_torch.training import optimizer as opt_mod
    for p in flatten(params).values():
        p.requires_grad_(True)
    return {"params": params, "opt": opt_mod.init_state(params)}


def semantic_calls(dataset: str, max_rows: int) -> list:
    """Every model call of the dataset's workload queries, run through the
    port's executor over the table's first ``max_rows`` rows: (operator
    kind, the prompt ``TorchBackend`` renders, the oracle's answer). Each
    tier answers as the oracle does, as ``TorchBackend`` in echo mode."""
    from repro_torch.core import executor, runtime
    from repro_torch.core import plan as plan_ir
    from repro_torch.core.cost_model import DEFAULT_TIERS
    from repro_torch.data import WORKLOADS, load_dataset
    from repro_torch.engine.torch_backend import render_prompt
    table, oracle = load_dataset(dataset, max_rows=max_rows)
    calls = []

    class Recorder:
        def __init__(self, tier):
            self.tier = tier

        def run_values(self, op, values, meter=None, batch_size=1):
            if op.kind == plan_ir.REDUCE:
                # TorchBackend's one prompt of a reduce
                joined = "; ".join(str(v)[:60] for v in list(values)[:32])
                answer = oracle.answer_reduce(op, values)
                calls.append((op.kind, render_prompt(op, joined), answer))
                return [answer]
            out = [oracle.answer(op, v) for v in values]
            calls.extend((op.kind, render_prompt(op, v), a)
                         for v, a in zip(values, out))
            return out

    backends = {name: Recorder(t) for name, t in DEFAULT_TIERS.items()}
    for query in WORKLOADS[dataset]:
        executor.execute(query.plan_for(table), table,
                         runtime.ExecutionContext(backends=backends,
                                                  default_tier="m1"))
    return calls


def max_new_tokens() -> int:
    """The tokens ``TorchBackend`` asks the engine for at most."""
    from repro_torch.engine.torch_backend import TorchBackend
    return TorchBackend.max_new_tokens


def launch_counts() -> dict:
    from repro_torch.kernels import ops
    return ops.launch_counts()
