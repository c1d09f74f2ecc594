"""A configuration of a new architecture joins the benchmark by files
alone: the file names its reference (``"reference"``), maps its further
keys to the port's fields (``"port_fields"``), and the reference's
``counts`` give the FLOPs and parameters the metrics read.

(a) The counts moved into ``bench/reference/model.py`` give every count of
the two real configurations and the two tiny ones bit for bit as the
formulas they replaced, kept frozen here. (b) A temporary root adds MLA
(``minicpm3-4b``) as files: a configuration, ``bench/reference/mla.py``,
limits and two cells, each correct on the CPU, the train cell not correct
with half its batch. (c) What ``port_fields`` refuses. (d) ``train_mfu``
and ``adamw_roofline.train`` of the MLA cell, against hand counts."""
import json
import math
import time

import pytest
import torch

from bench import faults, flops, program, spec, weights
from bench.run import run_cell
from bench.tests import tiny


def _config(name):
    return spec._json(spec.ROOT / "bench" / "configs" / f"{name}.json")


# --- (a) the formulas as they stood before the counts moved, frozen ---------

def old_dims(cfg):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return d, h, cfg["num_key_value_heads"], cfg.get("head_dim") or d // h


def old_layer_matmul_params(cfg):
    d, h, kv, hd = old_dims(cfg)
    attn = d * hd * (2 * h + 2 * kv)
    if "num_local_experts" in cfg:
        ffn = (d * cfg["num_local_experts"]
               + cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def old_attn_flops(cfg, pairs):
    _, h, _, hd = old_dims(cfg)
    return 4.0 * cfg["num_hidden_layers"] * h * hd * pairs


def old_prefill_flops(cfg, padded):
    return (2.0 * cfg["num_hidden_layers"] * old_layer_matmul_params(cfg)
            * padded + 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
            + old_attn_flops(cfg, flops.causal_pairs(padded)))


def old_tick_flops(cfg, active_lens):
    per_row = (cfg["num_hidden_layers"] * old_layer_matmul_params(cfg)
               + cfg["hidden_size"] * cfg["vocab_size"])
    return 2.0 * per_row * len(active_lens) + old_attn_flops(
        cfg, sum(active_lens))


def old_train_step_flops(cfg, batch, seq):
    matmul = (cfg["num_hidden_layers"] * old_layer_matmul_params(cfg)
              + cfg["hidden_size"] * cfg["vocab_size"])
    return (6.0 * matmul * batch * seq
            + 3.0 * batch * old_attn_flops(cfg, flops.causal_pairs(seq)))


def old_flash_fwd_cost(cfg, batch, seq, dtype, lse):
    _, h, kv, hd = old_dims(cfg)
    f = 4.0 * batch * h * hd * flops.causal_pairs(seq)
    nbytes = flops.ELEM[dtype] * batch * seq * hd * (2 * h + 2 * kv)
    return f, nbytes + (4 * batch * h * seq if lse else 0)


def old_flash_bwd_cost(cfg, batch, seq, dtype):
    _, h, kv, hd = old_dims(cfg)
    f = 10.0 * batch * h * hd * flops.causal_pairs(seq)
    nbytes = (flops.ELEM[dtype] * batch * seq * hd * (3 * h + 2 * kv)
              + 4 * batch * h * seq
              + flops.ELEM[dtype] * batch * seq * hd * (h + 2 * kv))
    return f, nbytes


def old_decode_cost(cfg, lens, dtype):
    _, h, kv, hd = old_dims(cfg)
    rows = sum(lens)
    nbytes = (flops.ELEM[dtype] * (2 * kv * hd * rows + 2 * len(lens) * h
                                   * hd) + 4 * len(lens))
    return 4.0 * h * hd * rows, nbytes


def old_params(cfg):
    d, h, kv, hd = old_dims(cfg)
    attn = d * hd * (2 * h + 2 * kv)
    if cfg.get("attention_bias"):
        attn += hd * (h + 2 * kv)
    if "num_local_experts" in cfg:
        e = cfg["num_local_experts"]
        ffn = d * e + e * 3 * d * cfg["intermediate_size"]
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    embed = cfg["vocab_size"] * d * (1 if cfg.get("tie_word_embeddings")
                                     else 2)
    return cfg["num_hidden_layers"] * (attn + ffn + 2 * d) + embed + d


CONFIGS = {"codeqwen1.5-7b": _config("codeqwen1.5-7b"),
           "granite-moe-1b-a400m": _config("granite-moe-1b-a400m"),
           "tiny.dense": tiny.DENSE, "tiny.moe": tiny.MOE}


def test_anchor_counts_of_the_real_configurations():
    adamw = spec.metric_reader("adamw_roofline.train")
    codeqwen, granite = (CONFIGS["codeqwen1.5-7b"],
                         CONFIGS["granite-moe-1b-a400m"])
    assert adamw.params(codeqwen) == 1_568_727_040
    assert adamw.params(granite) == 1_334_628_352
    assert flops.train_step_flops(codeqwen, 1, 4096) == 30_898_397_380_608
    assert flops.train_step_flops(granite, 1, 4096) == 13_007_987_933_184


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counts_match_the_frozen_formulas_bit_for_bit(name):
    cfg = CONFIGS[name]
    assert flops.counts(cfg)["params"] == old_params(cfg)
    for seq in (1, 64, 656, 4096):
        assert flops.prefill_flops(cfg, seq) == old_prefill_flops(cfg, seq)
        for b in (1, 2):
            assert flops.train_step_flops(cfg, b, seq) == \
                old_train_step_flops(cfg, b, seq)
        for dtype in ("float32", "bfloat16"):
            for lse in (False, True):
                assert flops.flash_fwd_cost(cfg, 1, seq, dtype, lse) == \
                    old_flash_fwd_cost(cfg, 1, seq, dtype, lse)
            assert flops.flash_bwd_cost(cfg, 2, seq, dtype) == \
                old_flash_bwd_cost(cfg, 2, seq, dtype)
    for lens in ([5], [70, 130], [1] * 32, list(range(100, 132))):
        assert flops.tick_flops(cfg, lens) == old_tick_flops(cfg, lens)
        for dtype in ("float32", "bfloat16"):
            assert flops.decode_cost(cfg, lens, dtype) == \
                old_decode_cost(cfg, lens, dtype)


# --- (b) MLA added to a temporary root by files alone -----------------------

MLA_REFERENCE = '''\
"""MiniCPM3's multi-head latent attention as the port computes it: no norm
on either latent, the rope key shared by the heads, scores scaled by
(qk_nope + qk_rope)^-0.5; then a SwiGLU feed-forward. Untied head."""
import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import model as base


def block(lw, x, cfg, prec):
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    nope, rope_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    pos = torch.arange(x.shape[1], device=x.device)
    h = base.rmsnorm(x, lw["attn_norm/scale"], eps)
    q = base.linear(base.linear(h, lw["attn/q_down/w"], prec),
                    lw["attn/q_up/w"], prec)
    q = torch.cat([q[..., :nope], base.rope(q[..., nope:], pos, theta)], -1)
    c_kv = base.linear(h, lw["attn/kv_down/w"], prec)
    k_rope = base.rope(base.linear(h, lw["attn/k_rope/w"], prec), pos,
                       theta)
    k_nope = base.linear(c_kv, lw["attn/k_up/w"], prec)
    k = torch.cat([k_nope, k_rope.expand(-1, -1, k_nope.shape[2], rope_d)],
                  -1)
    v = base.linear(c_kv, lw["attn/v_up/w"], prec)
    a = base.attention(q, k, v, prec)
    x = x + base.linear(a.reshape(a.shape[:2] + (-1,)),
                        lw["attn/o/w"].reshape(-1, x.shape[-1]), prec)
    h = base.rmsnorm(x, lw["ffn_norm/scale"], eps)
    return x + base.swiglu(h, lw["ffn/gate/w"], lw["ffn/up/w"],
                           lw["ffn/down/w"], prec)


def forward(w, cfg, tokens, prec="fp32", remat=False):
    x = w["embed/embedding"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        lw = base.layer_weights(w, i)
        x = (checkpoint(block, lw, x, cfg, prec, use_reentrant=False)
             if remat else block(lw, x, cfg, prec))
    x = base.rmsnorm(x, w["final_norm/scale"], cfg["rms_norm_eps"])
    return base.linear(x, w["unembed/w"], prec)


def loss(w, cfg, tokens, prec="fp32", remat=True):
    logits = forward(w, cfg, tokens, prec, remat)[:, :-1]
    return (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tokens[:, 1:, None])[..., 0]).mean()


def counts(cfg):
    d, h, f = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["intermediate_size"])
    ql, r = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope_d, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                        cfg["v_head_dim"])
    layer = (d * ql + ql * h * (nope + rope_d) + d * r + d * rope_d
             + r * h * (nope + vd) + h * vd * d + 3 * d * f)
    n = cfg["num_hidden_layers"]
    return {"matmul_params": n * layer,
            "params": n * (layer + 2 * d) + 2 * cfg["vocab_size"] * d + d,
            "attn_layers": n, "heads": h, "kv_heads": h,
            "qk_head_dim": nope + rope_d, "v_head_dim": vd,
            "mixer_flops": 0}
'''
MLA_KEYS = ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim")
MLA = {"arch": "minicpm3-4b", "reference": "mla", "hidden_size": 64,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 4, "intermediate_size": 96, "vocab_size": 512,
       "rope_theta": 1e4, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
       "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16,
       "port_fields": {k: f"mla.{k}" for k in MLA_KEYS},
       "serve_dtype": "float32", "train_dtype": "bfloat16",
       "init": [["embed/embedding", {"std": 0.02}],
                ["unembed/w", {"fan_in_dims": [0]}],
                ["*norm/scale", {"mean": 1.0, "std": 0.05}],
                ["layers/attn/o/w", {"fan_in_dims": [1, 2]}],
                ["layers/attn/*/w", {"fan_in_dims": [1]}],
                ["layers/ffn/*/w", {"fan_in_dims": [1]}]]}
# set as tiny.CELLS' are, from readings on the CPU (seeds 11-16): the
# program's largest grad_err 0.028, grad_gap 0.0043, change_gap 0.0016,
# loss_gap 5.0e-4; the fp8 control's least 0.30, 0.029, 0.0049, 1.9e-3;
# half the batch's 0.72, 0.067, 0.27, 7.7e-3. Serving (seeds 11-13): the
# program's logit_err at most 3.3e-6, TF32's at least 4.4e-3; a token
# altered reads a served_gap of 1.56 or more.
MLA_CELLS = {"tiny.mla.train": ("train", {"grad_err": 0.1,
                                          "loss_gap": 1.2e-3,
                                          "grad_gap": 0.012,
                                          "change_gap": 0.05}),
             "tiny.mla.serve": ("serve", {"logit_err": 1e-4,
                                          "served_gap": 0.1})}


def add_mla(root):
    """The files and entries that bring MLA into ``root``; no file of the
    harness is edited."""
    bench = root / "bench"
    (bench / "reference" / "mla.py").write_text(MLA_REFERENCE)
    (bench / "configs" / "mla.json").write_text(json.dumps(MLA))
    index = json.loads((root / "BENCHMARK.json").read_text())
    index["configs"].append({"name": "mla", "source": "tiny",
                             "file": "bench/configs/mla.json",
                             "reduced": [], "why": "CPU test"})
    for cell, (mix, limits) in MLA_CELLS.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        index["workloads"].append({"name": cell, "config": "mla",
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU test"})
        for m in index["end_to_end"] + index["per_layer"]:
            if f"tiny.{mix}" in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(index))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_mla(tiny.make_root(tmp_path_factory.mktemp("bench")))


def _run(root, name, plant=None, seed=11):
    return run_cell(spec.load_cell(name, root), seed, 1.0, False, "cpu",
                    time.perf_counter(), plant)


def test_mla_reference_is_the_ports_mla(root):
    """Logits, loss and every gradient leaf of the file's reference against
    the port's MLA decoder at fp32."""
    from repro_torch.models import transformer
    cfg = spec.load_cell("tiny.mla.train", root)["config"]
    ref = spec.reference(cfg)
    assert ref.__file__ == str(root / "bench" / "reference" / "mla.py")
    bundle = program.build(cfg)
    assert bundle.cfg.mla.qk_rope_head_dim == 8
    w = weights.make(program.param_shapes(bundle), cfg["init"], 4242, "cpu")
    tokens = torch.randint(0, 512, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    got = transformer.forward(program.nest(w), bundle.cfg, tokens,
                              dtype=torch.float32)
    assert torch.allclose(got, ref.forward(w, cfg, tokens), atol=2e-5,
                          rtol=1e-4)
    leaves = {p: t.clone().requires_grad_() for p, t in w.items()}
    got = bundle.loss_fn(program.nest(leaves), {"tokens": tokens},
                         dtype=torch.float32, remat=True)
    want = ref.loss(leaves, cfg, tokens)
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-6)
    for p, a, b in zip(leaves, torch.autograd.grad(got, list(leaves.values())),
                       torch.autograd.grad(want, list(leaves.values()))):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-4), p


@pytest.mark.parametrize("name", list(MLA_CELLS))
def test_mla_cell_added_by_files_is_correct(root, name):
    res = _run(root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and set(res["checks"]) == set(
        MLA_CELLS[name][1])


def test_mla_train_cell_with_half_its_batch_is_not_correct(root):
    assert not _run(root, "tiny.mla.train", faults.half_batch)["correct"]


# --- (c) what port_fields refuses -------------------------------------------

def _codeqwen(**keys):
    return dict(_config("codeqwen1.5-7b"), **keys)


REFUSED = {
    "no target": (_codeqwen(ssm_state_size=128), "ssm_state_size"),
    "no such field": (_codeqwen(ssm_state_size=128, port_fields={
        "ssm_state_size": "d_state"}), "has no field 'd_state'"),
    "no such field in the group": (dict(MLA, port_fields=dict(
        MLA["port_fields"], v_head_dim="mla.v_dim")),
        "has no field 'v_dim'"),
    "the group is None": (_codeqwen(ssm_state_size=128, port_fields={
        "ssm_state_size": "ssm.d_state"}), "no 'ssm' group"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_port_fields_refusals(case):
    cfg, match = REFUSED[case]
    with pytest.raises(KeyError, match=match):
        program.model_config(cfg)


def test_port_fields_set_nested_fields_and_tuples():
    run = program.model_config(dict(MLA, full_attn_layers=[0, 1],
                                    port_fields=dict(
                                        MLA["port_fields"],
                                        full_attn_layers="full_attn_layers")))
    assert run.full_attn_layers == (0, 1)
    assert [getattr(run.mla, k) for k in MLA_KEYS] == [32, 16, 16, 8, 16]
    assert run.d_model == 64 and run.n_layers == 2


# --- (d) the metrics of the MLA cell, against hand counts -------------------

# a layer's matmul parameters: q_down 64x32, q_up 32x4x24, kv_down 64x16,
# k_rope 64x8, k_up 16x4x16, v_up 16x4x16, o 4x16x64, SwiGLU 3x64x96
MLA_LAYER = 2048 + 3072 + 1024 + 512 + 2048 + 4096 + 18432
# two layers, their norms, embedding and untied head, the final norm
MLA_PARAMS = 2 * (MLA_LAYER + 128) + 2 * 512 * 64 + 64
# B = 2, S = 32: 6 x (layers + unembedding 64 x 512) x 64 tokens, and 3 x
# the forward's attention, 2 FLOPs a pair and head for each of qk 24 and
# v 16 dims, 4 heads, 2 layers, 528 causal pairs a row, 2 rows
MLA_STEP = 6 * (2 * MLA_LAYER + 64 * 512) * 64 + 3 * 2 * 2 * 2 * 4 * 40 * 528


def test_mla_train_mfu_and_adamw_roofline(root):
    cell = spec.load_cell("tiny.mla.train", root)
    cfg = cell["config"]
    assert MLA_PARAMS == 128_320 and MLA_STEP == 38_596_608
    assert MLA_PARAMS == sum(math.prod(s) for s in program.param_shapes(
        program.build(cfg)).values())
    run = {"kind": "train", "cfg": cfg, "mix": dict(cell["traffic"],
                                                    dtype="bfloat16"),
           "steps": 10, "window_s": 2.5, "launches": {"adamw": 20},
           "trace": {"window": (0, 2.5e6), "spans": [], "device": [
               (0, 40, "void adamw_sumsq_partial(NormLeaves, double*)"),
               (40, 200, "void adamw_update(UpdateLeaves, Coeffs)")]}}
    mfu = spec.metric_reader("train_mfu", root).read(run)
    assert mfu == pytest.approx(100 * MLA_STEP * 10 / 2.5 / 989e12,
                                rel=1e-12)
    share = spec.metric_reader("adamw_roofline.train", root).read(run)
    assert share == pytest.approx(
        100 * (10 * 32 * MLA_PARAMS / 3.35e12) / 200e-6, rel=1e-12)


def test_mla_kernel_costs_by_head_dims(root):
    """qk head 24 against v head 16, 4 heads and KV heads, B = 1, S = 32
    (528 causal pairs), bf16."""
    cfg = spec.load_cell("tiny.mla.train", root)["config"]
    assert flops.flash_fwd_cost(cfg, 1, 32, "bfloat16", True) == (
        2 * 4 * (24 + 16) * 528,
        2 * 32 * (4 * 24 + 4 * 24 + 4 * 16 + 4 * 16) + 4 * 4 * 32)
    # Q K^T, dQ, dK of 24; dP, dV of 16; read q, k, v, o, dO and the
    # log-sum-exp; write dQ, dK, dV
    assert flops.flash_bwd_cost(cfg, 1, 32, "bfloat16") == (
        2 * 4 * (3 * 24 + 2 * 16) * 528,
        2 * 32 * (4 * 24 + 4 * 24 + 4 * 16 + 2 * 4 * 16) + 4 * 4 * 32
        + 2 * 32 * (4 * 24 + 4 * 24 + 4 * 16))
    assert flops.decode_cost(cfg, [3, 5], "float32") == (
        2 * 4 * 40 * 8, 4 * (4 * 40 * 8 + 2 * 4 * 40) + 8)
