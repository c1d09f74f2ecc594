"""The JAX package's results at real mesh splits, for
``tests/test_torch_mesh.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_mesh_reference.py OUT_DIR

Forced host devices must be set before JAX is imported, so this runs in a
process of its own. It writes ``OUT_DIR/reference.npz``:

* for reduced granite-moe-1b-a400m and reduced llama4-scout-17b-a16e at the
  published capacity factor 1.25, one MoE layer's ``PRNGKey(1)`` weights,
  skewed rows ``x`` (B = 4, S = 16) and a cotangent ``ct``; then at each
  (data, model) mesh of ``MOE_MESHES`` the output of
  ``moe_forward_shardmap`` and ``jax.grad`` of ``sum(y * ct)`` for x and
  every weight (inside ``jax.set_mesh``, without which the gradient at more
  than one device raises); and, on one device, the output of the unsplit
  ``moe_forward_gather`` and the same gradients (``<arch>/gather/...``);
* ``compressed_psum`` inside ``shard_map`` over 2 and 4 devices, each
  device's input and result;
* for reduced qwen2-0.5b and reduced granite-moe-1b-a400m (``SPLIT_ARCHS``;
  granite at the published capacity factor 1.25, its MoE through
  ``shard_map``), ``PRNGKey(3)`` weights, a token batch and, at each mesh
  of ``SPLIT_MESHES``, the fp32 loss and every gradient leaf of the
  compiled ``jax.value_and_grad`` of the loss, its inputs placed by the
  train rules, the mean loss of its two microbatches, and one AdamW update
  (``optimizer.apply_updates`` from a fresh state) of the weights by those
  gradients: the new weights, moments and gradient norm (``split/...``);
  and for granite the loss and every gradient leaf of the same compiled
  step with ``moe_ctx=None``, GSPMD's gather path, on a batch of few
  distinct tokens, at each mesh of ``GATHER_MESHES`` (``split_gather/...``);
* for reduced qwen2-0.5b with 2 KV heads and with 1 (``SERVE_KV``),
  ``PRNGKey(4)`` weights, a prompt's prefill logits at ``max_len`` and one
  decode step's (``serve/...``); for reduced granite-moe-1b-a400m,
  ``PRNGKey(4)`` weights and a prompt's prefill logits
  (``serve/granite/...``), and at the published capacity factor 1.25
  skewed prompt tokens' prefill logits at ``max_len`` and one decode
  step's (``serve/granite125/...``);

and ``OUT_DIR/indices.json``: for every config of ``ARCH_IDS`` at full
width, every mode and every mesh of ``INDEX_MESHES``, each param and cache
leaf's spec and, per mesh coordinate, the offset and size of the block
``NamedSharding.devices_indices_map`` gives that device.
"""
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, get_config, reduced
from repro.distributed import sharding as shd
from repro.kernels import compat
from repro.models import common as cm
from repro.models import ffn, registry
from repro.training import compression
from repro.training import optimizer

MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
MOE_MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))
MOE_BATCH, MOE_SEQ = 4, 16
PSUM_RANKS = (2, 4)
PSUM_SHAPE = (3, 300)          # 900 values: three and a half blocks of 256
SPLIT_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m")
SPLIT_MESHES = ((1, 2), (2, 2))
GATHER_MESHES = SPLIT_MESHES + ((2, 1),)
SPLIT_BATCH, SPLIT_SEQ = 4, 16
SERVE_KV = {"kv_heads": 2, "kv_seq": 1}
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN = 2, 12, 16
INDEX_MESHES = {(1, 4): ("data", "model"), (2, 2): ("data", "model"),
                (4, 1): ("data", "model"),
                (2, 2, 1): ("pod", "data", "model")}
MODES = ("train", "serve", "prefill")
CACHE_BATCH, CACHE_LEN = 8, 4096


def mesh_of(shape, names=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def skewed(b, s, d, seed):
    """Rows that share one large direction, so the router favours some
    experts and, at capacity factor 1.25, overflows them."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=d) * 1.5
    return (rng.normal(size=(b, s, d)) * 0.5 + common).astype(np.float32)


def moe_config(arch):
    cfg = reduced(get_config(arch))
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=1.25))


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def moe_cases(out):
    for arch in MOE_ARCHS:
        cfg = moe_config(arch)
        p = ffn.moe_init(jax.random.PRNGKey(1), cfg)
        vals, axes = cm.values(p), cm.axes_tree(p)
        x = skewed(MOE_BATCH, MOE_SEQ, cfg.d_model, seed=5)
        ct = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
        out[f"{arch}/x"], out[f"{arch}/ct"] = x, ct
        out.update(flat(vals, f"{arch}/p"))

        def gather_loss(vals, x):
            y = ffn.moe_forward_gather(cm.zip_params(vals, axes), x, cfg)
            return jnp.sum(y * ct), y
        (_, y), (gv, gx) = jax.jit(jax.value_and_grad(
            gather_loss, argnums=(0, 1), has_aux=True))(vals, jnp.asarray(x))
        out[f"{arch}/gather/y"] = np.asarray(y)
        out[f"{arch}/gather/dx"] = np.asarray(gx)
        out.update(flat(gv, f"{arch}/gather/g"))
        for shape in MOE_MESHES:
            mesh = mesh_of(shape)

            def loss(vals, x):
                y = ffn.moe_forward_shardmap(cm.zip_params(vals, axes), x,
                                             cfg, mesh, dp_axes=("data",))
                return jnp.sum(y * ct), y
            with jax.set_mesh(mesh):
                (_, y), (gv, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(vals, jnp.asarray(x))
            key = f"{arch}/{shape[0]}x{shape[1]}"
            out[f"{key}/y"], out[f"{key}/dx"] = np.asarray(y), np.asarray(gx)
            out.update(flat(gv, f"{key}/g"))


def psum_cases(out):
    rng = np.random.default_rng(9)
    for n in PSUM_RANKS:
        mesh = mesh_of((n,), ("data",))
        xs = (rng.normal(size=(n,) + PSUM_SHAPE)
              * rng.uniform(0.1, 10, size=(n, 1, 1))).astype(np.float32)
        fn = jax.jit(compat.shard_map(
            lambda x: compression.compressed_psum(x[0], "data")[None], mesh,
            in_specs=P("data"), out_specs=P("data"), check_vma=False))
        out[f"psum{n}/x"], out[f"psum{n}/y"] = xs, np.asarray(fn(xs))


def split_config(arch):
    cfg = reduced(get_config(arch))
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=1.25))


def split_cases(out):
    for arch in SPLIT_ARCHS:
        cfg = split_config(arch)
        bundle = registry.build(cfg)
        p = bundle.init(jax.random.PRNGKey(3))
        vals, axes = cm.values(p), cm.axes_tree(p)
        out.update(flat(vals, f"split/{arch}/p"))
        toks = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (SPLIT_BATCH, SPLIT_SEQ), dtype=np.int32)
        out[f"split/{arch}/tokens"] = toks
        for shape in SPLIT_MESHES:
            mesh = mesh_of(shape)
            rules = shd.make_rules(cfg, mesh, "train")

            moe_ctx = (None if cfg.moe is None else
                       {"impl": "shardmap", "mesh": mesh,
                        "dp_axes": ("data",)})

            def loss(vals, toks):
                return bundle.loss_fn(cm.zip_params(vals, axes),
                                      {"tokens": toks}, dtype=jnp.float32,
                                      remat=True, moe_ctx=moe_ctx)
            in_sh = (shd.sharding_for_tree(p, rules, mesh),
                     shd.batch_sharding({"t": jax.ShapeDtypeStruct(
                         toks.shape, jnp.int32)}, rules, mesh)["t"])
            with jax.set_mesh(mesh), shd.activation_sharding(mesh, rules):
                lv, gv = jax.jit(jax.value_and_grad(loss),
                                 in_shardings=in_sh)(vals, jnp.asarray(toks))
            key = f"split/{arch}/{shape[0]}x{shape[1]}"
            out[f"{key}/loss"] = np.asarray(lv)
            # two microbatches, the reference's rows [0, B/2) and [B/2, B)
            half = SPLIT_BATCH // 2
            with jax.set_mesh(mesh), shd.activation_sharding(mesh, rules):
                halves = [jax.jit(loss, in_shardings=in_sh)(
                    vals, jnp.asarray(toks[i * half:(i + 1) * half]))
                    for i in range(2)]
            out[f"{key}/mb2_loss"] = np.asarray(sum(halves) / 2)
            out.update(flat(gv, f"{key}/g"))
            new_p, new_opt, metrics = optimizer.apply_updates(
                optimizer.AdamWConfig(), vals, gv,
                {"m": jax.tree.map(jnp.zeros_like, vals),
                 "v": jax.tree.map(jnp.zeros_like, vals),
                 "step": jnp.zeros((), jnp.int32)})
            out.update(flat(new_p, f"{key}/adamw/p"))
            out.update(flat(new_opt["m"], f"{key}/adamw/m"))
            out.update(flat(new_opt["v"], f"{key}/adamw/v"))
            out[f"{key}/adamw/grad_norm"] = np.asarray(metrics["grad_norm"])
        if cfg.moe is None:
            continue

        def gather_loss(vals, toks):
            return bundle.loss_fn(cm.zip_params(vals, axes),
                                  {"tokens": toks}, dtype=jnp.float32,
                                  remat=True, moe_ctx=None)
        # few distinct tokens, so that the router overflows experts
        few = np.random.default_rng(7).integers(
            0, 3, (SPLIT_BATCH, SPLIT_SEQ), dtype=np.int32)
        out[f"split_gather/{arch}/tokens"] = few
        for shape in GATHER_MESHES:
            mesh = mesh_of(shape)
            rules = shd.make_rules(cfg, mesh, "train")
            in_sh = (shd.sharding_for_tree(p, rules, mesh),
                     shd.batch_sharding({"t": jax.ShapeDtypeStruct(
                         few.shape, jnp.int32)}, rules, mesh)["t"])
            with jax.set_mesh(mesh), shd.activation_sharding(mesh, rules):
                lv, gv = jax.jit(jax.value_and_grad(gather_loss),
                                 in_shardings=in_sh)(vals, jnp.asarray(few))
            key = f"split_gather/{arch}/{shape[0]}x{shape[1]}"
            out[f"{key}/loss"] = np.asarray(lv)
            out.update(flat(gv, f"{key}/g"))


def serve_cases(out):
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    bundle = registry.build(cfg)
    p = bundle.init(jax.random.PRNGKey(4))
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    logits, _ = bundle.prefill(p, {"tokens": jnp.asarray(prompt)},
                               max_len=SERVE_MAX_LEN, dtype=jnp.float32)
    out.update(flat(cm.values(p), "serve/granite/p"))
    out["serve/granite/prompt"] = prompt
    out["serve/granite/prefill"] = np.asarray(logits)
    cfg = split_config("granite-moe-1b-a400m")
    bundle = registry.build(cfg)
    p = bundle.init(jax.random.PRNGKey(4))
    # few distinct tokens, so that the router overflows experts
    prompt = np.random.default_rng(8).integers(
        0, 3, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    token = np.random.default_rng(9).integers(
        0, 3, (SERVE_BATCH, 1), dtype=np.int32)
    logits, cache = bundle.prefill(p, {"tokens": jnp.asarray(prompt)},
                                   max_len=SERVE_MAX_LEN, dtype=jnp.float32)
    step, _ = bundle.decode_step(p, cache, jnp.asarray(token),
                                 dtype=jnp.float32)
    out.update(flat(cm.values(p), "serve/granite125/p"))
    out["serve/granite125/prompt"], out["serve/granite125/token"] = \
        prompt, token
    out["serve/granite125/prefill"] = np.asarray(logits)
    out["serve/granite125/decode"] = np.asarray(step)
    for name, kv in SERVE_KV.items():
        cfg = replace(reduced(get_config("qwen2-0.5b")), n_kv_heads=kv)
        bundle = registry.build(cfg)
        p = bundle.init(jax.random.PRNGKey(4))
        prompt = np.random.default_rng(8).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
        token = np.random.default_rng(9).integers(
            0, cfg.vocab_size, (SERVE_BATCH, 1), dtype=np.int32)
        logits, cache = bundle.prefill(p, {"tokens": jnp.asarray(prompt)},
                                       max_len=SERVE_MAX_LEN,
                                       dtype=jnp.float32)
        step, _ = bundle.decode_step(p, cache, jnp.asarray(token),
                                     dtype=jnp.float32)
        key = f"serve/{name}"
        out.update(flat(cm.values(p), f"{key}/p"))
        out[f"{key}/prompt"], out[f"{key}/token"] = prompt, token
        out[f"{key}/prefill"] = np.asarray(logits)
        out[f"{key}/decode"] = np.asarray(step)


def leaves(tree, prefix=""):
    if cm.is_param(tree):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from leaves(v, f"{prefix}/{k}" if prefix else k)


def index_cases():
    out = []
    for shape, names in INDEX_MESHES.items():
        mesh = mesh_of(shape, names)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            bundle = registry.build(cfg)
            params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
            cache = jax.eval_shape(
                lambda: bundle.init_cache(CACHE_BATCH, CACHE_LEN))
            for mode in MODES:
                rules = shd.make_rules(cfg, mesh, mode)
                for tree, kind in ((params, "params"), (cache, "cache")):
                    for name, p in leaves(tree):
                        leaf_shape = tuple(p.value.shape)
                        spec = shd.spec_for(leaf_shape, p.axes, rules, mesh)
                        idx = NamedSharding(mesh, spec).devices_indices_map(
                            leaf_shape)
                        blocks = []
                        for coord in np.ndindex(*shape):
                            sl = idx[mesh.devices[coord]]
                            blocks.append([list(coord), [
                                [s.indices(n)[0], len(range(*s.indices(n)))]
                                for s, n in zip(sl, leaf_shape)]])
                        out.append({"mesh": list(shape), "names": list(names),
                                    "arch": arch, "mode": mode,
                                    "leaf": f"{kind}/{name}",
                                    "shape": list(leaf_shape),
                                    "axes": list(p.axes),
                                    "blocks": blocks})
    return out


def main(out_dir):
    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    t0 = time.time()
    moe_cases(out)
    psum_cases(out)
    split_cases(out)
    serve_cases(out)
    np.savez(os.path.join(out_dir, "reference.npz"), **out)
    t1 = time.time()
    with open(os.path.join(out_dir, "indices.json"), "w") as f:
        json.dump(index_cases(), f)
    print(f"moe and psum {t1 - t0:.1f} s, indices {time.time() - t1:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1])
