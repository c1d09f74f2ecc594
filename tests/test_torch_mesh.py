"""The port's mesh against the JAX package's: logical axes, sharding rules,
placements, restore onto a mesh, remesh, ``compressed_psum``, the MoE
through shard_map, and the MoE's gather path split over the ranks.

The reference at a (1, 1) mesh runs in this process on its one CPU device;
at real splits it runs in a process of its own with four forced host
devices (``tests/torch_mesh_reference.py``: forced devices must be set
before JAX is imported), which writes its results to a file. The port's
side at a real split runs as 2 or 4 gloo processes on the CPU
(``tests/torch_mesh_workers.py``); at one rank, in this process over a
one-rank group (gloo, and NCCL for CUDA tensors when there is a card).

Tolerances, each with its reason:

* axes, rules, specs, placements' blocks, checkpoint values and manifests,
  remesh: equal;
* ``compressed_psum``: bit-equal (the same fp32 operations on the same
  integers and scales);
* the shard_map MoE in fp32 (one layer, outputs ~1): the output within
  1e-5; every gradient within 1e-5 of its largest |value| (the port and
  XLA sum the experts' products, the scatter and the psum in other
  orders);
* reduced granite's loss with ``moe_ctx`` (two layers): 1e-5 relative;
  every gradient leaf within 1e-4 of its largest |value|, as
  ``tests/test_torch_train.py`` holds the gather path;
* the split gather path against the reference's unsplit
  ``moe_forward_gather``: as the shard_map MoE (one layer), and as
  reduced granite's loss (the train step); the served logits within 1e-4
  of their largest |value|. At one rank on a mesh it gives the unplaced
  gather path's step bit for bit (the same operations on the same slots).

The MoE cases run at the published capacity factor 1.25 with skewed rows,
so that experts overflow: at one model rank the shard_map path's local
capacity is twice the gather path's, and at four half of it; the gather
path's capacity is global, so where the tokens are split the two paths
drop different assignments.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.distributed.tensor._utils import (  # noqa: E402
    _compute_local_shape_and_global_offset as local_block)

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import train_loop as jtrain_loop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import elastic  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import ffn, registry  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from torch_parity import (flatten_params, model_pair,  # noqa: E402
                          random_tokens, time_limit, to_torch)
import torch_mesh_workers as workers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("train", "serve", "prefill")
MOE_MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))


class FakeMesh:
    """A mesh by name and size, as the reference's own test fakes one."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


FAKE_MESHES = {"1x1": FakeMesh({"data": 1, "model": 1}),
               "16x16": FakeMesh({"data": 16, "model": 16}),
               "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def jparam_trees(arch):
    """The reference's full-width params and cache as ShapeDtypeStruct
    Param trees (nothing allocated)."""
    jb = jregistry.build(jget_config(arch))
    return (jax.eval_shape(jb.init, jax.random.PRNGKey(0)),
            jax.eval_shape(lambda: jb.init_cache(8, 4096)))


def param_leaves(tree, prefix=""):
    if jcm.is_param(tree):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from param_leaves(v, f"{prefix}/{k}" if prefix else k)


def axes_of(tree):
    return jax.tree.map(lambda p: tuple(p.axes), tree, is_leaf=jcm.is_param)


def at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Fixtures: the reference at forced devices, the port's ranks, one rank here
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tests", "torch_mesh_reference.py"),
                    str(out)], env=env, check=True, timeout=240)
    return str(out)


@pytest.fixture(scope="module")
def ref(ref_dir):
    return np.load(os.path.join(ref_dir, "reference.npz"))


@pytest.fixture(scope="module")
def ranks2(ref_dir, tmp_path_factory):
    return workers.run_ranks("ranks2", 2,
                             str(tmp_path_factory.mktemp("ranks2")), ref_dir)


@pytest.fixture(scope="module")
def ranks4(ref_dir, tmp_path_factory):
    return workers.run_ranks("ranks4", 4,
                             str(tmp_path_factory.mktemp("ranks4")), ref_dir)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank process group in this process: gloo for CPU tensors and,
    where there is a card, NCCL for CUDA tensors."""
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    store = dist.FileStore(str(tmp_path_factory.mktemp("group") / "store"),
                           1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh(group):
    return mesh_mod.make_host_mesh(device="cpu")


@pytest.fixture(autouse=True)
def limit():
    """Every test under ``time_limit`` (the module's fixtures, which start
    processes, carry timeouts of their own)."""
    with time_limit(120):
        yield


# ---------------------------------------------------------------------------
# Logical axes and rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_reference(arch):
    jparams, jcache = jparam_trees(arch)
    bundle = registry.build(get_config(arch))
    assert bundle.param_axes() == axes_of(jparams)
    assert bundle.cache_axes(8, 4096) == axes_of(jcache)


def test_int8_and_per_slot_cache_axes_equal_reference():
    for arch in ("qwen2-0.5b", "hymba-1.5b", "minicpm3-4b"):
        jb = jregistry.build(jget_config(arch))
        bundle = registry.build(get_config(arch))
        for jkw, kw in (({"kv_dtype": jnp.int8}, {"kv_dtype": torch.int8}),
                        ({"per_slot_pos": True}, {"per_slot_pos": True})):
            want = axes_of(jax.eval_shape(lambda: jb.init_cache(4, 64,
                                                                **jkw)))
            assert bundle.cache_axes(4, 64, **kw) == want, (arch, kw)


def test_convert_keeps_the_reference_axes():
    """``convert.axes_from_numpy`` keeps the Params' axes, which are the
    port's own ``param_axes`` tree."""
    jcfg, _, jparams, cfg, bundle, _ = model_pair("granite-moe-1b-a400m")
    assert convert.axes_from_numpy(flatten_params(jparams)) == \
        bundle.param_axes() == axes_of(jparams)


@pytest.mark.parametrize("mesh_name", sorted(FAKE_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_rules_equal_reference(arch, mesh_name):
    fake = FAKE_MESHES[mesh_name]
    for mode in MODES:
        want = jshd.make_rules(jget_config(arch), fake, mode)
        assert shd.make_rules(get_config(arch), fake, mode) == want, mode
    over = {"embed": None, "batch": "data"}
    assert shd.make_rules(get_config(arch), fake, "train", over) == \
        jshd.make_rules(jget_config(arch), fake, "train", over)


@pytest.mark.parametrize("mesh_name", sorted(FAKE_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equal_reference(arch, mesh_name):
    """On every param and cache leaf at full width, every mode."""
    fake = FAKE_MESHES[mesh_name]
    jparams, jcache = jparam_trees(arch)
    for mode in MODES:
        rules = shd.make_rules(get_config(arch), fake, mode)
        for tree in (jparams, jcache):
            for name, p in param_leaves(tree):
                shape = tuple(p.value.shape)
                want = tuple(jshd.spec_for(shape, p.axes, rules, fake))
                assert shd.spec_for(shape, p.axes, rules, fake) == want, \
                    (mode, name)


def test_spec_fallback_for_indivisible_dims():
    """The reference's three cases (``tests/test_training_infra.py``)."""
    fake = FAKE_MESHES["16x16"]
    rules = {"heads": "model", "embed": "data", "vocab": "model"}
    assert shd.spec_for((14, 64), ("heads", None), rules, fake) == \
        (None, None)
    assert shd.spec_for((32, 64), ("heads", None), rules, fake) == \
        ("model", None)
    assert shd.spec_for((32, 32), ("heads", "vocab"), rules, fake) == \
        ("model", None)


@pytest.fixture(scope="module")
def indices(ref_dir):
    with open(os.path.join(ref_dir, "indices.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh_shape", ["1x4", "2x2", "4x1", "2x2x1"])
def test_placements_give_each_rank_jax_block(indices, mesh_shape):
    """Each leaf's block on every rank, from the port's spec and placements,
    is the block ``devices_indices_map`` gives that device: every param and
    cache leaf of every config at full width, every mode, at forced
    4-device meshes; the pod mesh shards the batch over ("pod", "data")."""
    shape = tuple(int(n) for n in mesh_shape.split("x"))
    cases = [c for c in indices if tuple(c["mesh"]) == shape]
    assert len(cases) > 500
    tuple_dims = 0
    for c in cases:
        fake = FakeMesh(dict(zip(c["names"], shape)))
        cfg = get_config(c["arch"])
        spec = shd.spec_for(c["shape"], c["axes"],
                            shd.make_rules(cfg, fake, c["mode"]), fake)
        pl = shd.placements(spec, fake)
        tuple_dims += any(isinstance(e, tuple) for e in spec)
        for coord, block in c["blocks"]:
            size, offset = local_block(c["shape"], shape, coord, pl)
            assert [list(b) for b in zip(offset, size)] == block, \
                (c["arch"], c["mode"], c["leaf"], coord)
    assert tuple_dims > 0 if len(shape) == 3 else True


def test_placements_refuse_axes_out_of_mesh_order():
    fake = FAKE_MESHES["2x16x16"]
    assert shd.placements((("pod", "data"), "model"), fake) == \
        (Shard(0), Shard(0), Shard(1))
    assert shd.placements((None, None), fake) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        shd.placements((("data", "pod"),), fake)


def test_batch_sharding_and_replicated():
    """A batch's dim 0 over the data axes (both pods' on the two-pod mesh),
    the rest replicated; a batch that does not divide stays whole."""
    fake = FAKE_MESHES["2x16x16"]
    rules = shd.make_rules(get_config("qwen2-0.5b"), fake, "train")
    out = shd.batch_sharding({"tokens": (64, 512), "odd": torch.zeros(3, 2),
                              "prefix_embeds": (32, 256, 8)}, rules, fake)
    assert out["tokens"].spec == (("pod", "data"), None)
    assert out["tokens"].placements == (Shard(0), Shard(0), Replicate())
    assert out["prefix_embeds"].spec == (("pod", "data"), None, None)
    assert out["odd"].spec == (None, None)
    assert shd.replicated(fake).placements == (Replicate(),) * 3
    assert shd.dp_axes(FAKE_MESHES["16x16"]) == ("data",)


def test_plan_remesh_factorings():
    """The reference's cases (``tests/test_checkpoint.py``)."""
    assert elastic.plan_remesh(512) == (32, 16)
    assert elastic.plan_remesh(256) == (16, 16)
    assert elastic.plan_remesh(48) == (3, 16)
    assert elastic.plan_remesh(24) == (3, 8)
    assert elastic.plan_remesh(512, model_parallel=8) == (64, 8)
    with pytest.raises(ValueError):
        elastic.plan_remesh(10, model_parallel=4)


def test_production_meshes_over_fake_groups(tmp_path):
    """16 x 16 and 2 x 16 x 16 over fake process groups of 256 and 512
    ranks; the batch of the two-pod mesh over ("pod", "data"). Without a
    process group a mesh raises."""
    (out,) = workers.run_ranks("production", 1, str(tmp_path))
    assert "init_process_group" in out["no_group"]
    assert out[256][:3] == ((16, 16), ("data", "model"), ("data",))
    assert out[512][:3] == ((2, 16, 16), ("pod", "data", "model"),
                            ("pod", "data"))
    assert out[512][3] == (Shard(0), Shard(0), Replicate())


def test_mesh_entry_points_default_to_cuda():
    import inspect
    for fn in (mesh_mod.make_host_mesh, mesh_mod.make_production_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# One rank here: placement, restore, the train step, constrain
# ---------------------------------------------------------------------------

def test_host_mesh_and_placement(mesh):
    assert tuple(mesh.shape) == (1, 1)
    assert shd.dp_axes(mesh) == ("data",)
    with pytest.raises(ValueError, match="divide"):
        mesh_mod.make_host_mesh(model=2, device="cpu")
    bundle = registry.build(workers.moe_config("granite-moe-1b-a400m"))
    params = bundle.init(generator=torch.Generator().manual_seed(0),
                         device="cpu")
    rules = shd.make_rules(bundle.cfg, mesh, "train")
    placed = shd.place(params, shd.sharding_for_tree(
        params, bundle.param_axes(), rules, mesh))
    w = placed["layers"]["ffn"]["gate"]["w"]
    # ("layer", "expert", "embed", "mlp"): expert over model, embed over data
    assert isinstance(w, DTensor) and w.placements == (Shard(2), Shard(1))
    for a, b in zip(opt_mod.leaves(placed), opt_mod.leaves(params)):
        assert torch.equal(a.to_local(), b)


def test_restore_onto_a_mesh(mesh, tmp_path):
    """The elastic path at a (1, 1) mesh: the port's save writes the axes
    into the manifest, and restore places every leaf with axes by the
    rules; the values are the saved ones."""
    bundle, state, axes = workers.tiny_state()
    ck.save(str(tmp_path), 3, state, axes=axes)
    rules = {"embed": "data", "mlp": "model"}
    step, got = ck.restore(str(tmp_path), mesh=mesh, rules=rules)
    assert step == 3
    w = got["params"]["layers"]["ffn"]["up"]["w"]
    assert isinstance(w, DTensor) and w.device_mesh == mesh
    assert w.placements == (Shard(2), Shard(3))
    assert not isinstance(got["opt"]["step"], DTensor)
    for a, b in zip(opt_mod.leaves(got), opt_mod.leaves(state)):
        a = a.full_tensor() if isinstance(a, DTensor) else a
        assert torch.equal(a, b.detach())
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["opt/m/layers/ffn/up/w"]["axes"] == \
        ["layer", "expert", "embed", "mlp"]
    assert leaves["opt/step"]["axes"] is None


def test_reference_checkpoint_restores_onto_the_port_mesh(mesh, tmp_path):
    """A train state saved by ``repro`` is restored by the port onto the
    (1, 1) mesh with the train rules: every value equal; and the port's
    save of the same state writes the reference manifest's axes."""
    jcfg = jget_config("granite-moe-1b-a400m")
    from repro.configs import reduced as jreduced
    jb = jregistry.build(jreduced(jcfg))
    jstate = jtrain_loop.init_train_state(jb, jax.random.PRNGKey(0))
    jck.save(str(tmp_path / "ref"), 2, jstate)
    bundle = registry.build(workers.moe_config("granite-moe-1b-a400m"))
    rules = shd.make_rules(bundle.cfg, mesh, "train")
    step, got = ck.restore(str(tmp_path / "ref"), mesh=mesh, rules=rules)
    assert step == 2
    flat = flatten_params(jstate["params"])
    for name, (arr, _) in flat.items():
        leaf = at(got["params"], name)
        assert isinstance(leaf, DTensor)
        np.testing.assert_array_equal(leaf.full_tensor().numpy(), arr)
    state = {"params": convert.params_from_numpy(flat, device="cpu")}
    state["opt"] = opt_mod.init_state(state["params"])
    ck.save(str(tmp_path / "port"), 2, state,
            axes=train_loop.state_axes(bundle.param_axes()))
    manifests = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_00000002" / "manifest.json") as f:
            manifests.append({k: (v["axes"], v["shape"], v["dtype"])
                              for k, v in json.load(f)["leaves"].items()})
    assert manifests[0] == manifests[1]


def test_train_step_on_a_one_rank_mesh(mesh):
    """The step on the state placed by the train rules, through the
    shard_map MoE, gives the unplaced gather-path step's new state bit for
    bit at the reduced capacity factor (which drops nothing, and the local
    capacity only adds empty slots); the new state stays placed as the old
    one. The collectives per step: per MoE layer one all-reduce forward
    and two backward over model, four backward over data."""
    from repro_torch.configs import reduced
    bundle = registry.build(reduced(get_config("granite-moe-1b-a400m")))
    state = train_loop.init_train_state(
        bundle, torch.Generator().manual_seed(0), device="cpu")
    axes = train_loop.state_axes(bundle.param_axes())
    rules = shd.make_rules(bundle.cfg, mesh, "train")
    placed = shd.place(state, shd.sharding_for_tree(state, axes, rules,
                                                     mesh))
    ctx = {"impl": "shardmap", "mesh": mesh, "dp_axes": shd.dp_axes(mesh)}
    batch = {"tokens": torch.as_tensor(random_tokens(2, 32, seed=3))}
    shd.reset_collective_counts()
    new, metrics = train_loop.make_train_step(
        bundle, opt_mod.AdamWConfig(), moe_ctx=ctx)(placed, batch)
    counts = shd.collective_counts()
    want, want_metrics = train_loop.make_train_step(
        bundle, opt_mod.AdamWConfig())(state, batch)
    assert float(metrics["loss"]) == float(want_metrics["loss"])
    layers = bundle.cfg.n_layers
    assert counts == {"model": 3 * layers, "data": 4 * layers}
    for a, b, p in zip(opt_mod.leaves(new), opt_mod.leaves(want),
                       opt_mod.leaves(placed)):
        assert isinstance(a, DTensor) and a.placements == p.placements
        assert torch.equal(a.to_local(), b.detach())


def test_loss_and_grads_on_one_rank_leaves_run_the_split_gather_path(mesh):
    """Reduced granite at the published capacity factor 1.25, its params
    placed by the train rules on the one-rank mesh, with no ``moe_ctx``:
    the loss and every gradient on the DTensor leaves under
    ``activation_sharding`` (each MoE layer through
    ``ffn.moe_forward_gather_split`` on its blocks, as a split mesh runs
    it) equal the unplaced gather path's bit for bit, where assignments
    drop. The collectives of the MoE layers, per layer under remat: over
    data, the counts table's and the products' all-gathers in the forward
    and its recompute and the slots' two in the backward (6), the slots'
    and their weights' reduce-scatters in both forwards and the products'
    in the backward (5), and the all-reduces of the router's and the
    three stacks' gradients (4); over model, the output's sum and the
    partial gradients of x and the router (3)."""
    from dataclasses import replace
    from repro_torch.configs import reduced
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    bundle = registry.build(replace(cfg, moe=replace(cfg.moe,
                                                     capacity_factor=1.25)))
    params = train_loop.init_train_state(
        bundle, torch.Generator().manual_seed(0), device="cpu")["params"]
    rules = shd.make_rules(bundle.cfg, mesh, "train")
    placed = shd.place(params, shd.sharding_for_tree(
        params, bundle.param_axes(), rules, mesh))
    toks = torch.as_tensor(random_tokens(2, 32, seed=3))
    batch = shd.place({"tokens": toks},
                      shd.batch_sharding({"tokens": toks}, rules, mesh))
    for p in opt_mod.leaves(placed):
        p.requires_grad_(True)
    drops = [0]
    dispatch = workers.count_drops(ffn, drops)
    shd.reset_collective_counts()
    try:
        with shd.activation_sharding(mesh, rules):
            loss = bundle.loss_fn(placed, batch, remat=True)
            grads = train_loop.reduce_grads(
                train_loop.grad_tree(loss, placed), placed)
    finally:
        ffn.dispatch = dispatch
    counts = shd.collective_counts()
    want = bundle.loss_fn(params, {"tokens": toks}, remat=True)
    want_grads = train_loop.grad_tree(want, params)
    assert drops[0] > 0
    assert isinstance(loss, DTensor)
    assert torch.equal(loss.to_local(), want.detach())
    layers = bundle.cfg.n_layers
    assert counts == {"all_gather:data": 6 * layers,
                      "reduce_scatter:data": 5 * layers,
                      "model": 3 * layers, "data": 4 * layers}
    for a, b, p in zip(opt_mod.leaves(grads), opt_mod.leaves(want_grads),
                       opt_mod.leaves(placed)):
        assert isinstance(a, DTensor) and a.placements == p.placements
        assert torch.equal(a.to_local(), b)


def test_constrain_is_identity_outside_its_context(mesh):
    x = torch.randn(4, 6)
    assert shd.constrain(x, ("batch", None)) is x
    rules = {"batch": "data", "vocab": None}
    with shd.activation_sharding(mesh, rules):
        y = shd.constrain(x, ("batch", None))
        assert isinstance(y, DTensor) and y.placements == (Shard(0),
                                                           Replicate())
        assert torch.equal(y.full_tensor(), x)
        assert shd.constrain_if(x, (None, "vocab"), "vocab") is x
        z = shd.constrain(y, (None, "batch"))
        assert z.placements == (Shard(1), Replicate())
    assert shd.constrain(x, ("batch", None)) is x


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------

def test_compressed_psum_over_one_rank_is_compress_decompress(mesh):
    rng = np.random.default_rng(2)
    for shape in ((3, 257), (300,), (5, 4, 64)):
        x = to_torch(rng.normal(size=shape).astype(np.float32))
        got = compression.compressed_psum(x, mesh.get_group("data"))
        assert torch.equal(got, compression.compress_decompress(x))


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_bit_equal_to_reference(ref, ranks2, ranks4, world):
    """Every rank's result is the reference's inside shard_map."""
    outs = {2: ranks2, 4: ranks4}[world]
    want = ref[f"psum{world}/y"]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["psum"], want[r])


def test_compressed_psum_scales_by_the_mean_of_scales(ref, ranks2):
    """The reference's quirk, kept: the summed integers times the *mean*
    of the ranks' scales, not the sum of each rank's dequantized values."""
    xs = [to_torch(x) for x in ref["psum2/x"]]
    quants = [compression._quant(x) for x in xs]
    qsum = sum(q.to(torch.int32) for q, _ in quants)
    mean_scale = (quants[0][1] + quants[1][1]) / 2.0
    quirk = (qsum.float() * mean_scale).reshape(-1)[:xs[0].numel()]
    np.testing.assert_array_equal(ranks2[0]["psum"],
                                  quirk.reshape(xs[0].shape).numpy())
    dequantized_sum = sum(compression.compress_decompress(x) for x in xs)
    assert np.abs(ranks2[0]["psum"] - dequantized_sum.numpy()).max() > 0.1


# ---------------------------------------------------------------------------
# The MoE through shard_map
# ---------------------------------------------------------------------------

def moe_expected_counts(arch, shape):
    """All-reduces of one forward and backward: model: the output's sum
    and the partial gradients of x and the router, and where the expert
    stacks are split, their three gradients gathered; data: the router's,
    the experts' and the shared expert's gradients."""
    moe = workers.moe_config(arch).moe
    model = 3 + (3 if shape[1] > 1 else 0)
    data = 1 + 3 + (3 if moe.shared_expert_ff else 0)
    return {"model": model, "data": data}


# Top-1 routing renormalises the one weight to 1, so the router's gradient
# is zero in exact arithmetic and both sides hold rounding noise there
# (~2e-6 against gradients of ~1): it is held to be zero on both sides,
# within 1e-5 of the case's largest gradient.
ZERO_LEAVES = {"llama4-scout-17b-a16e": {"router/w"}}


def check_moe(ref, arch, shape, out):
    key = f"{arch}/{shape[0]}x{shape[1]}"
    lo, hi = out["rows"]
    np.testing.assert_allclose(out["y"], ref[f"{key}/y"][lo:hi], atol=1e-5,
                               rtol=0)
    grads = {"dx": (out["dx"], ref[f"{key}/dx"][lo:hi])}
    for name in (k[2:] for k in out if k.startswith("g/")):
        grads[name] = (out[f"g/{name}"], ref[f"{key}/g/{name}"])
    assert {"router/w", "gate/w", "up/w", "down/w"} <= set(grads)
    top = max(np.abs(w).max() for _, w in grads.values())
    for name, (got, want) in grads.items():
        assert got.shape == want.shape, name
        if name in ZERO_LEAVES.get(arch, ()):
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-5 * top
            continue
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-5 * scale, (key, name)
    assert out["counts"] == moe_expected_counts(arch, shape)


def moe_results(mesh_shape, ref_dir, ranks2, ranks4, mesh_1x1):
    if mesh_shape == (1, 1):
        ref = np.load(os.path.join(ref_dir, "reference.npz"))
        return [{a: workers.moe_case(ref, a, mesh_1x1)
                 for a in workers.MOE_ARCHS}]
    if mesh_shape == (1, 2):
        return [r["moe"] for r in ranks2]
    return [r["moe_1x4" if mesh_shape == (1, 4) else "moe_2x2"]
            for r in ranks4]


@pytest.mark.parametrize("mesh_shape", MOE_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", workers.MOE_ARCHS)
def test_moe_shardmap_matches_reference(ref, ref_dir, ranks2, ranks4, mesh,
                                        arch, mesh_shape):
    """Forward and every gradient (x, router, experts, shared) on every
    rank."""
    outs = moe_results(mesh_shape, ref_dir, ranks2, ranks4, mesh)
    for out in outs:
        check_moe(ref, arch, mesh_shape, out[arch])


def test_moe_shardmap_drops_at_production_capacity(ranks4):
    """At four model ranks the local capacity is half the gather path's,
    and the skewed rows overflow experts on both configs."""
    for arch in workers.MOE_ARCHS:
        assert sum(r["moe_1x4"][(arch, "dropped")] for r in ranks4) > 0


def test_moe_shardmap_refuses_a_stack_it_cannot_place(mesh):
    """Expert weights that are not the whole stack raise; nothing computes
    on what is there."""
    cfg = workers.moe_config("granite-moe-1b-a400m")
    p = {"router": {"w": torch.zeros(64, 4)},
         **{n: {"w": torch.zeros(2, 64, 64)} for n in ("gate", "up",
                                                      "down")}}
    with pytest.raises(ValueError, match="not the stack"):
        ffn.moe_forward_shardmap(p, torch.zeros(1, 2, 64), cfg, mesh)


def test_loss_and_grads_with_moe_ctx_match_jax(mesh):
    """Reduced granite's loss and every gradient leaf through the shard_map
    MoE at the (1, 1) mesh, against ``jax.value_and_grad`` of the
    reference's loss with its shard_map MoE on its (1, 1) mesh."""
    jcfg, jbundle, jparams, cfg, bundle, params = model_pair(
        "granite-moe-1b-a400m")
    toks = random_tokens(2, 24, seed=4)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jctx = {"impl": "shardmap", "mesh": jmesh, "dp_axes": ("data",)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jbundle.loss_fn(p, {"tokens": jnp.asarray(toks)},
                                  dtype=jnp.float32, remat=True,
                                  moe_ctx=jctx))(jparams)
    for p in opt_mod.leaves(params):
        p.requires_grad_(True)
    ctx = {"impl": "shardmap", "mesh": mesh, "dp_axes": ("data",)}
    loss = bundle.loss_fn(params, {"tokens": to_torch(toks).long()},
                          dtype=torch.float32, remat=True, moe_ctx=ctx)
    grads = train_loop.grad_tree(loss, params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, (want, _) in flatten_params(jgrads).items():
        got = at(grads, name).numpy()
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-4 * scale, name


def test_moe_gather_split_refuses_a_stack_it_cannot_place(mesh):
    """As the shard_map path: expert weights that are not the whole stack
    or its block raise, and so do experts that do not divide over the
    expert axis."""
    cfg = workers.moe_config("granite-moe-1b-a400m")
    p = {"router": {"w": torch.zeros(64, 4)},
         **{n: {"w": torch.zeros(2, 64, 64)} for n in ("gate", "up",
                                                      "down")}}
    with pytest.raises(ValueError, match="not the stack"):
        ffn.moe_forward_gather_split(p, torch.zeros(1, 2, 64), cfg, mesh)
    odd = workers.replace(cfg, moe=workers.replace(cfg.moe, num_experts=3))
    with pytest.raises(ValueError, match="do not divide"):
        ffn.moe_forward_gather_split(p, torch.zeros(1, 2, 64), odd,
                                     FakeMeshRanks({"data": 1, "model": 2}))


class FakeMeshRanks(FakeMesh):
    """A ``FakeMesh`` that answers the local rank (0) on every axis."""

    def get_local_rank(self, axis):
        return 0


GATHER_CASES = (((1, 2), "train"), ((2, 2), "train"), ((2, 1), "train"),
                ((1, 2), "prefill"), ((2, 2), "prefill"))


def gather_results(mesh_shape, ranks2, ranks4, key):
    """Each rank's result ``key`` of the job at ``mesh_shape``: (1, 2) and
    (2, 1) on the two ranks, (2, 2) on the four."""
    if mesh_shape == (2, 1):
        return [r[f"{key}_2x1"] for r in ranks2]
    return [r[key] for r in (ranks2 if mesh_shape == (1, 2) else ranks4)]


def gather_expected_counts(mode):
    """The collectives of one forward and backward of a layer through the
    split gather path, where the tokens are split over ``t`` and the
    experts over ``e`` (train: data and model; the ZeRO-3 prefill: model
    and data): over ``t`` the counts table's and the products' all-gathers
    forward and the slots' and their weights' backward, the slots' and
    their weights' reduce-scatters forward and the products' backward, and
    the all-reduces of the router's and the three stacks' gradients; over
    ``e`` the output's sum and the partial gradients of x and the router.
    The shared expert runs on DTensors, whose collectives these do not
    count."""
    t, e = ("data", "model") if mode == "train" else ("model", "data")
    return {f"all_gather:{t}": 4, f"reduce_scatter:{t}": 3, t: 4, e: 3}


@pytest.mark.parametrize("mesh_shape,mode", GATHER_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("arch", workers.MOE_ARCHS)
def test_moe_gather_split_matches_reference(ref, ranks2, ranks4, arch,
                                            mesh_shape, mode):
    """One MoE layer placed by the train rules (the batch over data, the
    experts over model) or the ZeRO-3 prefill rules (the sequence over
    model, the experts over data) as gloo ranks, on DTensors with no
    ``moe_ctx``, against the reference's unsplit ``moe_forward_gather`` of
    the whole input at capacity factor 1.25 with skewed rows, which drop
    assignments: the output and every gradient on every rank (the shard_map
    MoE's tolerances), and the collectives. The shard_map path on the same
    blocks computes another function wherever the tokens are split
    (its capacity is local: at (2, 1) each data rank's half of the tokens
    gets its own), so on a tree that runs it for every split layer these
    cases fail; at (1, 2) under the train rules every rank holds every
    token and its local capacity, C // 2 * 2, is C: there the two
    agree."""
    for outs in gather_results(mesh_shape, ranks2, ranks4, "gather"):
        out = outs[(arch, mode)]
        assert out["dropped"] > 0
        assert "Shard" in out["x_placements"]
        stack = "Shard(dim=0), Replicate()" if mode == "prefill" \
            else "Shard(dim=1), Shard(dim=0)"
        assert out["stack_placements"] == f"({stack})"
        want = ref[f"{arch}/gather/y"]
        np.testing.assert_allclose(out["y"], want, atol=1e-5, rtol=0)
        grads = {"dx": (out["dx"], ref[f"{arch}/gather/dx"])}
        for name in (k[2:] for k in out if k.startswith("g/")):
            grads[name] = (out[f"g/{name}"], ref[f"{arch}/gather/g/{name}"])
        assert {"router/w", "gate/w", "up/w", "down/w"} <= set(grads)
        top = max(np.abs(w).max() for _, w in grads.values())
        for name, (got, w) in grads.items():
            assert got.shape == w.shape, name
            if name in ZERO_LEAVES.get(arch, ()):
                assert max(np.abs(got).max(), np.abs(w).max()) <= 1e-5 * top
                continue
            assert close(got, w, 1e-5), name
        assert out["counts"] == gather_expected_counts(mode)
        shardmap_err = np.abs(out["y_shardmap"] - want).max()
        if mesh_shape == (1, 2) and mode == "train":
            assert shardmap_err <= 1e-5
        else:
            assert shardmap_err > 1e-2


SPLIT_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m")


def close(got, want, tol):
    """Every value within ``tol`` of the largest |value| of ``want``."""
    scale = max(np.abs(want).max(), 1e-30)
    return np.abs(got - want).max() <= tol * scale


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
@pytest.mark.parametrize("mesh_shape", ((1, 2), (2, 2)))
def test_train_step_on_split_leaves_matches_reference(ref, ranks2, ranks4,
                                                      arch, mesh_shape):
    """Reduced qwen2 and granite (its MoE at capacity factor 1.25 through
    shard_map on both sides, ``moe_ctx`` asking for it) with their state
    placed by the train rules at
    (1, 2) and (2, 2) (heads, experts, the vocab and the MLP split over
    model; the embed dim over data), as gloo ranks, against the reference's
    compiled step at the same mesh:

    * the loss (1e-5 relative) and every gradient leaf, gathered whole
      (within 1e-4 of its largest |value|, as the shard_map MoE's);
    * AdamW on the split weights given the reference's gradients: the
      gradient norm (1e-6 relative), the step, every new weight and moment
      within 1e-6 of its largest |value| (the same fp32 operations on the
      same inputs, summed in another order), and every update (new weight
      less old) within 1e-2 of its largest |value| (the first step's
      update is lr * ~1 = 3e-6, and one fp32 rounding of a weight of ~0.5
      is 3e-8);
    * the whole train step on the split state: its loss, its new leaves
      finite and placed as the old ones, its step, and its moments, whose
      gradients are the port's (m within 1e-4 of its largest |value|, as
      the gradients; v, quadratic in them, within 2e-4);
    * two microbatches give the reference's two microbatches' loss (1e-5);
      a count that does not split the batch, or its microbatch over the
      data ranks, raises (the reference's reshape raises on the first).

    At (2, 2) granite's MoE drops assignments (data rank 1's block), so its
    local capacity is held to the reference's."""
    ranks = ranks2 if mesh_shape == (1, 2) else ranks4
    key = f"split/{arch}/{mesh_shape[0]}x{mesh_shape[1]}"
    want_loss = float(ref[f"{key}/loss"])
    if arch != "qwen2-0.5b" and mesh_shape == (2, 2):
        assert sum(r["split"][arch]["dropped"] for r in ranks) > 0
    for r in ranks:
        got = r["split"][arch]
        assert got["split_leaves"] > 0
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        names = [k[len(f"{key}/g/"):] for k in ref.files
                 if k.startswith(f"{key}/g/")]
        assert len(names) == sum(k.startswith("g/") for k in got)
        for leaf in names:
            assert close(got[f"g/{leaf}"], ref[f"{key}/g/{leaf}"], 1e-4), \
                leaf
        want_norm = float(ref[f"{key}/adamw/grad_norm"])
        assert abs(got["given/grad_norm"] - want_norm) <= 1e-6 * want_norm
        assert got["given/step"] == got["step/step"] == 1
        for leaf in names:
            old = ref[f"split/{arch}/p/{leaf}"]
            new = ref[f"{key}/adamw/p/{leaf}"]
            assert close(got[f"given/p/{leaf}"], new, 1e-6), leaf
            assert close(got[f"given/p/{leaf}"] - old, new - old, 1e-2), \
                leaf
            for part, tol in (("m", 1e-6), ("v", 1e-6)):
                want = ref[f"{key}/adamw/{part}/{leaf}"]
                assert close(got[f"given/{part}/{leaf}"], want, tol), \
                    (part, leaf)
            for part, tol in (("m", 1e-4), ("v", 2e-4)):
                want = ref[f"{key}/adamw/{part}/{leaf}"]
                assert close(got[f"step/{part}/{leaf}"], want, tol), \
                    (part, leaf)
        assert abs(got["step_loss"] - want_loss) <= 1e-5 * abs(want_loss)
        assert got["step_placements_kept"] and got["step_finite"]
        want_mb = float(ref[f"{key}/mb2_loss"])
        assert abs(got["microbatched_loss"] - want_mb) <= 1e-5 * abs(want_mb)
        bad = (3, 4) if mesh_shape[0] > 1 else (3,)
        assert sorted(got["microbatch_errors"]) == list(bad)
        for msg in got["microbatch_errors"].values():
            assert "does not split" in msg


@pytest.mark.parametrize("mesh_shape", ((1, 2), (2, 2), (2, 1)))
def test_train_step_on_split_leaves_under_gather_matches_reference(
        ref, ranks2, ranks4, mesh_shape):
    """Reduced granite at capacity factor 1.25 with its state placed by
    the train rules at (1, 2), (2, 2) and (2, 1) as gloo ranks, with no
    ``moe_ctx`` (each MoE layer through the split gather path), against
    the reference's compiled step at the same mesh with ``moe_ctx=None``
    (GSPMD's gather path): the loss (1e-5 relative) and every gradient
    leaf, gathered whole (within 1e-4 of its largest |value|); the train
    step's loss (1e-5). Its layers drop assignments past the global
    capacity."""
    outs = gather_results(mesh_shape, ranks2, ranks4, "split_gather")
    arch = "granite-moe-1b-a400m"
    key = f"split_gather/{arch}/{mesh_shape[0]}x{mesh_shape[1]}"
    want_loss = float(ref[f"{key}/loss"])
    names = [k[len(f"{key}/g/"):] for k in ref.files
             if k.startswith(f"{key}/g/")]
    assert sum(got["dropped"] for got in outs) > 0
    for got in outs:
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        assert abs(got["step_loss"] - want_loss) <= 1e-5 * abs(want_loss)
        assert len(names) == sum(k.startswith("g/") for k in got)
        for leaf in names:
            assert close(got[f"g/{leaf}"], ref[f"{key}/g/{leaf}"], 1e-4), \
                leaf


def test_prefill_and_decode_under_gather_match_reference(ref, ranks2):
    """Reduced granite at capacity factor 1.25 on prompts of few distinct
    tokens (so that its layers drop assignments) at (1, 2), as gloo ranks:
    the prefill's and one decode step's logits on params placed by the
    serve rules, and the prefill's by the ZeRO-3 prefill rules (the
    sequence split over model), each MoE layer through the split gather
    path, within 1e-4 of their largest |value| of the reference's unsplit
    ones (fp32). The shard_map path's prefill on the sequence-split blocks
    drops other assignments and misses by more."""
    assert sum(r["serve_gather"]["dropped"] for r in ranks2) > 0
    for r in ranks2:
        got = r["serve_gather"]
        assert got["serve/stack_placements"] == "(Replicate(), Shard(dim=1))"
        assert got["prefill/stack_placements"] == \
            "(Shard(dim=1), Replicate())"
        for stage, want in (("serve/prefill", "prefill"),
                            ("serve/decode", "decode"),
                            ("prefill/prefill", "prefill")):
            assert close(got[stage], ref[f"serve/granite125/{want}"],
                         1e-4), stage
        assert not close(got["prefill/shardmap"],
                         ref["serve/granite125/prefill"], 1e-4)


@pytest.mark.parametrize("split", ("kv_heads", "kv_seq"))
def test_prefill_and_decode_on_a_split_cache_match_reference(ref, ranks2,
                                                             split):
    """Reduced qwen2 served at (1, 2) by the serve rules, its cache split on
    its 2 KV heads or, with 1 KV head, on its sequence (``kv_seq``; the
    decode step writes position 12, in rank 1's block): the prefill's and
    the decode step's logits within 1e-4 of their largest |value| of the
    reference's (fp32)."""
    for r in ranks2:
        got = r["serve"][split]
        dim = 3 if split == "kv_heads" else 2
        assert f"Shard(dim={dim})" in got["cache_placements"]
        assert got["pos"] == 13
        for stage in ("prefill", "decode"):
            want = ref[f"serve/{split}/{stage}"]
            scale = np.abs(want).max()
            assert np.abs(got[stage] - want).max() <= 1e-4 * scale, stage


def test_moe_prefill_with_experts_split_over_data_matches_reference(
        ref, ranks4):
    """Reduced granite's prefill at (2, 2) by the ZeRO-3 prefill rules (the
    expert stacks split over data, the sequence over model; each MoE layer
    through the shard_map path, which ``moe_ctx`` asks for, with data as
    its expert axis), against the
    reference's unsplit prefill: the logits within 1e-4 of their largest
    |value| (fp32; the reduced capacity factor 8 drops nothing, so the two
    paths compute the same sum)."""
    want = ref["serve/granite/prefill"]
    for r in ranks4:
        got = r["moe_prefill"]
        assert got["stack_placements"] == "(Shard(dim=1), Replicate())"
        assert close(got["prefill"], want, 1e-4)


def test_remesh_4x1_to_2x2(ranks4):
    """A train state placed on (4, 1) and remeshed to (2, 2) on 4 gloo
    ranks: each rank's local shard is its block, each leaf gathered whole
    is the original."""
    for r in ranks4:
        res = r["remesh"]
        assert res["blocks"] and res["whole"]
        assert res["split_leaves"] > 0


def test_adamw_on_split_leaves_by_blocks(ranks4):
    """AdamW on a reduced granite state split over (2, 2) gloo ranks through
    ``kernels.sharded`` (the plain passes standing in for the kernels): the
    norm all-reduced from the blocks' fp64 sums is the whole tree's on
    every rank, within 1e-6 of the chain's fp32 one; each new leaf placed
    as its param and bit-equal to the chain's on the DTensors; one norm
    call a group of leaves split over the same mesh dims."""
    for r in ranks4:
        res = r["adamw"]
        assert res["split_leaves"] > 0
        assert abs(float(res["norm"]) - res["fp64_norm"]) <= \
            1e-7 * res["fp64_norm"]
        assert abs(float(res["norm"]) - float(res["chain_norm"])) <= \
            1e-6 * res["fp64_norm"]
        assert res["placed"] and res["bit_equal"]
        assert sum(res["calls"]) == res["leaves"] and \
            1 < len(res["calls"]) <= 4
    assert len({float(r["adamw"]["norm"]) for r in ranks4}) == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda(group):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the Hopper kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_moe_shardmap_on_card_matches_cpu(cuda, ref):
    """The shard_map MoE at a (1, 1) mesh on the card (NCCL) against its
    CPU run (gloo), fp32, forward and every gradient, at the tolerances of
    the reference comparison (llama4's top-1 router gradient held to be
    zero on both sides)."""
    cpu_mesh = mesh_mod.make_host_mesh(device="cpu")
    card_mesh = mesh_mod.make_host_mesh()
    for arch in workers.MOE_ARCHS:
        want = workers.moe_case(ref, arch, cpu_mesh)
        got = workers.moe_case(ref, arch, card_mesh, device=cuda)
        np.testing.assert_allclose(got["y"], want["y"], atol=1e-5, rtol=0)
        names = [k for k in want if k.startswith("g/")] + ["dx"]
        top = max(np.abs(want[k]).max() for k in names)
        for k in names:
            if k[2:] in ZERO_LEAVES.get(arch, ()):
                assert max(np.abs(got[k]).max(),
                           np.abs(want[k]).max()) <= 1e-5 * top, k
                continue
            scale = max(np.abs(want[k]).max(), 1e-30)
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * scale, k


@pytest.mark.gpu
def test_moe_gather_split_on_card_matches_cpu(cuda, ref):
    """The split gather path at a (1, 1) mesh on the card (NCCL) against
    its CPU run (gloo), fp32, forward and every gradient, at the
    tolerances of the reference comparison; and the CPU run against the
    reference's unsplit gather path."""
    cpu_mesh = mesh_mod.make_host_mesh(device="cpu")
    card_mesh = mesh_mod.make_host_mesh()
    for arch in workers.MOE_ARCHS:
        want = workers.moe_case(ref, arch, cpu_mesh, gather=True)
        got = workers.moe_case(ref, arch, card_mesh, device=cuda,
                               gather=True)
        np.testing.assert_allclose(want["y"], ref[f"{arch}/gather/y"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["y"], want["y"], atol=1e-5, rtol=0)
        names = [k for k in want if k.startswith("g/")] + ["dx"]
        top = max(np.abs(want[k]).max() for k in names)
        for k in names:
            if k[2:] in ZERO_LEAVES.get(arch, ()):
                assert max(np.abs(got[k]).max(),
                           np.abs(want[k]).max()) <= 1e-5 * top, k
                continue
            assert close(got[k], want[k], 1e-5), k


@pytest.mark.gpu
def test_compressed_psum_on_nccl_is_compress_decompress(cuda):
    card_mesh = mesh_mod.make_host_mesh()
    x = torch.randn(7, 333, generator=torch.Generator().manual_seed(5))
    x = x.to(cuda)
    got = compression.compressed_psum(x, card_mesh.get_group("data"))
    assert torch.equal(got, compression.compress_decompress(x))
