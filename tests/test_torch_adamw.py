"""AdamW's two passes (``kernels/adamw.py``, ``csrc/adamw.cu``) and the
dispatch in ``training.optimizer.apply_updates``.

On the CPU: the plain version is the chain of PyTorch ops the optimizer ran
before the kernels, bit for bit; CPU trees still take that chain; on fake
CUDA tensors the step reaches the two ops, once each, with the outputs'
shapes and the bytes a parameter the roofline counts; fake CUDA DTensors
reach them on each rank's blocks (``tests/test_torch_mesh.py`` holds the
blocks' arithmetic on split gloo ranks). On the card (the
``gpu`` cases): the update bit-equal to the plain version, the norm within
1e-6 of an fp64 sum and the same bits every run, no host synchronisation,
and the launch count, at codeqwen1.5-7b's and granite-moe-1b-a400m's leaves
and at odd sizes.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.kernels import _build, adamw, ops  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

CFG = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=1000)
KW = dict(b1=CFG.b1, b2=CFG.b2, eps=CFG.eps, weight_decay=CFG.weight_decay)


def chain_update(p, g, m, v, scale, lr, b1c, b2c, cfg=CFG):
    """One leaf's step as ``apply_updates`` wrote it before the kernels."""
    g = g.float() * scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mhat = m2 / b1c
    vhat = v2 / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    return p - lr * (delta + cfg.weight_decay * p), m2, v2


def chain_step(cfg, params, grads, state):
    """``apply_updates`` as it was before the kernels, on flat lists."""
    step = state["step"] + 1
    lr = opt.schedule(cfg, step)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    out = [chain_update(p, g, m, v, scale, lr, b1c, b2c, cfg)
           for p, g, m, v in zip(params, grads, state["m"], state["v"])]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out], \
        gnorm


def leaf_values(gen, n, device="cpu"):
    """p, g, m, v of n elements: weights, gradients over six decades (and
    some exact zeros), signed first and positive second moments."""
    def randn():
        return torch.randn(n, generator=gen, device=device)

    p = randn() * 0.02
    g = randn() * torch.pow(10.0, -6 * torch.rand(n, generator=gen,
                                                  device=device))
    g[torch.rand(n, generator=gen, device=device) < 0.01] = 0
    m = randn() * 1e-3
    v = torch.rand(n, generator=gen, device=device) * 1e-5
    return p, g, m, v


def scalars(step, scale, device="cpu"):
    """(scale, lr, b1c, b2c) as ``apply_updates`` forms them at ``step``."""
    s = torch.tensor(step, dtype=torch.int32, device=device)
    return (torch.tensor(scale, dtype=torch.float32, device=device),
            opt.schedule(CFG, s), 1 - CFG.b1 ** s.to(torch.float32),
            1 - CFG.b2 ** s.to(torch.float32))


@pytest.mark.parametrize("n", [1, 3, 4, 1000, 65537])
@pytest.mark.parametrize("step", [1, 7, 400])
def test_plain_is_the_chain_bit_for_bit(n, step):
    gen = torch.Generator().manual_seed(n + step)
    p, g, m, v = leaf_values(gen, n)
    sc = scalars(step, 0.37)
    got = adamw.plain(p, g, m, v, *sc, **KW)
    want = chain_update(p, g, m, v, *sc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    grads = [g, p, m]
    assert torch.equal(adamw.plain_norm(grads),
                       torch.sqrt(sum(torch.sum(torch.square(x.float()))
                                      for x in grads)))


def random_tree(gen, shapes, device="cpu"):
    params, grads = {}, {}
    state = {"m": {}, "v": {}, "step": torch.tensor(4, dtype=torch.int32,
                                                    device=device)}
    for i, shape in enumerate(shapes):
        p, g, m, v = leaf_values(gen, math.prod(shape), device)
        key = f"leaf{i:02d}"
        params[key] = p.reshape(shape).requires_grad_(i % 2 == 0)
        grads[key], state["m"][key], state["v"][key] = (
            t.reshape(shape) for t in (g, m, v))
    return params, grads, state


def test_cpu_tree_takes_the_chain(monkeypatch):
    """A CPU tree's step is the chain's, bit for bit, and never reaches the
    kernels' wrappers; the new params keep ``requires_grad``."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tree reached the kernels")
    monkeypatch.setattr(adamw, "global_norm", refuse)
    monkeypatch.setattr(adamw, "update", refuse)
    gen = torch.Generator().manual_seed(5)
    shapes = [(3, 5), (7,), (2, 3, 4), (1,)]
    params, grads, state = random_tree(gen, shapes)
    new_p, new_s, metrics = opt.apply_updates(CFG, params, grads, state)
    flat = [opt.leaves(t) for t in (params, grads, state["m"], state["v"])]
    want_p, want_m, want_v, gnorm = chain_step(
        CFG, flat[0], flat[1], {"m": flat[2], "v": flat[3],
                                "step": state["step"]})
    for got, want in ((new_p, want_p), (new_s["m"], want_m),
                      (new_s["v"], want_v)):
        assert all(torch.equal(a, b) for a, b in zip(opt.leaves(got), want))
    assert torch.equal(metrics["grad_norm"], gnorm)
    assert int(new_s["step"]) == 5 and list(new_p) == sorted(params)
    assert [p.requires_grad for p in opt.leaves(new_p)] == \
        [p.requires_grad for p in flat[0]]


def test_takes_only_plain_contiguous_fp32_cuda_leaves():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a, b = torch.empty(4, 6, device="cuda"), torch.empty(6, device="cuda")
        assert adamw.takes([a, b])
        assert not adamw.takes([])
        assert not adamw.takes([a, torch.empty_strided((4, 6), (1, 4),
                                                       device="cuda")])
        assert not adamw.takes([a, b.to(torch.bfloat16)])
        assert not adamw.takes([a, torch.empty(3, device="cuda:1")])
    assert not adamw.takes([torch.zeros(3)])                  # the CPU


def test_wrappers_refuse_what_the_kernels_do_not_take():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with pytest.raises(ValueError, match="CUDA"):
        adamw.global_norm([torch.zeros(3)])
    with FakeTensorMode():
        a = torch.empty(8, device="cuda")
        sc = [torch.empty((), device="cuda") for _ in range(4)]
        with pytest.raises(ValueError, match="leaves"):
            adamw.update([a, a], [a], [a], [a], *sc, **KW)
        with pytest.raises(ValueError, match="shape|is"):
            adamw.update([a], [torch.empty(4, device="cuda")], [a], [a], *sc,
                         **KW)
        with pytest.raises(ValueError, match="0-dim"):
            adamw.update([a], [a], [a], [a], a, *sc[1:], **KW)
        with pytest.raises(ValueError, match="float32"):
            adamw.update([a], [torch.empty(8, dtype=torch.float64,
                                           device="cuda")], [a], [a], *sc,
                         **KW)


# 15 leaves: codeqwen1.5-7b cut to 4 layers as its benchmark runs it (32/4
# heads of 128); 40: more than one launch's 32
FAKE_TREES = {"codeqwen_4_layers": None, "forty_leaves": [(i + 1, 3)
                                                          for i in range(40)]}


def codeqwen_shapes():
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b"), n_layers=4,
                              n_kv_heads=4)
    return [tuple(t.shape) for t in opt.leaves(
        registry.build(cfg).init(device="meta"))]


@pytest.mark.parametrize("tree", sorted(FAKE_TREES))
def test_fake_cuda_tree_reaches_both_ops_once(tree):
    """Under ``FakeTensorMode`` a CUDA float32 tree takes the two ops, one
    call each whatever the number of leaves (a call launches one kernel for
    up to 32 leaves): the outputs' shapes and dtypes are the leaves', the
    norm 0-dim, no other op touches a whole leaf, and the bytes counted are
    32 a parameter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shapes = FAKE_TREES[tree] or codeqwen_shapes()
    n = sum(math.prod(s) for s in shapes)
    counter = rl.RankCounter()
    with FakeTensorMode():
        def tree_of():
            return {f"l{i:02d}": torch.empty(s, device="cuda")
                    for i, s in enumerate(shapes)}
        params, grads = tree_of(), tree_of()
        state = {"m": tree_of(), "v": tree_of(),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        with counter:
            new_p, new_s, metrics = opt.apply_updates(CFG, params, grads,
                                                      state)
    assert counter.launches == {"adamw_sumsq": 1, "adamw_update": 1}
    for got in (new_p, new_s["m"], new_s["v"]):
        assert [(tuple(t.shape), t.dtype, t.is_cuda, t.is_contiguous())
                for t in opt.leaves(got)] == [
            (s, torch.float32, True, True) for s in shapes]
    assert metrics["grad_norm"].shape == () and \
        metrics["grad_norm"].dtype == torch.float32
    by_op = {e["op"]: e for e in counter.entries()}
    assert by_op["repro_torch.adamw_sumsq"]["bytes"] == 4 * n
    assert by_op["repro_torch.adamw_update"]["bytes"] == 28 * n
    assert by_op["repro_torch.adamw_update"]["flops"] == \
        adamw.UPDATE_FLOPS * n
    assert all(e["bytes"] < 1024 for e in counter.entries()
               if not e["op"].startswith("repro_torch."))


# leaves of a (data, model) mesh's four kinds of placement: split over
# both dims, over neither, over model, over data (5 rows split unevenly)
DT_LEAVES = {"a": ((8, 6), ("S0", "S1")), "b": ((6,), ("R", "R")),
             "c": ((4, 10), ("R", "S0")), "d": ((5, 3), ("S0", "R"))}


@pytest.mark.parametrize("world,model,sumsq,all_reduces",
                         [(1, 1, 1, 0), (4, 2, 4, 4)])
def test_fake_cuda_dtensor_tree_reaches_the_ops_by_blocks(world, model,
                                                          sumsq,
                                                          all_reduces):
    """A fake CUDA DTensor tree over a fake group (the dry-run's) takes the
    kernels on each rank's blocks, as a plain tree does: one update call
    for every leaf; one norm call for each group of leaves split over the
    same mesh dims of more than one rank (one in all on a one-rank mesh),
    its sum all-reduced over each of those dims; each new leaf a DTensor
    placed as its param, the norm replicated. Gradient blocks left strided
    by their sharding are made dense for the kernels."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._collective_utils import MeshTopoInfo
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_block
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    placement = {"S0": Shard(0), "S1": Shard(1), "R": Replicate()}
    with dryrun.fake_group(world):
        mesh = make_host_mesh(model=model)
        MeshTopoInfo.build_from_mesh(mesh)
        spec = {k: (shape, [placement[p] for p in pl])
                for k, (shape, pl) in DT_LEAVES.items()}
        local = {k: local_block(shape, mesh, pl)[0]
                 for k, (shape, pl) in spec.items()}
        counter = rl.RankCounter()
        with dryrun._planning_unfaked(), \
                FakeTensorMode(allow_non_fake_inputs=True):
            def block(k, strided):
                if strided:   # transposed, as a tied embedding's gradient
                    return torch.empty(local[k][::-1], device="cuda").t()
                return torch.empty(local[k], device="cuda")

            def tree(strided=()):
                return {k: DTensor.from_local(
                    block(k, k in strided), mesh, pl, run_check=False,
                    shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride())
                    for k, (shape, pl) in spec.items()}
            params, grads = tree(), tree(strided=("a", "c"))
            assert not grads["c"].to_local().is_contiguous()
            state = {"m": tree(), "v": tree(), "step": DTensor.from_local(
                torch.zeros((), dtype=torch.int32, device="cuda"), mesh,
                [Replicate()] * mesh.ndim, run_check=False)}
            with counter:
                new_p, new_s, metrics = opt.apply_updates(CFG, params, grads,
                                                          state)
    assert counter.launches == {"adamw_sumsq": sumsq, "adamw_update": 1}
    assert sum(e["count"] for e in counter.entries()
               if e["op"] == "_c10d_functional.all_reduce") == all_reduces
    for got in (new_p, new_s["m"], new_s["v"]):
        for k, (shape, pl) in spec.items():
            t = got[k]
            assert isinstance(t, DTensor) and list(t.placements) == pl
            assert tuple(t.shape) == shape and \
                tuple(t.to_local().shape) == tuple(local[k])
            assert t.to_local().is_cuda and t.dtype == torch.float32
    norm = metrics["grad_norm"]
    assert isinstance(norm, DTensor) and norm.shape == () and \
        norm.dtype == torch.float32
    assert all(p.is_replicate() for p in norm.placements)


def test_registered_bytes_are_32_a_parameter():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        ls = [torch.empty(s, device="cuda") for s in ((5, 7), (3,), (1,))]
        sc = [torch.empty((), device="cuda")] * 4
        total = (_build.OP_BYTES[torch.ops.repro_torch.adamw_sumsq](ls)
                 + _build.OP_BYTES[torch.ops.repro_torch.adamw_update](
                     ls, ls, ls, ls, *sc, 0.9, 0.95, 1e-8, 0.1))
    assert total == 32 * (35 + 3 + 1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def granite_shapes():
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    return [tuple(t.shape) for t in opt.leaves(
        registry.build(get_config("granite-moe-1b-a400m")).init(
            device="meta"))]


def odd_sizes():
    """Every size 1-33, sizes either side of the kernels' tiles (1,024 and
    2,048 elements) and up to 16,384, and 4k + 1 .. 4k + 3: 47 leaves, so
    two launches."""
    return [(n,) for n in list(range(1, 34)) + [1023, 1024, 1025, 2047,
                                                 2049, 4093, 4097, 8191,
                                                 12289, 16383, 16384, 6,
                                                 10, 14]]


CARD_SETS = {"codeqwen": codeqwen_shapes, "granite": granite_shapes,
             "odd": odd_sizes}


def card_leaves(shapes, device, offset=0):
    """p, g, m, v lists on the card; with ``offset`` each leaf a view
    ``offset`` floats into its own buffer (contiguous, not 16-byte
    aligned)."""
    gen = torch.Generator(device).manual_seed(len(shapes))
    out = [[], [], [], []]
    for s in shapes:
        n = math.prod(s)
        for lst, t in zip(out, leaf_values(gen, n + offset, device)):
            lst.append(t[offset:].reshape(s))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_set,offset", [("codeqwen", 0), ("granite", 0),
                                             ("odd", 0), ("odd", 1)])
def test_update_is_plain_bit_for_bit_on_card(cuda, leaf_set, offset):
    """Offset 1: every leaf a view one float into its buffer, so no pointer
    is 16-byte aligned and every element takes the scalar path."""
    ps, gs, ms, vs = card_leaves(CARD_SETS[leaf_set](), cuda, offset)
    for step, scale in ((1, 1.0), (3, 0.37), (500, 0.0123)):
        sc = scalars(step, scale, cuda)
        new = adamw.update(ps, gs, ms, vs, *sc, **KW)
        for i, leaf in enumerate(zip(ps, gs, ms, vs)):
            want = adamw.plain(*leaf, *sc, **KW)
            for got, w, name in zip((new[0][i], new[1][i], new[2][i]), want,
                                    "pmv"):
                assert torch.equal(got, w), (leaf_set, step, i, name)
        del new


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_set", sorted(CARD_SETS))
def test_norm_is_the_fp64_sum_and_repeats_on_card(cuda, leaf_set):
    gs = card_leaves(CARD_SETS[leaf_set](), cuda)[1]
    want = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in gs))
    first = adamw.global_norm(gs)
    assert first.shape == () and first.dtype == torch.float32
    assert abs(float(first) - want) <= 1e-6 * want
    assert all(torch.equal(adamw.global_norm(gs), first) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_set", ["granite", "odd"])
def test_apply_updates_on_card_syncs_nothing_and_counts_two(cuda, leaf_set):
    """A step on a card tree takes both passes (two launches on the counter
    whatever the number of leaves), waits on no host read, and gives the
    plain version's params with the kernel's norm."""
    shapes = CARD_SETS[leaf_set]()
    ps, gs, ms, vs = card_leaves(shapes, cuda)
    key = [f"l{i:02d}" for i in range(len(shapes))]
    tree = lambda ls: dict(zip(key, ls))  # noqa: E731
    state = {"m": tree(ms), "v": tree(vs),
             "step": torch.tensor(6, dtype=torch.int32, device=cuda)}
    opt.apply_updates(CFG, tree(ps), tree(gs), state)   # built, warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_p, new_s, metrics = opt.apply_updates(CFG, tree(ps), tree(gs),
                                                  state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.launch_counts()["adamw"] == 2
    scale = torch.clamp(CFG.clip_norm / torch.clamp(metrics["grad_norm"],
                                                    min=1e-9), max=1.0)
    step = state["step"] + 1
    sc = (scale, opt.schedule(CFG, step), 1 - CFG.b1 ** step.float(),
          1 - CFG.b2 ** step.float())
    for k, leaf in zip(key, zip(ps, gs, ms, vs)):
        want = adamw.plain(*leaf, *sc, **KW)
        assert torch.equal(new_p[k], want[0])
        assert torch.equal(new_s["m"][k], want[1])
        assert torch.equal(new_s["v"][k], want[2])
