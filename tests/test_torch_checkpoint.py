"""The port's checkpoints and fault-tolerant supervision, mirroring
``tests/test_checkpoint.py`` and the fault-tolerance cases of
``tests/test_training_infra.py`` (these modules hold no numerics to compare
with JAX: the contracts are the same files on disk, the same restart
behaviour, the same straggler rule). Every test runs under
``torch_parity.time_limit``."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    InjectedFailure, StragglerStats, SupervisorConfig, TrainSupervisor)
from repro_torch.models import registry  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from torch_parity import time_limit  # noqa: E402

LIMIT_S = 60


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(LIMIT_S):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the models here are tiny, and the suite runs
    several worker processes at once, whose thread pools would otherwise
    contend for the same cores (a step then takes tens of times longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.zeros(16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def assert_state_equal(a, b):
    la, lb = opt_mod.leaves(a), opt_mod.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    s = tiny_state()
    ck.save(str(tmp_path), 3, s)
    step, got = ck.restore(str(tmp_path), device="cpu")
    assert step == 3
    assert_state_equal(s, got)


def test_atomicity_tmp_dirs_invisible(tmp_path):
    s = tiny_state()
    ck.save(str(tmp_path), 1, s)
    bad = tmp_path / "step_00000009.tmp-dead"   # a crashed writer's
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step(str(tmp_path)) == 1
    step, _ = ck.restore(str(tmp_path), device="cpu")
    assert step == 1
    ck.save(str(tmp_path), 2, s)                # the next commit's GC
    assert not bad.exists()


def test_keep_last_k_gc(tmp_path):
    s = tiny_state()
    for i in range(6):
        ck.save(str(tmp_path), i, s, keep_last=2)
    assert ck.committed_steps(str(tmp_path)) == [4, 5]


def test_checksum_detects_corruption(tmp_path):
    d = ck.save(str(tmp_path), 2, tiny_state())
    leaf = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    p = os.path.join(d, leaf)
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        ck.restore(str(tmp_path), device="cpu")
    step, _ = ck.restore(str(tmp_path), device="cpu", verify=False)
    assert step == 2


def test_async_checkpointer(tmp_path):
    s = tiny_state()
    ac = ck.AsyncCheckpointer(str(tmp_path), keep_last=2)
    for i in range(4):
        ac.save(i, s)
    ac.close()
    assert ck.committed_steps(str(tmp_path)) == [2, 3]
    _, got = ck.restore(str(tmp_path), device="cpu")
    assert_state_equal(s, got)


def test_async_save_copies_before_returning(tmp_path):
    """``save`` takes a host copy: an in-place change after it returns
    does not reach the checkpoint."""
    s = tiny_state()
    before = s["params"]["w"].clone()
    ac = ck.AsyncCheckpointer(str(tmp_path))
    ac.save(0, s)
    s["params"]["w"].add_(1.0)
    ac.close()
    _, got = ck.restore(str(tmp_path), device="cpu")
    assert torch.equal(got["params"]["w"], before)


def test_manifest_contents(tmp_path):
    d = ck.save(str(tmp_path), 5, tiny_state(), extra_meta={"run": "x"})
    m = json.load(open(os.path.join(d, "manifest.json")))
    assert m["step"] == 5 and m["meta"]["run"] == "x"
    w = m["leaves"]["params/w"]
    assert (w["shape"], w["dtype"], w["axes"]) == ([8, 16], "float32", None)
    assert w["file"] == "params__w.npy" and len(w["sha256"]) == 64
    assert m["leaves"]["opt/step"]["dtype"] == "int32"
    assert np.load(os.path.join(d, w["file"])).shape == (8, 16)


def test_other_dtypes_and_mesh_restore_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(str(tmp_path), 0, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert ck.latest_step(str(tmp_path)) is None
    ck.save(str(tmp_path), 0, tiny_state())
    with pytest.raises(TypeError, match="DeviceMesh"):
        ck.restore(str(tmp_path), mesh=object(), rules={})
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "empty"))


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config("qwen2-0.5b"))
    b = registry.build(cfg)
    state = train_loop.init_train_state(b, torch.Generator().manual_seed(0),
                                        device="cpu")
    return cfg, b, state


def batch_of(cfg, step, bsz=4, seq=32):
    g = torch.Generator().manual_seed(step)
    return {"tokens": torch.randint(0, cfg.vocab_size, (bsz, seq),
                                    generator=g)}


def test_loss_decreases(tiny):
    cfg, b, state = tiny
    step = train_loop.make_train_step(
        b, opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30))
    fixed = batch_of(cfg, 0)
    losses = []
    for _ in range(12):
        state, m = step(state, fixed)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9


@pytest.mark.parametrize("async_save", [False, True])
def test_restart_determinism(tmp_path, tiny, async_save):
    """A failure injected after step 6 restarts from the checkpoint of step
    3 (every 4 steps) and ends bit-identical to an uninterrupted run."""
    cfg, b, state = tiny
    step = train_loop.make_train_step(
        b, opt_mod.AdamWConfig(warmup_steps=1, total_steps=20))
    bf = lambda s: batch_of(cfg, 100 + s)
    sup = TrainSupervisor(step, bf, SupervisorConfig(
        ckpt_dir=str(tmp_path / "a"), ckpt_every=4, async_save=async_save))
    s1, logs, restarts = sup.run_with_restarts(state, 12, fail_at={6})
    assert restarts == 1
    assert [e["step"] for e in logs if "step" in e] == list(range(4, 12))
    assert ck.committed_steps(str(tmp_path / "a")) == [3, 7, 11]
    sup2 = TrainSupervisor(step, bf, SupervisorConfig(
        ckpt_dir=str(tmp_path / "b"), ckpt_every=4))
    s2, log2 = sup2.run(state, 12)
    assert len(log2) == 12 and all(np.isfinite(e["loss"]) for e in log2)
    assert_state_equal(s1, s2)


def test_supervisor_takes_over_a_built_state(tmp_path, tiny):
    """``run`` given a function that builds the state (as the launcher
    gives it): the same bits as ``run`` given the state, the function
    called once a run, and once the run ends nothing holds the state it
    built. With a checkpoint committed, the run restores onto the built
    state's device and resumes after it."""
    import gc
    import weakref
    cfg, b, state = tiny
    step = train_loop.make_train_step(
        b, opt_mod.AdamWConfig(warmup_steps=1, total_steps=20))
    bf = lambda s: batch_of(cfg, 200 + s)
    want, _ = TrainSupervisor(step, bf, SupervisorConfig(
        ckpt_dir=str(tmp_path / "a"), ckpt_every=100)).run(state, 3)
    built = []

    def build():
        fresh = opt_mod.tree_map(lambda t: t.detach().clone(), state)
        built.append(weakref.ref(opt_mod.leaves(fresh)[0]))
        return fresh
    sup = TrainSupervisor(step, bf, SupervisorConfig(
        ckpt_dir=str(tmp_path / "b"), ckpt_every=2))
    got, _ = sup.run(build, 3)
    gc.collect()
    assert len(built) == 1 and built[0]() is None
    assert_state_equal(got, want)
    again, log = sup.run(build, 4)
    assert len(built) == 2 and [e["step"] for e in log] == [2, 3]
    assert opt_mod.leaves(again)[0].device == torch.device("cpu")


def test_failure_propagates_without_restarts(tmp_path, tiny):
    cfg, b, state = tiny
    step = train_loop.make_train_step(b, opt_mod.AdamWConfig())
    sup = TrainSupervisor(step, lambda s: batch_of(cfg, s), SupervisorConfig(
        ckpt_dir=str(tmp_path), ckpt_every=2))
    fail = {2}
    with pytest.raises(InjectedFailure):
        sup.run(state, 4, fail_at=fail)
    assert fail == set() and ck.committed_steps(str(tmp_path)) == [1]


def test_straggler_detection():
    st = StragglerStats(deadline_factor=3.0)
    for i in range(10):
        st.observe(i, 0.1)
    assert st.observe(10, 1.0)          # 10x median
    assert not st.observe(11, 0.12)
    assert st.flagged == [10]


def test_supervisor_flags_injected_delay(tmp_path):
    """A step delayed far past 3x the running median is flagged, and only
    it. Each step sleeps 0.05 s and does no work, so the steps' times stay
    near the median however busy the machine is."""
    import time

    def step(state, batch):
        time.sleep(0.05)
        return state, {"loss": torch.tensor(0.0)}
    sup = TrainSupervisor(step, lambda s: None, SupervisorConfig(
        ckpt_dir=str(tmp_path), ckpt_every=100))
    _, log = sup.run({"w": torch.zeros(2)}, 8, delay_steps={6: 1.0})
    assert sup.straggler.flagged == [6]
    assert log[6]["seconds"] >= 1.0


def test_train_launcher_on_cpu(tmp_path, capsys):
    """``launch.train`` reduced on the CPU: the reference's report lines,
    checkpoints every --ckpt-every steps, and a second run in the same
    directory resumes from the last one."""
    from repro_torch.launch import train
    flags = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
             "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    losses = train.main(flags)
    out = capsys.readouterr().out
    assert "[train] arch=qwen2-0.5b-smoke" in out and "tok/s" in out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert ck.committed_steps(str(tmp_path)) == [1, 3]
    again = train.run(train.build_parser().parse_args(
        flags[:4] + ["6"] + flags[5:]))
    assert [e["step"] for e in again["log"]] == [4, 5]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_train_launcher_trains_ssm_and_hybrid_on_cpu(tmp_path, capsys,
                                                     arch):
    """The SSM and hybrid families through ``launch.train`` reduced on the
    CPU (the scan's gradient by autograd of its plain version): 2 steps
    with a checkpoint after each; a run with a failure after step 0
    restarts from that checkpoint and ends with the same bits."""
    from repro_torch.launch import train
    flags = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "40", "--ckpt-every", "1"]
    losses = train.main(flags + ["--ckpt-dir", str(tmp_path / "a")])
    assert f"[train] arch={arch}-smoke" in capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert ck.committed_steps(str(tmp_path / "a")) == [0, 1]
    args = train.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "b")])
    restarted = train.run(args, fail_at={0})
    assert restarted["restarts"] == 1
    assert [e["loss"] for e in restarted["log"] if "loss" in e][-1] \
        == losses[-1]
    _, whole = ck.restore(str(tmp_path / "a"), 1, device="cpu")
    for x, y in zip(opt_mod.leaves(restarted["state"]),
                    opt_mod.leaves(whole)):
        assert torch.equal(x.detach(), y.detach())


def test_training_entry_points_default_to_cuda():
    import inspect
    from repro_torch.examples import train_rewriter
    from repro_torch.launch import train
    for fn in (train_loop.init_train_state, ck.restore,
               train.synthetic_batch_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert train.build_parser().parse_args([]).device == "cuda"
    assert train_rewriter.build_parser().parse_args([]).device == "cuda"


def test_train_launcher_learns_a_corpus_on_cpu(tmp_path):
    """``--corpus movie``: the pipeline's text source (the plots packed by
    the byte tokenizer), on which the loss falls; the synthetic batches
    are uniform random tokens."""
    from repro_torch.launch import train
    losses = train.main(["--reduced", "--device", "cpu", "--steps", "12",
                         "--batch", "8", "--seq", "64", "--ckpt-every",
                         "100", "--ckpt-dir", str(tmp_path), "--corpus",
                         "movie"])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1
