"""The port's spans (``repro_torch.trace``): nothing without a profiler,
the engine's, the model's, the MoE's and the train step's under one, nested
as the trace reads them; and the engine's queue-wait counters."""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.engine import ContinuousBatcher, GenerationEngine  # noqa: E402
from repro_torch.engine.engine import Request  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

ENGINE_SPANS = {"engine.prefill", "engine.slot_copy", "engine.first_token",
                "engine.decode", "engine.sample", "engine.read_tokens",
                "engine.retire"}
MODEL_SPANS = {"model.embed", "model.attn", "model.ffn", "model.head"}
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
PREFIXES = ("engine.", "model.", "moe.", "step.")


def spans(prof):
    """The port's spans the profiler recorded, (start, end, name) by
    start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(PREFIXES))


def inside(span, outer_names, recorded):
    """Whether ``span`` lies within a recorded span of ``outer_names``."""
    s, t, _ = span
    return any(n in outer_names and a <= s and t <= b
               for a, b, n in recorded)


def graph_nodes(t):
    """The class names of every node of ``t``'s autograd graph."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.fixture(scope="module")
def served():
    cfg = reduced(get_config("qwen2-0.5b"))
    bundle = registry.build(cfg)
    params = bundle.init(generator=torch.Generator().manual_seed(0),
                         device="cpu")
    return bundle, params


@pytest.fixture(scope="module")
def moe_step():
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    bundle = registry.build(cfg)
    gen = torch.Generator().manual_seed(0)
    step = train_loop.make_train_step(bundle, opt_mod.AdamWConfig(),
                                      dtype=torch.float32, remat=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    return bundle, step, {"tokens": tokens}, gen


def test_span_is_a_no_op_without_a_profiler(moe_step):
    """No profiler: one shared no-op context, nothing recorded, and the
    MoE's autograd graph holds no marker node (under a profiler it
    does)."""
    assert trace.span("engine.prefill") is trace.span("moe.route")
    bundle, _, batch, gen = moe_step
    params = bundle.init(generator=gen, device="cpu", requires_grad=True)
    loss = bundle.loss_fn(params, batch, dtype=torch.float32, remat=False)
    assert not {"_OpenBackward", "_CloseBackward"} & graph_nodes(loss)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = bundle.loss_fn(params, batch, dtype=torch.float32,
                                remat=False)
    assert {"_OpenBackward", "_CloseBackward"} <= graph_nodes(traced)
    assert torch.equal(loss, traced)


def test_spans_are_host_ops_and_not_user_annotations(moe_step):
    """The profiler repeats a user annotation on the device's timeline as
    the range of the kernels launched inside it; a span, opened forward or
    in the backward, is a host op and leaves no such range."""
    bundle, step, batch, gen = moe_step
    state = train_loop.init_train_state(bundle, gen, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("engine.prefill"):
            torch.ones(2).add_(1)
        step(state, batch)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(PREFIXES)]
    assert {"engine.prefill", "moe.backward", "step.adamw"} <= {
        e.name() for e in events}
    assert not any(e.is_user_annotation() for e in events)


def test_engine_insert_and_tick_record_their_spans(served):
    bundle, params = served
    eng = GenerationEngine(bundle, params, device="cpu", max_len=64,
                           n_slots=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.insert(Request(0, "semantic query about movies",
                           max_new_tokens=4), 0)
        eng.decode_tick()
    rec = spans(prof)
    names = {n for _, _, n in rec}
    assert ENGINE_SPANS | MODEL_SPANS <= names
    for sp in rec:
        if sp[2].startswith("model."):
            assert inside(sp, {"engine.prefill", "engine.decode"}, rec), sp
    # the prefill's layers and the tick's
    assert [n for _, _, n in rec].count("model.attn") == \
        2 * bundle.cfg.n_layers


def test_moe_train_step_records_moe_and_step_spans(moe_step):
    """Forward, recomputation (remat) and backward of every MoE layer, the
    loss, the gradient and AdamW; the result is the untraced step's."""
    bundle, step, batch, gen = moe_step
    layers = bundle.cfg.n_layers
    state = train_loop.init_train_state(bundle, gen, device="cpu")
    want_state, want = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got_state, got = step(state, batch)
    assert torch.equal(got["loss"], want["loss"])
    for a, b in zip(opt_mod.leaves(got_state["params"]),
                    opt_mod.leaves(want_state["params"])):
        assert torch.equal(a, b)
    rec = spans(prof)
    names = [n for _, _, n in rec]
    for n in MOE_SPANS | {"step.loss", "step.grad", "step.adamw"}:
        assert n in names, n
    assert names.count("moe.backward") == layers
    # each layer's route runs in the forward and again, recomputed, in
    # its backward
    assert names.count("moe.route") == 2 * layers
    back = [sp for sp in rec if sp[2] == "moe.backward"]
    assert all(inside(sp, {"step.grad"}, rec) for sp in back)
    assert sum(inside(sp, {"moe.backward"}, rec) for sp in rec
               if sp[2] == "moe.route") == layers
    for sp in rec:
        if sp[2] in MOE_SPANS and not inside(sp, {"moe.backward"}, rec):
            assert inside(sp, {"step.loss"}, rec), sp


def test_queue_wait_counts_batcher_requests_and_skips_direct_inserts(
        served):
    bundle, params = served
    eng = GenerationEngine(bundle, params, device="cpu", max_len=64,
                           n_slots=2)
    eng.insert(Request(0, "direct insert", max_new_tokens=2), 0)
    assert eng.stats["queued"] == 0 and eng.stats["queue_wait_s"] == 0.0
    eng.decode_tick()
    cb = ContinuousBatcher(eng)
    rids = [cb.submit(f"queued request {i}", max_new_tokens=3)
            for i in range(5)]
    done = cb.run()
    assert eng.stats["queued"] == 5
    waits = sum(done[r].started_s - done[r].submitted_s for r in rids)
    assert eng.stats["queue_wait_s"] == pytest.approx(waits)
    assert eng.queue_wait_s == pytest.approx(waits / 5)
    # five requests over two slots: the later ones waited for a slot
    assert max(done[r].started_s - done[r].submitted_s for r in rids) > 0
