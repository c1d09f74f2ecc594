"""Each per-layer metric's arithmetic, on synthetic profiler records and
counters, and the trace's reduction (busy time, idle gaps by span)."""
import pytest

from bench import flops, spec
from bench import tracing as tr
from bench.reference import model

CFG = spec._json(spec.ROOT / "bench" / "configs" / "codeqwen1.5-7b.json")
MIX = dict(spec._json(spec.ROOT / "bench" / "traffic" / "train_4k.json"),
           dtype="bfloat16")


def read(name, run):
    return spec.metric_reader(name).read(run)


def test_busy_union_and_idle_gaps_by_span():
    trace = {"window": (0.0, 100.0),
             "device": [(10, 20, "a"), (15, 30, "b"), (50, 60, "a")],
             "spans": [(0, 40, "serve.insert"), (45, 95, "serve.tick")]}
    assert tr.busy_us(trace["device"]) == 30
    gaps = tr.idle_by_span(trace)
    # 0-10 and 30-50 (middle 40: after insert ended) ... 60-100
    assert gaps == {"serve.insert": 10, "host.loop": 20, "serve.tick": 40}
    b = tr.breakdown(trace)
    assert b["device_ops"][0] == ["a", 20 / 1e6]
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(70 / 1e6)
    run = {"kind": "serve", "trace": trace}
    assert read("idle_share.serve", run) == pytest.approx(70.0)
    assert read("idle_share.train", run) is None


def test_engine_counters():
    run = {"kind": "serve", "stats": {"decode_steps": 40, "decode_s": 0.6,
                                      "prefill_s": 2.0, "prefills": 9},
           "prompt_tokens": 4000}
    assert read("decode_tick_ms", run) == pytest.approx(15.0)
    assert read("prefill_ms_per_ktok", run) == pytest.approx(500.0)
    assert read("decode_tick_ms", {"stats": {"decode_steps": 0}}) is None


def test_serve_mfu_counts_prefills_and_active_rows():
    run = {"kind": "serve", "cfg": CFG, "mix": {"dtype": "float32"},
           "prefill_lens": [64, 128], "tick_lens": [[70, 0, 130], [71, 0, 0]],
           "window_s": 2.0}
    want = (flops.prefill_flops(CFG, 64) + flops.prefill_flops(CFG, 128)
            + flops.tick_flops(CFG, [70, 130]) + flops.tick_flops(CFG, [71]))
    assert read("serve_mfu", run) == pytest.approx(
        100 * want / 2.0 / 495e12)
    layer = model.layer_matmul_params(CFG)
    # q and o of 32 heads, k and v of 4, each of 128
    assert layer == 4096 * 128 * (2 * 32 + 2 * 4) + 3 * 4096 * 13440
    assert flops.tick_flops(CFG, [5]) == pytest.approx(
        2 * (4 * layer + 4096 * 92416) + 4 * 4 * 32 * 128 * 5)


def test_train_mfu_and_other_ms():
    run = {"kind": "train", "cfg": CFG, "mix": MIX, "steps": 10,
           "window_s": 2.5,
           "trace": {"window": (0, 2.5e6), "spans": [], "device": [
               (0, 1000, "void at::native::vectorized_elementwise_kernel<4>"),
               (0, 3000, "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT"),
               (0, 500, "void (anonymous namespace)::flash_fwd<bf16, 128>"),
               (0, 200, "ncclDevKernel_AllReduce_Sum_f32"),
               (0, 700, "void at::native::reduce_kernel<512, 1>")]}}
    per_step = flops.train_step_flops(CFG, 1, 4096)
    assert read("train_mfu", run) == pytest.approx(
        100 * per_step * 10 / 2.5 / 989e12)
    assert read("train_other_ms", run) == pytest.approx(1.7 / 10)
    # 6 x matmul params x tokens dominates; attention adds its pairs
    assert per_step == pytest.approx(
        6 * (4 * model.layer_matmul_params(CFG) + 4096 * 92416) * 4096
        + 3 * 4 * 4 * 32 * 128 * 4096 * 4097 // 2)


def test_attention_rooflines_from_shapes_and_kernel_time():
    dev = [(0, 100, "void (anonymous namespace)::flash_fwd<float, 128>(A)"),
           (0, 50, "void (anonymous namespace)::decode_kernel<float, 128>"),
           (0, 999, "sm80_xmma_gemm_f32f32")]
    run = {"kind": "serve", "cfg": CFG, "mix": {"dtype": "float32"},
           "prefill_lens": [128], "tick_lens": [[130, 0]],
           "launches": {"flash_attention": 4, "decode_attention": 4},
           "trace": {"window": (0, 1e3), "spans": [], "device": dev}}
    least = (flops.least_time(*flops.flash_fwd_cost(CFG, 1, 128, "float32",
                                                    False), "float32")
             + flops.least_time(*flops.decode_cost(CFG, [130, 1], "float32"),
                                "float32"))
    assert read("attn_roofline.serve", run) == pytest.approx(
        100 * 4 * least / 150e-6)
    with pytest.raises(RuntimeError, match="no device kernel matched"):
        read("attn_roofline.serve", dict(run, trace=dict(
            run["trace"], device=dev[2:])))
    with pytest.raises(RuntimeError, match="host's lengths"):
        read("attn_roofline.serve", dict(run, launches={
            "flash_attention": 4, "decode_attention": 8}))
    train = {"kind": "train", "cfg": CFG, "mix": MIX, "steps": 1,
             "launches": {"flash_attention": 8, "flash_attention_bwd": 4},
             "trace": {"window": (0, 1e5), "spans": [], "device": [
                 (0, 2000, "void flash_fwd<bf16, 128>"),
                 (0, 3000, "void bwd_dkdv_wgmma<bf16, 128>"),
                 (0, 1000, "void bwd_dq_wgmma<bf16, 128>"),
                 (0, 100, "void bwd_delta<bf16, 128>")]}}
    f = flops.least_time(*flops.flash_fwd_cost(CFG, 1, 4096, "bfloat16",
                                               True), "bfloat16")
    b = flops.least_time(*flops.flash_bwd_cost(CFG, 1, 4096, "bfloat16"),
                         "bfloat16")
    assert read("attn_roofline.train", train) == pytest.approx(
        100 * (8 * f + 4 * b) / 6100e-6)


def test_kernel_costs():
    # causal pairs, each input and output byte once
    f, b = flops.flash_fwd_cost(CFG, 2, 4, "bfloat16", True)
    assert f == 4 * 2 * 32 * 128 * 10
    assert b == 2 * 2 * 4 * 128 * (2 * 32 + 2 * 4) + 4 * 2 * 32 * 4
    f, b = flops.decode_cost(CFG, [3, 1], "float32")
    assert f == 4 * 32 * 128 * 4
    assert b == 4 * (2 * 4 * 128 * 4 + 2 * 2 * 32 * 128) + 8
    assert flops.least_time(1e12, 0, "bfloat16") == pytest.approx(1 / 989)
    assert flops.least_time(0, 3.35e12, "float32") == pytest.approx(1.0)
