"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and the script exits
non-zero):

1. environment: the card's name and power limit; TF32 off.
2. build: nvcc builds the port's CUDA kernels from ``src/repro_torch/csrc``,
   one process per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card, in
   fp32 and bf16. The attention kernels run over qwen2-0.5b's heads (14
   query over 2 KV, head_dim 64; reduced: 4 over 2, head_dim 16) at every
   prefill length the serve and semantic phases give them (16 to 160) and
   at longer ones; ``rowwise_cosine`` over 256-wide unit rows at 1 to 18891
   rows (the whole ``game`` table), against full rows and against one
   anchor row. Then each kernel's time at its path's shapes beside the
   plain version's, one PyTorch library call's
   (``scaled_dot_product_attention``; ``torch.mv`` for the cosine) and the
   card's bound for the same work.
4. serve: full-width qwen2-0.5b (24 layers, d_model 896, vocab 151936, seeded
   random weights) serves 8 requests through ``GenerationEngine`` and
   ``ContinuousBatcher``; every prefill must launch ``flash_attention`` once
   per layer and every decode tick ``decode_attention`` once per layer.
5. cross-check: one prompt's prefill logits on the card (kernels) against the
   same weights on the CPU (plain path), fp32.
6. profile: torch.profiler over 4 more requests on the served engine; the
   card's busy and idle share and its time by kind of kernel.
7. semantic: ``serve --semantic movie --serve 4 --cascade --no-reduced``
   (q1-q4 over 32 rows; m1 is full-width qwen2-0.5b, the cascade scores
   every filter morsel with ``rowwise_cosine``). Every query must finish;
   ``rowwise_cosine`` must launch once per ``tier0-embed`` call and the
   attention kernels once per layer per prefill and decode tick. The same
   queries then run reduced on the CPU: per-query results, per-tier calls
   and cascade stats must be equal. Then the single-query mode (q1, m1
   only), and the streaming run once more under torch.profiler for the
   card's idle share.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest
of the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Dense peaks of the H100 SXM (NVIDIA data sheet): device memory bytes/s and
# FLOP/s by input type. fp32 is the CUDA-core rate: the kernels run fp32
# FMAs, not TF32 tensor cores.
PEAKS = {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12}
# A kernel's output against its plain version's, element by element:
# |kernel - plain| <= atol + rtol * |plain|. Both compute in fp32 and round
# the output once. In fp32 only the order of the sums differs (~1e-7 at these
# magnitudes). In bf16 the two fp32 results round at most one bf16 step
# apart, and a step is at most 2^-7 |x|; so the limit follows each element,
# and a kernel that drops or double-counts keys fails even where the outputs
# are ~0.01 (long rows over 0.5 * randn values).
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
LOGITS_ATOL = 1e-3
N_LAYERS = 24
# rowwise_cosine: the embedding width (core.semhash.DIM) and the row counts
# it is checked at: a morsel at --slots 4 is 16 rows, and 18891 rows is the
# whole game table, the largest cascade pass these datasets give.
EMBED_DIM = 256
COSINE_ROWS = (1, 16, 127, 133, 18891)
SEMANTIC = ["--semantic", "movie", "--slots", "4", "--requests", "8"]
STREAMING = SEMANTIC + ["--serve", "4", "--cascade"]
# (Hq, Hkv, D) of qwen2-0.5b at full width (what chip_smoke serves) and
# reduced (the serve launcher's default): one case per head_dim the kernels
# are built for.
FULL_HEADS, REDUCED_HEADS = (14, 2, 64), (4, 2, 16)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=20):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph (no host launch overhead between them), replayed and timed with
    CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def held(got, want, dtype):
    """(max |got - want|, whether every element is within TOL[dtype])."""
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= atol + rtol * want.abs()).all())


def tol_text(dtype):
    atol, rtol = TOL[dtype]
    return f"{atol} + {rtol} * |plain|" if rtol else f"{atol}"


def served_prefill_lengths():
    """Prompt lengths, padded for prefill, of the serve phase's requests."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.engine.engine import PREFILL_ALIGN
    from repro_torch.launch.serve import DEMO_PROMPTS
    tok = ByteTokenizer()
    lens = [len(tok.encode(DEMO_PROMPTS[i % len(DEMO_PROMPTS)] + f" [{i}]"))
            for i in range(8)]
    return lens, sorted({-(-n // PREFILL_ALIGN) * PREFILL_ALIGN for n in lens})


def phase_environment():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); nothing was run")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "environment", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})
    if "H100" not in name or "HBM3" not in name:
        raise RuntimeError(f"{name}: the kernels target the H100 SXM and the "
                           f"bounds use its peaks")
    return name


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    seconds = time.perf_counter() - t0
    regs = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs[name] = sorted({int(l.split("Used ")[1].split()[0])
                             for l in lines if "Used " in l})
    emit({"phase": "build", "seconds": seconds,
          "libraries": [str(p.relative_to(ROOT)) for p in paths.values()],
          "registers_per_thread": regs})


def attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=1):
    """q (b, s, hq, d) and k/v slices of a layer-stacked (layers, b, s, hkv,
    d) tensor, read in place as the model reads its cache."""
    def rn(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(dtype)
    return rn(b, s, hq, d), rn(layers, b, s, hkv, d)[-1], rn(layers, b, s, hkv, d)[-1]


def flash_cases():
    """(heads, case, B, S, causal, window): qwen2-0.5b's heads at every
    prefill length the serve and semantic phases give the kernel (prompts
    pad to a multiple of PREFILL_ALIGN = 16 and are cut at max_len 160, so
    16 to 160; the serve phase's are 64, 80 and 96) and at the sweep's
    shapes; the reduced heads at a few of them."""
    full = [("causal", 1, s, True, 0) for s in range(16, 161, 16)]
    full += [("causal", 1, 2048, True, 0),
             ("padded", 2, 40, True, 0), ("window", 1, 160, True, 24),
             ("noncausal", 1, 160, False, 0),
             ("noncausal_window", 1, 160, False, 24)]
    small = [("causal", 1, 96, True, 0), ("padded", 2, 40, True, 0),
             ("window", 1, 160, True, 24), ("noncausal_window", 1, 160, False, 24)]
    return ([(FULL_HEADS, *c) for c in full]
            + [(REDUCED_HEADS, *c) for c in small])


DECODE_CASES = [(FULL_HEADS, b, s) for b in (4, 32) for s in (160, 4096)] \
    + [(REDUCED_HEADS, 4, 160)]


def phase_kernels():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(0)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for (hq, hkv, d), case, b, s, causal, window in flash_cases():
            q, k, v = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=2)
            kw = dict(causal=causal, window=window, q_offset=0, sk_valid=s)
            err, ok = held(fa.flash_attention(q, k, v, **kw),
                           fa.plain(q, k, v, **kw), dtype)
            emit({"phase": "kernel", "kernel": "flash_attention", "case": case,
                  "dtype": str(dtype), "B": b, "S": s, "Hq": hq, "Hkv": hkv,
                  "D": d, "window": window, "max_abs_err": err,
                  "tol": tol_text(dtype), "ok": ok})
            if not ok:
                failures.append(("flash_attention", case, str(dtype), s, d, err))
        for (hq, hkv, d), b, s in DECODE_CASES:
            q, kc, vc = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=2)
            q = q[:, :1]
            lens = torch.randint(1, s + 1, (b,), generator=gen,
                                 device="cuda").to(torch.int32)
            lens[0], lens[1], lens[2] = 1, s, 0
            got = dec.decode_attention(q, kc, vc, lens)
            err, ok = held(got, dec.plain(q, kc, vc, lens), dtype)
            zero = got[2].abs().max().item()
            ok = ok and zero == 0.0
            emit({"phase": "kernel", "kernel": "decode_attention",
                  "case": "ragged", "dtype": str(dtype), "B": b, "S": s,
                  "Hq": hq, "Hkv": hkv, "D": d,
                  "cache_len": lens.tolist()[:8], "max_abs_err": err,
                  "zero_len_row_max": zero, "tol": tol_text(dtype), "ok": ok})
            if not ok:
                failures.append(("decode_attention", str(dtype), b, s, d, err))
        check_rowwise(gen, dtype, failures)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return time_kernels(gen)


def unit_rows(gen, m, dtype):
    """m random rows of EMBED_DIM, L2-normalized, as the embedder gives."""
    x = torch.randn(m, EMBED_DIM, generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def check_rowwise(gen, dtype, failures):
    """rowwise_cosine against its plain version at every COSINE_ROWS, with
    b as full rows and as one (D,) anchor; M = 0 gives (0,) and no launch."""
    from repro_torch.kernels import similarity as sim
    for m in COSINE_ROWS:
        a, b = unit_rows(gen, m, dtype), unit_rows(gen, m, dtype)
        for case, other in (("rows", b), ("anchor", b[0])):
            err, ok = held(sim.rowwise_cosine(a, other),
                           sim.plain(a, other), dtype)
            emit({"phase": "kernel", "kernel": "rowwise_cosine",
                  "case": case, "dtype": str(dtype), "M": m,
                  "D": EMBED_DIM, "max_abs_err": err, "tol": tol_text(dtype),
                  "ok": ok})
            if not ok:
                failures.append(("rowwise_cosine", case, str(dtype), m, err))
    before = sim.stats["launches"]
    empty = sim.rowwise_cosine(unit_rows(gen, 0, dtype),
                               unit_rows(gen, 1, dtype)[0])
    ok = tuple(empty.shape) == (0,) and sim.stats["launches"] == before
    emit({"phase": "kernel", "kernel": "rowwise_cosine", "case": "empty",
          "dtype": str(dtype), "M": 0, "shape": list(empty.shape),
          "launched": sim.stats["launches"] - before, "ok": ok})
    if not ok:
        failures.append(("rowwise_cosine", "empty", str(dtype)))


KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:69"),
    "rowwise_cosine": dict(
        route="cuda", source="src/repro_torch/csrc/similarity.cu",
        replaces="src/repro/kernels/similarity.py:82"),
}


def time_flash(gen, s, dtype):
    """Causal prefill of one sequence of s tokens: kernel, plain version and
    SDPA timed on the same inputs; the bound counts q, k, v read once, o
    written once and 4 * D FLOPs per causal (query, key) pair."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    hq, hkv, d = FULL_HEADS
    q, k, v = attn_inputs(gen, 1, s, hq, hkv, d, dtype, layers=N_LAYERS)
    kw = dict(causal=True, window=0, q_offset=0, sk_valid=s)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return timing_row(
        "flash_attention", f"B=1 S={s} Hq={hq} Hkv={hkv} D={d} causal", dtype,
        lambda: fa.flash_attention(q, k, v, **kw), lambda: fa.plain(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        nbytes=(2 * s * hq * d + 2 * s * hkv * d) * q.element_size(),
        flops=4 * d * hq * (s * (s + 1) // 2))


def time_decode(gen, s, cache_len, dtype):
    """One decode step over len(cache_len) slots of an s-entry cache slice:
    kernel, plain version and SDPA with a boolean mask on the same inputs;
    the bound counts q, the valid K/V rows and cache_len read once, o
    written once and 4 * D FLOPs per valid (query head, key) pair."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    (hq, hkv, d), b = FULL_HEADS, len(cache_len)
    q, kc, vc = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=N_LAYERS)
    q = q[:, :1].contiguous()
    lens = torch.tensor(cache_len, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    n_valid = sum(cache_len)
    return timing_row(
        "decode_attention", f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
        f"sum(cache_len)={n_valid}", dtype,
        lambda: dec.decode_attention(q, kc, vc, lens),
        lambda: dec.plain(q, kc, vc, lens),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True),
        nbytes=(2 * b * hq * d + 2 * n_valid * hkv * d) * q.element_size()
        + 4 * b, flops=4 * d * hq * n_valid)


def time_rowwise(gen, m):
    """One cascade pass: m unit rows against one anchor row, fp32, as
    EmbeddingBackend.scores gives them to the kernel. The bound counts a
    and the anchor read once, the scores written once and 2 FLOPs per
    element pair; the library call is cuBLAS's GEMV."""
    from repro_torch.kernels import similarity as sim
    a = unit_rows(gen, m, torch.float32)
    anchor = unit_rows(gen, 1, torch.float32)[0]
    return timing_row(
        "rowwise_cosine", f"M={m} D={EMBED_DIM} anchor", torch.float32,
        lambda: sim.rowwise_cosine(a, anchor), lambda: sim.plain(a, anchor),
        lambda: torch.mv(a, anchor),
        nbytes=(m * EMBED_DIM + EMBED_DIM + m) * 4, flops=2 * m * EMBED_DIM)


def timing_row(name, shape, dtype, kernel, plain, library, *, nbytes, flops):
    t_bytes = nbytes / PEAKS["bytes"] * 1e3
    t_ops = flops / PEAKS[str(dtype).split(".")[-1]] * 1e3
    err, ok = held(kernel(), plain(), dtype)
    if not ok:
        raise AssertionError(f"{name} at {shape} {dtype}: max error {err} "
                             f"beyond {tol_text(dtype)}")
    row = dict(name=name, **KERNELS[name], shape=f"{shape} {dtype}",
               max_abs_err=err, ms=cuda_ms(kernel),
               plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit({"phase": "kernel_timing", **row})
    return row


def time_kernels(gen):
    """Times at the serve path's shapes, in fp32 (the engine's dtype):
    prefill of the longest served prompt (96 tokens after padding to 16),
    and a decode step over 4 slots of the 160-entry cache with the slots
    midway through their 24 new tokens; one cascade morsel of 16 rows. These
    rows go into the kernels line. Then times at long shapes, where the
    bound is more than launch latency: a 2048-token prefill (fp32 and
    bf16), a decode step over 32 slots of a 4096-entry cache and a cascade
    pass over the whole game table."""
    lens, padded = served_prefill_lengths()
    rows = [time_flash(gen, max(padded), torch.float32),
            time_decode(gen, 160, [n + 12 for n in lens[:4]], torch.float32),
            time_rowwise(gen, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        time_flash(gen, 2048, dtype)
    time_decode(gen, 4096, list(range(128, 4097, 128)), torch.float32)
    time_rowwise(gen, COSINE_ROWS[-1])
    return rows


def phase_serve(rows):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--no-reduced", "--requests", "8", "--slots", "4", "--max-len", "160",
         "--max-new", "24", "--device", "cuda"])
    ops.reset_launch_counts()
    finished, engine, seconds = serve.serve_tokens(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = engine.stats
    lats = sorted(r.done_s - r.submitted_s for r in finished.values())
    new_toks = sum(len(r.output_ids) for r in finished.values())
    emit({"phase": "serve", "arch": engine.bundle.cfg.name,
          "n_layers": engine.bundle.cfg.n_layers,
          "d_model": engine.bundle.cfg.d_model,
          "vocab": engine.bundle.cfg.vocab_size, "requests": len(finished),
          "seconds": seconds, "new_tokens": new_toks,
          "new_tok_per_s": new_toks / seconds,
          "p50_s": float(np.percentile(lats, 50)),
          "p99_s": float(np.percentile(lats, 99)),
          "occupancy": engine.occupancy, "prefills": st["prefills"],
          "decode_steps": st["decode_steps"], "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "launches": counts})
    if len(finished) != 8 or not all(r.output_ids for r in finished.values()):
        raise AssertionError("not every request finished with output")
    want = {"flash_attention": N_LAYERS * st["prefills"],
            "decode_attention": N_LAYERS * st["decode_steps"],
            "rowwise_cosine": 0}
    if counts != want or not (counts["flash_attention"]
                              and counts["decode_attention"]):
        raise AssertionError(f"launch counts {counts}, expected {want}")
    for r in rows:
        if r["name"] in ("flash_attention", "decode_attention"):
            r["launches"] = counts[r["name"]]
    return engine


def phase_cross_check(engine):
    """Prefill logits of one prompt on the card (kernels) and on the CPU
    (plain path) from the same fp32 weights. Tolerance: sums in another
    order over 24 layers move fp32 logits by ~1e-5; 1e-3 leaves a wide
    margin below any real fault."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.engine.engine import PREFILL_ALIGN
    from repro_torch.launch.serve import DEMO_PROMPTS
    tok = ByteTokenizer()
    ids = tok.pad_batch([tok.encode(DEMO_PROMPTS[0])], align=PREFILL_ALIGN)
    bundle = engine.bundle

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    gpu, _ = bundle.prefill(engine.params,
                            {"tokens": torch.as_tensor(ids, device="cuda")},
                            dtype=torch.float32)
    cpu, _ = bundle.prefill(to_cpu(engine.params),
                            {"tokens": torch.as_tensor(ids)},
                            dtype=torch.float32)
    gpu = gpu.cpu()
    err = max_err(gpu, cpu)
    finite = bool(torch.isfinite(gpu).all())
    same_argmax = int(gpu[0, -1].argmax()) == int(cpu[0, -1].argmax())
    emit({"phase": "cross_check", "tokens": ids.shape[1],
          "logits_shape": list(gpu.shape), "max_abs_err": err,
          "atol": LOGITS_ATOL, "finite": finite,
          "max_abs_logit": gpu.abs().max().item(),
          "argmax_equal": same_argmax})
    if not (finite and err <= LOGITS_ATOL and same_argmax
            and tuple(gpu.shape) == (1, 1, bundle.cfg.vocab_size)):
        raise AssertionError("card and CPU prefill logits disagree")


def profiled(run):
    """Run ``run()`` under torch.profiler and return the card's activity:
    busy time is the union of its kernel and copy intervals; the rest of
    the wall is the card waiting on the host. The device intervals are read
    from the profiler's raw records: building its event tree over the
    semantic run's million kernels would take minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                    e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    by_kind = {"attention kernels": 0.0, "rowwise_cosine": 0.0,
               "matmul": 0.0, "other": 0.0}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        kind = ("attention kernels" if "flash_fwd" in name or "decode_" in name
                else "rowwise_cosine" if "rowwise_kernel" in name
                else "matmul" if "gemm" in name.lower() or "gemv" in name.lower()
                else "other")
        by_kind[kind] += stop - start
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "device_kernels": len(spans)}


def phase_profile(engine):
    """Where serve time goes: torch.profiler over 4 more requests (prefills
    and decode ticks) on the served engine."""
    from repro_torch.engine import ContinuousBatcher
    from repro_torch.launch.serve import DEMO_PROMPTS
    batcher = ContinuousBatcher(engine)
    for i in range(4):
        batcher.submit(DEMO_PROMPTS[i], max_new_tokens=8)
    steps0 = engine.stats["decode_steps"]
    activity = profiled(batcher.run)
    emit({"phase": "profile", "requests": 4,
          "decode_steps": engine.stats["decode_steps"] - steps0, **activity})


def run_semantic(flags):
    """What ``serve --semantic`` runs, keeping the engine and context for
    the checks: returns (query handles, or the one query's result; engine;
    ExecutionContext; host seconds to the card's last work)."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(flags)
    table, cfg, engine, ctx = serve._semantic_context(args)
    drive = serve.serve_queries if args.serve else serve.serve_query
    t0 = time.perf_counter()
    out = drive(args, table, cfg, engine, ctx)
    if args.device == "cuda":
        torch.cuda.synchronize()
    return out, engine, ctx, time.perf_counter() - t0


def query_keys(handles):
    """Per query: (name, result, per-tier calls, cascade stats), the parts
    the card's run and the CPU's must share."""
    keys = []
    for h in handles:
        if not h.done() or h.failed() or h.rejected():
            raise AssertionError(f"query {h.name} did not finish: {h.state}")
        res = h.result()
        value = (("reduce", repr(res.scalar)) if res.is_reduce else
                 {k: list(map(repr, v)) for k, v in
                  sorted(res.table.columns.items())})
        keys.append((h.name, value,
                     {t: u.calls for t, u in sorted(h.meter.by_tier.items())},
                     res.cascade_stats))
    return keys


def attention_launches(engine):
    return {"flash_attention": N_LAYERS * engine.stats["prefills"],
            "decode_attention": N_LAYERS * engine.stats["decode_steps"]}


def phase_semantic(rows):
    """The streaming semantic path on the card at full width, its launch
    counts, and the same queries reduced on the CPU."""
    from repro_torch.core import cost_model
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    handles, engine, ctx, seconds = run_semantic(
        STREAMING + ["--no-reduced", "--device", "cuda"])
    counts = ops.launch_counts()
    keys = query_keys(handles)
    tiers = {t: u.calls for t, u in sorted(ctx.meter.by_tier.items())}
    want = {**attention_launches(engine),
            "rowwise_cosine": tiers.get(cost_model.EMBED_TIER_NAME, 0)}
    lats = [h.latency_s for h in handles]
    emit({"phase": "semantic", "flags": STREAMING + ["--no-reduced"],
          "arch": engine.bundle.cfg.name,
          "n_layers": engine.bundle.cfg.n_layers,
          "d_model": engine.bundle.cfg.d_model, "queries": len(handles),
          "wall_s": seconds,
          "makespan_s": max(h.submitted_s + h.latency_s for h in handles)
          - min(h.submitted_s for h in handles),
          "p50_s": float(np.percentile(lats, 50)),
          "p95_s": float(np.percentile(lats, 95)),
          "latency_s": {h.name: h.latency_s for h in handles},
          "engine": engine.stats, "occupancy": engine.occupancy,
          "tier_calls": tiers,
          "cascade": {k[0]: k[3] for k in keys}, "launches": counts})
    if counts != want or not all(counts.values()):
        raise AssertionError(f"launch counts {counts}, expected {want}")
    cpu_handles, _, cpu_ctx, cpu_seconds = run_semantic(
        STREAMING + ["--reduced", "--device", "cpu"])
    same = query_keys(cpu_handles) == keys
    emit({"phase": "semantic_cpu_check", "flags": STREAMING + ["--reduced"],
          "device": "cpu", "host_s": cpu_seconds,
          "tier_calls": {t: u.calls for t, u in
                         sorted(cpu_ctx.meter.by_tier.items())},
          "equal_to_card": same})
    if not same:
        raise AssertionError("the card's semantic run and the CPU's differ "
                             "in results, per-tier calls or cascade stats")
    for r in rows:
        if r["name"] == "rowwise_cosine":
            r["launches"] = counts["rowwise_cosine"]


def phase_semantic_single():
    """The single-query mode: q1 (a map) on m1 alone, at full width."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    res, engine, ctx, seconds = run_semantic(
        SEMANTIC + ["--no-reduced", "--device", "cuda"])
    counts = ops.launch_counts()
    want = {**attention_launches(engine), "rowwise_cosine": 0}
    emit({"phase": "semantic_single", "flags": SEMANTIC + ["--no-reduced"],
          "rows": res.rows_processed, "wall_s": res.wall_s, "host_s": seconds,
          "tier_calls": {t: u.calls for t, u in ctx.meter.by_tier.items()},
          "engine": engine.stats, "launches": counts})
    if counts != want or not counts["flash_attention"]:
        raise AssertionError(f"launch counts {counts}, expected {want}")


def phase_semantic_profile():
    """The streaming semantic run once more under torch.profiler: the
    card's busy and idle share over the whole run, model build excluded."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        STREAMING + ["--no-reduced", "--device", "cuda"])
    table, cfg, engine, ctx = serve._semantic_context(args)
    activity = profiled(
        lambda: serve.serve_queries(args, table, cfg, engine, ctx))
    emit({"phase": "semantic_profile", "flags": STREAMING + ["--no-reduced"],
          "engine": engine.stats,
          "tier_calls": {t: u.calls for t, u in ctx.meter.by_tier.items()},
          **activity})


def main():
    name = phase_environment()
    phase_build()
    rows = phase_kernels()
    engine = phase_serve(rows)
    phase_cross_check(engine)
    phase_profile(engine)
    phase_semantic(rows)
    phase_semantic_single()
    phase_semantic_profile()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
