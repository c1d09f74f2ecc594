"""Time the port's flash_attention (forward and backward), cosine_matrix,
rowwise_cosine, decode_attention and ssd_scan (forward and backward) kernels
of two source trees on one CUDA card, in turns: A, B, B, A.

    python3 src/repro_torch/kernels/bench_ab.py --a OLD_ROOT --b NEW_ROOT

Each root is a checkout of this repository (``git archive <commit>``
unpacked into a directory that .gitignore lists, for instance). Every turn
is a fresh process that builds and imports that root's ``repro_torch`` and
prints one JSON line: device ms per call (20 calls in a CUDA graph, timed
with CUDA events) at the paths' shapes and long ones, the same for one
PyTorch call computing the function (SDPA, ``torch.matmul``, ``torch.mv``;
none computes the SSD scan), and the wrapper's host time per call (mean of
200 calls, no synchronisation between them) at the paths' shapes. The flash
backward is timed at the training shapes (qwen2-0.5b's heads, B = 8,
S = 512, bf16; the rewriter's, B = 16, S = 384, fp32), the SSD scan's
backward (``ssd_scan_backward``, as training calls it) at mamba2-1.3b's
training shape (B = 8, S = 512) in bf16 and fp32 and hymba-1.5b's (B = 2,
S = 2048, 50 heads, N = 16) in bf16, and ``rowwise_cosine`` at a 16-row
morsel and the 18,891-row game table, warm and with L2 cold (8 copies of
the rows in turn). The last line is a JSON
summary: the mean of each number over each root's two turns, and the
card's name and power limit.

    python3 src/repro_torch/kernels/bench_ab.py --a OLD --b NEW \
        --pairs 10 --host-only

``--pairs N`` runs N pairs of turns, A B then B A in turn (A, B, B, A,
A, B, ...), and the summary adds, per number, each pair's B - A and their
median; ``--host-only`` times only the host time a call: the wrappers',
the attention calls through ``kernels.ops`` as the models make them, and
each piece of a call alone ("part ...": the fake-tensor test, the
dispatch-mode test of ``_build.call``, an empty log-sum-exp tensor,
decode's lengths built as ``ops`` built them, flash's input checks);
``--serve ARCH,...`` times, in place of the kernels, each arch served at
full width as ``chip_smoke.py``'s serve phases serve it (8 requests, 4
slots, 24 new tokens; ``launch.serve.serve_tokens``): new tok/s, prefill
and decode seconds of the second of two runs in the turn (the first
builds the kernels and warms the allocator). ``--profile`` (with
``--serve``) runs that second run under ``cProfile`` and adds its 30
functions of most host time of their own, with their calls and µs a
decode tick.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HEADS = (14, 2, 64)  # qwen2-0.5b at full width
SSM_HEADS = (64, 64, 128, 1)  # mamba2-1.3b: H, P, N, G
HYMBA_SSM_HEADS = (50, 64, 16, 1)  # hymba-1.5b's SSM heads
# decode steps: chip_smoke's, 4 slots of a 160-entry cache midway through
# their 24 new tokens (the served prompts of 89, 63, 67 and 71 tokens, + 12),
# and 32 slots of a 4096-entry cache filled to 128, 256, ..., 4096
DECODE = ((160, (101, 75, 79, 83)), (4096, tuple(range(128, 4097, 128))))


# --host-only: no device times (``cuda_ms`` returns None)
HOST_ONLY = False
# --profile: the second serve run of a turn under cProfile
PROFILE = False
# --serve: chip_smoke.py's serve flags, after --arch
SERVE_FLAGS = ["--no-reduced", "--requests", "8", "--slots", "4",
               "--max-len", "160", "--max-new", "24", "--device", "cuda"]


def cuda_ms(fn, reps=20):
    if HOST_ONLY:
        return None
    import torch
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


def host_us(fn, calls=200):
    fn()
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def one_turn(root):
    """Times of ``root``'s kernels; returns a dict."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import similarity as sim
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    out = {"root": root}
    hq, hkv, d = HEADS
    for dtype in (torch.float32, torch.bfloat16):
        for s in (96, 2048):
            def rn(*shape):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * 0.5).to(dtype)
            q, k, v = rn(1, s, hq, d), rn(1, s, hkv, d), rn(1, s, hkv, d)
            kw = dict(causal=True, window=0, q_offset=0, sk_valid=s)
            name = f"flash {str(dtype)[6:]} S={s}"
            out[name] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
            out[name + " sdpa"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True))
            if s == 96:
                out[name + " host_us"] = host_us(
                    lambda: fa.flash_attention(q, k, v, **kw))
                out[name + " ops host_us"] = host_us(
                    lambda: ops.flash_attention(q, k, v))
    for dtype in (torch.float32, torch.bfloat16):
        for m in (16, 250, 4096):
            x = torch.randn(m, 256, generator=gen, device="cuda")
            a = (x / x.norm(dim=1, keepdim=True)).to(dtype)
            name = f"cosine {str(dtype)[6:]} {m}x{m}x256"
            out[name] = cuda_ms(lambda: sim.cosine_matrix(a, a))
            out[name + " matmul"] = cuda_ms(lambda: torch.matmul(a, a.T))
            if m == 250 and dtype == torch.float32:
                out[name + " host_us"] = host_us(
                    lambda: sim.cosine_matrix(a, a))
    time_decode(out, gen)
    time_ssd(out, gen)
    if HOST_ONLY:
        time_host_parts(out, gen)
    else:
        time_ssd_bwd(out, gen)
        time_backward(out, gen)
        time_rowwise(out, gen)
    return {k: v for k, v in out.items() if v is not None}


def serve_turn(root, archs):
    """Each arch served twice from ``root``; the second run's numbers."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.launch import serve
    out = {"root": root}
    for arch in archs:
        args = serve.build_parser().parse_args(["--arch", arch]
                                               + SERVE_FLAGS)
        serve.serve_tokens(args)
        if PROFILE:
            import cProfile
            prof = cProfile.Profile()
            finished, engine, seconds = prof.runcall(serve.serve_tokens,
                                                     args)
            out[f"serve {arch} profile"] = top_functions(
                prof, engine.stats["decode_steps"])
        else:
            finished, engine, seconds = serve.serve_tokens(args)
        new = sum(len(r.output_ids) for r in finished.values())
        out[f"serve {arch} tok_per_s"] = new / seconds
        for key in ("prefill_s", "decode_s"):
            out[f"serve {arch} {key}"] = engine.stats[key]
        del engine
    return out


def top_functions(prof, ticks, n=30):
    """The ``n`` functions of most host time of their own in a cProfile
    run: [file:line:name, calls a tick, µs of their own a tick]."""
    import pstats
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    ticks = max(1, ticks)
    return [[f"{os.path.basename(f)}:{line}:{name}", nc / ticks,
             tt / ticks * 1e6] for (f, line, name), (_, nc, tt, _, _) in top]


def time_backward(out, gen):
    """flash_attention_backward from the forward kernel's output and
    log-sum-exp at the training shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    for (hq, hkv, d), b, s, dtype in ((HEADS, 8, 512, torch.bfloat16),
                                      ((4, 2, 32), 16, 384, torch.float32)):
        def rn(*shape):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * 0.5).to(dtype)
        q, k, v, dout = rn(b, s, hq, d), rn(b, s, hkv, d), rn(b, s, hkv, d), \
            rn(b, s, hq, d)
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        name = f"flash_bwd {str(dtype)[6:]} B={b} S={s} {hq}/{hkv}x{d}"
        out[name] = cuda_ms(
            lambda: fa.flash_attention_backward(q, k, v, o, dout, lse))


def time_rowwise(out, gen, m=18891, copies=8):
    """rowwise_cosine (fp32) of unit rows against one anchor row: a 16-row
    morsel, the game table warm, and the game table with L2 cold
    (``copies`` sets of rows, 8 x 19.3 MB, taken in turn)."""
    import torch
    from repro_torch.kernels import similarity as sim

    def unit(n):
        x = torch.randn(n, 256, generator=gen, device="cuda")
        return x / x.norm(dim=1, keepdim=True)
    anchor = unit(1)[0]
    for rows in (16, m):
        a = unit(rows)
        out[f"rowwise M={rows}"] = cuda_ms(lambda: sim.rowwise_cosine(a, anchor))
        out[f"rowwise M={rows} mv"] = cuda_ms(lambda: torch.mv(a, anchor))
    sets = [unit(m) for _ in range(copies)]
    turn = [0]

    def cycling(fn):
        def call():
            fn(sets[turn[0] % copies], anchor)
            turn[0] += 1
        return call
    out[f"rowwise M={m} cold"] = cuda_ms(cycling(sim.rowwise_cosine),
                                         reps=4 * copies)
    out[f"rowwise M={m} cold mv"] = cuda_ms(cycling(torch.mv),
                                            reps=4 * copies)


def time_decode(out, gen):
    """decode_attention (fp32, the engine's dtype) at DECODE's steps, the
    caches read as slices of a layer-stacked tensor as the model reads them;
    SDPA with a boolean mask beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    hq, hkv, d = HEADS
    for s, cache_len in DECODE:
        b = len(cache_len)

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda") * 0.5
        q, kc, vc = rn(b, 1, hq, d), rn(2, b, s, hkv, d)[1], \
            rn(2, b, s, hkv, d)[1]
        lens = torch.tensor(cache_len, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        name = f"decode float32 B={b} S={s}"
        out[name] = cuda_ms(lambda: dec.decode_attention(q, kc, vc, lens))
        out[name + " sdpa"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True))
        if s == 160:
            out[name + " host_us"] = host_us(
                lambda: dec.decode_attention(q, kc, vc, lens))
            out[name + " ops host_us"] = host_us(
                lambda: ops.decode_attention(q, kc, vc, lens))


def time_host_parts(out, gen, calls=20000):
    """Host µs a call of each piece of a serving call alone, at the serve
    shapes: ``_build.is_fake``, the dispatch-mode test, ``_build.call``
    around a call that does nothing, an empty (0,) fp32 tensor (what the
    flash forward's op returned for no log-sum-exp), decode's (B,) int32
    lengths built from a tick's as ``ops`` built them on every call, and
    the flash wrapper's input checks."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, d = HEADS
    q = torch.randn(1, 96, hq, d, generator=gen, device="cuda")
    k = torch.randn(1, 96, hkv, d, generator=gen, device="cuda")
    lens = torch.tensor(DECODE[0][1], dtype=torch.int32, device="cuda")

    def nothing(*args):
        return None
    parts = {
        "is_fake": lambda: _build.is_fake(q),
        "dispatch_mode": _get_current_dispatch_mode,
        "call": lambda: _build.call(None, nothing, q),
        "empty_lse": lambda: q.new_empty((0,), dtype=torch.float32),
        "decode_lens": lambda: torch.as_tensor(
            lens, dtype=torch.int32, device=q.device).reshape(-1).expand(
                lens.shape[0]).contiguous(),
        "flash_checks": lambda: fa._check_inputs(q, k, k),
    }
    for name, fn in parts.items():
        out[f"part {name} host_us"] = host_us(fn, calls=calls)


def time_ssd(out, gen):
    """ssd_scan (fp32) of one sequence at mamba2-1.3b's heads, at the
    served prefill's S = 96 and at S = 2048."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    h, p, n, g = SSM_HEADS
    for s in (96, 2048):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        dx, B, C = rn(1, s, h, p), rn(1, s, g, n), rn(1, s, g, n)
        dA = -rn(1, s, h).abs() * 0.2
        name = f"ssd_scan float32 S={s}"
        out[name] = cuda_ms(lambda: ssd.ssd_scan(dx, dA, B, C))
        if s == 96:
            out[name + " host_us"] = host_us(
                lambda: ssd.ssd_scan(dx, dA, B, C))


def time_ssd_bwd(out, gen):
    """ssd_scan_backward as training calls it (no initial state, the final
    state unused) at the training shapes."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    for (h, p, n, g), b, s, dtype in (
            (SSM_HEADS, 8, 512, torch.bfloat16),
            (HYMBA_SSM_HEADS, 2, 2048, torch.bfloat16),
            (SSM_HEADS, 8, 512, torch.float32)):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        dx, B, C = (rn(b, s, h, p).to(dtype), rn(b, s, g, n).to(dtype),
                    rn(b, s, g, n).to(dtype))
        dA, dy = -rn(b, s, h).abs() * 0.2, rn(b, s, h, p).to(dtype)
        name = f"ssd_scan_bwd {str(dtype)[6:]} B={b} S={s} H={h} N={n}"
        out[name] = cuda_ms(
            lambda: ssd.ssd_scan_backward(dx, dA, B, C, None, dy))


def main():
    global HOST_ONLY, PROFILE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="first root")
    ap.add_argument("--b", help="second root")
    ap.add_argument("--one", help="time this root in this process")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of turns (A B, then B A, in turn)")
    ap.add_argument("--host-only", action="store_true",
                    help="only the wrappers' host time a call")
    ap.add_argument("--serve", default="",
                    help="archs to serve, comma-separated, in place of "
                         "the kernels")
    ap.add_argument("--profile", action="store_true",
                    help="with --serve: the second run under cProfile")
    args = ap.parse_args()
    HOST_ONLY, PROFILE = args.host_only, args.profile
    if args.one:
        root = os.path.abspath(args.one)
        line = (serve_turn(root, args.serve.split(",")) if args.serve
                else one_turn(root))
        print(json.dumps(line), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_ab: no CUDA device")
    order = [(args.a, args.b) if i % 2 == 0 else (args.b, args.a)
             for i in range(args.pairs)]
    by_root = {"a": [], "b": []}
    for pair in order:
        for root in pair:
            cmd = [sys.executable, os.path.abspath(__file__), "--one",
                   os.path.abspath(root)]
            if args.host_only:
                cmd.append("--host-only")
            if args.serve:
                cmd += ["--serve", args.serve]
            if args.profile:
                cmd.append("--profile")
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=True)
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            by_root["a" if root == args.a else "b"].append(line)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": smi, "pairs": args.pairs}
    for tag, turns in by_root.items():
        summary[tag] = {key: sum(t[key] for t in turns) / len(turns)
                        for key, value in turns[0].items()
                        if isinstance(value, (int, float))}
        summary[tag]["root"] = turns[0]["root"]
    if args.pairs > 2:
        diffs = {key: sorted(b[key] - a[key] for a, b in
                             zip(by_root["a"], by_root["b"]))
                 for key in summary["a"] if key != "root"}
        summary["b_minus_a"] = {key: {"median": (d[(len(d) - 1) // 2]
                                                 + d[len(d) // 2]) / 2,
                                      "per_pair": d}
                                for key, d in diffs.items()}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
