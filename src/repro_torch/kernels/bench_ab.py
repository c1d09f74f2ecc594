"""Time the port's flash_attention (forward and backward), cosine_matrix,
rowwise_cosine, decode_attention and ssd_scan kernels of two source trees on
one CUDA card, in turns: A, B, B, A.

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
S = 512, bf16; the rewriter's, B = 16, S = 384, fp32) and
``rowwise_cosine`` at a 16-row morsel and the 18,891-row game table, warm
and with L2 cold (8 copies of the rows in turn). The last line is a JSON
summary: the mean of each number over each root's two turns, and the
card's name and power limit.
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
# decode steps: chip_smoke's, 4 slots of a 160-entry cache midway through
# their 24 new tokens (the served prompts of 89, 63, 67 and 71 tokens, + 12),
# and 32 slots of a 4096-entry cache filled to 128, 256, ..., 4096
DECODE = ((160, (101, 75, 79, 83)), (4096, tuple(range(128, 4097, 128))))


def cuda_ms(fn, reps=20):
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
    time_backward(out, gen)
    time_rowwise(out, gen)
    return out


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="first root")
    ap.add_argument("--b", help="second root")
    ap.add_argument("--one", help="time this root in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_turn(os.path.abspath(args.one))), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_ab: no CUDA device")
    turns = []
    for root in (args.a, args.b, args.b, args.a):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(root)], capture_output=True, text=True,
            check=True)
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        turns.append(line)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": smi}
    for tag, pair in (("a", (turns[0], turns[3])), ("b", (turns[1], turns[2]))):
        summary[tag] = {key: (pair[0][key] + pair[1][key]) / 2
                        for key in pair[0] if key != "root"}
        summary[tag]["root"] = pair[0]["root"]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
