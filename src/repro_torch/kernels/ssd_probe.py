"""Timing probes of the ssd_scan kernel on one CUDA card: where a chunk's
cycles go, and what sharing the scores C B^T across a head's four P blocks
(through a thread-block cluster) would save.

    python3 src/repro_torch/kernels/ssd_probe.py

Builds ``csrc/ssd_scan.cu`` five ways into ``build/probe/`` (one ``nvcc``
each, all started together): as shipped; with ``SSD_STAMPS``; with
``SSD_SHARE=1`` (each block forms only its quarter of the score columns);
with ``SSD_SHARE=2`` (that, plus sending the quarter to the other three
blocks of a cluster of 4 and a cluster barrier a chunk); and ``SSD_SHARE=2``
with stamps. The shared variants' y is wrong: they time the work of that
design, they do not compute it. Times the shipped and shared builds at
mamba2-1.3b's heads (B = 1, H = 64, P = 64, N = 128, G = 1, fp32) at S = 96
and 2048 in turns (shipped, share1, share2, share2, share1, shipped), device
ms per call as ``bench_ab.py`` times them (20 calls in a CUDA graph, CUDA
events). Reads the stamps of block (0, 0, 0) at S = 2048 and reports each
phase's median cycles over chunks 1 .. 30. Prints one JSON line: the
times, the stamps, each build's registers and ptxas warnings, and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from statistics import median
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bench_ab import SSM_HEADS, cuda_ms  # noqa: E402

VARIANTS = {
    "shipped": (),
    "stamps": ("-DSSD_STAMPS",),
    "share1": ("-DSSD_SHARE=1",),
    "share2": ("-DSSD_SHARE=2",),
    "share2_stamps": ("-DSSD_SHARE=2", "-DSSD_STAMPS"),
}
TIMED = ("shipped", "share1", "share2")
# phase k ends at stamp k of a chunk (STAMP(k) in the kernel)
PHASES = ("inputs landed [R]", "B, dx^T staged [A]", "score k-steps issued",
          "state operands built, scores landed",
          "sums swapped [E] (+ exchange)",
          "mask, M dx issued, state and M dx landed",
          "state^T, y written [B] [C]")


def build():
    """{variant: (library path, registers per instance, ptxas warnings)}."""
    out_dir = _build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"libssd_scan_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
               str(_build.CSRC / "ssd_scan.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        warns = sorted({ln.strip() for ln in log.splitlines()
                        if "warning" in ln.lower() or "spill stores" in ln
                        and not ln.strip().startswith("0 bytes")})
        built[name] = (lib, regs, warns)
    return built


def inputs(s):
    import torch
    gen = torch.Generator("cuda").manual_seed(s)
    h, p, n, g = SSM_HEADS

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    dx, B, C = rn(1, s, h, p), rn(1, s, g, n), rn(1, s, g, n)
    return dx, -rn(1, s, h).abs() * 0.2, B, C


def stamps(lib, ssd, args):
    """Median cycles of each phase, and of a whole chunk, over chunks 1 ..
    30 of the last call, and each phase's share of the chunk."""
    import torch
    with mock.patch.object(ssd, "_lib", lambda: lib):
        ssd.ssd_scan(*args)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (64 * 8))()
    err = lib.ssd_scan_stamps(buf)
    if err:
        raise RuntimeError(f"reading the stamps failed: CUDA error {err}")
    st = [list(buf[8 * c:8 * c + 8]) for c in range(64)]
    chunks = range(1, 31)
    out = {"chunk_cycles": median(st[c + 1][0] - st[c][0] for c in chunks)}
    for k, phase in enumerate(PHASES, start=1):
        cyc = median(st[c][k] - st[c][k - 1] for c in chunks)
        out[phase] = {"cycles": cyc,
                      "share": cyc / out["chunk_cycles"]}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ssd_scan as ssd
    built = build()
    libs = {name: ssd.bind(ctypes.CDLL(str(lib)))
            for name, (lib, _, _) in built.items()}
    for name in ("stamps", "share2_stamps"):
        libs[name].ssd_scan_stamps.argtypes = [
            ctypes.POINTER(ctypes.c_longlong)]
    out = {"builds": {n: {"registers": r, "warnings": w}
                      for n, (_, r, w) in built.items()}}
    for s in (96, 2048):
        args = inputs(s)
        turns = {name: [] for name in TIMED}
        for name in TIMED + TIMED[::-1]:
            with mock.patch.object(ssd, "_lib", lambda lib=libs[name]: lib):
                turns[name].append(cuda_ms(lambda: ssd.ssd_scan(*args)))
        out[f"S={s}"] = {name: {"ms": sum(t) / len(t), "turns": t}
                         for name, t in turns.items()}
    args = inputs(2048)
    out["stamps S=2048"] = {name: stamps(libs[name], ssd, args)
                            for name in ("stamps", "share2_stamps")}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
