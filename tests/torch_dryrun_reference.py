"""The JAX package's dry-run of small cells, for
``tests/test_torch_dryrun.py``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_dryrun_reference.py \\
        OUT_JSON

``repro.launch.dryrun`` forces 512 host devices when it is imported, so
this runs in a process of its own. For each case of ``CASES`` (a reduced
config and a small input shape) on a (1, 1) and a (2, 2) mesh of four of
those devices, ``_build_cell_traced`` is lowered and compiled as the
reference's ``run_cell`` does; the JSON file holds, per case and mesh, the
compiled module's ``memory_analysis()`` argument bytes, ``parse_hlo``'s dot
FLOPs and collectives, and each argument leaf's per-device bytes.
"""
import json
import sys
import time

import numpy as np

from repro.launch import dryrun  # noqa: F401  (forces the host devices)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.analysis import roofline as rl  # noqa: E402
from repro.configs import InputShape, get_config, reduced  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402

# (arch, kind, seq, batch): dense in every kind, the MoE, the SSM and the
# encoder-decoder in training
CASES = (("qwen2-0.5b", "train", 32, 4), ("qwen2-0.5b", "prefill", 32, 4),
         ("qwen2-0.5b", "decode", 32, 4),
         ("granite-moe-1b-a400m", "train", 32, 4),
         ("mamba2-1.3b", "train", 32, 4),
         ("seamless-m4t-large-v2", "train", 32, 4))
MESHES = ((1, 1), (2, 2))


def shape_of(kind, seq, batch):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    return InputShape(name, seq, batch, kind)


def case_key(arch, kind, mesh):
    return f"{arch}/{kind}/{mesh[0]}x{mesh[1]}"


def main(out_path):
    devices = jax.devices()
    out = {}
    t0 = time.time()
    for arch, kind, seq, batch in CASES:
        cfg = reduced(get_config(arch))
        shape = shape_of(kind, seq, batch)
        mode = {"train": "train", "prefill": "prefill",
                "decode": "serve"}[kind]
        for m in MESHES:
            mesh = Mesh(np.array(devices[:m[0] * m[1]]).reshape(m),
                        ("data", "model"))
            rules = shd.make_rules(cfg, mesh, mode)
            with shd.activation_sharding(mesh, rules):
                fn, args = dryrun._build_cell_traced(
                    cfg, shape, mesh, rules, moe_impl="gather",
                    microbatches=1, serve_dtype=jax.numpy.bfloat16)
                lowered = fn.lower(*args)
            compiled = lowered.compile()
            ma = compiled.memory_analysis()
            hstats = rl.parse_hlo(compiled.as_text())
            out[case_key(arch, kind, m)] = {
                "argument_size_in_bytes": int(ma.argument_size_in_bytes),
                "dot_flops": hstats.dot_flops,
                "collectives": hstats.collectives.counts,
            }
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(f"{len(out)} cases in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1])
