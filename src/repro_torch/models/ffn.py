"""Feed-forward mixer of the dense family: SwiGLU. (MoE is a later slice.)"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def swiglu_init(generator, d_model, d_ff, *, lead=(), device="cuda",
                dtype=torch.float32):
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "gate": cm.dense(generator, d_model, d_ff, **kw),
        "up": cm.dense(generator, d_model, d_ff, **kw),
        "down": cm.dense(generator, d_ff, d_model, **kw),
    }


def swiglu(p, x):
    g = cm.apply_dense(p["gate"], x)
    u = cm.apply_dense(p["up"], x)
    return cm.apply_dense(p["down"], F.silu(g) * u)
