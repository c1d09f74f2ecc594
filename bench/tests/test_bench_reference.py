"""The plain reference against the program at reduced sizes on the CPU:
logits, loss and every gradient leaf, and an AdamW step. (In the test
only: the reference itself imports nothing of the program.)"""
import pytest
import torch

from bench import program, spec, weights
from bench.reference import adamw
from bench.reference import model as ref
from bench.tests import tiny


def _setup(dims, name):
    init = spec._json(spec.ROOT / "bench" / "configs" / name)["init"]
    cfg = dict(dims, init=init)
    bundle = program.build(cfg)
    w = weights.make(program.param_shapes(bundle), init, 4242, "cpu")
    return cfg, bundle, w


CASES = [(tiny.DENSE, "codeqwen1.5-7b.json"),
         (tiny.MOE, "granite-moe-1b-a400m.json")]


@pytest.mark.parametrize("dims,name", CASES, ids=["dense", "moe"])
def test_forward_matches_the_program(dims, name):
    from repro_torch.models import transformer
    cfg, bundle, w = _setup(dims, name)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 37),
                           generator=torch.Generator().manual_seed(1))
    got = transformer.forward(program.nest(w), bundle.cfg, tokens,
                              dtype=torch.float32)
    want = ref.forward(w, cfg, tokens)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dims,name", CASES, ids=["dense", "moe"])
def test_loss_and_gradients_match_the_program(dims, name):
    cfg, bundle, w = _setup(dims, name)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(2))
    leaves = {p: t.clone().requires_grad_() for p, t in w.items()}
    got = bundle.loss_fn(program.nest(leaves), {"tokens": tokens},
                         dtype=torch.float32, remat=True)
    got_g = torch.autograd.grad(got, list(leaves.values()))
    want = ref.loss(leaves, cfg, tokens)
    want_g = torch.autograd.grad(want, list(leaves.values()))
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                                rel=1e-6)
    for p, a, b in zip(leaves, got_g, want_g):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-4), p


def test_moe_drops_past_capacity():
    """Skewed routing overflows experts: the reference keeps the first
    ``capacity`` assignments of each expert in (token, k) order."""
    cfg, bundle, w = _setup(tiny.MOE, "granite-moe-1b-a400m.json")
    w = dict(w)
    bias = torch.zeros_like(w["layers/ffn/router/w"])
    bias[..., 0] = 5.0
    w["layers/ffn/router/w"] = w["layers/ffn/router/w"] + bias
    tokens = torch.randint(0, 512, (1, 64),
                           generator=torch.Generator().manual_seed(3))
    from repro_torch.models import transformer
    got = transformer.forward(program.nest(w), bundle.cfg, tokens,
                              dtype=torch.float32)
    assert ref.capacity(64, cfg) == 24
    assert torch.allclose(got, ref.forward(w, cfg, tokens), atol=2e-5,
                          rtol=1e-4)


def test_adamw_step_matches_the_program():
    from repro_torch.training import optimizer as opt_mod
    mix = tiny.TRAIN["optimizer"]
    g = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(7, 3, generator=g),
              "b": torch.randn(11, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in
             params.items()}
    state = opt_mod.init_state(params)
    cfg = opt_mod.AdamWConfig(**mix)
    want_p, want_s = dict(params), state
    for _ in range(3):
        want_p, want_s, _ = opt_mod.apply_updates(cfg, want_p, grads, want_s)
    got = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in got.items()}
    v = {k: torch.zeros_like(t) for k, t in got.items()}
    for n in range(1, 4):
        adamw.step(mix, got, grads, m, v, n)
    for k in params:
        assert torch.allclose(got[k], want_p[k], atol=1e-7, rtol=1e-6)
        assert torch.allclose(m[k], want_s["m"][k], rtol=1e-6)
