"""``adamw_roofline.train``: its parameter count against the port's tree
for each configuration, and its arithmetic on synthetic traces."""
import math

import pytest

from bench import program, spec

CONFIGS = ("codeqwen1.5-7b", "granite-moe-1b-a400m")


def reader():
    return spec.metric_reader("adamw_roofline.train")


def config(name):
    return spec._json(spec.ROOT / "bench" / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_count_is_the_ports(name):
    cfg = config(name)
    shapes = program.param_shapes(program.build(cfg))
    assert reader().params(cfg) == sum(math.prod(s) for s in shapes.values())


def test_known_counts():
    assert reader().params(config("codeqwen1.5-7b")) == 1_568_727_040
    assert reader().params(config("granite-moe-1b-a400m")) == 1_334_628_352


def run(launches, device):
    return {"kind": "train", "cfg": config("codeqwen1.5-7b"), "steps": 10,
            "launches": launches,
            "trace": {"window": (0, 3e6), "spans": [], "device": device}}


DEVICE = [
    (0, 2000, "void (anonymous namespace)::adamw_sumsq_partial("
              "(anonymous namespace)::NormLeaves, double*)"),
    (2000, 2010, "void (anonymous namespace)::adamw_sumsq_finish("
                 "double const*, int, float*)"),
    (2010, 20000, "void (anonymous namespace)::adamw_update("
                  "(anonymous namespace)::UpdateLeaves, float const*, "
                  "float const*, float const*, float const*, "
                  "(anonymous namespace)::Coeffs)"),
    (0, 5000, "void at::native::vectorized_elementwise_kernel<4>"),
    (0, 9000, "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT")]


def test_share_on_a_synthetic_trace():
    got = reader().read(run({"adamw": 20}, DEVICE))
    least_s = 10 * 32 * 1_568_727_040 / 3.35e12
    assert got == pytest.approx(100 * least_s / 20000e-6)


def test_none_without_adamw_launches():
    """The parent's optimizer runs PyTorch's own ops: no ``adamw`` count,
    or a count of 0, reads None and does not raise."""
    assert reader().read(run({"flash_attention": 80}, DEVICE[3:])) is None
    assert reader().read(run({"adamw": 0}, DEVICE[3:])) is None
    assert reader().read({"kind": "serve", "trace": {}}) is None
    assert reader().read(dict(run({"adamw": 20}, DEVICE), trace=None)) \
        is None


def test_raises_when_launches_match_no_kernel():
    with pytest.raises(RuntimeError, match="no device kernel matched"):
        reader().read(run({"adamw": 20}, DEVICE[3:]))
