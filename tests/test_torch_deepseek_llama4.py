"""The port's deepseek-67b (dense GQA, 64/8 heads of 128) and
llama4-scout-17b-a16e (GQA 40/8 heads of 128, an MoE of 16 experts at
top-1 with a shared expert) against the JAX model and engine, on the same
weights.

Both reduced (2 layers, d_model 64, 4 query over 2 KV heads of 16;
llama4's MoE 4 experts, top-1, a shared expert of 64) with ``PRNGKey(0)``
weights carried over by ``repro_torch.convert``; both sides in fp32. The
port runs the attention kernels' plain versions and the MoE's gather path
in plain PyTorch. Tolerances: 1e-4 absolute on logits and the K/V cache
(sums in another order over two layers); greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from torch_parity import (greedy_engines, model_pair,  # noqa: E402
                          random_tokens, time_limit, to_torch)

ATOL = 1e-4
ARCHS = ["deepseek-67b", "llama4-scout-17b-a16e"]
# (layers, d_model, heads, KV heads, head_dim, d_ff, vocab)
PUBLISHED = {"deepseek-67b": (95, 8192, 64, 8, 128, 22016, 102400),
             "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 8192, 202048)}


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(120):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    whose thread pools would otherwise contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    def value(c, f):  # the MoE config's fields (each package's class)
        v = getattr(c, f)
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attn_type", "rms_eps",
              "rope_theta", "tie_embeddings", "moe"):
        assert value(cfg, f) == value(jcfg, f), f
        assert value(reduced(cfg), f) == value(jreduced(jcfg), f), f
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == PUBLISHED[arch]
    transformer.check_supported(cfg)


@pytest.mark.parametrize("seq", [16, 40])
def test_forward_logits_match(pair, seq):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, seq, seed=seq)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_decode_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, 24, seed=2)
    want, jc = jtransformer.prefill(jparams, jcfg, jnp.asarray(tok),
                                    max_len=32, dtype=jnp.float32)
    got, tc = transformer.prefill(params, cfg, to_torch(tok), max_len=32,
                                  dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for step in random_tokens(3, 2, seed=3):
        step = step.reshape(2, 1)
        want, jc = jtransformer.decode_step(jparams, jcfg, jc,
                                            jnp.asarray(step),
                                            dtype=jnp.float32)
        got, tc = transformer.decode_step(params, cfg, tc, to_torch(step),
                                          dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(),
                                   np.asarray(jc[leaf].value), atol=ATOL,
                                   err_msg=leaf)
    assert int(tc["pos"]) == int(jc["pos"].value) == 27


def test_greedy_tokens_equal_jax_engine(pair):
    _, jbundle, jparams, _, bundle, params = pair
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29]
    want, got = greedy_engines(jbundle, jparams, bundle, params, prompts)
    assert len(got) == len(prompts)
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    finished = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--slots", "2", "--max-new",
                           "4"])
    assert len(finished) == 3
    assert f"arch={arch}-smoke" in capsys.readouterr().out
