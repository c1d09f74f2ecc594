"""The port's codeqwen1.5-7b (dense GQA with QKV bias at head_dim 128)
against the JAX model, on the same weights.

``reduced(codeqwen1.5-7b, d_model=512)`` (2 layers, 4 query and 4 KV
heads of **128**, QKV bias, rope theta 1e6, untied embeddings) with
``PRNGKey(0)`` weights carried over by ``repro_torch.convert``; both sides
in fp32. The port's prefill and decode run the attention kernels' plain
versions at head_dim 128 (on the card, the kernels' 128 instances).
Tolerances: 1e-4 absolute on logits and the K/V cache (sums in another
order over two layers), decode against teacher forcing 2e-3 as
``tests/test_models.py`` holds the JAX model.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from torch_parity import (greedy_decode, greedy_engines,  # noqa: E402
                          model_pair, random_tokens, to_torch)

ATOL = 1e-4
ARCH = "codeqwen1.5-7b"
WIDTH = 512  # 4 heads of 128


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, d_model=WIDTH)


def test_configs_match():
    jcfg, cfg = jget_config(ARCH), get_config("codeqwen1_5_7b")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "attn_type", "rms_eps",
              "qkv_bias", "rope_theta", "tie_embeddings", "sliding_window"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(reduced(cfg, d_model=WIDTH), f) == getattr(
            jreduced(jcfg, d_model=WIDTH), f), f
    assert cfg.param_count() == jcfg.param_count() == 8_189_640_704
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 32, 128)
    small = reduced(cfg, d_model=WIDTH)
    assert (small.n_heads, small.n_kv_heads, small.head_dim) == (4, 4, 128)
    assert small.qkv_bias and transformer.layer_windows(cfg) is None


def test_head_dim_128_is_a_kernel_head_dim(pair):
    """The wrappers take 128, and the layer-stacked cache's slices at 128
    pass the kernels' 16-byte row check in both dtypes."""
    _, _, _, cfg, bundle, _ = pair
    assert 128 in fa.HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        cache = bundle.init_cache(4, 160, dtype=dtype, per_slot_pos=True,
                                  device="cpu")
        assert fa.rows_aligned(cache["k"][1], cache["v"][cfg.n_layers - 1])


def test_converted_params_carry_the_bias(pair):
    _, _, _, cfg, _, params = pair
    attn = params["layers"]["attn"]
    assert tuple(attn["q"]["w"].shape) == (2, WIDTH, 4, 128)
    assert tuple(attn["k"]["b"].shape) == (2, 4, 128)
    assert "b" not in attn["o"] and "unembed" in params


@pytest.mark.parametrize("seq", [16, 72])
def test_forward_logits_match(pair, seq):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, seq, seed=seq)
    want = jtransformer.forward(jparams, jcfg, jnp.asarray(tok),
                                dtype=jnp.float32)
    got = transformer.forward(params, cfg, to_torch(tok), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("seq", [16, 48])
def test_prefill_logits_and_cache_match(pair, seq):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, seq, seed=seq + 1)
    want_logits, want_cache = jtransformer.prefill(
        jparams, jcfg, jnp.asarray(tok), max_len=64, dtype=jnp.float32)
    got_logits, got_cache = transformer.prefill(
        params, cfg, to_torch(tok), max_len=64, dtype=torch.float32)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL)
    assert set(got_cache) == set(want_cache) == {"k", "v", "pos"}
    for leaf in ("k", "v"):
        assert got_cache[leaf].shape == (2, 2, 64, 4, 128)
        np.testing.assert_allclose(got_cache[leaf].numpy(),
                                   np.asarray(want_cache[leaf].value),
                                   atol=ATOL, err_msg=leaf)
    assert int(got_cache["pos"]) == int(want_cache["pos"].value) == seq


def test_decode_steps_match(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tok = random_tokens(2, 24, seed=2)
    _, jc = jtransformer.prefill(jparams, jcfg, jnp.asarray(tok), max_len=32,
                                 dtype=jnp.float32)
    _, tc = transformer.prefill(params, cfg, to_torch(tok), max_len=32,
                                dtype=torch.float32)
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


def test_decode_matches_teacher_forcing(pair):
    jcfg, _, jparams, cfg, bundle, params = pair
    prompt = torch.from_numpy(random_tokens(1, 16, seed=7))
    dec, full = greedy_decode(bundle, params, prompt, 64)
    want = transformer.forward(params, cfg, full, dtype=torch.float32)
    jwant = np.asarray(jtransformer.forward(jparams, jcfg,
                                            jnp.asarray(full.numpy()),
                                            dtype=jnp.float32))
    for i, lg in enumerate(dec):
        pos = prompt.shape[1] + i
        torch.testing.assert_close(lg, want[0, pos], atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(lg.numpy(), jwant[0, pos], atol=2e-3,
                                   rtol=2e-3)


def test_greedy_tokens_equal_jax_engine(pair):
    _, jbundle, jparams, _, bundle, params = pair
    prompts = ["x" * 15, "ab cd!", "hello world", "q" * 29,
               "def add(a, b):\n    return a + b"]
    want, got = greedy_engines(jbundle, jparams, bundle, params, prompts)
    assert len(got) == len(prompts)
    for rid in want:
        assert got[rid].output_ids == want[rid].output_ids, rid


def test_serve_main_runs_codeqwen_on_cpu(capsys):
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch import serve
    finished = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "5", "--slots", "2", "--max-new",
                           "6"])
    assert len(finished) == 5
    eos = ByteTokenizer.eos_id
    assert all(len(r.output_ids) == 6 or r.output_ids[-1] == eos
               for r in finished.values())
    out = capsys.readouterr().out
    assert "arch=codeqwen1.5-7b-smoke" in out and "new tok/s" in out
