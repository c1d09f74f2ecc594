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
   at longer ones, ``decode_attention`` also at every cache length at the
   edges of its 32-key tiles (0, 1, 31-33, 63-65, S) over groups of 1, 7 and
   16 and through unaligned rows; ``rowwise_cosine`` over 256-wide unit
   rows at 1 to 18891
   rows (the whole ``game`` table), against full rows and against one
   anchor row; ``ssd_scan`` over mamba2-1.3b's heads (64 of head_dim 64,
   d_state 128, one group; reduced: 8 of 16, d_state 16) at every prefill
   length 16 to 160, a ragged 272 and 2048, with and without an initial
   state, and at a two-group case, and at 272 and 2048 also against the
   sequential recurrence in fp64; ``cosine_matrix`` at the JAX tests'
   shapes, cosine_api's 250 x 250, ragged shapes, 4096 x 4096, D = 0 and
   M = 0. Then each kernel's time at its path's shapes beside the plain
   version's, one PyTorch library call's (``scaled_dot_product_attention``;
   ``torch.mv`` and ``torch.matmul`` for the cosines; none computes the SSD
   scan) and the card's bound for the same work (fp32 work at the 3xTF32
   rate, 165 TFLOP/s). Hymba's kernels too: ``decode_attention`` over its
   heads (25 query over 5 KV, head_dim 64) with a sliding window of 1024
   and without, at cache lengths 0, 1, 1023-1025, 2048 and 4096 of a
   4096-entry cache (the rows before a window are NaN, so a kernel that
   loaded them would fail); ``flash_attention`` with the window at every
   prefill length and at 2048; ``ssd_scan`` over its heads (50 of 64,
   d_state 16) at every prefill length, 272 and 2048 (fp64 too); timed:
   the windowed decode step over 4 slots of a 4096-entry cache and the
   scan at S = 96. codeqwen1.5-7b's heads (32 over 32, head_dim 128): flash
   at every prefill length 16-160, 2048 and the offset and empty-row
   cases; decode at B = 4, S = 160 and B = 32, S = 4096, at the edge lengths
   (0 must give exactly 0) and through unaligned rows; timed: the prefill
   and decode rows of qwen2's shapes at codeqwen's heads and at
   granite-moe-1b-a400m's (16 over 8 of 64). ``rowwise_cosine`` over the
   whole game table is also timed with L2 cold (8 copies of the rows in
   turn). The flash backward (``flash_attention_bwd``) against autograd
   of the plain forward, and the forward's log-sum-exp, at qwen2's
   training shape (B = 8, S = 512), the rewriter's (4 over 2 heads of 32,
   B = 16, S = 384), head_dim 16 at S = 1, 17 and 127-129, with a window,
   non-causal and off the tile edges, in fp32 and bf16 (``BWD_TOL``), and
   twice on the same inputs (the same bits); the forward at head_dim 32
   too. Timed: forward and backward at both training shapes (the library
   baseline of the backward: ``torch.autograd.grad`` through SDPA's
   backward, pinned to the fastest backend that takes the inputs; kernel
   and plain version in a CUDA graph, the baseline between CUDA events
   around 20 calls queued behind a spin kernel, host time kept out: SDPA's
   flash backward cannot be captured, and a failed capture would leave the
   allocator routing every later allocation into a private pool that is
   never freed).
4. serve: full-width qwen2-0.5b (24 layers, d_model 896, vocab 151936, seeded
   random weights) serves 8 requests through ``GenerationEngine`` and
   ``ContinuousBatcher``; every prefill must launch ``flash_attention`` once
   per layer and every decode tick ``decode_attention`` once per layer.
5. cross-check: one prompt's prefill logits on the card (kernels) against the
   same weights on the CPU (plain path), fp32.
6. profile: torch.profiler over 4 more requests on the served engine; the
   card's busy and idle share, its time by kind of kernel, and the device
   kernels of ``decode_attention`` per decode tick (one per layer: 24).
7. serve_ssm, cross_check_ssm, profile_ssm: phases 4-6 for full-width
   mamba2-1.3b (48 layers, d_model 2048, 64 SSM heads, vocab 50280): every
   prefill must launch ``ssd_scan`` once per layer and nothing else; the
   card's prefill logits and final SSM state against the CPU's.
8. serve_hybrid, cross_check_hybrid, profile_hybrid: phases 4-6 for
   full-width hymba-1.5b (32 layers, d_model 1600, 25/5 attention heads of
   64 with a window of 1024 on 29 layers, 50 SSM heads, vocab 32001):
   every prefill launches ``flash_attention`` and ``ssd_scan`` once per
   layer, every tick ``decode_attention`` once per layer; the card's
   prefill logits and SSM state against the CPU's.
9. serve_codeqwen, cross_check_codeqwen, profile_codeqwen; serve_moe,
   cross_check_moe, profile_moe; serve_mla, cross_check_mla, profile_mla:
   phases 4-6 for the cost model's other LLM tiers at full width and depth
   with the SSM phases' flags. codeqwen1.5-7b (m*: 32 layers, d_model
   4096, 32/32 heads of 128, QKV bias, vocab 92416; 32.76 GB fp32):
   ``flash_attention`` = 32 x prefills, ``decode_attention`` = 32 x ticks.
   granite-moe-1b-a400m (m2: 24 layers, d_model 1024, 16/8 heads of 64, 32
   experts of 512, top-8, the MoE's gather path in plain PyTorch): 24 x
   each. minicpm3-4b (m3: 62 layers, d_model 2560, MLA in plain PyTorch):
   no kernel launch at all. The cross-checks' CPU copies: granite whole;
   codeqwen cut to its first 4 layers and minicpm3 to its first 8, at full
   width (``CUT_LAYERS``). Each model's memory is released before the next
   is built (phase ``release``).
10. window_decode: reduced hymba (window 64 on layer 1) decodes greedily
   from a 16-token prompt to position 150 on the card, and its logits at
   every step are held against the same steps on the CPU: the window
   through the model on the card (the full-width serve never fills 1024).
11. cosine_api: ``kernels.ops.cosine_matrix``, the kernel's only entry point
   in the package, over the embedded plots of the whole movie table against
   themselves, held against the numpy product ``core.semhash.cosine_matrix``.
12. semantic: ``serve --semantic movie --serve 4 --cascade --no-reduced``
   (q1-q4 over 32 rows; m1 is full-width qwen2-0.5b, the cascade scores
   every filter morsel with ``rowwise_cosine``). Every query must finish;
   ``rowwise_cosine`` must launch once per ``tier0-embed`` call and the
   attention kernels once per layer per prefill and decode tick. The same
   queries then run reduced on the CPU: per-query results, per-tier calls
   and cascade stats must be equal. Then the single-query mode (q1, m1
   only), and the streaming run once more under torch.profiler for the
   card's idle share.
13. semantic_sharded: the streaming run at reduced width on the card,
   unsharded, with ``--shards 2`` and with ``--procs 2`` (spawned process
   workers; m1 and the cascade stay in this process): results, per-tier
   calls, meter totals and cascade stats must be equal.
14. train_synthetic (after the serve phases, before window_decode): the
   launcher's own random-token batches, 12 steps of qwen2-0.5b at full
   width without checkpoints (losses finite, reported, not held to fall;
   launch counts exact). train: ``launch.train --arch qwen2-0.5b --steps
   12 --batch 8 --seq 512 --ckpt-every 4 --corpus movie`` at full width (fp32 weights and AdamW moments, bf16 activations, remat):
   losses finite and falling, tok/s, step times, peak memory, the card's
   idle share over two more steps; the flash forward launches 2 x 24 x 12
   times (remat runs each layer's forward again), the backward 24 x 12.
   train_restart: the same run with a failure after step 6 under
   ``run_with_restarts``; its final state within 1e-6 (relative to each
   leaf's largest value) of the uninterrupted run's, and whether
   bit-identical. cross_check_train: one step's loss, grad norm and every
   gradient leaf in fp32 on the card and on the CPU, the model cut to its
   first 4 layers. train_rewriter: ``examples.train_rewriter`` (§3.3) on
   the card with 100 steps: train and eval accuracy, and the plan cost of
   the cloud rewriter and of the trained LocalModelRewriter.
15. serve_encdec (after the training phases): full-width
   seamless-m4t-large-v2 (24 encoder and 24 decoder layers, d_model 1024,
   16/16 heads of 64, d_ff 8192, vocab 256206, 2.03B parameters, 8.1 GB
   fp32) through ``registry.build``: ``prefill`` of 4 prompts of 32 tokens
   over (4, 4096, 1024) seeded encoder frames, max_len 160, then 24 greedy
   ``decode_step``s: prefill s, decode s a step, tok/s, the card's idle
   share (profiled prefill and 8 steps); flash 72 per prefill (24 encoder,
   24 decoder self, 24 cross), decode 48 a step (self and cross).
   cross_check_encdec: the same inputs with the model cut to its first 2
   encoder and 2 decoder layers, card against CPU: the prefill's and every
   step's logits within LOGITS_ATOL, the same argmax. The kernels phase
   holds flash at cross-attention's shapes (1, 17, 96 and 160 queries
   against 77 and 4096 keys at 16/16 heads of 64), the backward at the
   group of 1 with Sq != Sk and at the training shape, and decode over the
   whole 4096-frame cache.
16. train_encdec: ``launch.train --arch seamless-m4t-large-v2 --steps 8
   --batch 4 --seq 512 --corpus movie`` at full width, no checkpoint (one
   would be 24.4 GB): step time, tok/s, peak memory, losses finite and
   falling, the idle share over two profiled steps; per step the flash
   forward 24 + 2 x 48 times (remat recomputes the decoder only), the
   backward 72. cross_check_train_encdec: one fp32 step cut to 2 + 2
   layers, card against CPU (loss 1e-5, grad norm 1e-4, every leaf 1e-4
   of its max).
17. int8_decode: full-width qwen2-0.5b, 4 sequences: 64 prompt tokens one
   at a time through ``decode_step``, then 24 greedy steps, with the fp32
   cache and then the int8 cache fed the same tokens; at every step the
   int8 logits within 0.05 of the fp32 logits' largest |value| (the
   reference's bound); both caches' bytes and ms a step; decode launches
   24 a step for each.
18. serve_vlm: internvl2-76b at full width (d_model 8192, 64/8 heads of
   128, d_ff 28672, vocab 128256) cut to 4 of its 80 layers (~22 GB fp32):
   (4, 256, 8192) seeded patch embeddings and 32 tokens, 24 greedy steps
   through the bundle (flash 4 per prefill, decode 4 a step), then 4
   text-only requests through the engine. cross_check_vlm: the model cut
   to 1 layer, card against CPU, the prefill and 4 steps.
19. train_ssm: ``launch.train --arch mamba2-1.3b --steps 8 --batch 8 --seq
   512 --corpus movie`` at full width (48 layers, d_model 2048; fp32
   weights and AdamW moments, bf16 activations, remat), no checkpoint:
   losses finite and falling, tok/s, step time, peak memory, the idle
   share of two profiled steps, one gradient computed twice from the final
   state bit-equal; launches exactly ``ssd_scan`` 2 x 48 x 8 (remat runs
   each forward twice) and ``ssd_scan_bwd`` 48 x 8. cross_check_train_ssm:
   one fp32 step cut to 4 layers, card against CPU (loss 1e-5, grad norm
   1e-4, every leaf 1e-4 of its max). train_hybrid and
   cross_check_train_hybrid: the same for hymba-1.5b at B = 2, S = 2048
   (its window of 1024 bites; flash 2 x 32 x 8 and its backward 32 x 8
   beside the scan's), the cross-check at (1, 1280). The kernels phase
   holds the scan's backward (``ssd_scan_bwd``) against ``plain_backward``
   at both training shapes, the chunk edges S = 1, 63 and 65, a ragged
   S = 272 with and without an initial state and a final-state gradient
   (there also against autograd of the fp64 recurrence), a ragged S = 1000
   at hymba's heads, the reduced heads and two groups, fp32 and bf16
   (``SSD_BWD_TOL``), twice for the same bits; and times it.
20. serve_deepseek, serve_llama4: deepseek-67b (64/8 heads of 128, d_ff
   22016, vocab 102400) cut to 4 of its 95 layers, and
   llama4-scout-17b-a16e (40/8 heads of 128, 16 experts of d_ff 8192 at
   top-1 and a shared expert, vocab 202048) cut to 2 of its 48, at full
   width with seeded random fp32 weights: 4 prompts of 32 tokens and 24
   greedy steps through the bundle (flash once per layer, decode once per
   layer and step), then the engine; cross_check_deepseek /
   cross_check_llama4 at 1 layer, card against CPU (logits 1e-3, argmax
   equal).
21. dryrun (after the serve_deepseek and serve_llama4 phases, each cell in
   a process of its own, all started together): ``launch.dryrun`` traces
   qwen2-0.5b's and codeqwen1.5-7b's train_4k, qwen2-0.5b's prefill_32k
   and decode_32k and mamba2-1.3b's long_500k and hymba-1.5b's
   decode_32k on the single-pod mesh (a fake process group of 256
   ranks),
   granite-moe-1b-a400m's train_4k on both (its MoE through the split
   gather path, ``moe_impl_ran`` "gather"), and qwen2-0.5b's long_500k
   skip: every record ``ok``, one line each with the dominant roofline
   term, the step time, the bytes a device against the card's 80 GB and
   the link bytes by kind. Then the train and train_mesh phases' own
   cells at a (1, 1) mesh: the launches a step they predict must equal
   the measured ones; each predicted peak is printed beside the measured
   one. (train_mesh_gather has no such cell: a one-rank train step traced
   by the dry-run computes on the local tensors, the unsplit gather
   path.)
22. train_codeqwen (after train_mesh, before serve_deepseek):
   full-width codeqwen1.5-7b (d_model 4096, 32/32 heads of 128, d_ff
   13440, vocab 92416) cut to 4 of its 32 layers (1.686B parameters),
   through ``launch.train.run(args, cfg=...)`` at qwen2's training shape
   (B = 8, S = 512, bf16 activations, fp32 weights and AdamW moments,
   remat) for 8 steps on the movie plots, no checkpoint: losses finite and
   falling, step time, tok/s, the peak (under the card's 80 GB, printed
   beside the prediction), the idle share of two profiled steps, a
   gradient computed twice bit-equal; the flash forward 2 x 4 x 8 and the
   backward 4 x 8 launches (head_dim 128 on the tensor cores).
   cross_check_train_codeqwen: one fp32 step cut to 4 layers at (2, 256),
   card against CPU (loss 1e-5, grad norm 1e-4, every leaf 1e-4 of its
   max), through the fp32 head_dim 128 backward (the CUDA-core instance).
   Each prints its seconds. The kernels phase holds the backward at
   head_dim 128 in fp32 and bf16: codeqwen's heads at (8, 512), and
   deepseek-67b's 64/8 and llama4-scout's 40/8 at S = 1, 73, 127 and 129,
   rows with no key, a window across key tiles and non-causal, twice for
   the same bits; and times the forward (with its log-sum-exp) and the
   backward at codeqwen's training shape in bf16 (the kernels line), and
   the fp32 backward at (2, 256).
23. train_mesh, cross_check_train_mesh, train_mesh_gather (after
   train_hybrid, before train_codeqwen): full-width granite-moe-1b-a400m
   on a one-rank NCCL mesh, its state placed by the train-mode rules.
   train_mesh and its cross-check run the MoE's shard_map path
   (``moe_ctx`` {"impl": "shardmap"}): 8 steps, a checkpoint restored
   onto the mesh, remesh, ``compressed_psum``; one fp32 step card against
   CPU. train_mesh_gather runs the split gather path, as a mesh of more
   ranks does: no ``moe_ctx``, the loss and gradients on the DTensor
   leaves under ``activation_sharding``, so each MoE layer runs
   ``ffn.moe_forward_gather_split`` on its blocks (one global capacity,
   the counts table gathered, the slots reduce-scattered and the
   products all-gathered over the data axis): its first step's loss
   bit-equal to the unplaced gather path's on the same card and every
   gradient leaf within GATHER_GRAD_TOL of its largest |value|, granite's
   first MoE layer alone bit-equal to the unsplit one (output and every
   gradient, assignments dropped), then MESH_GATHER_STEPS such steps (the
   gradients reduced to their leaves' placements, AdamW on the
   DTensors), losses finite and falling, the launches exactly
   ``train_launches``, the collectives exactly
   ``gather_mesh_collectives``, seconds a step and the peak.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest
of the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Dense peaks of the H100 SXM (NVIDIA data sheet): device memory bytes/s and
# FLOP/s by input type. fp32 is the fastest fp32-accurate rate the card
# has: 3xTF32 on the tensor cores, three TF32 products (495 TFLOP/s) per
# fp32 product, 165 TFLOP/s, above the 67 of the CUDA cores; a bound at 67
# would let a 3xTF32 kernel read over 100% of it.
PEAKS = {"bytes": 3.35e12, "float32": 495e12 / 3, "bfloat16": 989e12}
# A kernel's output against its plain version's, element by element:
# |kernel - plain| <= atol + rtol * |plain|. Both compute in fp32 and round
# the output once. In fp32 only the order of the sums differs (~1e-7 at these
# magnitudes). In bf16 the two fp32 results round at most one bf16 step
# apart, and a step is at most 2^-7 |x|; so the limit follows each element,
# and a kernel that drops or double-counts keys fails even where the outputs
# are ~0.01 (long rows over 0.5 * randn values).
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
# The flash backward's dQ, dK and dV against autograd of the plain version:
# |kernel - plain| <= a M + r |plain|, elementwise, M the largest |value|
# of the three plain gradients (a gradient's scale follows the sequence
# length and the group; dQ and dK are differences dP - Delta of terms on
# dV's scale, exactly 0 at S = 1, where their own max would allow no
# rounding at all). fp32: both sum in fp32 in other
# orders (~3e-6 of the max at qwen2's heads, B = 8, S = 512): a = 1e-5. bf16:
# both round fp32 gradients to bf16 once (<= 2^-7 |x| apart, as TOL), and
# the kernel's Delta = rowsum(dO o) reads the forward's bf16 output where
# autograd keeps fp32 (~2^-9 of |dO| |o| through every dS): a = 2^-8. The
# log-sum-exp the forward writes for it: 1e-5 absolute where finite
# (values ~log S, fp32 on both sides), -inf exactly where the plain one is.
BWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2.0 ** -8, 2.0 ** -7)}
LSE_ATOL = 1e-5
LOGITS_ATOL = 1e-3
N_LAYERS = 24
SSM_LAYERS = 48
# rowwise_cosine: the embedding width (core.semhash.DIM) and the row counts
# it is checked at: a morsel at --slots 4 is 16 rows, and 18891 rows is the
# whole game table, the largest cascade pass these datasets give.
EMBED_DIM = 256
COSINE_ROWS = (1, 16, 127, 133, 18891)
SEMANTIC = ["--semantic", "movie", "--slots", "4", "--requests", "8"]
STREAMING = SEMANTIC + ["--serve", "4", "--cascade"]
# (Hq, Hkv, D) of qwen2-0.5b at full width (what chip_smoke serves and
# trains), reduced (the serve launcher's default) and reduced to d_model
# 128 (the rewriter example's model): one case per head_dim the kernels
# are built for.
FULL_HEADS, REDUCED_HEADS, REWRITER_HEADS = (14, 2, 64), (4, 2, 16), \
    (4, 2, 32)
# (H, P, N, G) of the SSD scan: mamba2-1.3b at full width and reduced, and a
# two-group case of the JAX sweep
SSM_FULL, SSM_REDUCED, SSM_GROUPED = (64, 64, 128, 1), (8, 16, 16, 1), \
    (4, 32, 16, 2)
SSM_SERVE = ["--arch", "mamba2-1.3b", "--no-reduced", "--requests", "8",
             "--slots", "4", "--max-len", "160", "--max-new", "24",
             "--device", "cuda"]
# hymba-1.5b: its attention heads, sliding window and SSM heads (H, P, N,
# G) at full width, and its layer count
HYMBA_HEADS, HYMBA_WINDOW, SSM_HYMBA = (25, 5, 64), 1024, (50, 64, 16, 1)
HYMBA_LAYERS = 32
HYMBA_SERVE = ["--arch", "hymba-1.5b"] + SSM_SERVE[2:]
# the cost model's other LLM tiers: codeqwen1.5-7b (m*, 32 query and 32 KV
# heads of 128), granite-moe-1b-a400m (m2, 16 over 8 heads of 64, 32
# experts top-8) and minicpm3-4b (m3, MLA: no attention kernel), served with
# the SSM phases' flags; the cross-checks' CPU copies of codeqwen and
# minicpm3 keep their first CUT_LAYERS layers at full width (a full-depth
# copy would take 33 and 17 GB of host memory)
CODEQWEN_HEADS, GRANITE_HEADS = (32, 32, 128), (16, 8, 64)
# seamless-m4t-large-v2 (16 query over 16 KV heads of 64: a GQA group of 1)
# and internvl2-76b (64 over 8 of 128)
SEAMLESS_HEADS, VLM_HEADS = (16, 16, 64), (64, 8, 128)
CODEQWEN_SERVE = ["--arch", "codeqwen1.5-7b"] + SSM_SERVE[2:]
MOE_SERVE = ["--arch", "granite-moe-1b-a400m"] + SSM_SERVE[2:]
MLA_SERVE = ["--arch", "minicpm3-4b"] + SSM_SERVE[2:]
CUT_LAYERS = {"codeqwen1.5-7b": 4, "minicpm3-4b": 8}
# training: full-width qwen2-0.5b through the launcher (checkpoints every 4
# steps, into a directory of the build tree removed afterwards) on the
# movie plots (the launcher's synthetic batches are uniform random tokens:
# their loss stays at ~12.1 +- 0.03, nothing to learn), the same
# run with a failure injected after step FAIL_AT, a card-vs-CPU step of the
# model cut to its first TRAIN_CUT layers on a (2, 256) batch, and the
# rewriter example with REWRITER_STEPS steps
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_EVERY = 12, 8, 512, 4
TRAIN = ["--arch", "qwen2-0.5b", "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every",
         str(TRAIN_EVERY), "--corpus", "movie"]
FAIL_AT, RESTART_RTOL = 6, 1e-6
TRAIN_CUT, CROSS_BATCH, CROSS_SEQ = 4, 2, 256
REWRITER_STEPS = 100
CKPT_ROOT = os.path.join(ROOT, "build", "smoke_ckpt")
QWEN_SERVE = ["--no-reduced", "--requests", "8", "--slots", "4",
              "--max-len", "160", "--max-new", "24", "--device", "cuda"]
# seamless-m4t-large-v2 through its bundle: 4 prompts of ENCDEC_PROMPT
# tokens over ENC_FRAMES encoder frames (the reference's ENC_CTX_SERVE),
# max_len 160, ENCDEC_STEPS greedy steps; the card-vs-CPU check cut to
# ENCDEC_CUT encoder and ENCDEC_CUT decoder layers. Training: launch.train
# at full width, B = 4, S = 512 (a checkpoint would be 24.4 GB: none is
# taken, --ckpt-every is past --steps; the enc-dec tree's checkpoint and
# restart are held on the CPU by tests/test_torch_encdec.py)
ENC_FRAMES, ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_MAX_LEN = 4096, 4, 32, 160
ENCDEC_STEPS, ENCDEC_CUT, ENCDEC_TRAIN_STEPS = 24, 2, 8
TRAIN_ENCDEC = ["--arch", "seamless-m4t-large-v2", "--steps",
                str(ENCDEC_TRAIN_STEPS), "--batch", str(ENCDEC_BATCH),
                "--seq", str(TRAIN_SEQ), "--corpus", "movie", "--ckpt-every",
                "1000"]
# int8_decode: full-width qwen2-0.5b, 4 sequences fed INT8_PROMPT tokens one
# at a time, then INT8_STEPS greedy steps, with the int8 and the fp32 cache;
# the reference's bound on the logits' difference
INT8_PROMPT, INT8_STEPS, INT8_BOUND = 64, 24, 0.05
# serve_vlm: internvl2-76b at full width cut to VLM_LAYERS of its 80 layers
# (4 x 3.4 GB fp32 beside 8.7 GB of embedding, unembedding and prefix
# projection: what one card holds with room for the run), 4 sequences of
# VLM_PREFIX patch embeddings and VLM_TEXT tokens, VLM_STEPS greedy steps;
# max_len 576 holds the prefill's pos (288 + 256: the reference counts the
# prefix twice) and the steps; the card-vs-CPU check at VLM_CUT layer
VLM_LAYERS, VLM_CUT, VLM_BATCH, VLM_PREFIX, VLM_TEXT = 4, 1, 4, 256, 32
VLM_STEPS, VLM_MAX_LEN = 24, 576
# train_ssm / train_hybrid: launch.train at full width, SSM_TRAIN_STEPS
# steps on the movie plots, no checkpoint (one of mamba2-1.3b is ~16 GB of
# fp32 weights and moments): mamba2-1.3b at B = 8, S = 512; hymba-1.5b at
# B = 2, S = 2048, since hymba's is the only training attention with a
# window and at S <= 1024 its window of 1024 masks nothing. Their card-vs-
# CPU steps cut to TRAIN_CUT layers, hymba's at (1, 1280), past the window
# (its layer 0 keeps full attention).
SSM_TRAIN_STEPS = 8
SSM_TRAIN_SHAPE, HYBRID_TRAIN_SHAPE = (8, 512), (2, 2048)
HYBRID_CROSS = (1, 1280)


def train_flags(arch, shape):
    return ["--arch", arch, "--steps", str(SSM_TRAIN_STEPS), "--batch",
            str(shape[0]), "--seq", str(shape[1]), "--corpus", "movie",
            "--ckpt-every", "1000"]

# train_mesh: granite-moe-1b-a400m at full width through the MoE's
# shard_map path on a (1, 1) mesh over a one-rank NCCL group, MESH_STEPS
# steps of
# TRAIN_BATCH x TRAIN_SEQ, a checkpoint (16 GB: fp32 params and moments)
# after MESH_CKPT_AT steps restored onto the mesh; the card-vs-CPU step cut
# to MESH_CUT layers at (CROSS_BATCH, CROSS_SEQ). The process group's
# FileStore lives under the git-ignored build/.
MESH_ARCH, MESH_STEPS, MESH_CKPT_AT, MESH_CUT = ("granite-moe-1b-a400m", 8,
                                                 4, 2)
MESH_STORE = os.path.join(ROOT, "build", "mesh_store")
# train_mesh_gather: the same model, mesh and batch on the DTensor leaves
# with no moe_ctx, so through the MoE's split gather path,
# MESH_GATHER_STEPS steps. Its first gradients against the unplaced step's,
# each leaf to GATHER_GRAD_TOL of its largest |value|: the DTensor forms of
# the loss's logsumexp (by its parts) and of the tied unembedding round
# otherwise, and the bf16 activations carry that through (2^-8 = 3.9e-3 a
# rounding; 5.3e-3 at most measured on the card, NVIDIA H100 80GB HBM3);
# the MoE layer alone is held bit for bit.
MESH_GATHER_STEPS, GATHER_GRAD_TOL = 4, 1e-2

# serve_deepseek / serve_llama4: at full width, cut in depth to what one
# card holds with room for the run (BIG_LAYERS: deepseek-67b ~2.8 GB fp32 a
# layer, llama4-scout's 16 experts and shared expert ~8.8 GB a layer, each
# beside 6.7 / 8.3 GB of embeddings); BIG_BATCH prompts of BIG_PROMPT
# seeded tokens, BIG_STEPS greedy steps through the bundle, then the
# engine; the card-vs-CPU check at BIG_CUT layer. Their heads: 64 over 8
# and 40 over 8 (a group of 5), head_dim 128.
BIG_LAYERS = {"deepseek-67b": 4, "llama4-scout-17b-a16e": 2}
# dryrun: cells of launch.dryrun traced on the card over fake process
# groups of 256 (single) and 512 (multi) ranks, one line each; then the
# smoke's own training cells (train: qwen2-0.5b; train_mesh: granite through
# the MoE's shard_map path) traced at a (1, 1) mesh at their batch and
# sequence, whose predicted launches a step must equal the phases' measured
# ones. The granite cells on the production meshes run its split gather
# path.
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", "single"),
                ("codeqwen1.5-7b", "train_4k", "single"),
                ("qwen2-0.5b", "prefill_32k", "single"),
                ("qwen2-0.5b", "decode_32k", "single"),
                ("qwen2-0.5b", "long_500k", "single"),
                ("granite-moe-1b-a400m", "train_4k", "single"),
                ("granite-moe-1b-a400m", "train_4k", "multi"),
                ("mamba2-1.3b", "long_500k", "single"),
                ("hymba-1.5b", "decode_32k", "single"))
DRYRUN_CROSS = {"train": ("qwen2-0.5b", "gather"),
                "train_mesh": (MESH_ARCH, "shardmap")}
DEVICE_GB = 80.0
# the training phases' measured launches, steps and peak memory, for dryrun
MEASURED = {}
BIG_PHASE = {"deepseek-67b": "serve_deepseek",
             "llama4-scout-17b-a16e": "serve_llama4"}
BIG_BATCH, BIG_PROMPT, BIG_STEPS, BIG_MAX_LEN, BIG_CUT = 4, 32, 24, 160, 1
DEEPSEEK_HEADS, LLAMA4_HEADS = (64, 8, 128), (40, 8, 128)
# train_codeqwen: full-width codeqwen1.5-7b (32/32 heads of 128) cut to
# CODEQWEN_TRAIN_LAYERS of its 32 layers (8.19B parameters and 131 GB of
# fp32 weights and moments at full depth; 1.686B and 27.0 GB at 4), trained
# at qwen2's shape (TRAIN_BATCH x TRAIN_SEQ) for SSM_TRAIN_STEPS steps, no
# checkpoint; the peak predicted before the first run (GB)
CODEQWEN_TRAIN_LAYERS, CODEQWEN_PEAK_PREDICTED = 4, (45.0, 65.0)
# cosine_matrix: the shapes of tests/test_kernels.py, the cosine_api path's
# all-pairs product of the 250 movie plots, a small one, ragged M, N and D
# (D 250 and 33 are read element by element), and products in each of the
# kernel's three tilings (clusters below 132 tiles of 64 x 64, 64 x 64
# tiles below 132 of 128 x 128, 128 x 128 tiles)
MATRIX_SHAPES = [(128, 128, 256), (130, 70, 256), (16, 16, 64), (1, 67, 256),
                 (127, 67, 256), (129, 67, 256), (250, 250, 256),
                 (16, 16, 256), (37, 45, 250), (300, 7, 33),
                 (1000, 1000, 256), (2048, 1100, 250), (4096, 4096, 256)]


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


def ssd_held(got, want, dtype, rel=2.0 ** -17):
    """(max error, within tolerance) of one output of the SSD scan:
    |got - want| <= 1e-4 + rel max|want|, plus 2^-7 |want| for y in bf16
    (one bf16 rounding; the state stays fp32). The limits follow the
    readings against the sequential recurrence in fp64 at mamba2-1.3b's
    heads (S = 272 and 2048, |y| up to ~194, on an H100): the kernel's fp32
    y was off by up to 2.4e-4 (~2^-19.6 max|y|) and the plain version's by
    up to 7.8e-4 (~2^-17.9), since its fp32 running log-decay spans the
    model's chunk of up to 256 steps where the kernel's spans 64. So the
    kernel is held within 2^-19 max|want| of fp64 and within 2^-19 +
    3 x 2^-19 = 2^-17 of the plain version; a dropped or misplaced term
    moves y by O(1)."""
    got, want, rtol = got.double(), want.double(), TOL[dtype][1]
    atol = 1e-4 + rel * want.abs().max().item()
    err = (got - want).abs()
    return err.max().item(), bool((err <= atol + rtol * want.abs()).all())


def expect(**launches):
    """Every kernel's launch count 0, but those named."""
    from repro_torch.kernels import ops
    return {**{name: 0 for name in ops.launch_counts()}, **launches}


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


def attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=1, sk=None):
    """q (b, s, hq, d) and k/v slices of a layer-stacked (layers, b, sk,
    hkv, d) tensor (sk = s by default), read in place as the model reads
    its cache."""
    sk = sk or s

    def rn(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(dtype)
    return (rn(b, s, hq, d), rn(layers, b, sk, hkv, d)[-1],
            rn(layers, b, sk, hkv, d)[-1])


def flash_cases():
    """(heads, case, B, S, causal, window, q_offset, sk_valid, Sk): qwen2-0.5b's
    heads at every prefill length the serve and semantic phases give the
    kernel (prompts pad to a multiple of PREFILL_ALIGN = 16 and are cut at
    max_len 160, so 16 to 160; the serve phase's are 64, 80 and 96) and at
    the sweep's shapes; the reduced heads at a few of them. The offset cases
    move the causal diagonal and the key limit off the tile edges (query
    row i at position i + q_offset, keys at or past sk_valid masked), where
    the packing of a GQA group's rows into one tile is easiest to get
    wrong; at q_offset -6 the first 6 rows see no key and must give 0.
    Hymba's heads (a group of 5) with its window of 1024 at every prefill
    length and at 2048, where the window masks. codeqwen1.5-7b's heads (32
    over 32 of head_dim 128) at every prefill length, 2048 and the offset
    cases. The rewriter's heads (4 over 2 of head_dim 32) at the reduced
    cases, its training shape (B = 16, S = 384) and the offset cases.
    Sk is None (= S) but for cross-attention: seamless-m4t-large-v2's heads
    (a group of 1) with 1, 17, 96 and 160 queries against 77 and 4096 keys,
    non-causal; its encoder's self-attention at 4096 frames and its
    training shape (S = 512, causal and not). internvl2-76b's heads (64
    over 8 of 128, deepseek-67b's too) causal at its served prefill (256
    prefix + 32 text) and at 96. llama4-scout's heads (40 over 8 of 128, a
    group of 5) at every prefill length and the offset cases."""
    full = [("causal", 1, s, True, 0) for s in range(16, 161, 16)]
    full += [("causal", 1, 2048, True, 0),
             ("padded", 2, 40, True, 0), ("window", 1, 160, True, 24),
             ("noncausal", 1, 160, False, 0),
             ("noncausal_window", 1, 160, False, 24)]
    small = [("causal", 1, 96, True, 0), ("padded", 2, 40, True, 0),
             ("window", 1, 160, True, 24), ("noncausal_window", 1, 160, False, 24)]
    offsets = [("offset", 2, 200, True, 0, 9, 187),
               ("offset_window", 2, 48, True, 8, 5, 41),
               ("empty_rows", 2, 48, True, 8, -6, 37),
               ("offset_noncausal", 2, 48, False, 0, 3, 28)]
    hymba = [("hymba_window", 1, s, True, HYMBA_WINDOW)
             for s in list(range(16, 161, 16)) + [2048]]
    prefills = [("causal", 1, s, True, 0) for s in range(16, 161, 16)]
    codeqwen = prefills + [("causal", 1, 2048, True, 0)]
    rewriter = small + [("train", 16, 384, True, 0)]
    seamless = [("encoder", 1, 4096, False, 0), ("train", 2, 512, True, 0),
                ("train_noncausal", 2, 512, False, 0)]
    vlm = [("causal", 1, 96, True, 0), ("vlm_prefill", 1, 288, True, 0)]
    cases = ([(FULL_HEADS, *c, 0, c[2]) for c in full]
             + [(REDUCED_HEADS, *c, 0, c[2]) for c in small]
             + [(REWRITER_HEADS, *c, 0, c[2]) for c in rewriter]
             + [(h, *c) for h in (FULL_HEADS, REDUCED_HEADS, CODEQWEN_HEADS,
                                  REWRITER_HEADS, LLAMA4_HEADS)
                for c in offsets]
             + [(HYMBA_HEADS, *c, 0, c[2]) for c in hymba]
             + [(CODEQWEN_HEADS, *c, 0, c[2]) for c in codeqwen]
             + [(SEAMLESS_HEADS, *c, 0, c[2]) for c in seamless]
             + [(VLM_HEADS, *c, 0, c[2]) for c in vlm]
             + [(LLAMA4_HEADS, *c, 0, c[2]) for c in prefills])
    return ([c + (None,) for c in cases]
            + [(SEAMLESS_HEADS, "cross", 2, sq, False, 0, 0, sk, sk)
               for sq in (1, 17, 96, 160) for sk in (77, 4096)])


DECODE_CASES = [(FULL_HEADS, b, s) for b in (4, 32) for s in (160, 4096)] \
    + [(REDUCED_HEADS, 4, 160), (CODEQWEN_HEADS, 4, 160),
       (CODEQWEN_HEADS, 32, 4096), (SEAMLESS_HEADS, 4, 160),
       (SEAMLESS_HEADS, 4, 4096), (VLM_HEADS, 4, 576), (VLM_HEADS, 4, 4096),
       (LLAMA4_HEADS, 4, BIG_MAX_LEN), (LLAMA4_HEADS, 32, 4096)]
# seamless's cross decode reads the whole encoder cache: every slot's
# cache_len is its 4096 frames
ENCODER_LENS = (4096,) * 4
# cache lengths at the kernel's edges: none, one key, either side of its
# 32-key tiles and of two of them, the whole cache; over groups of 1, 7
# (qwen2-0.5b) and 16 (the largest) at head_dim 64, the reduced heads, and
# at head_dim 128 codeqwen1.5-7b's heads (a group of 1), a group of 16,
# internvl2-76b's and deepseek-67b's (8) and llama4-scout's (5)
DECODE_EDGE_LENS = (0, 1, 31, 32, 33, 63, 64, 65, 160)
DECODE_EDGE_HEADS = [(2, 2, 64), (14, 2, 64), (32, 2, 64), REDUCED_HEADS,
                     CODEQWEN_HEADS, (32, 2, 128), SEAMLESS_HEADS, VLM_HEADS,
                     LLAMA4_HEADS]
# hymba's sliding window: lengths on either side of it and of twice it, of
# a 4096-entry cache
WINDOW_LENS = (0, 1, 1023, 1024, 1025, 2048, 4096)


def check_decode(gen, dtype, failures):
    """decode_attention against its plain version: random lengths in [1, S]
    with one slot of 1, one of S and one of 0 (which must give exactly 0)
    at DECODE_CASES; every DECODE_EDGE_LENS at once over DECODE_EDGE_HEADS,
    the cache read as a slice of a layer-stacked tensor and, once per
    head_dim, through rows that are not 16-byte aligned (the element-wise
    loads). Hymba's heads at WINDOW_LENS with its window of 1024 and
    without; with the window, every K and V row before a sequence's window
    is NaN and the plain version reads the cache with them zeroed: a kernel
    that loaded them would give NaN. Seamless's heads (a group of 1) with
    every slot at the whole 4096-entry encoder cache (cross decode)."""
    from repro_torch.kernels import decode_attention as dec
    cases = [("ragged", heads, b, s, None, 0) for heads, b, s in DECODE_CASES]
    cases += [("encoder", SEAMLESS_HEADS, len(ENCODER_LENS), ENCODER_LENS[0],
               ENCODER_LENS, 0)]
    cases += [("edges", heads, len(DECODE_EDGE_LENS), 160, DECODE_EDGE_LENS,
               0) for heads in DECODE_EDGE_HEADS]
    cases += [("unaligned", heads, len(DECODE_EDGE_LENS), 160,
               DECODE_EDGE_LENS, 0)
              for heads in (FULL_HEADS, REDUCED_HEADS, CODEQWEN_HEADS)]
    cases += [(case, HYMBA_HEADS, len(WINDOW_LENS), WINDOW_LENS[-1],
               WINDOW_LENS, window)
              for case, window in (("hymba_window", HYMBA_WINDOW),
                                   ("hymba_full", 0))]
    for case, (hq, hkv, d), b, s, edge, window in cases:
        q, kc, vc = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=2)
        q = q[:, :1]
        if case == "unaligned":  # rows d + 1 elements apart
            kc, vc = (torch.randn(b, s, hkv, d + 1, generator=gen,
                                  device="cuda").to(dtype)[..., 1:]
                      for _ in range(2))
        if edge is None:
            lens = torch.randint(1, s + 1, (b,), generator=gen,
                                 device="cuda").to(torch.int32)
            lens[0], lens[1], lens[2] = 1, s, 0
        else:
            lens = torch.tensor(edge, dtype=torch.int32, device="cuda")
        clean = (kc, vc)
        if window:
            before = (torch.arange(s, device="cuda")[None, :]
                      < (lens - window)[:, None])
            clean = tuple(torch.where(before[..., None, None], 0, c)
                          for c in (kc, vc))
            for c in (kc, vc):
                c[before] = float("nan")
        got = dec.decode_attention(q, kc, vc, lens, window=window)
        err, ok = held(got, dec.plain(q, *clean, lens, window=window), dtype)
        empty = (lens == 0).nonzero().flatten().tolist()
        zero = max([got[i].abs().max().item() for i in empty] + [0.0])
        ok = ok and zero == 0.0
        emit({"phase": "kernel", "kernel": "decode_attention",
              "case": case, "dtype": str(dtype), "B": b, "S": s,
              "Hq": hq, "Hkv": hkv, "D": d, "window": window,
              "cache_len": lens.tolist()[:9], "max_abs_err": err,
              "zero_len_row_max": zero, "tol": tol_text(dtype), "ok": ok})
        if not ok:
            failures.append(("decode_attention", case, str(dtype), b, s, hq,
                             d, err))


def phase_kernels():
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(0)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for ((hq, hkv, d), case, b, s, causal, window, q_offset,
             sk_valid, sk) in flash_cases():
            q, k, v = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=2,
                                  sk=sk)
            kw = dict(causal=causal, window=window, q_offset=q_offset,
                      sk_valid=sk_valid)
            got = fa.flash_attention(q, k, v, **kw)
            err, ok = held(got, fa.plain(q, k, v, **kw), dtype)
            if q_offset < 0:  # rows with no valid key give 0
                ok = ok and bool((got[:, :-q_offset] == 0).all())
            emit({"phase": "kernel", "kernel": "flash_attention", "case": case,
                  "dtype": str(dtype), "B": b, "S": s, "Sk": sk or s,
                  "Hq": hq, "Hkv": hkv,
                  "D": d, "window": window, "q_offset": q_offset,
                  "sk_valid": sk_valid, "max_abs_err": err,
                  "tol": tol_text(dtype), "ok": ok})
            if not ok:
                failures.append(("flash_attention", case, str(dtype), s, d, err))
        check_backward(gen, dtype, failures)
        check_decode(gen, dtype, failures)
        check_rowwise(gen, dtype, failures)
        check_ssd(gen, dtype, failures)
        check_ssd_bwd(gen, dtype, failures)
        check_matrix(gen, dtype, failures)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return time_kernels(gen)


def bwd_cases():
    """(heads, case, B, S, causal, window, q_offset, sk_valid, Sk) of the
    backward: qwen2-0.5b's training shape, the rewriter's, head_dim 16 at
    S = 1, 17 and either side of two 64-row tiles, with the window, and
    non-causal; the offset cases move the masks off the tile edges, and at
    q_offset -6 the first 6 rows see no key (zero gradient, no NaN); qwen2's
    group of 7 at S = 73 (511 packed rows, the last tile cut mid-tile), and
    a window of 24 crossing key tiles at head_dim 32 and 64. Sk is None
    (= S) but for seamless's cross-attention, at its group of 1: 129
    queries against 200 keys and 200 against 129, non-causal; and its
    training shape (B = 4, S = 512) causal (the decoder) and non-causal
    (the encoder, and cross-attention, whose S_enc = S_dec). Head_dim 128:
    codeqwen1.5-7b's training shape, and deepseek-67b's and llama4-scout's
    heads at the edges."""
    cases = ([(FULL_HEADS, "train", TRAIN_BATCH, TRAIN_SEQ, True, 0, 0,
              TRAIN_SEQ),
             (REWRITER_HEADS, "rewriter", 16, 384, True, 0, 0, 384)]
            + [(REDUCED_HEADS, "causal", 2, s, True, 0, 0, s)
               for s in (1, 17, 127, 128, 129)]
            + [(REDUCED_HEADS, "window", 2, 129, True, 24, 0, 129),
               (REDUCED_HEADS, "noncausal", 2, 129, False, 0, 0, 129),
               (REDUCED_HEADS, "noncausal_window", 2, 127, False, 24, 0, 127),
               (FULL_HEADS, "offset", 2, 200, True, 0, 9, 187),
               (FULL_HEADS, "empty_rows", 2, 48, True, 8, -6, 37),
               (REWRITER_HEADS, "offset_noncausal", 2, 48, False, 0, 3, 28),
               (FULL_HEADS, "group7_ragged", 2, 73, True, 0, 0, 73),
               (REWRITER_HEADS, "window_tiles", 2, 200, True, 24, 0, 200),
               (FULL_HEADS, "window_tiles", 2, 200, True, 24, 0, 200),
               (SEAMLESS_HEADS, "encdec_train", ENCDEC_BATCH, TRAIN_SEQ, True,
                0, 0, TRAIN_SEQ),
               (SEAMLESS_HEADS, "encdec_train_noncausal", ENCDEC_BATCH,
                TRAIN_SEQ, False, 0, 0, TRAIN_SEQ)])
    # head_dim 128: codeqwen's 32/32 at the training shape; deepseek's 64/8
    # and llama4's 40/8 (a group of 5) at S = 1, either side of two 64-row
    # tiles and a ragged 73, the first 6 rows with no key, a window of 24
    # crossing key tiles, and non-causal
    cases += [(CODEQWEN_HEADS, "codeqwen_train", TRAIN_BATCH, TRAIN_SEQ, True,
               0, 0, TRAIN_SEQ)]
    for name, heads in (("deepseek", DEEPSEEK_HEADS),
                        ("llama4", LLAMA4_HEADS)):
        cases += [(heads, f"{name}_causal", 2, s, True, 0, 0, s)
                  for s in (1, 127, 129, 73)]
        cases += [(heads, f"{name}_empty_rows", 2, 48, True, 8, -6, 37),
                  (heads, f"{name}_window_tiles", 2, 200, True, 24, 0, 200),
                  (heads, f"{name}_noncausal", 2, 129, False, 0, 0, 129)]
    return ([c + (None,) for c in cases]
            + [(SEAMLESS_HEADS, "group1_cross", 2, 129, False, 0, 0, 200, 200),
               (SEAMLESS_HEADS, "group1_cross_rev", 2, 200, False, 0, 0, 129,
                129)])


def bwd_held(got, want, dtype):
    """(max |got - want| over dQ, dK, dV, whether every element of each is
    within BWD_TOL[dtype] of the three's largest |value|)."""
    a, r = BWD_TOL[dtype]
    scale = max(w.float().abs().max().item() for w in want)
    errs, ok = [], True
    for x, w in zip(got, want):
        x, w = x.float(), w.float()
        err = (x - w).abs()
        errs.append(err.max().item())
        ok = ok and bool((err <= a * scale + r * w.abs()).all())
    return max(errs), ok


def check_backward(gen, dtype, failures):
    """The flash backward against ``plain_backward`` (autograd of the plain
    forward) at ``bwd_cases``, from the forward kernel's own output and
    log-sum-exp; the log-sum-exp against ``plain_lse``; a second launch on
    the same inputs must give the same bits (no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    for ((hq, hkv, d), case, b, s, causal, window, q_offset,
         sk_valid, sk) in bwd_cases():
        q, k, v = attn_inputs(gen, b, s, hq, hkv, d, dtype, sk=sk)
        dout = (torch.randn(b, s, hq, d, generator=gen, device="cuda")
                * 0.5).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  sk_valid=sk_valid)
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        want_lse = fa.plain_lse(q, k, **kw)
        fin = torch.isfinite(want_lse)
        lse_err = (lse[fin] - want_lse[fin]).abs().max().item() \
            if fin.any() else 0.0
        lse_ok = lse_err <= LSE_ATOL and bool(
            (lse[~fin] == float("-inf")).all())
        got = fa.flash_attention_backward(q, k, v, out, dout, lse, **kw)
        err, ok = bwd_held(got, fa.plain_backward(q, k, v, dout, **kw), dtype)
        again = fa.flash_attention_backward(q, k, v, out, dout, lse, **kw)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if q_offset < 0:  # rows with no valid key get 0
            ok = ok and bool((got[0][:, :-q_offset] == 0).all())
        ok = ok and lse_ok and same and all(
            bool(torch.isfinite(x).all()) for x in got)
        a, r = BWD_TOL[dtype]
        emit({"phase": "kernel", "kernel": "flash_attention_bwd",
              "case": case, "dtype": str(dtype), "B": b, "S": s,
              "Sk": sk or s, "Hq": hq,
              "Hkv": hkv, "D": d, "causal": causal, "window": window,
              "q_offset": q_offset, "sk_valid": sk_valid,
              "max_abs_err": err, "lse_max_abs_err": lse_err,
              "max_abs_grad": max(x.float().abs().max().item() for x in got),
              "tol": f"{a} * max|plain dQ, dK, dV| + {r} * |plain|",
              "deterministic": same, "ok": ok})
        if not ok:
            failures.append(("flash_attention_bwd", case, str(dtype), s, d,
                             err))


def unit_rows(gen, m, dtype, d=EMBED_DIM):
    """m random rows of d (the embedder's EMBED_DIM), L2-normalized."""
    x = torch.randn(m, d, generator=gen, device="cuda")
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


def ssd_cases():
    """(heads, case, B, S, with an initial state): mamba2-1.3b's heads at
    every prefill length the serve phases give the kernel (prompts pad to a
    multiple of 16 and are cut at max_len 160; the served ones pad to 64, 80
    and 96), a ragged last chunk (272 = 4 x 64 + 16) and 2048; hymba-1.5b's
    heads (50 of 64, d_state 16) at the same lengths; the reduced heads; two
    B/C groups."""
    full = [("prefill", 1, s, False) for s in range(16, 161, 16)]
    full += [("prefill_init", 1, 96, True), ("ragged", 1, 272, False),
             ("ragged_init", 1, 272, True), ("long", 1, 2048, False),
             ("long_init", 1, 2048, True)]
    hymba = [("hymba_prefill", 1, s, False) for s in range(16, 161, 16)]
    hymba += [("hymba_ragged", 1, 272, False), ("hymba_long", 1, 2048, False)]
    return ([(SSM_FULL, *c) for c in full]
            + [(SSM_HYMBA, *c) for c in hymba]
            + [(SSM_REDUCED, "reduced", 2, 96, False),
               (SSM_REDUCED, "reduced_init", 2, 96, True),
               (SSM_GROUPED, "grouped", 2, 128, False),
               (SSM_GROUPED, "grouped_init", 2, 128, True)])


def ssd_inputs(gen, b, s, heads, dtype, init=False):
    """The JAX tests' scales: dA = -|N(0, 1)| * 0.2 (fp32), dx, B, C and the
    initial state N(0, 1)."""
    h, p, n, g = heads

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    dx, B, C = rn(b, s, h, p).to(dtype), rn(b, s, g, n).to(dtype), \
        rn(b, s, g, n).to(dtype)
    return dx, -rn(b, s, h).abs() * 0.2, B, C, rn(b, h, n, p) if init else None


def ssd_compare(got, want, dtype):
    """(y error, state error, both within ``ssd_held``) of one scan's
    (y, final state) against another's."""
    err_y, ok_y = ssd_held(got[0], want[0], dtype)
    err_state, ok_state = ssd_held(got[1], want[1], torch.float32)
    return err_y, err_state, ok_y and ok_state


def check_ssd(gen, dtype, failures):
    """ssd_scan (its own chunk of 64) against the plain version at the
    model's chunk, y and the final state. At S = 272 and 2048 both are also
    read against the sequential recurrence in fp64 (``ref.ssd_ref`` on the
    same inputs), which says which side carries the difference; the kernel
    must hold that too (``ssd_held`` at 2^-19), the plain version is only
    read."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    for heads, case, b, s, init in ssd_cases():
        args = ssd_inputs(gen, b, s, heads, dtype, init)
        got = ssd.ssd_scan(*args)
        want = ssd.plain(*args, chunk=ssd.model_chunk(s))
        err_y, err_s, ok = ssd_compare(got, want, dtype)
        row = {"phase": "kernel", "kernel": "ssd_scan", "case": case,
               "dtype": str(dtype), "B": b, "S": s, "H": heads[0],
               "P": heads[1], "N": heads[2], "G": heads[3],
               "plain_chunk": ssd.model_chunk(s), "max_abs_err_y": err_y,
               "max_abs_y": want[0].float().abs().max().item(),
               "max_abs_err_state": err_s,
               "tol": "1e-4 + 2^-17 max|plain|"
               + (" + 2^-7 |plain| (y)" if dtype != torch.float32 else "")}
        if case.startswith(("ragged", "long", "hymba_ragged", "hymba_long")):
            exact = ref.ssd_ref(*(None if t is None else t.double()
                                  for t in args))
            for side, out in (("kernel", got), ("plain", want)):
                for i, leaf in enumerate(("y", "state")):
                    err, held_64 = ssd_held(out[i], exact[i], (
                        dtype if leaf == "y" else torch.float32), 2.0 ** -19)
                    row[f"{side}_vs_f64_{leaf}"] = err
                    ok = ok and (held_64 or side == "plain")
            row["tol_f64"] = "kernel: 1e-4 + 2^-19 max|f64|" + (
                " + 2^-7 |f64| (y)" if dtype != torch.float32 else "")
        emit({**row, "ok": ok})
        if not ok:
            failures.append(("ssd_scan", case, str(dtype), s, row))


# The SSD backward against its plain version (``plain_backward``, the same
# formulas in plain PyTorch), each leaf elementwise: |kernel - plain| <=
# a M + r |plain|, M that leaf's largest |value| (each has its own scale:
# ddA sums a chunk's steps, dB a group's heads). Both sum in fp32 in other
# orders (a CPU emulation of the kernel read ~1e-6 of M against fp64):
# a = 1e-5. bf16: ddx, dB and dC round once to bf16 on both sides,
# r = 2^-7 (one step, as TOL); ddA and the state's gradient stay fp32. At
# S = 272 also against autograd of ``ref.ssd_ref`` in fp64, the same limit.
SSD_BWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
SSD_GRADS = ("ddx", "ddA", "dB", "dC", "dinit")


def bwd_ssd_cases():
    """(heads, case, B, S, initial state, final-state gradient) of the
    backward: mamba2-1.3b's training shape (B = 8, S = 512) and hymba-1.5b's
    (B = 2, S = 2048), as training gives them (no initial state, the final
    state unused); the chunk edges S = 1, 63 and 65 at mamba2's heads with
    both; a ragged S = 272 = 4 x 64 + 16 at mamba2's heads without and with
    both, and a ragged S = 1000 at hymba's; the reduced heads and two
    groups."""
    return [(SSM_FULL, "train", *SSM_TRAIN_SHAPE, False, False),
            (SSM_HYMBA, "hymba_train", *HYBRID_TRAIN_SHAPE, False, False),
            (SSM_FULL, "edge_1", 1, 1, True, True),
            (SSM_FULL, "edge_63", 1, 63, True, True),
            (SSM_FULL, "edge_65", 1, 65, True, True),
            (SSM_HYMBA, "hymba_ragged", 1, 1000, True, True),
            (SSM_FULL, "ragged", 1, 272, False, False),
            (SSM_FULL, "ragged_init_dstate", 1, 272, True, True),
            (SSM_REDUCED, "reduced", 2, 96, True, False),
            (SSM_GROUPED, "grouped", 2, 128, False, True)]


def ssd_bwd_inputs(gen, b, s, heads, dtype, init, dstate):
    """``ssd_inputs`` and y's gradient N(0, 1) in dtype, and optionally the
    final state's, N(0, 1) fp32: the backward's arguments."""
    h, p, n, _ = heads
    dx, dA, B, C, st = ssd_inputs(gen, b, s, heads, dtype, init)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    ds = (torch.randn(b, h, n, p, generator=gen, device="cuda") if dstate
          else None)
    return dx, dA, B, C, st, dy, ds


def ssd_bwd_held(got, want, dtype):
    """({leaf: max |got - want|}, every leaf within SSD_BWD_TOL[dtype])."""
    a, r = SSD_BWD_TOL[dtype]
    errs, ok = {}, True
    for name, x, w in zip(SSD_GRADS, got, want):
        x, w = x.double(), w.double()
        err = (x - w).abs()
        errs[name] = err.max().item()
        rel = r if name in ("ddx", "dB", "dC") else 0.0
        ok = ok and bool((err <= a * w.abs().max() + rel * w.abs()).all())
    return errs, ok


def ssd_grads_f64(dx, dA, B, C, init, dy, dstate):
    """The five gradients by autograd of the sequential recurrence
    ``ref.ssd_ref`` in fp64 (a zero initial state where there is none)."""
    from repro_torch.kernels import ref
    b, _, h, p = dx.shape
    if init is None:
        init = torch.zeros(b, h, B.shape[3], p, device=dx.device)
    leaves = [t.detach().double().requires_grad_()
              for t in (dx, dA, B, C, init)]
    with torch.enable_grad():
        y, fin = ref.ssd_ref(*leaves)
        loss = (y * dy.double()).sum()
        if dstate is not None:
            loss = loss + (fin * dstate.double()).sum()
        return torch.autograd.grad(loss, leaves)


def check_ssd_bwd(gen, dtype, failures):
    """ssd_scan_backward against ``plain_backward`` at ``bwd_ssd_cases``
    (``ssd_bwd_held``), at S = 272 also against the fp64 recurrence's
    autograd; a second launch on the same inputs must give the same bits
    (no atomics: a group's dB and dC are summed over its heads in order)."""
    from repro_torch.kernels import ssd_scan as ssd
    for heads, case, b, s, init, dstate in bwd_ssd_cases():
        args = ssd_bwd_inputs(gen, b, s, heads, dtype, init, dstate)
        got = ssd.ssd_scan_backward(*args)
        again = ssd.ssd_scan_backward(*args)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        errs, ok = ssd_bwd_held(got, ssd.plain_backward(*args), dtype)
        row = {"phase": "kernel", "kernel": "ssd_scan_bwd", "case": case,
               "dtype": str(dtype), "B": b, "S": s, "H": heads[0],
               "P": heads[1], "N": heads[2], "G": heads[3],
               "initial_state": init, "dstate": dstate,
               "max_abs_err": errs,
               "max_abs_grad": {k: x.float().abs().max().item()
                                for k, x in zip(SSD_GRADS, got)},
               "tol": "1e-5 max|plain leaf|" + (
                   " + 2^-7 |plain| (ddx, dB, dC)"
                   if dtype != torch.float32 else ""),
               "deterministic": same}
        if s == 272:
            errs64, ok64 = ssd_bwd_held(got, ssd_grads_f64(*args), dtype)
            row["max_abs_err_vs_f64"] = errs64
            ok = ok and ok64
        ok = ok and same and all(bool(torch.isfinite(x).all()) for x in got)
        emit({**row, "ok": ok})
        if not ok:
            failures.append(("ssd_scan_bwd", case, str(dtype), s, errs))


def check_matrix(gen, dtype, failures):
    """cosine_matrix against its plain version over unit rows; both sum in
    fp32 into fp32 (atol 1e-5, as tests/test_kernels.py holds the Pallas
    kernel); M = 0 gives (0, N) and no launch; D = 0 gives zeros."""
    from repro_torch.kernels import similarity as sim
    for m, n, d in MATRIX_SHAPES:
        a, b = unit_rows(gen, m, dtype, d), unit_rows(gen, n, dtype, d)
        err = max_err(sim.cosine_matrix(a, b), sim.plain_matrix(a, b))
        ok = err <= 1e-5
        emit({"phase": "kernel", "kernel": "cosine_matrix", "case": "unit",
              "dtype": str(dtype), "M": m, "N": n, "D": d,
              "max_abs_err": err, "tol": 1e-5, "ok": ok})
        if not ok:
            failures.append(("cosine_matrix", str(dtype), m, n, d, err))
    before = sim.matrix_stats["launches"]
    empty = sim.cosine_matrix(unit_rows(gen, 0, dtype), unit_rows(gen, 5, dtype))
    ok = tuple(empty.shape) == (0, 5) and sim.matrix_stats["launches"] == before
    emit({"phase": "kernel", "kernel": "cosine_matrix", "case": "empty",
          "dtype": str(dtype), "M": 0, "N": 5, "shape": list(empty.shape),
          "launched": sim.matrix_stats["launches"] - before, "ok": ok})
    if not ok:
        failures.append(("cosine_matrix", "empty", str(dtype)))
    no_d = torch.zeros(5, 0, device="cuda", dtype=dtype)
    zero = sim.cosine_matrix(no_d, no_d)
    ok = tuple(zero.shape) == (5, 5) and not zero.any().item()
    emit({"phase": "kernel", "kernel": "cosine_matrix", "case": "D=0",
          "dtype": str(dtype), "M": 5, "N": 5, "D": 0, "ok": ok})
    if not ok:
        failures.append(("cosine_matrix", "D=0", str(dtype)))


KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85"),
    "flash_attention_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:85"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:69"),
    "rowwise_cosine": dict(
        route="cuda", source="src/repro_torch/csrc/similarity.cu",
        replaces="src/repro/kernels/similarity.py:82"),
    "cosine_matrix": dict(
        route="cuda", source="src/repro_torch/csrc/similarity.cu",
        replaces="src/repro/kernels/similarity.py:45"),
    "ssd_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:69"),
    "ssd_scan_bwd": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan.py:69"),
    "adamw": dict(
        route="cuda", source="src/repro_torch/csrc/adamw.cu",
        replaces="none: the reference's AdamW is jnp, fused by XLA"),
}


def attended_pairs(b, s, sk, causal):
    """(query, key) pairs a causal (sk = s) or non-causal attention of b
    sequences computes, per query head."""
    return b * (s * (s + 1) // 2 if causal else s * sk)


def flash_shape(b, s, sk, heads, causal):
    hq, hkv, d = heads
    return (f"B={b} S={s}" + (f" Sk={sk}" if sk != s else "")
            + f" Hq={hq} Hkv={hkv} D={d} "
            + ("causal" if causal else "non-causal"))


def time_flash(gen, s, dtype, heads=FULL_HEADS, b=1, causal=True, sk=None,
               lse=False):
    """Prefill of b sequences of s tokens over ``heads``, causal, or
    non-causal against sk keys (sk = s by default; cross-attention): kernel,
    plain version and SDPA timed on the same inputs; the bound counts q, k,
    v read once, o written once and 4 * D FLOPs per attended (query, key)
    pair, at the dtype's peak (fp32: 3xTF32). With ``lse`` the kernel also
    writes the log-sum-exp, as the training forward calls it (the bound
    counts its fp32 rows written, the plain version computes it too, and it
    is held within LSE_ATOL)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    hq, hkv, d = heads
    sk = sk or s
    q, k, v = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=N_LAYERS,
                          sk=sk)
    kw = dict(causal=causal, window=0, q_offset=0, sk_valid=sk)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: fa.plain(q, k, v, **kw)  # noqa: E731
    check, shape = None, flash_shape(b, s, sk, heads, causal)
    if lse:
        kernel = lambda: fa.flash_attention(q, k, v,  # noqa: E731
                                            return_lse=True, **kw)
        plain = lambda: (fa.plain(q, k, v, **kw),  # noqa: E731
                         fa.plain_lse(q, k, **kw))

        def check(got, want):
            err, ok = held(got[0], want[0], dtype)
            lse_err = max_err(got[1], want[1])
            return max(err, lse_err), ok and lse_err <= LSE_ATOL
        shape += " +lse"
    return timing_row(
        "flash_attention", shape, dtype, kernel, plain,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True),
        nbytes=b * (2 * s * hq * d + 2 * sk * hkv * d) * q.element_size()
        + (4 * b * s * hq if lse else 0),
        flops=4 * d * hq * attended_pairs(b, s, sk, causal), check=check)


def queued_ms(fn, reps=20, windows=5):
    """Device ms of one call of ``fn`` that a CUDA graph cannot capture
    (SDPA's flash backward), with host time kept out, and the timer's name:
    a spin kernel (``torch.cuda._sleep``) holds the stream while the host
    queues ``reps`` calls behind it between two CUDA events, so the events
    time the card alone. The start event still pending once the last call
    is queued proves the queue never ran dry; otherwise the spin is made
    four times longer. Median of ``windows`` windows; None if even a spin
    of half a second is outrun (``fn`` waits on the card). No capture is
    tried: a capture that fails leaves its side stream current and the
    caching allocator routing every later allocation into the capture's
    private pool, which ``empty_cache`` never returns."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin, per_call = 1 << 24, []
    while len(per_call) < windows:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ran_dry = start.query()
        end.synchronize()
        if not ran_dry:
            per_call.append(start.elapsed_time(end) / reps)
        elif spin >= 1 << 30:
            return None
        else:
            spin <<= 2
    return statistics.median(per_call), "queued events"


def sdpa_backward(q, k, v, dout, causal=True):
    """``torch.autograd.grad`` through SDPA's GQA backward on the
    model-layout inputs, pinned to each backend that takes them
    (``torch.nn.attention.sdpa_kernel``): (call, backend name, ms, timer)
    of the fastest."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = dout.transpose(1, 2)
    best = None
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                ot = F.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=causal,
                                                    enable_gqa=True)

            def call(ot=ot):
                return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                           retain_graph=True)
            timed = queued_ms(call)
        except RuntimeError:  # the backend refuses these inputs
            torch.cuda.synchronize()
            continue
        if timed is None:  # its calls wait on the card: no host-free time
            continue
        ms, timer = timed
        if best is None or ms < best[2]:
            best = (call, backend.name, ms, timer)
    if best is None:
        raise AssertionError("no SDPA backend's backward could be timed")
    return best


def time_flash_bwd(gen, b, s, dtype, heads=FULL_HEADS, causal=True):
    """The backward of b sequences of s tokens, causal or not: kernel (from the
    forward kernel's output and log-sum-exp), ``plain_backward`` (autograd
    of the plain forward, forward included) and, as the library baseline,
    ``torch.autograd.grad`` through SDPA's backward alone (its forward run
    once before), pinned to the fastest backend that takes the inputs
    (``sdpa_backward``); kernel and plain version graph-timed
    (``cuda_ms``), the library call by ``queued_ms``. The bound counts q,
    k, v, o, dO and the lse read once, dQ, dK and dV written once, and the
    five products of the backward (S, dP, dV, dQ, dK: 10 D FLOPs per
    attended (query, key) pair and query head) at the dtype's peak (fp32:
    3xTF32); the kernel computes S and dP twice (seven products)."""
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, d = heads
    q, k, v = attn_inputs(gen, b, s, hq, hkv, d, dtype)
    dout = (torch.randn(b, s, hq, d, generator=gen, device="cuda")
            * 0.5).to(dtype)
    kw = dict(causal=causal, window=0, q_offset=0, sk_valid=s)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    library, backend, _, _ = sdpa_backward(q, k, v, dout, causal)
    return timing_row(
        "flash_attention_bwd", flash_shape(b, s, s, heads, causal), dtype,
        lambda: fa.flash_attention_backward(q, k, v, out, dout, lse, **kw),
        lambda: fa.plain_backward(q, k, v, dout, **kw), library,
        nbytes=b * s * (4 * hq + 4 * hkv) * d * q.element_size() + 4 * b * hq * s,
        flops=10 * d * hq * attended_pairs(b, s, s, causal),
        check=lambda got, want: bwd_held(got, want, dtype),
        library_timer=queued_ms,
        library_name=f"autograd.grad through SDPA ({backend})")


def time_decode(gen, s, cache_len, dtype, heads=FULL_HEADS, window=0):
    """One decode step over len(cache_len) slots of an s-entry cache slice:
    kernel, plain version and SDPA with a boolean mask on the same inputs;
    the bound counts q, the K/V rows it attends to (the valid ones, or a
    window's) and cache_len read once, o written once and 4 * D FLOPs per
    (query head, attended key) pair."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    (hq, hkv, d), b = heads, len(cache_len)
    q, kc, vc = attn_inputs(gen, b, s, hq, hkv, d, dtype, layers=N_LAYERS)
    q = q[:, :1].contiguous()
    lens = torch.tensor(cache_len, dtype=torch.int32, device="cuda")
    k_pos = torch.arange(s, device="cuda")[None, :]
    mask = k_pos < lens[:, None]
    if window:
        mask &= k_pos >= (lens - window)[:, None]
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    n_valid = sum(min(n, window) if window else n for n in cache_len)
    return timing_row(
        "decode_attention", f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
        f"window={window} attended={n_valid}", dtype,
        lambda: dec.decode_attention(q, kc, vc, lens, window=window),
        lambda: dec.plain(q, kc, vc, lens, window=window),
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


def time_rowwise_cold(gen, m, copies=8):
    """``time_rowwise`` with L2 cold: ``copies`` sets of m rows (8 x 19.3
    MB at m = 18891, past the 50 MB L2) taken in turn, so each call reads
    rows that the calls between evicted. Kernel and ``torch.mv`` only; not
    a row of the kernels line."""
    from repro_torch.kernels import similarity as sim
    rows = [unit_rows(gen, m, torch.float32) for _ in range(copies)]
    anchor = unit_rows(gen, 1, torch.float32)[0]
    turn = [0]

    def cycling(fn):
        def call():
            fn(rows[turn[0] % copies], anchor)
            turn[0] += 1
        return call
    line = {"phase": "kernel_timing_cold_l2", "name": "rowwise_cosine",
            "shape": f"M={m} D={EMBED_DIM} anchor float32, {copies} copies "
                     f"of {m * EMBED_DIM * 4 / 1e6:.1f} MB in turn",
            "ms": cuda_ms(cycling(sim.rowwise_cosine), reps=4 * copies),
            "library_ms": cuda_ms(cycling(torch.mv), reps=4 * copies),
            "bound_ms": (m * EMBED_DIM + EMBED_DIM + m) * 4
            / PEAKS["bytes"] * 1e3, "bound_by": "bytes"}
    emit(line)
    return line


# AdamW's leaf sets, those of the benchmark's training cells
# (bench/configs): codeqwen1.5-7b at its published 32/4 heads cut to 4 of
# its 32 layers (1.569B parameters in 15 leaves), granite-moe-1b-a400m
# whole (1.335B in 12)
ADAMW_SETS = {"codeqwen.train.4k": ("codeqwen1.5-7b",
                                    {"n_layers": 4, "n_kv_heads": 4}),
              "granite.train.4k": ("granite-moe-1b-a400m", {})}


def adamw_shapes(arch, fields):
    """The parameter leaves' shapes of ``arch`` with ``fields`` replaced."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = replace(get_config(arch), **fields)
    return [tuple(t.shape) for t in leaves(registry.build(cfg).init(
        device="meta"))]


def time_adamw(gen, cell, shapes):
    """AdamW's two passes over fp32 leaves of ``shapes`` (``cell``'s leaf
    set): the norm within 1e-6 of an fp64 sum and the same bits twice, the
    update bit-equal to the plain version leaf by leaf; then device ms
    (``queued_ms``, each call from an emptied cache, so that no allocation
    waits on the card) of the step as ``apply_updates`` runs it (the norm, the
    clip's 0-dim ops, the update), of each pass alone, of the plain version
    (``plain_norm`` and ``plain`` a leaf: the chain the optimizer ran
    before the kernels) and, as a yardstick only, of
    ``torch.optim.AdamW(fused=True)``'s step on the same leaves (no clip;
    its own order of operations; the port never calls it). The bound: 32
    bytes a parameter over 3.35 TB/s (the norm's 4, the update's 28). Not a
    row of the kernels line: no phase of the smoke trains these leaf
    sets."""
    import math

    from repro_torch.kernels import adamw
    n = sum(math.prod(s) for s in shapes)

    def leaf_list(scale, positive=False):
        flat = (torch.rand(n, generator=gen, device="cuda") if positive
                else torch.randn(n, generator=gen, device="cuda")).mul_(scale)
        return list(torch.split(flat, [math.prod(s) for s in shapes]))
    ps, gs, ms, vs = (leaf_list(0.02), leaf_list(1e-3), leaf_list(1e-4),
                      leaf_list(1e-7, positive=True))
    ps, gs, ms, vs = ([t.view(s) for t, s in zip(ls, shapes)]
                      for ls in (ps, gs, ms, vs))
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    step = torch.tensor(3.0, device="cuda")
    lr = torch.tensor(9e-5, device="cuda")
    b1c, b2c = 1 - kw["b1"] ** step, 1 - kw["b2"] ** step

    def clip(norm):
        return torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
    norm = adamw.global_norm(gs)
    want = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in gs))
    norm_err = abs(float(norm) - want) / want
    repeat = torch.equal(adamw.global_norm(gs), norm)
    new = adamw.update(ps, gs, ms, vs, clip(norm), lr, b1c, b2c, **kw)
    same = all(torch.equal(got, w) for i, leaf in enumerate(zip(ps, gs, ms,
                                                                 vs))
               for got, w in zip((new[0][i], new[1][i], new[2][i]),
                                 adamw.plain(*leaf, clip(norm), lr, b1c,
                                             b2c, **kw)))
    del new
    if not (norm_err <= 1e-6 and repeat and same):
        raise AssertionError(f"adamw at {cell}: norm error {norm_err}, the "
                             f"same bits twice {repeat}, update bit-equal "
                             f"{same}")

    def kernel_step():
        adamw.update(ps, gs, ms, vs, clip(adamw.global_norm(gs)), lr, b1c,
                     b2c, **kw)

    def plain_step():
        scale = clip(adamw.plain_norm(gs))
        for leaf in zip(ps, gs, ms, vs):
            adamw.plain(*leaf, scale, lr, b1c, b2c, **kw)
    timed = {"ms": kernel_step, "norm_ms": lambda: adamw.global_norm(gs),
             "update_ms": lambda: adamw.update(ps, gs, ms, vs, clip(norm),
                                               lr, b1c, b2c, **kw),
             "plain_ms": plain_step}
    line = {"phase": "kernel_timing", "name": "adamw", **KERNELS["adamw"],
            "path": cell, "shape": f"{n} parameters in {len(shapes)} "
            f"leaves torch.float32", "norm_rel_err": norm_err,
            "norm_same_bits_twice": repeat, "update_bit_equal": same}
    params = [torch.nn.Parameter(p) for p in ps]
    for p, g in zip(params, gs):
        p.grad = g
    fused = torch.optim.AdamW(params, lr=9e-5, betas=(kw["b1"], kw["b2"]),
                              eps=kw["eps"], weight_decay=kw["weight_decay"],
                              fused=True)
    timed["library_ms"] = fused.step
    for key, fn in timed.items():
        torch.cuda.empty_cache()
        # the chain (~300 launches a call) and the library's multi-tensor
        # apply (one launch for each run of chunks) launch so many kernels
        # that 20 calls queued would fill the card's launch queue, whose
        # next launch waits on the card: two calls a window
        many = key in ("plain_ms", "library_ms")
        got = queued_ms(fn, reps=2 if many else 20)
        if got is None:
            raise AssertionError(f"adamw at {cell}: {key}'s calls wait on "
                                 f"the card")
        line[key], line["timer"] = got
    line.update(library="torch.optim.AdamW(fused=True).step, no clip",
                bound_ms=32 * n / PEAKS["bytes"] * 1e3, bound_by="bytes",
                norm_bound_ms=4 * n / PEAKS["bytes"] * 1e3,
                update_bound_ms=28 * n / PEAKS["bytes"] * 1e3)
    emit(line)
    del fused, params, ps, gs, ms, vs
    torch.cuda.empty_cache()
    return line


def ssd_flops(s, heads):
    """The fewest FLOPs of an exact form of one sequence's scan: the chunked
    dual form at the chunk length L that needs least. Per chunk of l steps
    and head, C . state (2 l N P), the B (x) dx state update (2 l N P), the
    causal decayed scores times dx (l (l + 1) P) and the state's decay
    (N P); per chunk and group, the causal scores C . B^T (l (l + 1) N),
    which the group's heads share. The exps and masks are not counted.
    L = 1 is the sequential recurrence (5 N P a step and head); at
    mamba2-1.3b's heads L ~ 11 needs least, ~4.19 N P."""
    h, p, n, g = heads

    def chunked(step):
        total = 0
        for start in range(0, s, step):
            l = min(step, s - start)
            total += (h * (4 * l * n * p + l * (l + 1) * p + n * p)
                      + g * l * (l + 1) * n)
        return total
    return min(chunked(step) for step in range(1, min(s, 256) + 1))


def time_ssd(gen, s, heads=SSM_FULL, b=1, dtype=torch.float32):
    """One layer's scan of b sequences of s steps at ``heads`` (mamba2-1.3b's
    or hymba-1.5b's), fp32 (the engine's dtype) or bf16 (training's
    activations): kernel and plain version on the same inputs.
    No single PyTorch call computes the scan, so there is no library time.
    The bound counts dx, dA, B, C read once, y and the final state written
    once, and ``ssd_flops``: the least work of the chunked form."""
    from repro_torch.kernels import ssd_scan as ssd
    h, p, n, g = heads
    args = ssd_inputs(gen, b, s, heads, dtype)
    chunk = ssd.model_chunk(s)
    es = torch.finfo(dtype).bits // 8

    def check(got, want):
        err_y, err_state, ok = ssd_compare(got, want, dtype)
        return max(err_y, err_state), ok
    return timing_row(
        "ssd_scan", f"B={b} S={s} H={h} P={p} N={n} G={g}", dtype,
        lambda: ssd.ssd_scan(*args), lambda: ssd.plain(*args, chunk=chunk),
        None, nbytes=b * ((2 * s * h * p + 2 * s * g * n) * es
                          + (s * h + h * n * p) * 4),
        flops=b * ssd_flops(s, heads), check=check)


def ssd_bwd_flops(s, heads):
    """The fewest FLOPs of one sequence's scan backward in the chunked form
    of ``plain_backward``, at the chunk length that needs least. Per chunk
    of l steps and head: the states entering the chunks (B^T (w o dx),
    2 l N P), the chain of dS ((C o exp(cs))^T dy, 2 l N P), B dS1, dy S0^T
    and dx dS1^T (2 l N P each; y_off o dy and W reuse the last two), M^T dy
    and G = dy dx^T over the causal pairs (l (l + 1) P each), (G o E) B and
    (G o E)^T C (l (l + 1) N each), and the two state decays (N P each);
    per chunk and group, the scores C B^T (l (l + 1) N). Exps and masks are
    not counted."""
    h, p, n, g = heads

    def chunked(step):
        total = 0
        for start in range(0, s, step):
            l = min(step, s - start)
            total += (h * (10 * l * n * p + 2 * l * (l + 1) * (p + n)
                           + 2 * n * p) + g * l * (l + 1) * n)
        return total
    return min(chunked(step) for step in range(1, min(s, 256) + 1))


def time_ssd_bwd(gen, b, s, heads, dtype):
    """The scan's backward as training calls it (no initial state, the
    final state unused) over b sequences of s steps: kernel and
    ``plain_backward`` on the same inputs, both in a CUDA graph. No single
    PyTorch call computes it, so there is no library time. The bound counts
    dx, dA, B, C and dy read once and ddx, ddA, dB and dC written once, and
    ``ssd_bwd_flops``."""
    from repro_torch.kernels import ssd_scan as ssd
    h, p, n, g = heads
    args = ssd_bwd_inputs(gen, b, s, heads, dtype, False, False)
    es = torch.finfo(dtype).bits // 8

    def check(got, want):
        errs, ok = ssd_bwd_held(got, want, dtype)
        return max(errs.values()), ok
    return timing_row(
        "ssd_scan_bwd", f"B={b} S={s} H={h} P={p} N={n} G={g}", dtype,
        lambda: ssd.ssd_scan_backward(*args),
        lambda: ssd.plain_backward(*args), None,
        nbytes=b * s * ((3 * h * p + 4 * g * n) * es + 2 * h * 4),
        flops=b * ssd_bwd_flops(s, heads), check=check)


def time_matrix(gen, m, n):
    """All pairs of m and n unit rows of EMBED_DIM, fp32: kernel, plain
    version and torch.matmul (cuBLAS SGEMM, TF32 off). The bound counts a
    and b read once, the (m, n) output written once and 2 D FLOPs per
    output, at the fp32 (3xTF32) peak."""
    from repro_torch.kernels import similarity as sim
    a, b = unit_rows(gen, m, torch.float32), unit_rows(gen, n, torch.float32)
    return timing_row(
        "cosine_matrix", f"M={m} N={n} D={EMBED_DIM}", torch.float32,
        lambda: sim.cosine_matrix(a, b), lambda: sim.plain_matrix(a, b),
        lambda: torch.matmul(a, b.T),
        nbytes=((m + n) * EMBED_DIM + m * n) * 4, flops=2 * m * n * EMBED_DIM)


def timing_row(name, shape, dtype, kernel, plain, library, *, nbytes, flops,
               check=None, timer=cuda_ms, library_timer=None,
               library_name=None):
    """Time kernel, plain version and library call (None: no single PyTorch
    call computes the function) with ``timer`` (the library call with
    ``library_timer`` where given) after holding the kernel against the
    plain version (``check(got, want) -> (max error, ok)``; default:
    ``held``). A timer may return (ms, the timer's name)."""
    t_bytes = nbytes / PEAKS["bytes"] * 1e3
    t_ops = flops / PEAKS[str(dtype).split(".")[-1]] * 1e3
    check = check or (lambda got, want: held(got, want, dtype))
    err, ok = check(kernel(), plain())
    if not ok:
        raise AssertionError(f"{name} at {shape} {dtype}: max error {err} "
                             f"beyond its tolerance")
    timers = {}

    def timed(key, fn, clock=timer):
        out = clock(fn)
        ms, timers[key] = out if isinstance(out, tuple) else (out, "graph")
        return ms
    row = dict(name=name, **KERNELS[name], shape=f"{shape} {dtype}",
               max_abs_err=err, ms=timed("ms", kernel),
               plain_ms=timed("plain_ms", plain),
               library_ms=(timed("library_ms", library,
                                 library_timer or timer)
                           if library else None),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    extra = {"timers": timers}
    if library_name:
        extra["library"] = library_name
    emit({"phase": "kernel_timing", **row, **extra})
    return row


def movie_rows():
    """Rows of the movie table: cosine_api's all-pairs product is
    movie_rows() x movie_rows()."""
    from repro_torch.data import load_dataset
    return load_dataset("movie")[0].n_rows


def time_kernels(gen):
    """Times at the paths' shapes, in fp32 (the engine's dtype): prefill of
    the longest served prompt (96 tokens after padding to 16), and a decode
    step over 4 slots of the 160-entry cache with the slots midway through
    their 24 new tokens; one cascade morsel of 16 rows; cosine_api's 250 x
    250 product. These rows go into the kernels line. Then the same prefill
    in bf16, and times at long shapes, where the bound is more than launch
    latency: a 2048-token prefill (fp32 and bf16), a decode step over 32
    slots of a 4096-entry cache, a cascade pass over the whole game table
    and a 4096 x 4096 product. Hymba's rows also go into the kernels line:
    its windowed decode step over 4 slots of a full 4096-entry cache
    (window 1024) and its scan at the longest served prompt; so do
    codeqwen1.5-7b's and granite-moe-1b-a400m's prefill and decode step at
    the qwen2 rows' shapes over their heads. Training's rows too: the flash
    forward and backward at the launcher's B = 8, S = 512 over qwen2's heads
    in bf16 (its activations) and at the rewriter's B = 16, S = 384 over
    its heads in fp32; then the backward at the other dtype of each. The
    new paths' rows: seamless-m4t-large-v2's serve (fp32) at its encoder's
    non-causal self-attention over 4 x 4096 frames, its cross-attention
    prefill (32 queries against 4096 keys) and its cross decode step over
    4 slots of the whole 4096-frame cache (a group of 1); its training
    (bf16, B = 4, S = 512) through the forward and the backward, causal
    (the decoder) and non-causal (the encoder and cross-attention);
    qwen2's decode over the dequantized int8 cache (int8_decode: 4 slots,
    64 prompt tokens and 24 steps); internvl2-76b's prefill (256 prefix
    embeddings + 32 tokens) and decode step (4 slots at ~556 of a
    576-entry cache), 64 over 8 heads of 128, fp32. train_mesh's rows, and
    train_mesh_gather's at the same shapes: granite-moe-1b-a400m's flash
    forward with its log-sum-exp and its backward at B = 8, S = 512 over
    16/8 heads of 64 in bf16.
    train_codeqwen's: the same at codeqwen1.5-7b's 32/32 heads of 128; and,
    outside the line, the fp32 backward at head_dim 128 (the CUDA-core
    instance) at its cross-check's (2, 256), and AdamW's two passes over
    the benchmark's training cells' leaves (``time_adamw``)."""
    lens, padded = served_prefill_lengths()
    plots = movie_rows()
    mid = [n + 12 for n in lens[:4]]
    rows = [time_flash(gen, max(padded), torch.float32),
            time_decode(gen, 160, mid, torch.float32),
            time_rowwise(gen, 16), time_matrix(gen, plots, plots),
            time_ssd(gen, max(padded)),
            time_decode(gen, 4096, [4096] * 4, torch.float32,
                        heads=HYMBA_HEADS, window=HYMBA_WINDOW),
            time_ssd(gen, max(padded), heads=SSM_HYMBA),
            time_flash(gen, max(padded), torch.float32, heads=CODEQWEN_HEADS),
            time_decode(gen, 160, mid, torch.float32, heads=CODEQWEN_HEADS),
            time_flash(gen, max(padded), torch.float32, heads=GRANITE_HEADS),
            time_decode(gen, 160, mid, torch.float32, heads=GRANITE_HEADS)]
    rows += [time_flash(gen, TRAIN_SEQ, torch.bfloat16, b=TRAIN_BATCH),
             time_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16),
             time_flash(gen, 384, torch.float32, heads=REWRITER_HEADS, b=16),
             time_flash_bwd(gen, 16, 384, torch.float32,
                            heads=REWRITER_HEADS)]
    paths = ["serve", "serve", "semantic", "cosine_api", "serve_ssm",
             "serve_hybrid", "serve_hybrid", "serve_codeqwen",
             "serve_codeqwen", "serve_moe", "serve_moe", "train", "train",
             "train_rewriter", "train_rewriter"]
    vlm_len = VLM_PREFIX + VLM_TEXT
    rows += [time_flash(gen, ENC_FRAMES, torch.float32, heads=SEAMLESS_HEADS,
                        b=ENCDEC_BATCH, causal=False),
             time_flash(gen, ENCDEC_PROMPT, torch.float32,
                        heads=SEAMLESS_HEADS, b=ENCDEC_BATCH, causal=False,
                        sk=ENC_FRAMES),
             time_decode(gen, ENC_FRAMES, list(ENCODER_LENS), torch.float32,
                         heads=SEAMLESS_HEADS),
             time_flash(gen, TRAIN_SEQ, torch.bfloat16, heads=SEAMLESS_HEADS,
                        b=ENCDEC_BATCH, causal=False),
             time_flash_bwd(gen, ENCDEC_BATCH, TRAIN_SEQ, torch.bfloat16,
                            heads=SEAMLESS_HEADS),
             time_flash_bwd(gen, ENCDEC_BATCH, TRAIN_SEQ, torch.bfloat16,
                            heads=SEAMLESS_HEADS, causal=False),
             time_decode(gen, INT8_PROMPT + INT8_STEPS,
                         [INT8_PROMPT + INT8_STEPS // 2] * 4, torch.float32),
             time_flash(gen, vlm_len, torch.float32, heads=VLM_HEADS,
                        b=VLM_BATCH),
             time_decode(gen, VLM_MAX_LEN,
                         [vlm_len + VLM_PREFIX + VLM_STEPS // 2] * VLM_BATCH,
                         torch.float32, heads=VLM_HEADS)]
    paths += ["serve_encdec"] * 3 + ["train_encdec"] * 3 + ["int8_decode"] \
        + ["serve_vlm"] * 2
    bf16 = torch.bfloat16
    rows += [time_ssd(gen, SSM_TRAIN_SHAPE[1], b=SSM_TRAIN_SHAPE[0],
                      dtype=bf16),
             time_ssd_bwd(gen, *SSM_TRAIN_SHAPE, SSM_FULL, bf16),
             time_ssd(gen, HYBRID_TRAIN_SHAPE[1], heads=SSM_HYMBA,
                      b=HYBRID_TRAIN_SHAPE[0], dtype=bf16),
             time_ssd_bwd(gen, *HYBRID_TRAIN_SHAPE, SSM_HYMBA, bf16)]
    paths += ["train_ssm"] * 2 + ["train_hybrid"] * 2
    rows += [time_flash(gen, TRAIN_SEQ, bf16, heads=GRANITE_HEADS,
                        b=TRAIN_BATCH, lse=True),
             time_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, bf16,
                            heads=GRANITE_HEADS)]
    paths += ["train_mesh"] * 2
    rows += [time_flash(gen, TRAIN_SEQ, bf16, heads=GRANITE_HEADS,
                        b=TRAIN_BATCH, lse=True),
             time_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, bf16,
                            heads=GRANITE_HEADS)]
    paths += ["train_mesh_gather"] * 2
    rows += [time_flash(gen, TRAIN_SEQ, bf16, heads=CODEQWEN_HEADS,
                        b=TRAIN_BATCH, lse=True),
             time_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, bf16,
                            heads=CODEQWEN_HEADS)]
    paths += ["train_codeqwen"] * 2
    for heads, path in ((DEEPSEEK_HEADS, "serve_deepseek"),
                        (LLAMA4_HEADS, "serve_llama4")):
        rows += [time_flash(gen, BIG_PROMPT, torch.float32, heads=heads,
                            b=BIG_BATCH),
                 time_decode(gen, BIG_MAX_LEN,
                             [BIG_PROMPT + BIG_STEPS // 2] * BIG_BATCH,
                             torch.float32, heads=heads)]
        paths += [path] * 2
    for row, path in zip(rows, paths):
        row["path"] = path
    time_flash(gen, max(padded), torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        time_flash(gen, 2048, dtype)
    time_decode(gen, 4096, list(range(128, 4097, 128)), torch.float32)
    time_rowwise(gen, COSINE_ROWS[-1])
    time_rowwise_cold(gen, COSINE_ROWS[-1])
    time_matrix(gen, 4096, 4096)
    time_ssd(gen, 2048)
    time_flash_bwd(gen, TRAIN_BATCH, TRAIN_SEQ, torch.float32)
    time_flash_bwd(gen, 16, 384, torch.bfloat16, heads=REWRITER_HEADS)
    time_flash_bwd(gen, CROSS_BATCH, CROSS_SEQ, torch.float32,
                   heads=CODEQWEN_HEADS)
    time_ssd_bwd(gen, *SSM_TRAIN_SHAPE, SSM_FULL, torch.float32)
    for cell, (arch, fields) in ADAMW_SETS.items():
        time_adamw(gen, cell, adamw_shapes(arch, fields))
    return rows


def run_serve(phase, flags):
    """``serve`` in token mode with ``flags``, its launch counts read around
    it; emits the phase's line and returns (engine, launch counts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(flags)
    ops.reset_launch_counts()
    finished, engine, seconds = serve.serve_tokens(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st, cfg = engine.stats, engine.bundle.cfg
    lats = sorted(r.done_s - r.submitted_s for r in finished.values())
    new_toks = sum(len(r.output_ids) for r in finished.values())
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": cfg.param_count(), "requests": len(finished),
          "seconds": seconds, "new_tokens": new_toks,
          "new_tok_per_s": new_toks / seconds,
          "p50_s": float(np.percentile(lats, 50)),
          "p99_s": float(np.percentile(lats, 99)),
          "occupancy": engine.occupancy, "prefills": st["prefills"],
          "decode_steps": st["decode_steps"], "prefill_s": st["prefill_s"],
          "decode_s": st["decode_s"], "launches": counts})
    if len(finished) != 8 or not all(r.output_ids for r in finished.values()):
        raise AssertionError(f"{phase}: not every request finished with output")
    return engine, counts


def set_launches(rows, counts, path, *names):
    """The launch counts of ``path``'s run into its rows of ``names``."""
    for r in rows:
        if r["name"] in names and r["path"] == path:
            r["launches"] = counts[r["name"]]


def phase_serve(rows, phase="serve", flags=QWEN_SERVE):
    """A GQA model (qwen2-0.5b; codeqwen1.5-7b, granite-moe-1b-a400m):
    every prefill launches ``flash_attention`` and every decode tick
    ``decode_attention`` once per layer; no other kernel runs (granite's
    MoE is plain PyTorch: the reference has no kernel for it)."""
    engine, counts = run_serve(phase, flags)
    want = expect(**attention_launches(engine))
    if counts != want or not (counts["flash_attention"]
                              and counts["decode_attention"]):
        raise AssertionError(f"launch counts {counts}, expected {want}")
    set_launches(rows, counts, phase, "flash_attention", "decode_attention")
    return engine


def phase_serve_ssm(rows):
    """Full-width mamba2-1.3b: every prefill launches ``ssd_scan`` once per
    layer; decode is plain PyTorch (the reference has no kernel for it), and
    no other kernel runs."""
    engine, counts = run_serve("serve_ssm", SSM_SERVE)
    want = expect(ssd_scan=SSM_LAYERS * engine.stats["prefills"])
    if counts != want or not counts["ssd_scan"]:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    set_launches(rows, counts, "serve_ssm", "ssd_scan")
    return engine


def phase_serve_hybrid(rows):
    """Full-width hymba-1.5b: every prefill launches ``flash_attention`` and
    ``ssd_scan`` once per layer (attention and the SSM side by side), every
    decode tick ``decode_attention`` once per layer, 29 of them with the
    window of 1024; no other kernel runs."""
    engine, counts = run_serve("serve_hybrid", HYMBA_SERVE)
    st = engine.stats
    want = expect(flash_attention=HYMBA_LAYERS * st["prefills"],
                  decode_attention=HYMBA_LAYERS * st["decode_steps"],
                  ssd_scan=HYMBA_LAYERS * st["prefills"])
    if counts != want or not all(counts[k] for k in (
            "flash_attention", "decode_attention", "ssd_scan")):
        raise AssertionError(f"launch counts {counts}, expected {want}")
    set_launches(rows, counts, "serve_hybrid", "decode_attention", "ssd_scan")
    return engine


def phase_serve_mla(rows):
    """Full-width minicpm3-4b (tier m3): MLA's prefill and absorbed decode
    run in plain PyTorch, as the reference runs them in jnp, so no kernel
    launches at all."""
    engine, counts = run_serve("serve_mla", MLA_SERVE)
    want = expect()
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return engine


def release():
    """Free the card's memory of the phase that ended (its engine and
    weights are unreachable once its function returns), so no two large
    models are on the card at once."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "release",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9})


def to_cpu(tree):
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def phase_window_decode():
    """The sliding window through the model on the card: reduced hymba
    (2 layers, window 64 on layer 1) prefills a 16-token prompt and decodes
    greedily to position 150 on the card; the CPU decodes the same tokens
    (the card's choices) from the same weights. Every step's logits within
    LOGITS_ATOL of the CPU's and with the same argmax; launches one flash
    and one ``ssd_scan`` per layer, one decode per layer and step."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    cfg = reduced(get_config("hymba-1.5b"))
    bundle = registry.build(cfg)
    params = bundle.init(generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    cpu_params = to_cpu(params)
    prompt = torch.randint(0, cfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(0))
    max_len, kw = 152, dict(max_len=152, dtype=torch.float32)
    ops.reset_launch_counts()
    logits, cache = bundle.prefill(params, {"tokens": prompt.cuda()}, **kw)
    cpu_logits, cpu_cache = bundle.prefill(cpu_params, {"tokens": prompt},
                                           **kw)
    errs, same = [max_err(logits.cpu(), cpu_logits)], True
    steps = 0
    while int(cache["pos"]) < max_len - 2:
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        same &= int(tok) == int(cpu_logits[:, -1].argmax())
        logits, cache = bundle.decode_step(params, cache, tok,
                                           dtype=torch.float32)
        cpu_logits, cpu_cache = bundle.decode_step(
            cpu_params, cpu_cache, tok.cpu(), dtype=torch.float32)
        errs.append(max_err(logits.cpu(), cpu_logits))
        steps += 1
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = expect(flash_attention=cfg.n_layers, ssd_scan=cfg.n_layers,
                  decode_attention=cfg.n_layers * steps)
    last = int(cache["pos"])
    emit({"phase": "window_decode", "arch": cfg.name,
          "windows": [0 if i in cfg.full_attn_layers else cfg.sliding_window
                      for i in range(cfg.n_layers)],
          "prompt": prompt.shape[1], "decode_steps": steps,
          "last_position": last, "max_abs_err": max(errs),
          "max_abs_err_past_window": max(errs[cfg.sliding_window - 15:]),
          "atol": LOGITS_ATOL, "argmax_equal": same, "launches": counts})
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if not (same and max(errs) <= LOGITS_ATOL
            and last > 2 * cfg.sliding_window):
        raise AssertionError("window_decode: the card's windowed decode and "
                             "the CPU's disagree")


def cut_depth(engine, n_layers):
    """The served model cut to its first ``n_layers`` layers at full
    width: (bundle, params), the layers as views of the served weights."""
    from dataclasses import replace

    from repro_torch.models import registry
    cfg = replace(engine.bundle.cfg, n_layers=n_layers)
    params = dict(engine.params)
    params["layers"] = layers_upto(engine.params["layers"], n_layers)
    return registry.build(cfg), params


def layers_upto(tree, n):
    return {k: layers_upto(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def phase_cross_check(engine, phase="cross_check", state_leaf=None,
                      layers=None):
    """Prefill logits of one prompt on the card (kernels) and on the CPU
    (plain path) from the same fp32 weights, and with ``state_leaf`` that
    cache leaf too (the SSM's final state); with ``layers``, the model cut
    to its first ``layers`` layers at full width, on both sides (the CPU's
    copy of the whole model would not fit the host). Tolerance: sums in
    another order over 24 to 62 layers move fp32 logits by ~1e-5; 1e-3
    leaves a wide margin below any real fault."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.engine.engine import PREFILL_ALIGN
    from repro_torch.launch.serve import DEMO_PROMPTS
    tok = ByteTokenizer()
    ids = tok.pad_batch([tok.encode(DEMO_PROMPTS[0])], align=PREFILL_ALIGN)
    bundle, params = ((engine.bundle, engine.params) if layers is None
                      else cut_depth(engine, layers))
    gpu, gcache = bundle.prefill(
        params, {"tokens": torch.as_tensor(ids, device="cuda")},
        dtype=torch.float32)
    cpu, ccache = bundle.prefill(to_cpu(params),
                                 {"tokens": torch.as_tensor(ids)},
                                 dtype=torch.float32)
    gpu = gpu.cpu()
    err = max_err(gpu, cpu)
    finite = bool(torch.isfinite(gpu).all())
    same_argmax = int(gpu[0, -1].argmax()) == int(cpu[0, -1].argmax())
    line = {"phase": phase, "tokens": ids.shape[1],
            "layers": bundle.cfg.n_layers,
            "layers_served": engine.bundle.cfg.n_layers,
            "logits_shape": list(gpu.shape), "max_abs_err": err,
            "atol": LOGITS_ATOL, "finite": finite,
            "max_abs_logit": gpu.abs().max().item(),
            "argmax_equal": same_argmax}
    ok = (finite and err <= LOGITS_ATOL and same_argmax
          and tuple(gpu.shape) == (1, 1, bundle.cfg.vocab_size))
    if state_leaf:
        state_err = max_err(gcache[state_leaf].cpu(), ccache[state_leaf])
        line.update({f"{state_leaf}_max_abs_err": state_err,
                     f"{state_leaf}_max_abs": ccache[state_leaf].abs().max()
                     .item()})
        ok = ok and state_err <= LOGITS_ATOL
    emit(line)
    if not ok:
        raise AssertionError(f"{phase}: card and CPU prefill disagree")


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
    by_kind = {"attention kernels": 0.0, "flash backward": 0.0,
               "ssd_scan": 0.0, "ssd_scan backward": 0.0,
               "rowwise_cosine": 0.0, "cosine_matrix": 0.0, "matmul": 0.0,
               "collectives": 0.0, "other": 0.0}
    decode_kernels = 0
    by_name = {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + stop - start
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        decode_kernels += "decode_" in name
        kind = ("attention kernels" if "flash_fwd" in name or "decode_" in name
                else "flash backward" if any(
                    k in name for k in ("bwd_delta", "bwd_dq_wgmma", "bwd_dkdv_wgmma"))
                else "ssd_scan" if "ssd_scan_kernel" in name
                else "ssd_scan backward" if any(
                    k in name for k in ("bwd_walk", "bwd_chunk",
                                        "bwd_group_sum"))
                else "rowwise_cosine" if "rowwise_" in name
                else "cosine_matrix" if "matrix_kernel" in name
                else "matmul" if any(k in name.lower() for k in (
                    "gemm", "gemv", "nvjet"))
                else "collectives" if "nccl" in name.lower()
                else "other")
        by_kind[kind] += stop - start
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "top_kernels_ms": {n[:80]: v / 1e3 for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]},
            "device_kernels": len(spans), "decode_kernels": decode_kernels}


def phase_profile(engine, phase="profile"):
    """Where serve time goes: torch.profiler over 4 more requests (prefills
    and decode ticks) on the served engine. The device kernels per decode
    tick show that ``decode_attention`` is one kernel per layer: the count
    of kernels named ``decode_*`` must be GQA layers x ticks (0 for MLA
    and SSM models)."""
    from repro_torch.engine import ContinuousBatcher
    from repro_torch.launch.serve import DEMO_PROMPTS
    batcher = ContinuousBatcher(engine)
    for i in range(4):
        batcher.submit(DEMO_PROMPTS[i], max_new_tokens=8)
    before = dict(engine.stats)
    activity = profiled(batcher.run)
    ticks = engine.stats["decode_steps"] - before["decode_steps"]
    cfg = engine.bundle.cfg
    # layers whose decode launches the kernel: GQA ones (not MLA, not SSM)
    attn_layers = cfg.n_layers if cfg.attn_type == "gqa" else 0
    emit({"phase": phase, "requests": 4,
          "prefills": engine.stats["prefills"] - before["prefills"],
          "decode_steps": ticks, **activity,
          "decode_kernels_per_tick":
              activity["decode_kernels"] / max(ticks, 1)})
    if activity["decode_kernels"] != attn_layers * ticks:
        raise AssertionError(
            f"{phase}: {activity['decode_kernels']} decode_attention device "
            f"kernels over {ticks} ticks, expected one per attention layer")


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
    """One flash launch per layer and prefill, one decode launch per layer
    and tick (24 layers at full width, 2 reduced)."""
    layers = engine.bundle.cfg.n_layers
    return {"flash_attention": layers * engine.stats["prefills"],
            "decode_attention": layers * engine.stats["decode_steps"]}


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
    want = expect(**attention_launches(engine),
                  rowwise_cosine=tiers.get(cost_model.EMBED_TIER_NAME, 0))
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
    if counts != want or not all(counts[k] for k in (
            "flash_attention", "decode_attention", "rowwise_cosine")):
        raise AssertionError(f"launch counts {counts}, expected {want}")
    cpu_handles, _, cpu_ctx, cpu_seconds = run_semantic(
        STREAMING + ["--reduced", "--device", "cpu"])
    cpu_keys = query_keys(cpu_handles)
    same = cpu_keys == keys
    emit({"phase": "semantic_cpu_check", "flags": STREAMING + ["--reduced"],
          "device": "cpu", "host_s": cpu_seconds,
          "tier_calls": {t: u.calls for t, u in
                         sorted(cpu_ctx.meter.by_tier.items())},
          "equal_to_card": same,
          "differences": [
              {"query": card[0], "results_equal": card[1] == cpu[1],
               "card_calls": card[2], "cpu_calls": cpu[2],
               "card_cascade": card[3], "cpu_cascade": cpu[3]}
              for card, cpu in zip(keys, cpu_keys) if card != cpu]})
    if not same:
        raise AssertionError("the card's semantic run and the CPU's differ "
                             "in results, per-tier calls or cascade stats")
    set_launches(rows, counts, "semantic", "rowwise_cosine")


def phase_semantic_single():
    """The single-query mode: q1 (a map) on m1 alone, at full width."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    res, engine, ctx, seconds = run_semantic(
        SEMANTIC + ["--no-reduced", "--device", "cuda"])
    counts = ops.launch_counts()
    want = expect(**attention_launches(engine))
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


def meter_totals(ctx):
    """Per tier: calls, tokens and price of a run (its measured latencies
    differ from run to run)."""
    return {t: (u.calls, round(u.tok_in, 6), round(u.tok_out, 6),
                round(u.usd, 9)) for t, u in sorted(ctx.meter.by_tier.items())}


def phase_semantic_sharded():
    """The streaming semantic run at reduced width on the card (m1 the
    2-layer qwen2, the cascade on ``rowwise_cosine``), unsharded, through
    two shard workers and through two spawned process workers. m1 and the
    cascade stay in this process (they hold the card), so every kernel
    launch is counted here; the workers serve the simulated tiers. Results,
    per-tier calls, meter totals and cascade stats must equal the
    unsharded run's."""
    from repro_torch.core import cost_model
    from repro_torch.kernels import ops
    flags = STREAMING + ["--reduced", "--device", "cuda"]
    runs = {}
    for name, extra in (("unsharded", []), ("shards", ["--shards", "2"]),
                        ("procs", ["--procs", "2"])):
        ops.reset_launch_counts()
        handles, engine, ctx, seconds = run_semantic(flags + extra)
        counts = ops.launch_counts()
        keys, totals = query_keys(handles), meter_totals(ctx)
        want = expect(**attention_launches(engine), rowwise_cosine=totals.get(
            cost_model.EMBED_TIER_NAME, (0,))[0])
        emit({"phase": "semantic_sharded", "run": name,
              "flags": flags + extra, "arch": engine.bundle.cfg.name,
              "host_s": seconds, "tier_totals": totals,
              "cascade": {k[0]: k[3] for k in keys},
              "equal_to_unsharded": (keys, totals) == runs.get(
                  "unsharded", (keys, totals)),
              "launches": counts})
        if counts != want or not counts["rowwise_cosine"]:
            raise AssertionError(f"{name}: launch counts {counts}, "
                                 f"expected {want}")
        runs[name] = (keys, totals)
    if not runs["shards"] == runs["procs"] == runs["unsharded"]:
        raise AssertionError("semantic_sharded: the sharded or process runs "
                             "differ from the unsharded one in results, "
                             "per-tier calls, meter totals or cascade stats")


def phase_cosine_api(rows):
    """``kernels.ops.cosine_matrix``, the kernel's one entry point (the JAX
    package calls its Pallas ``cosine_matrix`` only from ``ops`` and the
    tests): the whole movie table's plots, embedded as the semantic layer
    embeds them, against themselves, on the card; held against the numpy
    product ``core.semhash.cosine_matrix`` (atol 1e-5)."""
    from repro_torch.core import semhash
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops
    table, _ = load_dataset("movie")
    emb = semhash.embed(table.columns["Plot"])
    a = torch.as_tensor(emb, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = ops.cosine_matrix(a, a).cpu().numpy()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_sim = semhash.cosine_matrix(emb, emb)
    err = float(np.abs(got - want_sim).max())
    emit({"phase": "cosine_api", "rows": len(emb), "D": emb.shape[1],
          "shape": list(got.shape), "host_s": seconds, "max_abs_err": err,
          "atol": 1e-5, "diag_min": float(np.diag(got).min()),
          "launches": counts})
    want = expect(cosine_matrix=1)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if got.shape != (table.n_rows, table.n_rows) or err > 1e-5:
        raise AssertionError("cosine_matrix on the card disagrees with the "
                             "numpy product")
    set_launches(rows, counts, "cosine_api", "cosine_matrix")


def train_args(ckpt_dir, flags=TRAIN):
    from repro_torch.launch import train
    return train.build_parser().parse_args(flags + ["--ckpt-dir", ckpt_dir])


def phase_train_synthetic():
    """The launcher's own batches, uniform random tokens, for the train
    phase's 12 steps without a checkpoint: every loss finite, the launch
    counts exact. The losses are reported and not held to fall: nothing in
    these batches can be learnt (the loss can only fall towards ln(vocab) =
    11.93 from the tied embedding's initial excess)."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    flags = TRAIN[:TRAIN.index("--ckpt-every")] + ["--ckpt-every", "1000"]
    ckpt = os.path.join(CKPT_ROOT, "synthetic")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    ops.reset_launch_counts()
    out = train.run(train_args(ckpt, flags))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    losses = [e["loss"] for e in out["log"]]
    layers = out["cfg"].n_layers
    want = expect(flash_attention=2 * layers * TRAIN_STEPS,
                  flash_attention_bwd=layers * TRAIN_STEPS,
                  adamw=2 * TRAIN_STEPS)
    emit({"phase": "train_synthetic", "flags": flags,
          "seconds": out["seconds"], "losses": losses,
          "median_step_s": float(np.median([e["seconds"]
                                            for e in out["log"]])),
          "launches": counts})
    if counts != want or not all(np.isfinite(losses)):
        raise AssertionError(f"train_synthetic: launch counts {counts} "
                             f"(expected {want}) or a loss not finite")


def train_launches(cfg, steps, updates=0):
    """The launches of ``steps`` training steps under remat: per layer and
    step, each kernel's forward twice (the forward and remat's recompute)
    and its backward once; flash for GQA attention, the scan for an SSM
    mixer (a hybrid's layer has both); AdamW's two passes (the norm and the
    update) for each of ``updates`` steps on card leaves whose mesh dims,
    if any, have one rank (none where the step ends at the gradient);
    nothing else."""
    per = {}
    if cfg.attn_type == "gqa":
        per.update(flash_attention=2, flash_attention_bwd=1)
    if cfg.ssm is not None:
        per.update(ssd_scan=2, ssd_scan_bwd=1)
    return expect(**{k: v * cfg.n_layers * steps for k, v in per.items()},
                  adamw=2 * updates)


def phase_train(rows, phase="train", flags=TRAIN, ckpt=True, cfg=None,
                peak_predicted=None):
    """``launch.train`` at full width with ``flags``: fp32 weights and
    AdamW moments, bf16 activations, each layer recomputed in the
    backward. train: qwen2-0.5b (24 layers), 12 steps of 8 x 512 tokens
    with a checkpoint every 4 steps (``ckpt``). train_ssm / train_hybrid:
    mamba2-1.3b (48 layers, d_model 2048, 64 SSM heads of 64, d_state 128)
    and hymba-1.5b at ``train_flags``, no checkpoint. Every loss finite and
    the last below the first; the launches exactly ``train_launches``.
    Then two more steps from the final state under torch.profiler for the
    card's idle share. Without a checkpoint, and so no restart to show the
    step deterministic, one gradient from the final state and the next
    batch computed twice: the same bits. ``cfg``: a config built already
    (train_codeqwen: full width cut in depth) for ``train.run``; with
    ``peak_predicted`` ((lo, hi) GB) the peak is printed beside it and must
    stay under the card's DEVICE_GB. Returns the final state, for
    train_restart."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.training.train_loop import grad_tree
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    ckpt_dir = os.path.join(CKPT_ROOT, phase)
    args = train_args(ckpt_dir, flags)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.run(args, cfg=cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, log, state = out["cfg"], out["log"], out["state"]
    losses = [e["loss"] for e in log]
    step_s = [e["seconds"] for e in log]
    tokens = args.batch * args.seq
    want = train_launches(cfg, args.steps, updates=args.steps)

    def two_steps():  # from the final state; the new states are dropped
        for i in range(2):
            out["train_step"](state, out["batch_fn"](args.steps + i))
    activity = profiled(two_steps)
    busy_step_ms = activity["device_busy_ms"] / 2
    extra, same = {}, True
    if ckpt:
        extra = {"stragglers": out["straggler"].flagged,
                 "checkpoints": sorted(os.listdir(ckpt_dir)),
                 "disk_free_gb": shutil.disk_usage(CKPT_ROOT).free / 1e9}
    else:
        bundle, batch = registry.build(cfg), out["batch_fn"](args.steps)
        params = state["params"]
        for p in leaves(params):
            p.requires_grad_(True)

        def gradient():
            loss = bundle.loss_fn(params, batch, dtype=torch.bfloat16,
                                  remat=True)
            return leaves(grad_tree(loss, params))
        first = gradient()
        same = all(torch.equal(x, y) for x, y in zip(first, gradient()))
        extra = {"gradient_bit_equal_twice": same}
        del first
    if peak_predicted:
        extra["peak_predicted_gb"] = list(peak_predicted)
    emit({"phase": phase, "flags": flags, "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": sum(p.numel() for p in leaves(state["params"])),
          "steps": len(log), "seconds": out["seconds"],
          "tok_per_s": args.steps * tokens / out["seconds"],
          "step_s": step_s, "median_step_s": float(np.median(step_s)),
          "tok_per_s_median_step": tokens / float(np.median(step_s)),
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "grad_norm_last": log[-1]["grad_norm"],
          "peak_memory_gb": peak_gb, "launches": counts,
          "profile_2_steps": activity,
          "busy_ms_per_profiled_step": busy_step_ms,
          "idle_share_of_median_step":
              1.0 - busy_step_ms / (1e3 * float(np.median(step_s))),
          **extra})
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    MEASURED[phase] = {"launches": counts, "steps": len(log),
                       "peak_memory_gb": peak_gb}
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and same):
        raise AssertionError(f"{phase}: losses {losses} not finite and "
                             f"falling, or a repeated gradient differs")
    if peak_predicted and peak_gb >= DEVICE_GB:
        raise AssertionError(f"{phase}: peak {peak_gb} GB, not under the "
                             f"card's {DEVICE_GB}")
    set_launches(rows, counts, phase, *(k for k, v in want.items() if v))
    return state


def leaves(tree):
    from repro_torch.training.optimizer import leaves as tree_leaves
    return tree_leaves(tree)


def phase_train_restart(reference):
    """The train phase's run again, with a failure injected after step
    FAIL_AT: ``run_with_restarts`` restores the checkpoint of step 3 and
    runs steps 4-11 again. Its final state (params, moments, step) against
    the uninterrupted run's, leaf by leaf: within RESTART_RTOL of each
    leaf's largest |value|, and whether bit-identical (every kernel of the
    step is deterministic: the flash backward has no atomics, the
    embedding's gradient sorts, AdamW's norm adds in a fixed order).
    Launches: the 7 steps before the failure and the 8 after the
    restore."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    ckpt = os.path.join(CKPT_ROOT, "restart")
    ops.reset_launch_counts()
    out = train.run(train_args(ckpt), fail_at={FAIL_AT})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    resumed = (FAIL_AT + 1) // TRAIN_EVERY * TRAIN_EVERY
    ran = FAIL_AT + 1 + TRAIN_STEPS - resumed
    layers = out["cfg"].n_layers
    want = expect(flash_attention=2 * layers * ran,
                  flash_attention_bwd=layers * ran, adamw=2 * ran)
    rel, same = 0.0, True
    for x, y in zip(leaves(out["state"]), leaves(reference)):
        x, y = x.detach().double(), y.detach().double()
        rel = max(rel, (x - y).abs().max().item()
                  / max(y.abs().max().item(), 1e-30))
        same = same and torch.equal(x, y)
    emit({"phase": "train_restart", "fail_at": FAIL_AT,
          "restarts": out["restarts"], "resumed_at_step": resumed,
          "steps_run": ran, "seconds": out["seconds"],
          "loss_last": out["log"][-1]["loss"],
          "leaves": len(leaves(reference)), "max_rel_diff": rel,
          "rtol": RESTART_RTOL, "bit_identical": same, "launches": counts})
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    if counts != want:
        raise AssertionError(f"train_restart: launch counts {counts}, "
                             f"expected {want}")
    if out["restarts"] != 1 or rel > RESTART_RTOL:
        raise AssertionError("train_restart: the restarted run's state "
                             "differs from the uninterrupted run's")


def phase_cross_check_train(phase="cross_check_train", arch="qwen2-0.5b",
                            shape=(CROSS_BATCH, CROSS_SEQ)):
    """One training step's loss and gradient in fp32 on the card (the
    flash and scan kernels, forward and backward) and on the CPU (plain
    versions): ``arch`` at full width cut to its first TRAIN_CUT layers,
    on a batch of the launcher's pipeline, with remat
    (``cross_check_step``). qwen2-0.5b and mamba2-1.3b at (2, 256);
    hymba-1.5b at HYBRID_CROSS, past its window of 1024, with full
    attention on its layer 0 and the window on the other three."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    cfg = replace(get_config(arch), n_layers=TRAIN_CUT)
    toks = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=shape[0],
                         seq_len=shape[1]).batch_at(0)["tokens"]
    cross_check_step(phase, cfg, {"tokens": torch.as_tensor(toks)},
                     train_launches(cfg, 1))


def cross_check_step(phase, cfg, batch, want, moe_ctx=None):
    """One training step's loss and gradient in fp32 on the card and on the
    CPU from the same weights, seeded on the CPU and carried to the card
    through ``convert.params_from_numpy``, on ``batch`` (CPU tensors), with
    remat; the card's launches must be ``want``. Tolerances: the loss 1e-5
    relative and the grad norm 1e-4 relative; every gradient leaf within
    1e-4 of its largest |value| (fp32 sums in other orders through the
    layers and their backward, as the CPU tests hold the port against
    JAX). ``moe_ctx``: each side's (by device) for the loss."""
    from repro_torch import convert
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_loop import grad_tree
    bundle = registry.build(cfg)
    cpu = bundle.init(generator=torch.Generator().manual_seed(0),
                      device="cpu", requires_grad=True)
    flat = {}

    def collect(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                collect(v, path + (k,))
            else:
                stacked = path[:1] and path[0] in convert.STACKED
                axes = (("layer",) if stacked else ()) + \
                    (None,) * (v.dim() - bool(stacked))
                flat["/".join(path + (k,))] = (v.detach().numpy(), axes)
    collect(cpu, ())
    card = convert.params_from_numpy(flat, device="cuda", requires_grad=True)
    out = {}
    for side, params in (("cuda", card), ("cpu", cpu)):
        ops.reset_launch_counts()
        loss = bundle.loss_fn(params, {k: v.to(side) for k, v in
                                       batch.items()},
                              dtype=torch.float32, remat=True,
                              moe_ctx=(moe_ctx or {}).get(side))
        grads = grad_tree(loss, params)
        out[side] = (float(loss.detach()), float(global_norm(grads)), grads,
                     ops.launch_counts())
    counts = out["cuda"][3]
    worst, worst_leaf = 0.0, None
    for g, c, name in zip(leaves(out["cuda"][2]), leaves(out["cpu"][2]),
                          sorted(flat)):
        rel = (g.cpu() - c).abs().max().item() / max(
            c.abs().max().item(), 1e-30)
        if rel >= worst:
            worst, worst_leaf = rel, name
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    norm_rel = abs(out["cuda"][1] - out["cpu"][1]) / out["cpu"][1]
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
          "tokens": list(batch["tokens"].shape),
          "loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
          "loss_rel_diff": loss_rel, "grad_norm_card": out["cuda"][1],
          "grad_norm_cpu": out["cpu"][1], "grad_norm_rel_diff": norm_rel,
          "worst_leaf": worst_leaf, "worst_leaf_rel_diff": worst,
          "tol": {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-4},
          "launches": counts})
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}")
    if not (loss_rel <= 1e-5 and norm_rel <= 1e-4 and worst <= 1e-4):
        raise AssertionError(f"{phase}: the card's step and the CPU's "
                             f"disagree")


def phase_train_rewriter(rows):
    """The §3.3 example on the card with REWRITER_STEPS steps: the reduced
    qwen2 (4/2 heads of 32) trains in fp32 through the flash forward and
    backward kernels (no remat: one forward launch per layer and step),
    then scores rewrites as the LocalModelRewriter. Launches: the backward
    2 x steps; the forward 2 x (steps + accuracy evaluations + policy
    calls); AdamW's two passes a step; every rewrite the logical optimizer
    asked for scored by the model (none fell back to a random pick)."""
    from repro_torch.examples import train_rewriter
    from repro_torch.kernels import ops
    steps = REWRITER_STEPS
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_rewriter.main(["--steps", str(steps)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    evals = 3 + sum((i + 1) % max(1, steps // 5) == 0 for i in range(steps))
    layers = train_rewriter.make_model()[0].n_layers
    want = expect(
        flash_attention=layers * (steps + evals + out["policy_calls"]),
        flash_attention_bwd=layers * steps, adamw=2 * steps)
    emit({"phase": "train_rewriter", "steps": steps, "seconds": seconds,
          "loss_first": out["losses"][0], "loss_last": out["losses"][-1],
          "initial_eval_acc": out["initial_eval_acc"],
          "train_acc": out["train_acc"], "eval_acc": out["eval_acc"],
          "plan_cost": out["plan_cost"], "policy_calls": out["policy_calls"],
          "rewriter_calls": out["rewriter_calls"], "launches": counts})
    if counts != want:
        raise AssertionError(f"train_rewriter: launch counts {counts}, "
                             f"expected {want}")
    if not (all(np.isfinite(out["losses"]))
            and out["policy_calls"] == out["rewriter_calls"] > 0):
        raise AssertionError("train_rewriter: a loss is not finite or a "
                             "rewrite was not scored by the model")
    set_launches(rows, counts, "train_rewriter", "flash_attention",
                 "flash_attention_bwd")


def greedy_run(bundle, params, batch, steps, max_len, forced=None):
    """Prefill ``batch`` and decode ``steps`` greedy tokens in fp32 on the
    device of ``batch``'s tokens; with ``forced`` (another run's tokens, on
    the CPU) feed those instead of this run's argmax. Returns (the last
    position's logits (B, V) on the CPU after the prefill and after each
    step, the tokens fed on the CPU, prefill seconds, decode seconds, the
    cache)."""
    dev = batch["tokens"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, batch, max_len=max_len,
                                   dtype=torch.float32)
    sync()
    t1 = time.perf_counter()
    out, fed = [logits[:, -1].cpu()], []
    for i in range(steps):
        tok = (forced[i].to(dev) if forced is not None
               else logits[:, -1].argmax(dim=-1, keepdim=True))
        fed.append(tok.cpu())
        logits, cache = bundle.decode_step(params, cache, tok,
                                           dtype=torch.float32)
        out.append(logits[:, -1].cpu())
    sync()
    return out, fed, t1 - t0, time.perf_counter() - t1, cache


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def check_against_cpu(phase, bundle, params, batch, steps, max_len, want,
                      **extra):
    """The card's greedy run (``greedy_run``) of ``bundle`` against the CPU's
    from the same weights, the CPU fed the card's tokens: the prefill's and
    every step's logits within LOGITS_ATOL, the same argmax at every step;
    the card's launches must be ``want``."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    card, fed, *_ = greedy_run(bundle, params, batch, steps, max_len)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cpu = greedy_run(bundle, to_cpu(params), to_cpu(batch), steps, max_len,
                     forced=fed)[0]
    errs = [max_err(a, b) for a, b in zip(card, cpu)]
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(card, cpu))
    finite = all(bool(torch.isfinite(a).all()) for a in card)
    emit({"phase": phase, "layers": bundle.cfg.n_layers, **extra,
          "steps": steps, "max_abs_err": max(errs),
          "max_abs_err_prefill": errs[0], "atol": LOGITS_ATOL,
          "max_abs_logit": max(a.abs().max().item() for a in card),
          "argmax_equal": same, "finite": finite, "launches": counts})
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}")
    if not (finite and same and max(errs) <= LOGITS_ATOL):
        raise AssertionError(f"{phase}: the card's run and the CPU's "
                             f"disagree")


def decode_profile(bundle, params, cache, logits, steps):
    """torch.profiler over ``steps`` more greedy decode steps from
    ``cache``: the card's activity (``profiled``)."""
    def run():
        nonlocal logits, cache
        for _ in range(steps):
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            logits, cache = bundle.decode_step(params, cache, tok,
                                               dtype=torch.float32)
    return profiled(run)


def phase_serve_encdec(rows):
    """Full-width seamless-m4t-large-v2 (24 encoder and 24 decoder layers,
    d_model 1024, 16/16 heads of 64, d_ff 8192, vocab 256206; seeded random
    fp32 weights) through its bundle: ``prefill`` of 4 prompts of
    ENCDEC_PROMPT tokens over ENC_FRAMES seeded encoder frames, then
    ENCDEC_STEPS greedy ``decode_step``s. Launches: the prefill's flash
    attention once per encoder layer (non-causal self-attention) and twice
    per decoder layer (causal self, non-causal cross against the 4096
    frames); every step's decode attention twice per decoder layer (self,
    and cross over the whole encoder cache). Then a profiled prefill and 8
    profiled steps for the card's idle share. Returns what the cross-check
    needs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    cfg = get_config("seamless-m4t-large-v2")
    bundle = registry.build(cfg)
    params = bundle.init(generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (ENCDEC_BATCH, ENCDEC_PROMPT),
                                     generator=gen, device="cuda"),
             "enc_embeds": torch.randn((ENCDEC_BATCH, ENC_FRAMES, cfg.d_model),
                                       generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, fed, prefill_s, decode_s, cache = greedy_run(
        bundle, params, batch, ENCDEC_STEPS, ENCDEC_MAX_LEN)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L, E = cfg.n_layers, cfg.n_encoder_layers
    want = expect(flash_attention=E + 2 * L,
                  decode_attention=2 * L * ENCDEC_STEPS)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    pos = int(cache["pos"])
    prefill_profile = profiled(lambda: bundle.prefill(
        params, batch, max_len=ENCDEC_MAX_LEN, dtype=torch.float32))
    last = logits[-1][:, None].to(batch["tokens"].device)
    decode_activity = decode_profile(bundle, params, cache, last, 8)
    new_tokens = ENCDEC_BATCH * ENCDEC_STEPS
    emit({"phase": "serve_encdec", "arch": cfg.name, "n_layers": L,
          "n_encoder_layers": E, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size,
          "params": sum(p.numel() for p in leaves(params)),
          "param_gb": tree_bytes(params) / 1e9, "batch": ENCDEC_BATCH,
          "prompt": ENCDEC_PROMPT, "enc_frames": ENC_FRAMES,
          "max_len": ENCDEC_MAX_LEN, "decode_steps": ENCDEC_STEPS,
          "prefill_s": prefill_s, "decode_s": decode_s,
          "decode_s_per_step": decode_s / ENCDEC_STEPS,
          "new_tok_per_s": new_tokens / decode_s,
          "tok_per_s_with_prefill": new_tokens / (prefill_s + decode_s),
          "cache_gb": tree_bytes(cache) / 1e9, "peak_memory_gb": peak_gb,
          "pos": pos, "finite": finite, "launches": counts,
          "profile_prefill": prefill_profile,
          "profile_8_steps": decode_activity})
    if counts != want:
        raise AssertionError(f"serve_encdec: launch counts {counts}, "
                             f"expected {want}")
    if not (finite and pos == ENCDEC_PROMPT + ENCDEC_STEPS
            and tuple(logits[0].shape) == (ENCDEC_BATCH, cfg.vocab_size)):
        raise AssertionError("serve_encdec: logits not finite or of the "
                             "wrong shape, or the cache's position wrong")
    set_launches(rows, counts, "serve_encdec", "flash_attention",
                 "decode_attention")
    return cfg, params, batch


def phase_cross_check_encdec(served):
    """The serve_encdec run, its model cut to its first ENCDEC_CUT encoder
    and ENCDEC_CUT decoder layers at full width on the same inputs, on the
    card and on the CPU (``check_against_cpu``: the prefill and
    ENCDEC_STEPS steps)."""
    from dataclasses import replace

    from repro_torch.models import registry
    cfg, params, batch = served
    cut = dict(params)
    for tree in ("enc_layers", "dec_layers"):
        cut[tree] = layers_upto(params[tree], ENCDEC_CUT)
    bundle = registry.build(replace(cfg, n_layers=ENCDEC_CUT,
                                    n_encoder_layers=ENCDEC_CUT))
    check_against_cpu(
        "cross_check_encdec", bundle, cut, batch, ENCDEC_STEPS,
        ENCDEC_MAX_LEN,
        expect(flash_attention=3 * ENCDEC_CUT,
               decode_attention=2 * ENCDEC_CUT * ENCDEC_STEPS),
        encoder_layers=ENCDEC_CUT, enc_frames=ENC_FRAMES)


def phase_train_encdec(rows):
    """``launch.train --arch seamless-m4t-large-v2`` at full width (2.03B
    parameters: fp32 weights and AdamW moments, bf16 activations, the
    decoder's layers recomputed in the backward), ENCDEC_TRAIN_STEPS steps
    of 4 x 512 movie-plot tokens over 4 x 512 random frames, no checkpoint:
    every loss finite and the last below the first. Launches per step: the
    flash forward once per encoder layer and twice per decoder layer, both
    again in the decoder's recompute; the backward once for each of those
    attentions; AdamW's two passes. Then two more steps under
    torch.profiler for the card's idle share."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.run(train_args(os.path.join(CKPT_ROOT, "encdec"),
                               TRAIN_ENCDEC))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, log, state = out["cfg"], out["log"], out["state"]
    L, E, steps = cfg.n_layers, cfg.n_encoder_layers, ENCDEC_TRAIN_STEPS
    want = expect(flash_attention=(E + 4 * L) * steps,
                  flash_attention_bwd=(E + 2 * L) * steps, adamw=2 * steps)
    losses = [e["loss"] for e in log]
    step_s = [e["seconds"] for e in log]
    tokens = ENCDEC_BATCH * TRAIN_SEQ

    def two_steps():  # from the final state; the new states are dropped
        for i in range(2):
            out["train_step"](state, out["batch_fn"](steps + i))
    activity = profiled(two_steps)
    busy_step_ms = activity["device_busy_ms"] / 2
    emit({"phase": "train_encdec", "flags": TRAIN_ENCDEC, "arch": cfg.name,
          "n_layers": L, "n_encoder_layers": E, "d_model": cfg.d_model,
          "params": sum(p.numel() for p in leaves(state["params"])),
          "steps": len(log), "seconds": out["seconds"],
          "tok_per_s": steps * tokens / out["seconds"],
          "step_s": step_s, "median_step_s": float(np.median(step_s)),
          "tok_per_s_median_step": tokens / float(np.median(step_s)),
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "grad_norm_last": log[-1]["grad_norm"],
          "peak_memory_gb": peak_gb, "launches": counts,
          "profile_2_steps": activity,
          "busy_ms_per_profiled_step": busy_step_ms,
          "idle_share_of_median_step":
              1.0 - busy_step_ms / (1e3 * float(np.median(step_s)))})
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    if counts != want:
        raise AssertionError(f"train_encdec: launch counts {counts}, "
                             f"expected {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_encdec: losses {losses} not finite "
                             f"and falling")
    set_launches(rows, counts, "train_encdec", "flash_attention",
                 "flash_attention_bwd")


def phase_cross_check_train_encdec():
    """One fp32 training step of seamless-m4t-large-v2 at full width cut to
    ENCDEC_CUT encoder and ENCDEC_CUT decoder layers, card against CPU
    (``cross_check_step``), on a (2, 256) batch of the launcher's pipeline
    and seeded frames as long."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    cfg = replace(get_config("seamless-m4t-large-v2"), n_layers=ENCDEC_CUT,
                  n_encoder_layers=ENCDEC_CUT)
    toks = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=CROSS_BATCH,
                         seq_len=CROSS_SEQ).batch_at(0)["tokens"]
    frames = torch.randn((CROSS_BATCH, CROSS_SEQ, cfg.d_model),
                         generator=torch.Generator().manual_seed(0))
    cut = ENCDEC_CUT
    cross_check_step("cross_check_train_encdec", cfg,
                     {"tokens": torch.as_tensor(toks), "enc_embeds": frames},
                     expect(flash_attention=cut + 4 * cut,
                            flash_attention_bwd=cut + 2 * cut))


def phase_int8_decode(rows):
    """Full-width qwen2-0.5b decodes 4 sequences: INT8_PROMPT prompt tokens
    fed one at a time through ``decode_step``, then INT8_STEPS greedy
    steps, first with the fp32 cache, then with the int8 cache
    (``init_cache(kv_dtype=torch.int8)``) fed the fp32 run's tokens. At
    every step the int8 logits within INT8_BOUND of the fp32 logits'
    largest |value| (the reference's bound). Launches: decode attention
    once per layer and step for each cache (the int8 one over its
    dequantized copy)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    cfg = get_config("qwen2-0.5b")
    bundle = registry.build(cfg)
    params = bundle.init(generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (4, INT8_PROMPT),
                           generator=torch.Generator("cuda").manual_seed(2),
                           device="cuda")
    total = INT8_PROMPT + INT8_STEPS
    runs, fed = {}, []
    for name, kv in (("fp32", None), ("int8", torch.int8)):
        cache = bundle.init_cache(4, total, dtype=torch.float32,
                                  kv_dtype=kv, device="cuda")
        cache_bytes = tree_bytes({k: v for k, v in cache.items()
                                  if k != "pos"})
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for t in range(total):
            if t < INT8_PROMPT:
                tok = prompt[:, t:t + 1]
            elif name == "int8":
                tok = fed[t - INT8_PROMPT]
            else:
                tok = out[-1].argmax(dim=-1, keepdim=True)
                fed.append(tok)
            logits, cache = bundle.decode_step(params, cache, tok,
                                               dtype=torch.float32)
            out.append(logits[:, -1])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[name] = (torch.stack(out), ops.launch_counts(), seconds,
                      cache_bytes)
    fp, q8 = runs["fp32"][0], runs["int8"][0]
    rel = ((q8 - fp).abs().amax(dim=(1, 2))
           / fp.abs().amax(dim=(1, 2))).tolist()
    want = expect(decode_attention=cfg.n_layers * total)
    emit({"phase": "int8_decode", "arch": cfg.name, "sequences": 4,
          "prompt": INT8_PROMPT, "greedy_steps": INT8_STEPS,
          "max_rel_diff": max(rel), "rel_diff_last": rel[-1],
          "bound": INT8_BOUND,
          "cache_bytes": {k: v[3] for k, v in runs.items()},
          "ms_per_step": {k: 1e3 * v[2] / total for k, v in runs.items()},
          "launches": {k: v[1] for k, v in runs.items()}})
    if any(v[1] != want for v in runs.values()):
        raise AssertionError(f"int8_decode: launch counts, expected {want}")
    if not (bool(torch.isfinite(q8).all()) and max(rel) < INT8_BOUND):
        raise AssertionError(f"int8_decode: the int8 cache's logits are "
                             f"{max(rel)} of the fp32 ones' max apart")
    set_launches(rows, runs["int8"][1], "int8_decode", "decode_attention")


def phase_serve_vlm(rows):
    """internvl2-76b at full width (d_model 8192, 64/8 heads of 128, d_ff
    28672, vocab 128256) cut to VLM_LAYERS of its 80 layers, seeded random
    fp32 weights, through its bundle: ``prefill`` of 4 sequences of
    VLM_PREFIX seeded patch embeddings and VLM_TEXT tokens, then VLM_STEPS
    greedy ``decode_step``s (flash attention once per layer, decode
    attention once per layer and step); the prefill's pos is
    min(288 + 256, 576), the reference's count. Then the engine serves 4
    text-only requests (its prefill passes the tokens alone, as the
    reference's): flash once per layer and prefill, decode once per layer
    and tick. Returns what the cross-check needs."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.engine import ContinuousBatcher, GenerationEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import registry
    cfg = replace(get_config("internvl2-76b"), n_layers=VLM_LAYERS)
    bundle = registry.build(cfg)
    params = bundle.init(generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT),
                                     generator=gen, device="cuda"),
             "prefix_embeds": torch.randn((VLM_BATCH, VLM_PREFIX, cfg.d_model),
                                          generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, fed, prefill_s, decode_s, cache = greedy_run(
        bundle, params, batch, VLM_STEPS, VLM_MAX_LEN)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expect(flash_attention=VLM_LAYERS,
                  decode_attention=VLM_LAYERS * VLM_STEPS)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    pos = int(cache["pos"])
    want_pos = min(VLM_PREFIX + VLM_TEXT + VLM_PREFIX, VLM_MAX_LEN) + VLM_STEPS
    last = logits[-1][:, None].to(batch["tokens"].device)
    activity = decode_profile(bundle, params, cache, last, 4)
    engine = GenerationEngine(bundle, params, max_len=160, n_slots=4,
                              device="cuda")
    batcher = ContinuousBatcher(engine)
    for p in DEMO_PROMPTS:
        batcher.submit(p, max_new_tokens=8)
    ops.reset_launch_counts()
    finished = batcher.run()
    torch.cuda.synchronize()
    engine_counts = ops.launch_counts()
    st = engine.stats
    engine_want = expect(flash_attention=VLM_LAYERS * st["prefills"],
                         decode_attention=VLM_LAYERS * st["decode_steps"])
    new_tokens = VLM_BATCH * VLM_STEPS
    emit({"phase": "serve_vlm", "arch": cfg.name, "n_layers": VLM_LAYERS,
          "n_layers_published": get_config("internvl2-76b").n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": sum(p.numel() for p in leaves(params)),
          "param_gb": tree_bytes(params) / 1e9, "batch": VLM_BATCH,
          "prefix": VLM_PREFIX, "text": VLM_TEXT, "max_len": VLM_MAX_LEN,
          "prefill_s": prefill_s, "decode_s": decode_s,
          "decode_s_per_step": decode_s / VLM_STEPS,
          "new_tok_per_s": new_tokens / decode_s,
          "peak_memory_gb": peak_gb, "pos": pos, "want_pos": want_pos,
          "finite": finite, "launches": counts, "profile_4_steps": activity,
          "engine": {"requests": len(finished), "prefills": st["prefills"],
                     "decode_steps": st["decode_steps"],
                     "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                     "launches": engine_counts}})
    if counts != want or engine_counts != engine_want:
        raise AssertionError(f"serve_vlm: launch counts {counts} / "
                             f"{engine_counts}, expected {want} / "
                             f"{engine_want}")
    if not (finite and pos == want_pos and len(finished) == len(DEMO_PROMPTS)
            and st["decode_steps"]
            and all(r.output_ids for r in finished.values())):
        raise AssertionError("serve_vlm: logits not finite, the position "
                             "wrong, or a request unfinished")
    set_launches(rows, counts, "serve_vlm", "flash_attention",
                 "decode_attention")
    return cfg, params, batch


def phase_cross_check_vlm(served):
    """The serve_vlm run cut to its first VLM_CUT layer at full width on
    the same inputs, card against CPU (``check_against_cpu``: the prefill
    and 4 steps)."""
    from dataclasses import replace

    from repro_torch.models import registry
    cfg, params, batch = served
    cut = dict(params)
    cut["layers"] = layers_upto(params["layers"], VLM_CUT)
    check_against_cpu(
        "cross_check_vlm", registry.build(replace(cfg, n_layers=VLM_CUT)),
        cut, batch, 4, VLM_MAX_LEN,
        expect(flash_attention=VLM_CUT, decode_attention=VLM_CUT * 4),
        prefix=VLM_PREFIX)


def phase_serve_big(rows, arch):
    """``arch`` (deepseek-67b or llama4-scout-17b-a16e) at full width cut
    to BIG_LAYERS[arch] layers, seeded random fp32 weights, through its
    bundle: ``prefill`` of BIG_BATCH prompts of BIG_PROMPT seeded tokens,
    then BIG_STEPS greedy ``decode_step``s (flash attention once per layer,
    decode attention once per layer and step; llama4's MoE in plain
    PyTorch); then the engine serves the demo prompts (flash once per
    layer and prefill, decode once per layer and tick). Returns what the
    cross-check needs."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.engine import ContinuousBatcher, GenerationEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models import registry
    phase, layers = BIG_PHASE[arch], BIG_LAYERS[arch]
    cfg = replace(get_config(arch), n_layers=layers)
    bundle = registry.build(cfg)
    params = bundle.init(generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (BIG_BATCH, BIG_PROMPT), generator=gen,
                                     device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, _, prefill_s, decode_s, cache = greedy_run(
        bundle, params, batch, BIG_STEPS, BIG_MAX_LEN)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expect(flash_attention=layers, decode_attention=layers * BIG_STEPS)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    pos = int(cache["pos"])
    last = logits[-1][:, None].to(batch["tokens"].device)
    activity = decode_profile(bundle, params, cache, last, 4)
    engine = GenerationEngine(bundle, params, max_len=BIG_MAX_LEN, n_slots=4,
                              device="cuda")
    batcher = ContinuousBatcher(engine)
    for p in DEMO_PROMPTS:
        batcher.submit(p, max_new_tokens=8)
    ops.reset_launch_counts()
    finished = batcher.run()
    torch.cuda.synchronize()
    engine_counts = ops.launch_counts()
    st = engine.stats
    engine_want = expect(flash_attention=layers * st["prefills"],
                         decode_attention=layers * st["decode_steps"])
    emit({"phase": phase, "arch": cfg.name, "n_layers": layers,
          "n_layers_published": get_config(arch).n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads,
                                            cfg.head_dim],
          "vocab": cfg.vocab_size,
          "params": sum(p.numel() for p in leaves(params)),
          "param_gb": tree_bytes(params) / 1e9, "batch": BIG_BATCH,
          "prompt": BIG_PROMPT, "max_len": BIG_MAX_LEN,
          "prefill_s": prefill_s, "decode_s": decode_s,
          "decode_s_per_step": decode_s / BIG_STEPS,
          "new_tok_per_s": BIG_BATCH * BIG_STEPS / decode_s,
          "peak_memory_gb": peak_gb, "pos": pos, "finite": finite,
          "launches": counts, "profile_4_steps": activity,
          "engine": {"requests": len(finished), "prefills": st["prefills"],
                     "decode_steps": st["decode_steps"],
                     "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                     "launches": engine_counts}})
    if counts != want or engine_counts != engine_want:
        raise AssertionError(f"{phase}: launch counts {counts} / "
                             f"{engine_counts}, expected {want} / "
                             f"{engine_want}")
    if not (finite and pos == BIG_PROMPT + BIG_STEPS
            and len(finished) == len(DEMO_PROMPTS) and st["decode_steps"]
            and all(r.output_ids for r in finished.values())):
        raise AssertionError(f"{phase}: logits not finite, the position "
                             f"wrong, or a request unfinished")
    set_launches(rows, counts, phase, "flash_attention", "decode_attention")
    return cfg, params, batch


def phase_cross_check_big(arch, served):
    """The serve_deepseek / serve_llama4 run cut to its first BIG_CUT layer
    at full width on the same prompts, card against CPU
    (``check_against_cpu``: the prefill and 4 steps)."""
    from dataclasses import replace

    from repro_torch.models import registry
    cfg, params, batch = served
    cut = dict(params)
    cut["layers"] = layers_upto(params["layers"], BIG_CUT)
    check_against_cpu(
        "cross_check_" + BIG_PHASE[arch].split("_")[1],
        registry.build(replace(cfg, n_layers=BIG_CUT)), cut, batch, 4,
        BIG_MAX_LEN,
        expect(flash_attention=BIG_CUT, decode_attention=BIG_CUT * 4))


@contextlib.contextmanager
def one_rank_group(backend):
    """A one-rank process group (``backend``: "nccl", or "cpu:gloo,cuda:nccl"
    for CPU and CUDA tensors side by side) through a FileStore under the
    git-ignored build/, bound to the card; destroyed on exit, so that the
    later phases run as before. A failed collective raises through it."""
    import torch.distributed as dist
    os.makedirs(os.path.dirname(MESH_STORE), exist_ok=True)
    if os.path.exists(MESH_STORE):
        os.remove(MESH_STORE)
    dist.init_process_group(backend, store=dist.FileStore(MESH_STORE, 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if os.path.exists(MESH_STORE):
            os.remove(MESH_STORE)


def mesh_collectives(cfg, steps):
    """The all-reduces of ``steps`` training steps through the MoE's
    shard_map path under remat, by mesh axis. Per MoE layer and step:
    over model, the output's sum in the forward (remat's recompute stops
    at the layer's last saved tensor, before the sum) and the partial
    gradients of x and of the router in the backward; over data, the
    gradients of the router and of the three expert stacks (and of a
    shared expert's three)."""
    n = cfg.n_layers * steps
    return {"model": 3 * n,
            "data": (4 + (3 if cfg.moe.shared_expert_ff else 0)) * n}


def gather_mesh_collectives(cfg, steps):
    """The collectives of ``steps`` training steps through the MoE's split
    gather path on the DTensor leaves of a one-rank mesh under remat, by
    kind and mesh axis (the MoE's own; DTensor's are not counted). Per
    MoE layer and step, over data (the token axis): the counts table's and
    the products' all-gathers in the forward and remat's recompute (which
    stops after the products' return to the tokens, before the sum) and
    the gradients of the slots and their weights in the backward (6); the
    slots' and their weights' reduce-scatters in both forwards and the
    products' gradient in the backward (5); the all-reduces of the
    router's and the three expert stacks' gradients (and a shared
    expert's three). Over model (the expert axis): the output's sum and
    the partial gradients of x and of the router (3)."""
    n = cfg.n_layers * steps
    return {"all_gather:data": 6 * n, "reduce_scatter:data": 5 * n,
            "model": 3 * n,
            "data": (4 + (3 if cfg.moe.shared_expert_ff else 0)) * n}


def local_tree(tree, device=None):
    """Each leaf's local tensor (a DTensor's shard, here the whole leaf),
    detached, on ``device`` (where it is by default)."""
    from torch.distributed.tensor import DTensor
    return {k: local_tree(v, device) if isinstance(v, dict) else
            (v.to_local() if isinstance(v, DTensor) else v).detach().to(
                device or v.device.type)
            for k, v in tree.items()}


def phase_train_mesh(rows):
    """Full-width granite-moe-1b-a400m trained through the MoE's shard_map
    path (``moe_ctx`` {"impl": "shardmap"}) on a (data 1, model 1) mesh
    over a one-rank NCCL group: the train state
    placed by the train-mode rules, MESH_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ movie-plot tokens (fp32 weights and AdamW moments, bf16
    activations, remat), a checkpoint with the state's logical axes after
    MESH_CKPT_AT steps. Launches exactly ``train_launches``, all-reduces
    exactly ``mesh_collectives``; losses finite and falling. Then the
    checkpoint restored onto the mesh runs the remaining steps again: its
    losses and every leaf of its final state must be bit-equal to the
    uninterrupted run's. ``remesh`` of that state to the serve-mode rules
    must leave every value bit-equal, and ``compressed_psum`` over the data
    axis of two gradient leaves (the router's and the embedding's) must
    equal ``compress_decompress`` bit for bit. Two more steps under
    torch.profiler for the idle share and device time by kind."""
    import shutil

    from repro_torch.checkpoint import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.training import compression
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_loop
    cfg = get_config(MESH_ARCH)
    bundle = registry.build(cfg)
    axes = train_loop.state_axes(bundle.param_axes())
    ckpt_dir = os.path.join(CKPT_ROOT, "train_mesh")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    with one_rank_group("nccl"):
        mesh = make_host_mesh()
        rules = shd.make_rules(cfg, mesh, "train")
        ctx = {"impl": "shardmap", "mesh": mesh,
               "dp_axes": shd.dp_axes(mesh)}
        step_fn = train_loop.make_train_step(
            bundle, opt_mod.AdamWConfig(lr=3e-4, warmup_steps=10,
                                        total_steps=MESH_STEPS),
            remat=True, moe_ctx=ctx)
        batch_fn = train.synthetic_batch_fn(
            cfg, TRAIN_BATCH, TRAIN_SEQ,
            documents=train.corpus_documents("movie"))

        def run(state, first, save):
            losses, secs = [], []
            for i in range(first, MESH_STEPS):
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch_fn(i))
                losses.append(float(metrics["loss"]))
                secs.append(time.perf_counter() - t0)
                if save and i + 1 == MESH_CKPT_AT:
                    checkpoint.save(ckpt_dir, i + 1, state, axes=axes)
            return state, losses, secs

        torch.cuda.reset_peak_memory_stats()
        state = train_loop.init_train_state(
            bundle, torch.Generator("cuda").manual_seed(0))
        state = shd.place(state, shd.sharding_for_tree(state, axes, rules,
                                                        mesh))
        placements = {n: str(x.placements) for n, x in (
            ("embed", state["params"]["embed"]["embedding"]),
            ("expert_gate", state["params"]["layers"]["ffn"]["gate"]["w"]))}
        ops.reset_launch_counts()
        shd.reset_collective_counts()
        t0 = time.perf_counter()
        state, losses, secs = run(state, 0, save=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, colls = ops.launch_counts(), shd.collective_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        def two_steps():  # from the final state; the new states are dropped
            for i in range(2):
                step_fn(state, batch_fn(MESH_STEPS + i))
        activity = profiled(two_steps)
        busy_step_ms = activity["device_busy_ms"] / 2
        ckpt_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                      os.walk(ckpt_dir) for f in fs) / 1e9
        want_host = local_tree(state, "cpu")
        del state
        release()

        step, restored = checkpoint.restore(ckpt_dir, mesh=mesh, rules=rules)
        ops.reset_launch_counts()
        restored, losses_b, _ = run(restored, step, save=False)
        torch.cuda.synchronize()
        counts_b = ops.launch_counts()
        same = [torch.equal(x.cpu(), y) for x, y in zip(
            leaves(local_tree(restored)), leaves(want_host))]
        del want_host

        serve = elastic.remesh(restored, mesh, mesh,
                               shd.make_rules(cfg, mesh, "serve"), axes=axes)
        remesh_same = all(torch.equal(x, y) for x, y in zip(
            leaves(local_tree(serve)), leaves(local_tree(restored))))
        del serve

        local = local_tree(restored["params"])
        for p in leaves(local):
            p.requires_grad_(True)
        loss = bundle.loss_fn(local, batch_fn(MESH_STEPS), moe_ctx=ctx)
        grads = train_loop.grad_tree(loss, local)
        psum_same = {}
        for name, g in (("layers/ffn/router/w",
                         grads["layers"]["ffn"]["router"]["w"]),
                        ("embed/embedding",
                         grads["embed"]["embedding"])):
            psum_same[name] = torch.equal(
                compression.compressed_psum(g, mesh.get_group("data")),
                compression.compress_decompress(g))
        del local, grads, loss, restored
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    want = train_launches(cfg, MESH_STEPS, updates=MESH_STEPS)
    want_b = train_launches(cfg, MESH_STEPS - step,
                            updates=MESH_STEPS - step)
    want_colls = mesh_collectives(cfg, MESH_STEPS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    median = float(np.median(secs))
    emit({"phase": "train_mesh", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "backend": "nccl", "placements": placements,
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": MESH_STEPS,
          "seconds": seconds, "step_s": secs, "median_step_s": median,
          "tok_per_s_median_step": tokens / median,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "peak_memory_gb": peak_gb,
          "checkpoint_gb": ckpt_gb, "launches": counts,
          "collectives": colls, "collectives_expected": want_colls,
          "profile_2_steps": activity,
          "busy_ms_per_profiled_step": busy_step_ms,
          "idle_share_of_median_step": 1.0 - busy_step_ms / (1e3 * median),
          "restored_at_step": step, "losses_restored": losses_b,
          "launches_restored": counts_b,
          "restored_losses_bit_equal": losses_b == losses[step:],
          "restored_leaves_bit_equal": sum(same), "leaves": len(same),
          "remesh_serve_bit_equal": remesh_same,
          "compressed_psum_bit_equal": psum_same})
    MEASURED["train_mesh"] = {"launches": counts, "steps": MESH_STEPS,
                              "peak_memory_gb": peak_gb}
    if counts != want or counts_b != want_b or colls != want_colls:
        raise AssertionError(f"train_mesh: launches {counts} / {counts_b} "
                             f"(expected {want} / {want_b}) or all-reduces "
                             f"{colls} (expected {want_colls})")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_mesh: losses {losses} not finite and "
                             f"falling")
    if not (step == MESH_CKPT_AT and losses_b == losses[step:] and all(same)
            and remesh_same and all(psum_same.values())):
        raise AssertionError("train_mesh: the run restored onto the mesh, "
                             "the remeshed state or compressed_psum differs")
    set_launches(rows, counts, "train_mesh", "flash_attention",
                 "flash_attention_bwd")


def moe_layer_bit_check(cfg, params, tokens, mesh, rules):
    """Granite's first MoE layer (its weights from the placed ``params``)
    on the bf16 embedding rows of ``tokens`` (repeated tokens route alike,
    so that experts overflow): on DTensors placed by the train rules
    (``ffn.moe_forward`` with no ``moe_ctx``: ``_on_blocks`` ->
    ``moe_forward_gather_split``) and on the local tensors
    (``moe_forward_gather``), the output and the gradients of x and of
    every weight for a seeded cotangent. Returns (how many of those are
    bit-equal, how many there are, the assignments the unsplit dispatch
    drops)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import ffn
    local = {k: {n: t.to_local()[0].detach().clone() for n, t in v.items()}
             for k, v in params["layers"]["ffn"].items()}
    placed = shd.place(local, shd.sharding_for_tree(
        local, ffn.moe_axes(cfg), rules, mesh))
    table = params["embed"]["embedding"].to_local().detach()
    x = table[tokens].to(torch.bfloat16)
    shape = tuple(x.shape)
    ct = torch.randn(shape, generator=torch.Generator(x.device).manual_seed(1),
                     device=x.device).to(torch.bfloat16)
    act = shd.Sharding(mesh, shd.spec_for(shape, ("batch", "seq",
                                                   "embed_act"), rules,
                                          mesh))

    def run(p, xx, cc):
        ws = leaves(p)
        for w in ws:
            w.requires_grad_(True)
        xx.requires_grad_(True)
        y = ffn.moe_forward(p, xx, cfg)
        return [y] + list(torch.autograd.grad((y * cc).sum(), [xx] + ws))

    with shd.activation_sharding(mesh, rules):
        split = [t.full_tensor() for t in run(placed, act.place(x),
                                              act.place(ct))]
    whole = run(local, x.clone(), ct)
    _, experts = ffn.route(local["router"], x.reshape(-1, cfg.d_model),
                           cfg.moe)
    loads = torch.bincount(experts.reshape(-1),
                           minlength=cfg.moe.num_experts)
    dropped = int((loads - ffn.capacity(x.shape[0] * x.shape[1], cfg.moe))
                  .clamp_min(0).sum())
    return (sum(torch.equal(a, b) for a, b in zip(split, whole)),
            len(whole), dropped)


def phase_train_mesh_gather(rows):
    """Full-width granite-moe-1b-a400m trained through the MoE's split
    gather path on the (data 1, model 1) mesh over a one-rank NCCL group,
    the train state placed by the train-mode rules (DTensor leaves), at
    TRAIN_BATCH x TRAIN_SEQ movie-plot tokens (fp32 weights and AdamW
    moments, bf16 activations, remat). ``train_loop``'s step on a one-rank
    mesh computes on the local tensors, so this phase runs the operations
    of its step on a mesh of more ranks instead: with no ``moe_ctx``, the
    loss and its gradients on the DTensor leaves inside
    ``activation_sharding`` (each MoE layer through
    ``ffn.moe_forward_gather_split`` on its blocks, via ``_on_blocks``),
    the gradients reduced to their leaves' placements, AdamW's kernels on
    the DTensors' blocks. First the loss and every gradient leaf of the initial
    params on the first batch, so and by the unplaced gather path (the
    local tensors, no mesh): the loss bit-equal, each leaf within
    GATHER_GRAD_TOL of its largest |value|; and the first MoE layer alone
    on both (``moe_layer_bit_check``): bit-equal, with assignments
    dropped. Then MESH_GATHER_STEPS steps:
    launches exactly ``train_launches``, collectives exactly
    ``gather_mesh_collectives``, losses finite and falling; seconds a step
    and the peak (from after the comparison's tensors are freed)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_loop
    cfg = get_config(MESH_ARCH)
    bundle = registry.build(cfg)
    axes = train_loop.state_axes(bundle.param_axes())
    opt_cfg = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=10,
                                  total_steps=MESH_GATHER_STEPS)
    t_phase = time.perf_counter()
    with one_rank_group("nccl"):
        mesh = make_host_mesh()
        rules = shd.make_rules(cfg, mesh, "train")
        batch_fn = train.synthetic_batch_fn(
            cfg, TRAIN_BATCH, TRAIN_SEQ,
            documents=train.corpus_documents("movie"))

        def placed_batch(i):
            batch = batch_fn(i)
            return shd.place(batch, shd.batch_sharding(batch, rules, mesh))

        def loss_and_grads(params, batch):
            """The loss (local) and the gradients reduced to the leaves'
            placements."""
            for p in leaves(params):
                p.requires_grad_(True)
            with shd.activation_sharding(mesh, rules):
                loss = bundle.loss_fn(params, batch, remat=True)
                grads = train_loop.reduce_grads(
                    train_loop.grad_tree(loss, params), params)
            return loss.to_local().detach(), grads

        def step_fn(state, batch):
            loss, grads = loss_and_grads(state["params"], batch)
            with implicit_replication():
                params, opt_state, metrics = opt_mod.apply_updates(
                    opt_cfg, state["params"], grads, state["opt"])
            metrics["loss"] = loss
            return {"params": params, "opt": opt_state}, metrics

        state = train_loop.init_train_state(
            bundle, torch.Generator("cuda").manual_seed(0))
        state = shd.place(state, shd.sharding_for_tree(state, axes, rules,
                                                        mesh))
        loss, grads = loss_and_grads(state["params"], placed_batch(0))
        split = (loss, [g.to_local() for g in leaves(grads)])
        del loss, grads
        local = local_tree(state["params"])
        for p in leaves(local):
            p.requires_grad_(True)
        loss = bundle.loss_fn(local, batch_fn(0), remat=True)
        unplaced = (loss.detach(), leaves(train_loop.grad_tree(loss, local)))
        del loss, local
        loss_same = torch.equal(split[0], unplaced[0])
        same = [torch.equal(a, b) for a, b in zip(split[1], unplaced[1])]
        # each leaf's largest difference over its largest |value|
        grad_diff = [float((a.float() - b.float()).abs().max()
                           / b.float().abs().max().clamp_min(1e-30))
                     for a, b in zip(split[1], unplaced[1])]
        first_loss = float(split[0])
        del split, unplaced
        release()
        layer_same, layer_n, layer_dropped = moe_layer_bit_check(
            cfg, state["params"], batch_fn(0)["tokens"], mesh, rules)
        release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        shd.reset_collective_counts()
        losses, secs = [], []
        t0 = time.perf_counter()
        for i in range(MESH_GATHER_STEPS):
            t1 = time.perf_counter()
            state, metrics = step_fn(state, placed_batch(i))
            losses.append(float(metrics["loss"]))
            secs.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, colls = ops.launch_counts(), shd.collective_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        placements = str(state["params"]["layers"]["ffn"]["gate"]["w"]
                         .placements)
        del state
    want = train_launches(cfg, MESH_GATHER_STEPS, updates=MESH_GATHER_STEPS)
    want_colls = gather_mesh_collectives(cfg, MESH_GATHER_STEPS)
    median = float(np.median(secs))
    emit({"phase": "train_mesh_gather", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": cfg.param_count(),
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "backend": "nccl", "moe_path": "moe_forward_gather_split",
          "expert_gate_placements": placements,
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": MESH_GATHER_STEPS,
          "first_loss": first_loss, "first_loss_bit_equal": loss_same,
          "first_grad_leaves_bit_equal": sum(same), "leaves": len(same),
          "first_grad_diff_of_max": grad_diff,
          "moe_layer_bit_equal": layer_same, "moe_layer_tensors": layer_n,
          "moe_layer_dropped": layer_dropped,
          "seconds": seconds, "step_s": secs, "median_step_s": median,
          "tok_per_s_median_step": TRAIN_BATCH * TRAIN_SEQ / median,
          "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "peak_memory_gb": peak_gb, "launches": counts,
          "collectives": colls, "collectives_expected": want_colls,
          "phase_seconds": time.perf_counter() - t_phase})
    if counts != want or colls != want_colls:
        raise AssertionError(f"train_mesh_gather: launches {counts} "
                             f"(expected {want}) or collectives {colls} "
                             f"(expected {want_colls})")
    if not (loss_same and max(grad_diff) <= GATHER_GRAD_TOL
            and layer_same == layer_n and layer_dropped):
        raise AssertionError(f"train_mesh_gather: the first step's loss "
                             f"(bit-equal: {loss_same}), its gradients "
                             f"({max(grad_diff)} of a leaf's max) or the "
                             f"MoE layer "
                             f"({layer_same} of {layer_n} bit-equal, "
                             f"{layer_dropped} dropped) differs from the "
                             f"unplaced gather path's")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_mesh_gather: losses {losses} not "
                             f"finite and falling")
    set_launches(rows, counts, "train_mesh_gather", "flash_attention",
                 "flash_attention_bwd")


def phase_cross_check_train_mesh():
    """One fp32 training step of granite-moe-1b-a400m at full width cut to
    MESH_CUT layers through the MoE's shard_map path at a (1, 1) mesh, on
    the card
    (a CUDA mesh: NCCL) and on the CPU (a CPU mesh: gloo) of one group
    (``cross_check_step``'s tolerances)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    cfg = replace(get_config(MESH_ARCH), n_layers=MESH_CUT)
    toks = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=CROSS_BATCH,
                         seq_len=CROSS_SEQ).batch_at(0)["tokens"]
    with one_rank_group("cpu:gloo,cuda:nccl"):
        ctx = {}
        for side in ("cuda", "cpu"):
            mesh = make_host_mesh(device=side)
            ctx[side] = {"impl": "shardmap", "mesh": mesh,
                         "dp_axes": shd.dp_axes(mesh)}
        cross_check_step("cross_check_train_mesh", cfg,
                         {"tokens": torch.as_tensor(toks)},
                         train_launches(cfg, 1), moe_ctx=ctx)


DRYRUN_SCRIPT = """
import json, sys
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun
job = json.loads(sys.argv[1])
if job[0] == "cell":
    _, arch, shape, mesh = job
    rec = dryrun.run_cell(arch, shape, multi_pod=mesh == "multi")
else:
    _, phase, arch, moe, batch, seq = job
    shape = InputShape(f"{phase}_{batch}x{seq}", seq, batch, "train")
    rec = dryrun.run_cell(arch, shape, multi_pod=False, moe_impl=moe,
                          mesh_shape=(1, 1))
    rec["phase"] = phase
print(json.dumps(rec), flush=True)
"""
DRYRUN_JOBS = os.path.join(ROOT, "build", "dryrun_jobs")


def run_dryrun_jobs(jobs, timeout=600):
    """Each job of ``DRYRUN_SCRIPT`` in a process of its own, all started
    together (a trace is one core's work; the card's host has eight), their
    output in files under the git-ignored build/. Returns (each job's
    record or None, each failed job's exit code and stderr tail); every
    process is ended before it returns."""
    import shutil
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    shutil.rmtree(DRYRUN_JOBS, ignore_errors=True)
    os.makedirs(DRYRUN_JOBS)
    procs, files = [], []
    try:
        for i, job in enumerate(jobs):
            out = open(os.path.join(DRYRUN_JOBS, f"{i}.out"), "w+")
            err = open(os.path.join(DRYRUN_JOBS, f"{i}.err"), "w+")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(job)],
                env=env, cwd=ROOT, stdout=out, stderr=err, text=True))
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        recs, errors = [], []
        for i, p in enumerate(procs):
            out, err = files[2 * i], files[2 * i + 1]
            out.seek(0)
            err.seek(0)
            lines = [line for line in out.read().splitlines()
                     if line.startswith("{")]
            recs.append(json.loads(lines[-1]) if lines else None)
            if p.returncode:
                errors.append({"job": jobs[i], "returncode": p.returncode,
                               "stderr_tail": err.read()[-1500:]})
        return recs, errors
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        shutil.rmtree(DRYRUN_JOBS, ignore_errors=True)


def phase_dryrun():
    """``launch.dryrun`` on the card, each cell in a process of its own
    (its fake default group cannot live beside an NCCL one; the processes
    run together): DRYRUN_CELLS on the
    production meshes over fake groups of 256 and 512 ranks, each record
    ``ok`` (long_500k of a full-attention arch: the reference's skip), one
    line each with the dominant term, the step time, the bytes a device
    against the card's 80 GB and the link bytes by kind. Then the smoke's
    own training cells (DRYRUN_CROSS) at a (1, 1) mesh at TRAIN_BATCH x
    TRAIN_SEQ: the kernel launches a step they predict must equal the
    train and train_mesh phases' measured launches over their steps; the
    predicted bytes a device are printed beside each phase's measured
    peak."""
    jobs = [["cell", *cell] for cell in DRYRUN_CELLS] + [
        ["cross", phase, arch, moe, TRAIN_BATCH, TRAIN_SEQ]
        for phase, (arch, moe) in DRYRUN_CROSS.items()]
    t0 = time.perf_counter()
    recs, errors = run_dryrun_jobs(jobs)
    seconds = time.perf_counter() - t0
    recs = [r for r in recs if r is not None]
    failures = []
    for rec in recs:
        line = {"phase": "dryrun", "cell": f"{rec['arch']}__{rec['shape']}__"
                f"{rec['mesh']}", "chips": rec["chips"], "ok": rec["ok"],
                "trace_s": rec.get("trace_s")}
        if "moe_impl_ran" in rec:
            line["moe_impl_ran"] = rec["moe_impl_ran"]
        if rec.get("skipped"):
            line["skipped"] = rec["skip_reason"]
        elif rec["ok"]:
            roof = rec["roofline"]
            line.update(dominant=roof["dominant"],
                        step_time_s=roof["step_time_s"],
                        roofline_fraction=roof["roofline_fraction"],
                        bytes_per_device_gb=rec["bytes_per_device"] / 1e9,
                        device_gb=DEVICE_GB,
                        link_bytes_by_kind=rec["collectives"]["bytes_by_kind"],
                        launches=rec["launches"])
        else:
            line["error"] = rec.get("error")
            failures.append(line["cell"])
        if "phase" in rec and rec["ok"]:
            got = MEASURED.get(rec["phase"])
            if got is None:
                failures.append(f"{rec['phase']}: no measured run")
            else:
                per_step = {}
                for k, v in rec["launches"].items():
                    k = "adamw" if k.startswith("adamw_") else \
                        k.replace("_fwd", "")
                    per_step[k] = per_step.get(k, 0) + v
                measured = {k: v // got["steps"]
                            for k, v in got["launches"].items() if v}
                line.update(cross_check=rec["phase"],
                            predicted_launches_per_step=per_step,
                            measured_launches_per_step=measured,
                            predicted_peak_gb=rec["bytes_per_device"] / 1e9,
                            measured_peak_gb=got["peak_memory_gb"],
                            peak_gap_gb=rec["bytes_per_device"] / 1e9
                            - got["peak_memory_gb"])
                if per_step != measured or any(
                        v % got["steps"] for v in got["launches"].values()):
                    failures.append(f"{rec['phase']}: predicted {per_step}, "
                                    f"measured {measured}")
        emit(line)
    emit({"phase": "dryrun", "seconds": seconds, "records": len(recs),
          "processes": len(jobs), "errors": errors})
    if errors or len(recs) != len(jobs) or failures:
        raise AssertionError(f"dryrun: {len(recs)} of {len(jobs)} records, "
                             f"failures {failures}, errors {errors}")


def mesh_phases(rows):
    phase_train_mesh(rows)
    release()
    phase_cross_check_train_mesh()
    release()
    phase_train_mesh_gather(rows)


def ssm_training_phases(rows):
    phase_train(rows, "train_ssm", train_flags("mamba2-1.3b", SSM_TRAIN_SHAPE),
                ckpt=False)
    release()
    phase_cross_check_train("cross_check_train_ssm", "mamba2-1.3b")
    release()
    phase_train(rows, "train_hybrid",
                train_flags("hymba-1.5b", HYBRID_TRAIN_SHAPE), ckpt=False)
    release()
    phase_cross_check_train("cross_check_train_hybrid", "hymba-1.5b",
                            HYBRID_CROSS)


def codeqwen_training_phases(rows):
    """train_codeqwen and cross_check_train_codeqwen, each followed by its
    seconds: full-width codeqwen1.5-7b cut to CODEQWEN_TRAIN_LAYERS layers
    through ``launch.train`` (bf16, the head_dim 128 backward on the tensor
    cores), then one fp32 step cut to TRAIN_CUT layers card against CPU
    (the CUDA-core fp32 instance)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cfg = replace(get_config("codeqwen1.5-7b"), n_layers=CODEQWEN_TRAIN_LAYERS)
    t0 = time.perf_counter()
    phase_train(rows, "train_codeqwen",
                train_flags("codeqwen1.5-7b", (TRAIN_BATCH, TRAIN_SEQ)),
                ckpt=False, cfg=cfg, peak_predicted=CODEQWEN_PEAK_PREDICTED)
    release()
    emit({"phase": "train_codeqwen", "phase_seconds":
          time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_cross_check_train("cross_check_train_codeqwen", "codeqwen1.5-7b")
    emit({"phase": "cross_check_train_codeqwen", "phase_seconds":
          time.perf_counter() - t0})


def big_phases(rows):
    for arch in BIG_LAYERS:
        served = phase_serve_big(rows, arch)
        phase_cross_check_big(arch, served)
        del served
        release()


def encdec_phases(rows):
    served = phase_serve_encdec(rows)
    phase_cross_check_encdec(served)
    del served
    release()
    phase_train_encdec(rows)
    release()
    phase_cross_check_train_encdec()


def vlm_phases(rows):
    served = phase_serve_vlm(rows)
    phase_cross_check_vlm(served)


def training_phases(rows):
    phase_train_synthetic()
    state = phase_train(rows)
    phase_train_restart(state)
    del state
    release()
    phase_cross_check_train()
    phase_train_rewriter(rows)


def qwen2_phases(rows):
    engine = phase_serve(rows)
    phase_cross_check(engine)
    phase_profile(engine)


def ssm_phases(rows):
    engine = phase_serve_ssm(rows)
    phase_cross_check(engine, "cross_check_ssm", state_leaf="ssm_state")
    phase_profile(engine, "profile_ssm")


def hybrid_phases(rows):
    engine = phase_serve_hybrid(rows)
    phase_cross_check(engine, "cross_check_hybrid", state_leaf="ssm_state")
    phase_profile(engine, "profile_hybrid")


def codeqwen_phases(rows):
    engine = phase_serve(rows, "serve_codeqwen", CODEQWEN_SERVE)
    phase_cross_check(engine, "cross_check_codeqwen",
                      layers=CUT_LAYERS["codeqwen1.5-7b"])
    phase_profile(engine, "profile_codeqwen")


def moe_phases(rows):
    engine = phase_serve(rows, "serve_moe", MOE_SERVE)
    phase_cross_check(engine, "cross_check_moe")
    phase_profile(engine, "profile_moe")


def mla_phases(rows):
    engine = phase_serve_mla(rows)
    phase_cross_check(engine, "cross_check_mla",
                      layers=CUT_LAYERS["minicpm3-4b"])
    phase_profile(engine, "profile_mla")


def main():
    name = phase_environment()
    phase_build()
    rows = phase_kernels()
    for phases in (qwen2_phases, ssm_phases, hybrid_phases, codeqwen_phases,
                   moe_phases, mla_phases, training_phases, encdec_phases,
                   phase_int8_decode, vlm_phases, ssm_training_phases,
                   mesh_phases, codeqwen_training_phases, big_phases):
        phases(rows)
        release()
    phase_dryrun()
    phase_window_decode()
    phase_cosine_api(rows)
    phase_semantic(rows)
    phase_semantic_single()
    phase_semantic_profile()
    phase_semantic_sharded()
    keys = ("name", "route", "source", "replaces", "path", "shape",
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
