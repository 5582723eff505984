#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print ptxas' registers / shared memory /
   spills;
3. hold every kernel against its plain PyTorch version on the card at the
   main paths' shapes (gemma3-1b, batch 4, block 16, chunk 16; the
   read-only cross-attention kernel at seamless-m4t-medium's and gemma3's
   head shapes) and time it, its plain version and one PyTorch library call
   computing the same function (a yardstick the port never calls), beside
   its bound; the bit-serial kernel also shows every plane's noisy weight
   bit-exact on both of its kernels; every kernel splits work across CTAs
   (split-K slabs or a thread-block cluster's ranks, summed in a fixed
   order) and gives bit-identical results on two calls; the decode
   attention kernels (fused and read-only) are held to float64 plain
   versions;
   the noisy matmuls are also timed at a chunk step (M = 64) and per
   distinct weight shape of a decode step, with device times
   (torch.profiler) beside event times, and the bit-serial phase reports
   the share of (k, plane) pairs whose plane is zero in every row;
4. serve 6 staggered requests through the port's ServingEngine at full
   gemma3-1b width (random weights from a seed; all-global, per-row DAC
   scale, frozen noise, paged KV, chunked prefill) on two paths: analog
   (every projection technique A on the default cell) and the "mixed"
   device placement (attention analog on PCM, MLPs bit-serial on RRAM, the
   unembed analog on PCM).  Each path's run resets every kernel's launch
   count just before and reads it just after; the mixed run books its
   energy per corner.  Then, for each path, every kernel call of one chunk
   step and one decode step is held to its plain version on the model's
   activations (K1's in float64), with exact call counts, and those
   steps' logits to the plain path's (1e-3 with a
   24-bit activation DAC; the main paths' 8-bit DAC gap is reported with
   the level flips that cause it);
5. serve 6 staggered requests through full-width seamless-m4t-medium
   (12 encoder + 12 decoder layers, random weights from a seed, analog,
   per-row DAC scale, frozen noise, paged KV, the legacy bucketed prefill;
   the engine's encoder input is all zeros, the speech front end being a
   stub) with exact launch counts: K1 and K4 12 per decode step, K3 217 per
   admission and 109 per decode step.  Then, with random encoder frame
   embeddings so that the cross K/V are not zero, three batch-1 prefills,
   their paged insert and one decode step at batch 4 (one idle row): every
   kernel call held to its plain version, and the logits to the plain
   path's as in phase 4;
6. serve 6 staggered requests with prompts of 520-600 tokens (max_len
   640) through gemma3-1b's published 5:1 stack cut to RING_LAYERS = 12
   deep: 10 sliding-window layers (window 512, every ring wraps) and 2
   global, analog, per-row DAC scale, frozen noise, chunked prefill; on
   the paged layout (per-slot rings of blocks for the local layers) with
   exact launch counts, K1 12 per decode step, K2 2 per chunk step (the
   global layers), K3 85 per step, and on the contiguous layout (JAX's
   default engine; K3 85 per step, no K1 or K2).  Then, on a history chunk step that wraps the rings, a chunk step
   and a decode step: every paged kernel call held to its plain version
   (K1 on the ring tables to its float64 plain version), and the logits
   of the paged and contiguous paths against each other and each against
   its plain path, 1e-3 at the 24-bit DAC, the 8-bit gaps reported;
7. the serving front end at full gemma3-1b width (all-global, analog,
   per-row DAC scale, frozen noise, paged, temperature 0), built through
   ``ServeSpec.build_engine``: the prefix cache on the default scenario
   matrix's shared-prefix cell (8 requests of 128 tokens with a 64-token
   header, staggered 2 steps; then a repeat of one prompt, a prompt that
   diverges inside a block, and a continuation of a request's prompt and
   its first 17 generated tokens), served with the cache off and on (a
   pool small enough to evict): identical tokens, the prompt tokens the
   cache served not computed, a copy-on-write admission, a hit on a block
   that decode wrote, an eviction, exact launch counts; then the matrix's
   Poisson cell (16 requests of 6-20 tokens at 4 req/s, block 8) through
   the launcher's ``serve_streaming`` and ``StreamingServer``, one request
   cancelled through its handle after its first token, the others
   finished; every result equal to a fresh engine replaying the stream's
   schedule of submits and cancels, exact launch counts, TTFT and
   inter-token latency reported; against an ``engine.serve`` run of the
   same requests, the logits of every token up to a request's first
   differing one held within POISSON_LOGIT_TOL (on the card a token's
   float order depends on the step it is computed in), and each
   difference's logit margins and DAC level flips printed; then each new
   path's kernel calls against their plain versions: the prefix path's on
   tables whose rows share blocks and over copied blocks, the Poisson
   path's at block 8;
8. training (float32): K3's backward kernels K3-dx and K3-dw at
   gemma3-1b's training shapes (M = 8 x 128; the tied unembed's table.T)
   and the CNN's K = 27 and 576, against float64 plain versions, dw bit
   for bit against the plain pass on integer x and g (x^T g exact in
   either precision), two calls bit-identical, timed beside K3's forward
   at the same shapes (the tensor-core kernel, held to its float64 plain
   version, two calls bit-identical, x = I to fluctuate bit for bit at
   the first shape), torch.matmul yardsticks and bounds (FP32 pipe and
   3xTF32, 4 products for the forward); then
   ``launch.train``'s path at full width (gemma3-1b as published, analog,
   AdamW, lam 1e-6, batch 8 x 128): a gradient step (finite nonzero
   gradients on every w and rho_raw; K3 (all on its tensor-core kernel),
   K3-dx, K3-dw 183 launches each),
   three steps through ``train_loop`` with exact launch counts, the step-2
   checkpoint (JAX's format) restored bit for bit, the third step
   profiled (device busy, peak memory), and a fresh loop resuming from
   step 2 whose third step equals the uninterrupted one bit for bit; the
   loss and every gradient of a full-width step, kernels against plain
   versions at a 24-bit DAC (TRAIN_PLAIN_TOL); vgg16_cifar (batch 32,
   SyntheticImages) under A+B (K3, K3-dx, K3-dw) and A+B+C (K5, the
   ideal-matmul VJP): gradients against the plain versions
   (CNN_PLAIN_TOL, ReLU gate flips counted), three steps with exact
   launch counts, finite losses and every rho moved by technique B;
9. (run between phases 7 and 8) speculative decoding and int8 weight
   streaming at full gemma3-1b width
   (all-global, analog, per-row DAC scale, frozen noise, batch 4): in
   phase 3 K3 with the int8 weight operand (the 182 projections of
   ``quantize_tree_for_serving(params)``; the tied unembed stays float32)
   at M = 4 and 64 against its plain version, bit-exact noisy weights,
   timed per step and per weight shape beside torch.matmul on the
   dequantized pre-noised weights and beside dequantizing in PyTorch
   before the float32 kernel; then the speculative engine
   (``ServeSpec(draft_placement="sram_digital", spec_k=4,
   temperature=0)``, gemma3-1b's published widths cut to SPEC_LAYERS =
   13 layers) on the paged and on the contiguous layout against the
   plain engine of the same spec on 6 staggered requests of 20-96 prompt
   tokens, max_new 32: launches exact from the engine's round log (K3 92
   a model step, K2 13 a verify step on the paged layout, no K1), the
   three ledger invariants at rtol 1e-6, tokens equal up to each
   request's first differing one and the logits up to it within
   POISSON_LOGIT_TOL (margins and DAC flips printed at each difference),
   accept rate, tokens/s and analog uJ/token with and without
   speculation, one full round timed and its verify step profiled
   (paged), then every kernel call
   of a round against its plain version (a draft decode, K3's GEMV at
   sigma 0; the verify, K3 on the tensor cores at M = 20 and K2 at
   C = 5); then the int8 engine on phase 4's requests
   (182 int8 and 1 float32 K3 launches a step; its device busy a step and
   peak memory against phase 4's), its kernel calls against
   their plain versions and its logits against the float32 engine's
   (1e-3 at the 24-bit DAC, the 8-bit gap reported);
10. (run between phases 9 and 8) mixture of experts: moonshot-v1-16b-a3b
   at its published widths (64 experts top-6 of d_ff 1408, d_model 2048,
   16 MHA heads of 128, vocab 163,840) cut to MOE_LAYERS = 4 of 48 layers,
   on the "mixed" placement (attention analog on PCM; the routers on SRAM
   through K3 at N = 64; the experts technique A on RRAM through K3's
   experts entry, one launch a projection of all 64 experts; the untied
   unembed analog on PCM), batch 4, paged, chunked: 6 staggered requests
   with exact launch counts (21 K3 and 12 expert K3 a step, K1 4 a
   decode step, K2 4 a chunk step, no K5) and energy on all three
   corners; every kernel call of a history chunk step, a chunk step
   (expert capacity 8) and a decode step (capacity 4) against its plain
   version, the expert calls' |w~| sum (rtol 1e-6) and max (exact) too;
   the experts entry timed on the decode step's 12 calls (and at the
   chunk step's M = 8) beside torch.bmm on the pre-noised stacks; the
   logits against the plain path at the 24-bit DAC (1e-3, every corner's
   noise on: the experts read in analog), the 8-bit gaps reported;
11. (run between phases 10 and 8) the recurrent stacks through the legacy
   bucketed prefill (the engine's only one for them): xlstm-350m at full
   width (24 blocks, 21 mLSTM and 3 sLSTM, d_model 1024, vocab 50,304,
   tied), analog, contiguous (nothing to page), prompts of 20-60 tokens
   (the reference's mLSTM gives NaN logits on a 128-position chunk), 166
   K3 launches an admission and a decode step; jamba-v0.1-52b at
   published widths (d_model 4096, 16 experts top-2 of 14,336, d_inner
   8,192, state 16, vocab 65,536) cut to JAMBA_LAYERS = 4 (mamba, mamba +
   MoE, mamba, attention + MoE) on the mixed placement, paged, prompts of
   20-120 tokens (a 128-token bucket runs the experts at 20 rows, the
   experts' tensor-core kernel): 19 K3, 6 expert K3 and 6 K5 launches an
   admission and a decode step, K1 one a decode step; for each, every
   kernel call of
   three legacy prefills and a decode step with an idle row against its
   plain version and the logits against the plain path's (1e-3 at the
   24-bit DAC, the 8-bit gaps reported), and the experts entry timed at
   20 rows on one jamba MoE layer's calls beside torch.bmm;
12. (run between phases 11 and 8) the five last architectures: gemma2-9b
   at full published width (42 layers alternating local and global,
   window 4,096, 16 heads over 8 of 256, vocab 256,000 tied, softcaps 50
   and 30: 9.24 B parameters, 37.0 GB), analog, paged, chunked prefill,
   batch 4, 6 staggered requests of GEMMA2_MAX_NEW tokens with exact
   launch counts (K3 295 a step, K1 42 a decode step, K2 42 a chunk step:
   max_len 128 is below the window, so no layer pages through a ring
   table), one profiled step of each kind; every kernel call of a
   history chunk step, a chunk step and a decode step against its plain
   version (K1 in float64) and their logits against the plain path's
   (1e-3 at the 24-bit DAC, the 8-bit gap and its level flips reported);
   then CUT_ARCHS at published widths cut in depth (llama3-405b 1 layer,
   deepseek-67b 2, qwen2-vl-72b 2 with M-RoPE and the embeds input,
   llama4-scout 2 on the mixed placement, its 16 experts top-1 through
   the experts entry), one after another: a chunk step (or, for the
   M-RoPE and embeds stacks, a legacy prefill of batch 3 on random
   embeddings) and a decode step at batch 4 with an idle row, launch
   counts exact, every kernel call against its plain version, the logits
   against the plain path's at the 24-bit DAC (1e-3); llama3's decode
   step runs K1 at G = 16.  Phase 3 also holds K1 and K4 at those
   architectures' query groups (ATTN_GROUPS: G = 16, 5, 8 and 2 x 256,
   softcap 50) against their float64 plain versions;
13. (run after phase 8) training the MoE and recurrent families:
   the experts' K3-dx and K3-dw (``emt_matmul_experts_dx`` /
   ``_dw``, one launch over a stack, expert e hashed at rows e * K + k,
   the noisy stack's sum |w~| cotangent in dw's epilogue) at
   moonshot-v1-16b-a3b's training shapes (E 64, M 120) and jamba's (E
   16, M 20) against float64 plain versions (K3_BWD_TOL), dw bit for bit
   on integer inputs, two calls bit-identical, timed beside torch.bmm on
   pre-noised stacks and their bounds; moonshot at published widths cut
   to TRAIN_MOE_LAYERS on the mixed placement and xlstm-350m at full
   width (batch 8 x 64), each built as ``launch.train`` builds a run
   (AdamW, lam 1e-6): a gradient step with exact launch counts and
   finite nonzero gradients, TRAIN_STEPS steps through ``train_loop``
   with its checkpoints off (gemma3's phase holds the round trip), the
   last profiled, then the trained weights' loss and every gradient
   against the plain versions at a 24-bit DAC (TRAIN_PLAIN_TOL; xlstm's
   plain run on the kernel run's branch at the gates' kinks and on its
   DAC levels); jamba at
   published widths cut to TRAIN_JAMBA_LAYERS (mamba + a K5 MLP, mamba +
   MoE at M = 20): one gradient step at batch 2 x 64 and a 24-bit DAC
   (the bit-serial MLPs' read noise off), launches exact, against the
   plain versions with the kernels' gradients moved to the host first.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Every "ms" is the kernel's time in one
main-path step: K1 = the 26 decode-attention launches of a gemma3 decode
step, K2 = the 26 prefill launches of a chunk step, K3 = the 183 noisy
matmuls of an analog decode step, K4 = the 12 cross-attention launches of
a seamless decode step, K5 = the 78 bit-serial MLP matmuls of a mixed
decode step, K3-dx and K3-dw (``emt_matmul_dx``, ``emt_matmul_dw``) = the
183 calls each of a gemma3-1b training step at M = 1,024, K3 int8
(``emt_matmul_int8``) = the 182 int8 calls and the float32 unembed of a
decode step (its launches: the int8 engine's run), K3's tensor-core
forward (``emt_matmul_tc``, every float32 and int8 K3 call at M > 16) =
the 183 calls of a gemma3-1b training step at M = 1,024 (its launches:
the training run's three steps; ``serve_launches`` its count in the
analog run's chunk steps), K3 experts
(``emt_matmul_experts``) = the 12 expert calls of a moonshot decode step
(M = 4; its launches: the moe run, and ``device_ms``/``chunk_*`` at the
chunk step's M = 8); K3's, K3 int8's, K3 experts' and K5's records carry
``library_device_ms`` (the yardstick's device time, every kernel its call
launched; K5's and the experts' also ``chunk_library_device_ms``), and K3
int8's ``unembed_device_ms`` (the float32 unembed's share of its step);
K3's and K5's records also carry ``chunk_ms``,
``chunk_bound_ms`` and ``chunk_library_ms``, the same matmuls and their
yardstick at M = 64, and K1's, K4's and K5's
``device_ms`` (K5's also ``chunk_device_ms``), the kernels' device time in
that step from torch.profiler, null where no trace recorded them (not
measured).  "launches" counts
K1-K3 in the analog run, K4 in the seamless run and K5 in the mixed run;
K1-K3 also carry ``ring_paged_launches`` and ``ring_contiguous_launches``,
their counts in the two ring runs, and ``prefix_launches`` and
``poisson_launches``, their counts in the prefix cache's cache-on run and
in the Poisson stream; K2's and K3's ``spec_paged_launches`` and
``spec_contiguous_launches`` are their counts in the two speculative
runs; K1-K3's (and ``emt_matmul_tc``'s) ``gemma2_launches`` their counts
in the gemma2-9b run, and ``llama3_launches``, ``deepseek_launches``,
``qwen2_launches`` and ``llama4_launches`` (K1, K2, K3 and the experts
entry, where the path launched them) their counts in each cut
architecture's two steps; K1's and K4's ``groups`` the device time and
bound of one launch at each ATTN_GROUPS shape ("G x hd"); K3's
``train_launches``, ``train_ms``, ``train_bound_ms`` and
``train_library_ms`` are its forward's in the training run; K3-dx's and
K3-dw's "launches" count the training run's three uninterrupted steps
and ``cnn_launches`` the two CNN runs'; the experts' K3-dx and K3-dw
(``emt_matmul_experts_dx``, ``emt_matmul_experts_dw``) = the 6 calls each
of a moonshot training step at 2 layers (E 64, M 120; their "launches":
the moonshot run's three steps, ``jamba_*`` the 3 calls of jamba's step
at E 16, M 20, ``library_ms`` torch.bmm on the pre-noised stacks, and
for dw the factor's multiply after it).
Bounds are the largest of the bytes over the H100 SXM's published 3.35
TB/s, the FP32 pipe's operations (FLOPs, and for the noisy matmuls the
hash's integer multiplies and the noise factor's FMULs as two each) over
its 67 TFLOP/s (no tensor cores) and, for the noisy matmuls, the integer
ALU pipe's operations of the noise hash and the state select over 64 lanes
per SM x 132 SMs x 1.98 GHz (16.7 TOP/s).  Those counts are the kernels'
own (HASH_OPS), matched against their SASS by scripts/sass_ops.py.  K3-dx
and K3-dw compute their products on the tensor cores in 3xTF32: their
bound's product term is 3 x 2 MKN TF32 FLOPs over the 495 TFLOP/s TF32
rate.  K3's forward above 16 rows (the training step at M = 1,024 and the
chunk steps at M = 64, float32 and int8) runs on the tensor cores too: its
product term is 4 x 2 MNK TF32 FLOPs, the fourth product being the price
of x = I returning w~ bit for bit (w~ split in three pieces; 3 products,
as dx's, are printed beside it for the training step), and the FP32-pipe
bound of the same work is printed beside it (``chunk_fp32_bound_ms``,
``fp32_bound_ms``).  K5 above 16 rows (the mixed chunk step, the CNN's
A+B+C training) runs on the tensor cores as well, the noisy weight of
each plane in three BF16 pieces: its chunk bound's product term is 3 x 2
MNK BF16 FLOPs a plane over the 989 TFLOP/s BF16 rate, beside the bytes
and its hash's ALU-pipe operations
(``chunk_bound_term`` names the term that sets it); ``cnn_device_ms`` is
the device time of the 13 K5 calls of one vgg16_cifar A+B+C step, replayed
on their recorded inputs.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
# the tensor cores' dense TF32 rate (NVIDIA's H100 SXM data sheet, 700 W);
# a 3xTF32 product does 3 x 2 MKN TF32 FLOPs
TF32_FLOPS = 495e12
# and their dense BF16 rate (K5 above 16 rows: three BF16 products a plane)
BF16_FLOPS = 989e12
# 32-bit integer operations on the ALU pipe (bit logic, shifts, compares,
# selects): 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (the H100 SXM's
# boost clock).  Integer multiplies (IMAD) issue to the FP32 (FMA) pipe.
INT32_OPS = 64 * 132 * 1.98e9
# The noisy matmuls' operations per weight element on one plane (alu,
# imad, fmul) and once per element whatever the planes (*_el), as the
# kernels compute them on a two-state corner (common.cuh, emt_matmul.cu,
# emt_bitserial.cu).  K3: hash_rc (1 XOR, 2 IMAD), hash_mix (6 shifts,
# 8 XOR, 4 IMAD), compare + select, w * factor.  K5's GEMV (M <= 16): per
# plane hash_mix_pre (5 shifts, 7 XOR, 4 IMAD) and compare + select of
# the element's two noisy values; per element hash_rc and its pre-shift
# (2 XOR, 1 shift, 2 IMAD) and those two values (2 FMUL).  K5 above 16
# rows counts the function's own work, not its kernel's: per plane
# hash_mix_folded on the element's pre-shifted row and column terms (a
# 3-input XOR, three shift/XOR pairs and a constant XOR: 8 ALU ops, 4
# IMAD), a compare and a select; per element its two noisy values (2
# FMUL); the row and column terms once a row and a column (not counted).
# What its kernel issues is printed beside the bound (K5_TC_ISSUE_ALU).
# scripts/sass_ops.py: K5's GEMV plane loop issues 7 LOP3, 5 SHF, 1 ISETP,
# 1 FSEL, 4 IMAD and M FFMA per element-plane (plus ~0.75 of loop
# control), K3's K walk 17.4 ALU-pipe operations per element, ~25
# instructions in all: below the ALU pipe's 64 lanes, 128 an SM a clock
# issue.
HASH_OPS = {
    "K3": dict(alu=17, imad=6, fmul=1),
    "K5 GEMV": dict(alu=14, imad=4, fmul=0, alu_el=3, imad_el=2, fmul_el=2),
    "K5 tc": dict(alu=10, imad=4, fmul=0, fmul_el=2),
}
# ALU-pipe instructions that bitserial_tc's plane loop issues an
# element-plane on a two-state corner, as scripts/sass_ops.py counts its
# SASS on sm_90a (one row tile; 4.81 IMAD-type, 21.25 in all with the
# loop's uniform and wgmma instructions): beyond the function's 10, the
# loop's control and addresses, the mask's build and one 3-input logic
# operation a piece to select the three BF16 pieces.  The kernel's issue
# cost: this over the element-planes it hashes, once per CTA row of x.
K5_TC_ISSUE_ALU = 13.38
ARCH = "gemma3-1b"
SEAMLESS = "seamless-m4t-medium"
# the MoE path: moonshot-v1-16b-a3b at its published widths on the "mixed"
# placement, cut from 48 layers to MOE_LAYERS: a layer holds 0.57 B
# parameters (2.28 GB in float32), 4 layers and the untied embedding and
# head 11.8 GB; the 48 layers (109 GB) do not fit the card
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 4
# the recurrent paths.  xlstm-350m at full width (24 blocks, 0.49 B
# parameters, 1.9 GB in float32), analog; its prompts stay at or under 64
# tokens, so that no legacy bucket reaches 128: the reference's mLSTM gives
# NaN logits on any prefill chunk of 128 positions (exp of the intra-chunk
# decay overflows before the causal mask multiplies it by 0), which the
# port mirrors (ROADMAP Queue 3)
XLSTM_ARCH, XLSTM_PROMPTS = "xlstm-350m", (20, 60)
# jamba-v0.1-52b at published widths cut from 32 layers to JAMBA_LAYERS
# (mamba; mamba + MoE; mamba; attention + MoE: 6.9 B parameters, 27.5 GB in
# float32) on the mixed placement; prompts of 20-120 tokens, so that an
# admission's bucket reaches 128 and the experts run capacity(128) = 20
# rows on the experts' tensor-core kernel; max_len 144 keeps that bucket
# (a bucket of max_len or more prefills at the prompt's exact length)
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 4
JAMBA_PROMPTS, JAMBA_MAX_LEN = (20, 120), 144
# the model steps of the recurrent paths' kernel and logits checks: three
# batch-1 legacy prefills of (prompt length, bucket), left-padded, then a
# decode step at batch 4 with one idle row
XLSTM_STEPS = ((20, 32), (60, 64), (13, 16))
JAMBA_STEPS = ((100, 128), (40, 64), (13, 16))
# jamba's logits checks (seven runs of the steps, the plain ones over 27.5
# GB of weights) drop the 64 bucket, whose calls the kernel check holds
JAMBA_LOGIT_STEPS = ((100, 128), (13, 16))
BATCH, BLOCK, CHUNK, MAX_LEN, MAX_NEW = 4, 16, 16, 128, 8
# the decode-attention kernels' query groups (G, hd) beyond gemma3's and
# seamless's, over 8 kv heads at softcap 50: llama3-405b's 16 x 128 (8
# outputs a thread), llama4-scout's 5 (no power of two), deepseek-67b's
# and qwen2-vl-72b's 8 and gemma2-9b's 2 x 256
ATTN_GROUPS = ((16, 128, "llama3-405b"), (5, 128, "llama4-scout-17b-a16e"),
               (8, 128, "deepseek-67b, qwen2-vl-72b"), (2, 256, "gemma2-9b"))
# gemma2-9b at its full published width (42 layers alternating local and
# global attention, window 4,096, d_model 3,584, 16 heads over 8 of 256,
# d_ff 14,336, vocab 256,000 tied and scaled, softcaps 50 and 30: 9.24 B
# parameters, 37.0 GB in float32), analog, paged, chunked; max_len MAX_LEN
# is below the window, so no layer pages through a ring table and the
# local layers see every position; requests of GEMMA2_MAX_NEW tokens
GEMMA2_ARCH, GEMMA2_MAX_NEW = "gemma2-9b", 4
# the architectures checked at published widths with the depth cut to fit
# the card (arch, layers, published layers, placement): llama3-405b's 126
# layers hold 1.6 TB in float32, one 29.6 GB of which 8.4 GB is the untied
# head; deepseek-67b 2 layers 12.3 GB; qwen2-vl-72b 2 layers 17.0 GB
# (M-RoPE, the embeds stub); llama4-scout 2 layers 24.9 GB, on the mixed
# placement so that its 16 experts (top-1) read in analog, as moonshot's do
CUT_ARCHS = (("llama3-405b", 1, 126, "analog"),
             ("deepseek-67b", 2, 95, "analog"),
             ("qwen2-vl-72b", 2, 80, "analog"),
             ("llama4-scout-17b-a16e", 2, 48, "mixed"))
SEED = 0
# the ring paths: prompts past gemma3-1b's 512-position window, so that
# every ring wraps
RING_MAX_LEN, RING_PROMPTS = 640, (520, 600)
# the ring paths' depth, cut from the published 26 layers to 12 (the 5:1
# pattern twice: 10 ring layers, 2 global) to keep the whole smoke well
# within its 1200 s limit (each 6 layers cost about 40 s of it); the
# widths, window and lengths are the published ones
RING_LAYERS = 12
# the prefix path: prompts of 128 tokens and a continuation of 145 (request
# 0's prompt and its first 17 generated tokens, so that block 8, written by
# decode, is hit); the cache-on run's pool evicts registered blocks
PREFIX_MAX_LEN, PREFIX_CONT_AT, PREFIX_ON_BLOCKS = 192, 17, 40
# the speculative paths: 6 staggered greedy requests of 20-96 prompt
# tokens, max_new 32, drafting SPEC_K tokens a round on sram_digital;
# gemma3-1b all-global at published widths, cut from 26 layers to
# SPEC_LAYERS to keep the smoke within its 1200 s limit with the recurrent
# paths (the two phases took 133 s at 26 layers)
SPEC_K, SPEC_MAX_NEW, SPEC_PROMPTS = 4, 32, (20, 96)
SPEC_LAYERS = 13
# the request the Poisson path cancels after its first token
POISSON_CANCEL = 3
# The Poisson stream against engine.serve of the same requests: a token may
# be computed in a decode step or as a decode lane of a chunk step, under
# another view bucket, so it sums in another float32 order, and at the
# 8-bit DAC a level can flip at a .5 tie.  One step's logits then move by
# 0.12-0.23 (the logits phases' 8-bit kernel vs plain and f32 vs f64
# gaps on the H100); the stream's logits are held to engine.serve's within
# about twice that on every token up to a request's first differing one.
POISSON_LOGIT_TOL = 0.5
# a token reported in both schedules whatever the run: request 2's token
# 10, which came out differently in the stream and in engine.serve in
# earlier runs on the H100
POISSON_PROBE = (2, 10)
# training: gemma3-1b at full width through launch.train's path (AdamW, lam
# 1e-6, 3 steps, batch 8 x 128 tokens) and the paper's vgg16_cifar (batch
# 32 of 32 x 32 images, 10 classes) under regimes A+B and A+B+C
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 3
CNN_BATCH, CNN_STEPS, CNN_LR, CNN_LAM = 32, 3, 5e-3, 3e-8
TRAIN_KERNELS = ("emt_matmul", "emt_matmul_tc", "emt_matmul_dx",
                 "emt_matmul_dw", "emt_bitserial", "emt_matmul_experts",
                 "emt_matmul_experts_dx", "emt_matmul_experts_dw")
# training the MoE and recurrent families (phase 13): moonshot-v1-16b-a3b
# at published widths cut from 48 layers to TRAIN_MOE_LAYERS (1.81 B
# parameters, 29 GB with AdamW) and xlstm-350m at full width, each
# TRAIN_STEPS steps at batch TRAIN_BATCH (xlstm's sequences
# XLSTM_TRAIN_SEQ: the reference's mLSTM gives NaN on a 128-position
# chunk); jamba-v0.1-52b at published widths cut from 32 layers to
# TRAIN_JAMBA_LAYERS (mamba + MLP, mamba + MoE: 3.7 B parameters), one
# gradient step at JAMBA_TRAIN_BATCH x JAMBA_TRAIN_SEQ (expert capacity 20)
TRAIN_MOE_LAYERS, TRAIN_JAMBA_LAYERS, XLSTM_TRAIN_SEQ = 2, 2, 64
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ = 2, 64
# K3-dx and K3-dw against their float64 plain versions: dx sums up to
# 262,144 float32 products in one thread's sequence (the tied unembed),
# ~eps * sqrt(N) = 3e-5 of the result
K3_BWD_TOL = 1e-4
# K3's forward on the tensor cores (3xTF32 with a three-piece weight)
# against its float64 plain version at the training shapes
K3_FWD_TOL = 1e-5
# a full-width training step's loss and gradients, kernels against the
# plain versions on the card at a 24-bit DAC: float32 order differences of
# the kernels' sums carried through 26 layers' backward
TRAIN_PLAIN_TOL = 1e-3
# the same for vgg16_cifar: its ReLUs are not continuous in their
# gradient, so a pre-activation within the two runs' float32 difference of
# 0 opens its gate in one run and not in the other, and moves the
# gradients below it by that position's whole term (1.2e-3 measured on
# the H100 at the 24-bit DAC, the gates that differ counted and printed)
CNN_PLAIN_TOL = 1e-2


def bound(nbytes: float, flops: float, alu: float = 0.0, fma: float = 0.0,
          tc: float = 0.0, bf16: float = 0.0):
    """(ms, "bytes" or "operations", the term that bounds): the largest of
    the bytes over the memory rate, the FP32 pipe's operations (the FLOPs
    and `fma` other operations there, IMAD and FMUL, two FLOPs' worth
    each), the integer ALU pipe's `alu` operations and, for a kernel on
    the tensor cores, its `tc` TF32 FLOPs and `bf16` BF16 FLOPs, over
    their peak rates."""
    terms = [(nbytes / HBM_BPS * 1e3, "bytes", "bytes"),
             ((flops + 2 * fma) / FP32_FLOPS * 1e3, "operations",
              "FP32 pipe" if fma else "FP32 FLOPs"),
             (alu / INT32_OPS * 1e3, "operations", "INT32 ALU pipe"),
             (tc / TF32_FLOPS * 1e3, "operations", "3xTF32 tensor cores"),
             (bf16 / BF16_FLOPS * 1e3, "operations", "BF16 tensor cores")]
    return max(terms, key=lambda t: t[0])


def hash_ops(kind: str, elements: int, planes: int = 1):
    """(ALU-pipe ops, other FP32-pipe ops) of the noise hash and select of
    `elements` weight elements on `planes` planes (HASH_OPS[kind])."""
    c = HASH_OPS[kind]
    alu = elements * (c["alu"] * planes + c.get("alu_el", 0))
    fma = elements * ((c["imad"] + c["fmul"]) * planes + c.get("imad_el", 0)
                      + c.get("fmul_el", 0))
    return alu, fma


def k5_bound(k5, calls):
    """K5's bound over `calls`, (M, K, N, planes) each: (bound(...), the
    bytes, the ALU-pipe operations, the ms of the tensor-core kernel's
    ALU-pipe issue).  Bytes: each input read once, y written once.
    Products: FP32 FLOPs on the GEMV (M <= 16); above, three BF16
    products a plane (the weight in three pieces) on the tensor cores.
    The hash and its select on every weight element and plane (HASH_OPS).
    The issue: K5_TC_ISSUE_ALU over the element-planes the kernel hashes,
    its 128-column tiles by its CTA rows (k5.tc_rows)."""
    nbytes = flops = alu = fma = bf16 = hashed = 0
    for M, K, N, bits in calls:
        nbytes += 4 * (M * K + K * N + M * N)
        gemv = M <= k5.GEMV_MAX_M
        if gemv:
            flops += 2 * M * N * K * bits
        else:
            bf16 += 3 * 2 * M * N * K * bits
            bn, rows = k5.TC["bn"], k5.tc_rows(M)
            hashed += K * -(-N // bn) * bn * -(-M // rows) * bits
        a, f = hash_ops("K5 GEMV" if gemv else "K5 tc", N * K, bits)
        alu, fma = alu + a, fma + f
    return (bound(nbytes, flops, alu, fma, bf16=bf16), nbytes, alu,
            K5_TC_ISSUE_ALU * hashed / INT32_OPS * 1e3)


def share(bound_ms: float, ms) -> str:
    """bound_ms as a share of a measured time (None: not measured)."""
    return "not measured" if ms is None else f"{100 * bound_ms / ms:.2f}%"


def fmt(ms, digits: int = 3) -> str:
    """A time in ms, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def plane_pairs(xq, bits: int) -> int:
    """The (k, plane) pairs of levels xq (M, K) whose plane is not zero in
    every row (the others add exact zeros; the bit-serial kernel computes
    them all the same: skipping them measured slower)."""
    a = xq.abs().long()
    return sum(int(((a >> p) & 1).any(0).sum().item()) for p in range(bits))


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `iters` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, key, tries: int = 3, need: str = "", agree: bool = False):
    """Device time (ms) of the kernels whose name contains `key` (a string
    or a tuple of them) in one run of fn, from torch.profiler: the kernels
    alone, without the host's dispatch gaps that a CUDA-event time of short
    launches includes ("" matches every kernel: the device busy time).
    `key` may be a dict of such keys by name: then a dict of their times
    from the same trace.  A trace that holds none of them, or none named
    `need` where given (the profiler on the card has dropped a run's
    device events, once only the large product's of three kernels), is
    taken again, up to `tries` times; None (not measured, null in the
    record) if none does.  `agree`: the profiler has also dropped some of
    a run's events and kept the rest, so a trace counts only once another
    holds as many device events (up to 2 * tries traces)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    groups = key if isinstance(key, dict) else {None: key}
    groups = {n: (k,) if isinstance(k, str) else k for n, k in groups.items()}
    fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(2 * tries if agree else tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device events only: an aten op's entry carries the device time
        # of the kernels it launched, which are entries too
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        ms = {n: sum(e.self_device_time_total for e in events
                     if any(k in e.key for k in keys)) / 1e3
              for n, keys in groups.items()}
        needed = sum(e.self_device_time_total for e in events
                     if need in e.key)
        count = sum(e.count for e in events)
        if min(ms.values()) > 0 and needed > 0 and (
                not agree or count in seen):
            return ms if isinstance(key, dict) else ms[None]
        seen.add(count)
    print(f"  (torch.profiler recorded no device time for "
          f"{list(groups.values())} in {tries} traces: not measured)")
    return dict.fromkeys(key) if isinstance(key, dict) else None


def graph_ms(fn, iters: int = 5):
    """Milliseconds of fn() with no host dispatch between its kernels: fn
    captured once as a CUDA graph (after a warm-up run on a side stream),
    the graph replayed `iters` times between CUDA events, the mean; None
    where the capture fails (the error printed)."""
    import torch
    try:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        ms = cuda_time(graph.replay, iters)
        del graph
        return ms
    except RuntimeError as e:
        print(f"  (graph capture failed: {e}; not measured)")
        return None


def rel_err(a, b) -> tuple:
    d = (a - b).abs().max().item()
    return d, d / max(b.abs().max().item(), 1e-30)


class Smoke:
    """The phases, run in order by main()."""

    def __init__(self):
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failures = []
        self.records = {}
        self.ring_summaries = {}
        self.spec_summaries = {}

    def sync(self):
        self.torch.cuda.synchronize()

    def fail(self, msg: str):
        print(f"FAIL: {msg}", flush=True)
        self.failures.append(msg)

    def check(self, cond: bool, msg: str):
        if not cond:
            self.fail(msg)

    # -- phase 1 -------------------------------------------------------------
    def device_info(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        self.smi = smi
        print(f"card: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"{self.sms} SMs")

    # -- phase 2 -------------------------------------------------------------
    def build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        infos = _build.build()
        print(f"build: {time.perf_counter() - t0:.2f} s wall for "
              f"{len(infos)} kernels (parallel nvcc)")
        for name, info in infos.items():
            print(f"  {name}: {info.seconds:.2f} s -> {info.path.name}")
            for line in info.log.splitlines():
                if re.search(r"registers|spill|Compiling entry", line):
                    print(f"    {line.strip()}")

    # -- phase 3: model weights shared by the kernel checks and the engine --
    def model(self):
        from repro_torch.models import lm
        from repro_torch.serve.spec import build_config
        self.cfg = build_config(ARCH, "analog", smoke=False, all_global=True,
                                a_per_row=True)
        self.mixed = build_config(ARCH, smoke=False, placement="mixed",
                                  all_global=True, a_per_row=True)
        # the speculative paths' stack: the first SPEC_LAYERS layers
        self.spec_cfg = self.cfg.replace(num_layers=SPEC_LAYERS)
        # the published stack, 5 sliding-window (ring) layers to 1 global,
        # cut to RING_LAYERS deep
        self.ring = build_config(ARCH, "analog", smoke=False, a_per_row=True,
                                 model_overrides={"num_layers": RING_LAYERS})
        self.check(self.ring.blocks().count("global") == RING_LAYERS // 6
                   and self.ring.sliding_window == 512,
                   f"ring stack {self.ring.blocks()}")
        # every projection of the three paths is active (it has a rho_raw)
        # and a local layer has a global one's weights: one parameter tree
        # serves all three (the ring stack reads its first RING_LAYERS
        # layers)
        shapes = [[(k, tuple(v.shape)) for k, v in _flat(lm.specs(c))]
                  for c in (self.cfg, self.mixed, self.ring)]
        self.check(shapes[0] == shapes[1] and set(shapes[2]) <= set(shapes[0]),
                   "analog, mixed and ring parameter trees differ")
        t0 = time.perf_counter()
        self.params = lm.init_model_params(self.cfg, SEED, device=self.dev)
        self.sync()
        n = sum(p.numel() for _, p in _flat(self.params))
        print(f"model: {ARCH} full width, {self.cfg.num_layers} layers, "
              f"{n:,} parameters (f32), init "
              f"{time.perf_counter() - t0:.2f} s")
        plan = {}
        for _, corner, mode in self.mixed.placement_plan():
            plan[(corner, mode)] = plan.get((corner, mode), 0) + 1
        print(f"  mixed placement: {plan} projections per (corner, mode)")

    def seamless_model(self):
        from repro_torch.models import lm
        from repro_torch.serve.spec import build_config
        self.s2s = build_config(SEAMLESS, "analog", smoke=False,
                                all_global=True, a_per_row=True)
        t0 = time.perf_counter()
        self.s2s_params = lm.init_model_params(self.s2s, SEED,
                                               device=self.dev)
        self.sync()
        n = sum(p.numel() for _, p in _flat(self.s2s_params))
        cfg = self.s2s
        print(f"model: {SEAMLESS} full width, {cfg.encoder_layers} encoder + "
              f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads of {cfg.head_dim} (kv "
              f"{cfg.num_kv_heads}), d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, untied lm_head: {n:,} parameters (f32), "
              f"init {time.perf_counter() - t0:.2f} s")

    def k3(self):
        """Technique-A matmul at every projection of one decode step (and of
        one chunk step, M = 64)."""
        from repro_torch.core import noise, quant, regularizer
        from repro_torch.core.emt_linear import _tag_plane
        from repro_torch.kernels import emt_matmul as k
        torch = self.torch
        emt = self.cfg.emt
        layers = self.params["decoder"]
        calls = []                      # (w, rho_raw, plane)
        for name in sorted(layers):
            blk = layers[name]
            for grp, w in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                           ("attn", "wo"), ("ffn", "wg"), ("ffn", "wu"),
                           ("ffn", "wd")):
                p = blk[grp][w]
                tag = f"dec/{name}/{'mlp' if grp == 'ffn' else grp}/{w}"
                calls.append((p["w"], p["rho_raw"], _tag_plane(tag)))
        calls.append((self.params["embed"]["table"].T,
                      self.params["lm_head"]["rho_raw"],
                      _tag_plane("unembed")))
        gen = torch.Generator(device=self.dev).manual_seed(1)
        prepared = []
        for w, rho_raw, plane in calls:
            wq, _ = quant.quantize_weights(w, emt.quant)
            rho = regularizer.rho_from_raw(rho_raw)
            sig = emt.device.sigma_rel(rho)
            prepared.append((wq, rho, sig, plane))
        # correctness at every distinct (K, N), decode and chunk row counts;
        # a second call on the same inputs must give the same bits (the
        # split-K sum runs in slab order)
        seen = set()
        worst = 0.0
        for wq, rho, sig, plane in prepared:
            shape = tuple(wq.shape)
            if shape in seen:
                continue
            seen.add(shape)
            K, N = shape
            for M in (BATCH, BATCH * CHUNK):
                x = torch.randn((M, K), generator=gen, device=self.dev)
                y = k.emt_matmul(x, wq, sig, device=emt.device, seed=SEED,
                                 plane=plane)
                y2 = k.emt_matmul(x, wq, sig, device=emt.device, seed=SEED,
                                  plane=plane)
                yp = k.plain(x, wq, sig, device=emt.device, seed=SEED,
                             plane=plane)
                self.sync()
                d, r = rel_err(y, yp)
                same = torch.equal(y, y2)
                worst = max(worst, d)
                p = k.plan(M, N, K, self.sms, wq.stride(1) == 1)
                print(f"  K3 {M}x{K} @ {K}x{N}"
                      f"{' (tied unembed, transposed)' if wq.stride(0) == 1 else ''}"
                      f": max|diff| {d:.3e} rel {r:.3e}; {p.splits} K "
                      f"slab(s) of {p.k_slab}, {p.ctas} CTAs; two calls "
                      f"bit-identical: {same}")
                self.check(r <= 1e-5, f"K3 {M}x{K}x{N} rel {r:.3e} > 1e-5")
                self.check(same, f"K3 {M}x{K}x{N}: two calls differ")
            # x = I returns the noisy weight itself: bit-exact with fluctuate
            eye = torch.eye(K, device=self.dev)
            wn = k.emt_matmul(eye, wq, sig, device=emt.device, seed=SEED,
                              plane=plane)
            ref = noise.fluctuate(wq, rho, emt.device, emt.noise, seed=SEED,
                                  plane=plane)
            same = torch.equal(wn, ref)
            print(f"  K3 noisy weight {K}x{N} bit-exact with fluctuate: {same}")
            self.check(same, f"K3 noisy weight {K}x{N} differs from fluctuate")
            del eye, wn, ref
        # timing: one decode step's 183 calls (and a chunk step's), in model
        # order
        xs = [torch.randn((BATCH, wq.shape[0]), generator=gen, device=self.dev)
              for wq, *_ in prepared]
        xc = [torch.randn((BATCH * CHUNK, wq.shape[0]), generator=gen,
                          device=self.dev) for wq, *_ in prepared]

        def run(fn, inputs, calls=prepared):
            for x, (wq, rho, sig, plane) in zip(inputs, calls):
                fn(x, wq, sig, device=emt.device, seed=SEED, plane=plane)

        noisy = [noise.fluctuate(wq, rho, emt.device, emt.noise, seed=SEED,
                                 plane=plane)
                 for wq, rho, sig, plane in prepared]

        def run_library(inputs=xs):
            for x, wn in zip(inputs, noisy):
                torch.matmul(x, wn)

        def step_bound(M, calls=prepared):
            """(the bound, the FP32-pipe bound's ms, bytes, FLOPs): bytes
            (each input read once, y written once), 2 MKN FLOPs and the
            hash's and select's operations, once per weight element
            (HASH_OPS["K3"]).  Above GEMV_MAX_M rows the product runs on
            the tensor cores: its term is the forward's four TF32
            products, and the FP32-pipe bound is the same work with the
            product on the FP32 pipe."""
            nbytes = sum(4 * (M * K + K * N + M * N)
                         for K, N in (wq.shape for wq, *_ in calls))
            flops = sum(2 * M * wq.numel() for wq, *_ in calls)
            alu, fma = hash_ops("K3", sum(wq.numel() for wq, *_ in calls))
            fp32 = bound(nbytes, flops, alu, fma)
            if M > k.GEMV_MAX_M:
                return (bound(nbytes, 0, alu, fma, 4 * flops), fp32[0],
                        nbytes, flops)
            return fp32, fp32[0], nbytes, flops

        # event times first, the kernel beside its yardstick, then the
        # profiler's device times
        keys = ("emt_matmul", "emt_matmul_tc", "split_sum")
        ms = cuda_time(lambda: run(k.emt_matmul, xs), 5)
        lib_ms = cuda_time(run_library, 5)
        chunk_ms = cuda_time(lambda: run(k.emt_matmul, xc), 3)
        chunk_lib_ms = cuda_time(lambda: run_library(xc), 3)
        dev_ms = device_ms(lambda: run(k.emt_matmul, xs), keys, agree=True)
        chunk_dev_ms = device_ms(lambda: run(k.emt_matmul, xc), keys,
                                 agree=True)
        # the yardstick's device time: every kernel torch.matmul launches
        lib_dev_ms = device_ms(run_library, "", agree=True)
        del noisy
        plain_ms = cuda_time(lambda: run(k.plain, xs), 2, warmup=1)
        (b_ms, by, bterm), _, nbytes, flops = step_bound(BATCH)
        (cb_ms, cby, cterm), cb32_ms, _, cflops = step_bound(BATCH * CHUNK)
        self.records["emt_matmul"] = dict(
            name="emt_matmul", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_matmul.cu",
            replaces="src/repro/kernels/emt_matmul.py:57",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, chunk_ms=chunk_ms,
            chunk_bound_ms=cb_ms, chunk_fp32_bound_ms=cb32_ms,
            chunk_library_ms=chunk_lib_ms)
        print(f"  K3 per decode step ({len(prepared)} calls, M={BATCH}): "
              f"kernel {ms:.3f} ms (device time {fmt(dev_ms)}), plain "
              f"{plain_ms:.3f} ms, torch.matmul on pre-noised weights "
              f"{lib_ms:.3f} ms (device time {fmt(lib_dev_ms)}), bound "
              f"{b_ms:.3f} ms ({bterm}; "
              f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP), roofline "
              f"share {100 * b_ms / ms:.2f}%")
        print(f"  K3 per chunk step ({len(prepared)} calls, "
              f"M={BATCH * CHUNK}): kernel {chunk_ms:.3f} ms (device time "
              f"{fmt(chunk_dev_ms)}), torch.matmul on pre-noised weights "
              f"{chunk_lib_ms:.3f} ms (loses by "
              f"{chunk_ms / chunk_lib_ms:.3f}x), bound "
              f"{cb_ms:.3f} ms ({cterm}; {cflops / 1e9:.3f} GFLOP), roofline "
              f"share {100 * cb_ms / chunk_ms:.2f}%, share of the device "
              f"time {share(cb_ms, chunk_dev_ms)}; FP32-pipe bound "
              f"{cb32_ms:.3f} ms)")
        # per distinct (K, N, layout) at M = 4: which calls lead the step
        groups = {}
        for i, (wq, *_) in enumerate(prepared):
            groups.setdefault((*wq.shape, wq.stride(1) == 1), []).append(i)
        for (K, N, n_major), idx in groups.items():
            calls = [prepared[i] for i in idx]
            inputs = [xs[i] for i in idx]
            g_ms = cuda_time(lambda: run(k.emt_matmul, inputs, calls), 5)
            g_dev = device_ms(lambda: run(k.emt_matmul, inputs, calls), keys,
                              agree=True)
            (g_b, _, g_term), _, g_bytes, _ = step_bound(BATCH, calls)
            print(f"  K3 {K}x{N}{'' if n_major else ' (transposed)'} at "
                  f"M={BATCH}: {len(idx)} calls a step, {g_ms:.4f} ms "
                  f"(device time {fmt(g_dev, 4)}), bound {g_b:.4f} ms "
                  f"({g_term}; {g_bytes / 1e9:.3f} GB), share of the device "
                  f"time {share(g_b, g_dev)}")

    def k3_int8(self):
        """K3 with the int8 weight operand (store_int8 serving): the 182
        projections of quantize_tree_for_serving(params) as int8 levels and
        per-column scales, the tied unembed float32 (its dict holds no
        w), at a decode step (M = 4) and a chunk step (M = 64).  Every
        distinct weight shape within 1e-5 of the plain version (dequantize,
        then K3's plain path), two calls bit-identical, x = I bit-exact
        with fluctuate of the dequantized weight; timed with its plain
        version and torch.matmul on the dequantized, pre-noised float32
        weights (event and device time), the float32 unembed's share of
        the step's device time apart; bound: the int8 bytes against the
        hash's ALU-pipe
        operations (HASH_OPS["K3"]) and the FP32 pipe's (plus one FMUL an
        element for the dequantization)."""
        from repro_torch.core import noise, regularizer
        from repro_torch.core.emt_linear import (_tag_plane,
                                                 quantize_tree_for_serving)
        from repro_torch.kernels import emt_matmul as k
        from repro_torch.kernels.ref import dequantize
        torch = self.torch
        emt = self.cfg.emt
        self.params_q = quantize_tree_for_serving(self.params)
        layers = self.params_q["decoder"]
        prepared = []                   # (w operand, rho, sig, plane)
        for name in sorted(layers):
            blk = layers[name]
            for grp, w in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                           ("attn", "wo"), ("ffn", "wg"), ("ffn", "wu"),
                           ("ffn", "wd")):
                p = blk[grp][w]
                tag = f"dec/{name}/{'mlp' if grp == 'ffn' else grp}/{w}"
                rho = regularizer.rho_from_raw(p["rho_raw"])
                prepared.append(((p["w_int8"], p["w_scale"]), rho,
                                 emt.device.sigma_rel(rho), _tag_plane(tag)))
        from repro_torch.core import quant
        table_q, _ = quant.quantize_weights(self.params["embed"]["table"].T,
                                            emt.quant)
        rho = regularizer.rho_from_raw(self.params_q["lm_head"]["rho_raw"])
        prepared.append((table_q, rho, emt.device.sigma_rel(rho),
                         _tag_plane("unembed")))
        gen = torch.Generator(device=self.dev).manual_seed(3)
        seen, worst = set(), 0.0
        for w, rho, sig, plane in prepared:
            if not isinstance(w, tuple):
                continue                # the float unembed: the K3 phase's
            shape = tuple(w[0].shape)
            if shape in seen:
                continue
            seen.add(shape)
            K, N = shape
            for M in (BATCH, BATCH * CHUNK):
                x = torch.randn((M, K), generator=gen, device=self.dev)
                y = k.emt_matmul(x, w, sig, device=emt.device, seed=SEED,
                                 plane=plane)
                y2 = k.emt_matmul(x, w, sig, device=emt.device, seed=SEED,
                                  plane=plane)
                yp = k.plain(x, w, sig, device=emt.device, seed=SEED,
                             plane=plane)
                self.sync()
                d, r = rel_err(y, yp)
                same = torch.equal(y, y2)
                worst = max(worst, d)
                p = k.plan(M, N, K, self.sms, True)
                print(f"  K3 int8 {M}x{K} @ {K}x{N}: max|diff| {d:.3e} rel "
                      f"{r:.3e}; {p.splits} K slab(s) of {p.k_slab}, "
                      f"{p.ctas} CTAs; two calls bit-identical: {same}")
                self.check(r <= 1e-5, f"K3 int8 {M}x{K}x{N} rel {r:.3e}")
                self.check(same, f"K3 int8 {M}x{K}x{N}: two calls differ")
            eye = torch.eye(K, device=self.dev)
            wn = k.emt_matmul(eye, w, sig, device=emt.device, seed=SEED,
                              plane=plane)
            ref = noise.fluctuate(dequantize(*w), rho, emt.device, emt.noise,
                                  seed=SEED, plane=plane)
            same = torch.equal(wn, ref)
            print(f"  K3 int8 noisy weight {K}x{N} bit-exact with fluctuate "
                  f"of the dequantized weight: {same}")
            self.check(same, f"K3 int8 noisy weight {K}x{N} differs")
            del eye, wn, ref
        xs = [torch.randn((BATCH, (w[0] if isinstance(w, tuple) else w)
                           .shape[0]), generator=gen, device=self.dev)
              for w, *_ in prepared]
        xc = [torch.randn((BATCH * CHUNK, x.shape[1]), generator=gen,
                          device=self.dev) for x in xs]

        def run(fn, inputs):
            for x, (w, rho, sig, plane) in zip(inputs, prepared):
                fn(x, w, sig, device=emt.device, seed=SEED, plane=plane)

        noisy = [noise.fluctuate(dequantize(*w) if isinstance(w, tuple)
                                 else w, rho, emt.device, emt.noise,
                                 seed=SEED, plane=plane)
                 for w, rho, sig, plane in prepared]

        def run_library(inputs=xs):
            for x, wn in zip(inputs, noisy):
                torch.matmul(x, wn)

        def step_bound(M):
            """(the bound, the FP32-pipe bound's ms, bytes, FLOPs, ALU
            ops): bytes (x, the weight as stored: int8 levels + the
            float32 scale, or float32, and y), 2 MKN FLOPs, and the
            hash's, the select's and the dequantization's operations per
            element; above GEMV_MAX_M rows the product term is the tensor
            cores' four TF32 products, as K3's."""
            nbytes = flops = elements = deq = 0
            for w, *_ in prepared:
                q8 = isinstance(w, tuple)
                K, N = (w[0] if q8 else w).shape
                nbytes += 4 * M * K + 4 * M * N + (K * N + 4 * N if q8
                                                   else 4 * K * N)
                flops += 2 * M * K * N
                elements += K * N
                deq += K * N if q8 else 0
            alu, fma = hash_ops("K3", elements)
            fp32 = bound(nbytes, flops, alu, fma + deq)
            if M > k.GEMV_MAX_M:
                return (bound(nbytes, 0, alu, fma + deq, 4 * flops), fp32[0],
                        nbytes, flops, alu)
            return fp32, fp32[0], nbytes, flops, alu

        keys = ("emt_matmul", "emt_matmul_tc", "split_sum")
        ms = cuda_time(lambda: run(k.emt_matmul, xs), 5)
        lib_ms = cuda_time(run_library, 5)
        chunk_ms = cuda_time(lambda: run(k.emt_matmul, xc), 3)
        chunk_lib_ms = cuda_time(lambda: run_library(xc), 3)
        dev_ms = device_ms(lambda: run(k.emt_matmul, xs), keys, agree=True)
        chunk_dev_ms = device_ms(lambda: run(k.emt_matmul, xc), keys,
                                 agree=True)
        lib_dev_ms = device_ms(run_library, "", agree=True)
        # the float32 unembed's share of the step (the last call)
        w, rho, sig, plane = prepared[-1]
        unembed_dev_ms = device_ms(
            lambda: k.emt_matmul(xs[-1], w, sig, device=emt.device,
                                 seed=SEED, plane=plane), keys, agree=True)
        del noisy

        def dequantized(x, w, sig, **kw):
            """The alternative to the int8 operand: dequantize in PyTorch,
            then the float32 kernel."""
            return k.emt_matmul(x, dequantize(*w) if isinstance(w, tuple)
                                else w, sig, **kw)

        # every kernel of the step: the dequantization's and K3's
        deq_dev_ms = device_ms(lambda: run(dequantized, xs), "")
        plain_ms = cuda_time(lambda: run(k.plain, xs), 2, warmup=1)
        (b_ms, by, bterm), _, nbytes, flops, alu = step_bound(BATCH)
        (cb_ms, _, cterm), cb32_ms, _, cflops, _ = step_bound(BATCH * CHUNK)
        self.records["emt_matmul_int8"] = dict(
            name="emt_matmul_int8", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_matmul.cu",
            replaces="src/repro/kernels/emt_matmul.py:57",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms,
            unembed_device_ms=unembed_dev_ms,
            chunk_ms=chunk_ms, chunk_device_ms=chunk_dev_ms,
            chunk_bound_ms=cb_ms, chunk_fp32_bound_ms=cb32_ms,
            chunk_library_ms=chunk_lib_ms, dequantized_device_ms=deq_dev_ms)
        int8_dev_ms = (None if dev_ms is None or unembed_dev_ms is None
                       else dev_ms - unembed_dev_ms)
        print(f"  K3 int8 per decode step: the float32 unembed "
              f"{fmt(unembed_dev_ms)} of the step's {fmt(dev_ms)} device "
              f"time ({share(unembed_dev_ms or 0.0, dev_ms)}), the "
              f"{len(prepared) - 1} int8 calls {fmt(int8_dev_ms)}")
        print(f"  K3 int8 per decode step: dequantizing in PyTorch and "
              f"running the float32 kernel instead takes {fmt(deq_dev_ms)} "
              f"of device time against the int8 operand's {fmt(dev_ms)}")
        print(f"  K3 int8 per decode step ({len(prepared) - 1} int8 calls + "
              f"the float32 unembed, M={BATCH}): kernel {ms:.3f} ms (device "
              f"time {fmt(dev_ms)}), plain {plain_ms:.3f} ms, torch.matmul "
              f"on dequantized pre-noised weights {lib_ms:.3f} ms (device "
              f"time {fmt(lib_dev_ms)}), bound "
              f"{b_ms:.3f} ms ({bterm}; {nbytes / 1e9:.3f} GB over the "
              f"memory rate {nbytes / HBM_BPS * 1e3:.3f} ms, {alu / 1e9:.2f} "
              f"G ALU-pipe operations {alu / INT32_OPS * 1e3:.3f} ms), "
              f"share of the device time {share(b_ms, dev_ms)}")
        print(f"  K3 int8 per chunk step (M={BATCH * CHUNK}): kernel "
              f"{chunk_ms:.3f} ms (device time {fmt(chunk_dev_ms)}), "
              f"torch.matmul {chunk_lib_ms:.3f} ms, bound {cb_ms:.3f} ms "
              f"({cterm}; {cflops / 1e9:.3f} GFLOP), share of the device "
              f"time {share(cb_ms, chunk_dev_ms)}; FP32-pipe bound "
              f"{cb32_ms:.3f} ms)")
        # per distinct int8 weight shape, at both row counts
        groups = {}
        for i, (w, *_) in enumerate(prepared):
            if isinstance(w, tuple):
                groups.setdefault(tuple(w[0].shape), []).append(i)
        for (K, N), idx in groups.items():
            for M, inputs in ((BATCH, xs), (BATCH * CHUNK, xc)):
                def run_group(idx=idx, inputs=inputs):
                    for i in idx:
                        w, rho, sig, plane = prepared[i]
                        k.emt_matmul(inputs[i], w, sig, device=emt.device,
                                     seed=SEED, plane=plane)
                g_ms = cuda_time(run_group, 5)
                g_dev = device_ms(run_group, keys, agree=True)
                g_bytes = len(idx) * (K * N + 4 * N + 4 * M * (K + N))
                alu, fma = hash_ops("K3", len(idx) * K * N)
                g_flops = 2 * M * len(idx) * K * N
                tc = M > k.GEMV_MAX_M           # four TF32 products
                g_b, _, g_term = bound(g_bytes, 0 if tc else g_flops, alu,
                                       fma + len(idx) * K * N,
                                       4 * g_flops if tc else 0)
                print(f"  K3 int8 {K}x{N} at M={M}: {len(idx)} calls a "
                      f"step, {g_ms:.4f} ms (device time {fmt(g_dev, 4)}), "
                      f"bound {g_b:.4f} ms ({g_term}; {g_bytes / 1e9:.4f} "
                      f"GB), share of the device time {share(g_b, g_dev)}")

    def k5(self):
        """Technique-C bit-serial matmul at every MLP projection of one
        step of the mixed path (RRAM, 7 planes at the 8-bit DAC)."""
        from repro_torch.core import noise, quant, regularizer
        from repro_torch.core.decompose import bit_plane
        from repro_torch.core.emt_linear import _tag_plane
        from repro_torch.kernels import emt_bitserial as k
        torch = self.torch
        layers = self.params["decoder"]
        emt = self.mixed.emt_at("dec/layer_000/mlp/wg")
        bits, dev = emt.quant.a_bits - 1, emt.device
        self.check(emt.mode == "bitserial" and bits == 7,
                   f"mixed MLP corner is {emt.mode}, {bits} planes")
        prepared = []                   # (wq, rho, sig, base plane)
        for name in sorted(layers):
            for w in ("wg", "wu", "wd"):
                tag = f"dec/{name}/mlp/{w}"
                p = layers[name]["ffn"][w]
                wq, _ = quant.quantize_weights(p["w"],
                                               self.mixed.emt_at(tag).quant)
                rho = regularizer.rho_from_raw(p["rho_raw"])
                prepared.append((wq, rho, dev.sigma_rel(rho),
                                 _tag_plane(tag)))
        gen = torch.Generator(device=self.dev).manual_seed(4)

        def levels(M, K):
            """DAC levels as the path makes them (per-row 8-bit scale)."""
            x = torch.randn((M, K), generator=gen, device=self.dev)
            return quant.quant_levels(x, bits + 1, axis=-1)[0]

        kw = dict(device=dev, bits=bits, seed=SEED)
        worst = 0.0
        seen = set()
        for wq, rho, sig, plane in prepared[:3]:
            K, N = wq.shape
            for M in (BATCH, BATCH * CHUNK):
                x = levels(M, K)
                y = k.emt_bitserial(x, wq, sig, base_plane=plane, **kw)
                y2 = k.emt_bitserial(x, wq, sig, base_plane=plane, **kw)
                yp = k.plain(x, wq, sig, base_plane=plane, **kw)
                self.sync()
                d, r = rel_err(y, yp)
                same = torch.equal(y, y2)
                worst = max(worst, d)
                print(f"  K5 {M}x{K} @ {K}x{N}, {bits} planes: max|diff| "
                      f"{d:.3e} rel {r:.3e}; two calls bit-identical: "
                      f"{same}")
                self.check(r <= 1e-5, f"K5 {M}x{K}x{N} rel {r:.3e} > 1e-5")
                self.check(same, f"K5 {M}x{K}x{N}: two calls differ")
            if (K, N) in seen:
                continue
            seen.add((K, N))
            # levels 2^p on the identity (the tensor-core kernel) and on
            # BATCH of its rows (the GEMV kernel) return 2^p x plane p's
            # noisy weight
            eye = torch.eye(K, device=self.dev)
            rows = torch.randperm(K, generator=gen, device=self.dev)[:BATCH]
            exact = []
            for p in range(bits):
                wn = k.emt_bitserial(eye * 2.0 ** p, wq, sig, base_plane=plane,
                                     **kw)
                wr = k.emt_bitserial(eye[rows] * 2.0 ** p, wq, sig,
                                     base_plane=plane, **kw)
                ref = noise.fluctuate(wq, rho, dev, noise.NoiseConfig(),
                                      seed=SEED, plane=plane + p) * 2.0 ** p
                exact.append(bool(torch.equal(wn, ref)
                                  and torch.equal(wr, ref[rows])))
                del wn, wr, ref
            print(f"  K5 noisy weight {K}x{N}, planes 0..{bits - 1} "
                  f"bit-exact with fluctuate: {exact}")
            self.check(all(exact), f"K5 noisy weight {K}x{N} planes {exact}")
            del eye
        # timing: one decode step's 78 calls (and a chunk step's), in model
        # order
        xs = [levels(BATCH, wq.shape[0]) for wq, *_ in prepared]
        xc = [levels(BATCH * CHUNK, wq.shape[0]) for wq, *_ in prepared]

        def run(fn, inputs):
            for x, (wq, rho, sig, plane) in zip(inputs, prepared):
                fn(x, wq, sig, base_plane=plane, **kw)

        # yardstick: one torch.bmm per call of the (bits, M, K) signed
        # planes (scaled by 2^p) with the (bits, K, N) pre-noised weights;
        # layer 0's three stand in for every layer (each call reads 7 x
        # 32 MB, far past the 50 MB L2)
        def signed_planes(x):
            return torch.stack([torch.sign(x) * bit_plane(x.abs(), p)
                                * 2.0 ** p for p in range(bits)])

        lib = []
        for x, c, (wq, rho, sig, plane) in zip(xs[:3], xc[:3],
                                               prepared[:3]):
            wn = torch.stack([noise.fluctuate(wq, rho, dev,
                                              noise.NoiseConfig(), seed=SEED,
                                              plane=plane + p)
                              for p in range(bits)])
            lib.append((signed_planes(x), signed_planes(c), wn))

        def run_library(chunk=False):
            for _ in range(len(layers)):
                for planes, planes_c, wn in lib:
                    torch.bmm(planes_c if chunk else planes, wn)

        keys = ("bitserial", "split_sum")
        ms = cuda_time(lambda: run(k.emt_bitserial, xs), 3)
        chunk_ms = cuda_time(lambda: run(k.emt_bitserial, xc), 2)
        lib_ms = cuda_time(run_library, 3)
        chunk_lib_ms = cuda_time(lambda: run_library(True), 2)
        dev_ms = device_ms(lambda: run(k.emt_bitserial, xs), keys, agree=True)
        chunk_dev_ms = device_ms(lambda: run(k.emt_bitserial, xc), keys,
                                 agree=True)
        lib_dev_ms = device_ms(run_library, "", agree=True)
        chunk_lib_dev_ms = device_ms(lambda: run_library(True), "", agree=True)
        del lib
        plain_ms = cuda_time(lambda: run(k.plain, xs), 1, warmup=1)

        def step_bound(inputs, idx=range(len(prepared))):
            """k5_bound of the calls, and the share of (k, plane) pairs
            whose plane is not zero in every row."""
            pairs = sum(plane_pairs(inputs[i], bits) for i in idx)
            total = sum(prepared[i][0].shape[0] * bits for i in idx)
            calls = [(inputs[i].shape[0], *prepared[i][0].shape, bits)
                     for i in idx]
            return (*k5_bound(k, calls), pairs / total)

        (b_ms, by, bterm), nbytes, alu, _, need = step_bound(xs)
        (cb_ms, cby, cterm), _, calu, c_issue, _ = step_bound(xc)
        self.records["emt_bitserial"] = dict(
            name="emt_bitserial", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_bitserial.cu",
            replaces="src/repro/kernels/emt_bitserial.py:69",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, chunk_ms=chunk_ms,
            chunk_device_ms=chunk_dev_ms, chunk_bound_ms=cb_ms,
            chunk_bound_term=cterm, chunk_issue_ms=c_issue,
            chunk_library_ms=chunk_lib_ms,
            chunk_library_device_ms=chunk_lib_dev_ms)
        print(f"  K5 per decode step ({len(prepared)} calls, M={BATCH}, "
              f"{bits} planes): kernel {ms:.3f} ms (device time "
              f"{fmt(dev_ms)}), plain {plain_ms:.3f} ms, torch.bmm on "
              f"planes and pre-noised weights {lib_ms:.3f} ms (device time "
              f"{fmt(lib_dev_ms)}), bound "
              f"{b_ms:.3f} ms ({bterm}; {nbytes / 1e9:.3f} GB, "
              f"{alu / 1e9:.3f} G ALU-pipe ops), roofline share "
              f"{100 * b_ms / ms:.2f}% (of the device time "
              f"{share(b_ms, dev_ms)}); (k, plane) pairs whose plane "
              f"is zero in every row: {100 * (1 - need):.2f}%")
        print(f"  K5 per chunk step ({len(prepared)} calls, "
              f"M={BATCH * CHUNK}): kernel {chunk_ms:.3f} ms (device time "
              f"{fmt(chunk_dev_ms)}), torch.bmm on planes and pre-noised "
              f"weights {chunk_lib_ms:.3f} ms (device time "
              f"{fmt(chunk_lib_dev_ms)}; loses by "
              f"{chunk_ms / chunk_lib_ms:.3f}x), bound {cb_ms:.3f} ms "
              f"({cterm}; "
              f"{calu / 1e9:.3f} G ALU-pipe ops), roofline share "
              f"{100 * cb_ms / chunk_ms:.2f}% (of the device time "
              f"{share(cb_ms, chunk_dev_ms)}); the kernel's ALU-pipe issue "
              f"as compiled {c_issue:.3f} ms ({K5_TC_ISSUE_ALU} an "
              f"element-plane, scripts/sass_ops.py)")
        # per distinct (K, N) at M = 4: which calls lead the step
        groups = {}
        for i, (wq, *_) in enumerate(prepared):
            groups.setdefault(tuple(wq.shape), []).append(i)
        for (K, N), idx in groups.items():
            calls = [(xs[i], prepared[i]) for i in idx]

            def run_group():
                for x, (wq, rho, sig, plane) in calls:
                    k.emt_bitserial(x, wq, sig, base_plane=plane, **kw)

            g_dev = device_ms(run_group, keys)
            (g_b, _, g_term), _, _, _, g_need = step_bound(xs, idx)
            p = k.plan(BATCH, N, K, self.sms, True, bits)
            print(f"  K5 {K}x{N} at M={BATCH}: {len(idx)} calls a step, "
                  f"device time {fmt(g_dev, 4)}, bound {g_b:.4f} ms "
                  f"({g_term}), share of the device time "
                  f"{share(g_b, g_dev)}; {p.splits} K slab(s) of "
                  f"{p.k_slab}, {p.ctas} CTAs; pairs zero in every row "
                  f"{100 * (1 - g_need):.2f}%")

    def _pools(self, gen, n_layers):
        torch = self.torch
        KV, hd = self.cfg.num_kv_heads, self.cfg.head_dim
        nb = BATCH * (MAX_LEN // BLOCK)
        pools = []
        for _ in range(n_layers):
            kp = torch.randn((nb + 1, BLOCK, KV, hd), generator=gen,
                             device=self.dev)
            vp = torch.randn((nb + 1, BLOCK, KV, hd), generator=gen,
                             device=self.dev)
            kp[nb] = 0.0
            vp[nb] = 0.0
            pools.append((kp, vp))
        return pools, nb

    def k1(self):
        """Fused decode (write + attend) at the engine's decode shapes."""
        import torch.nn.functional as F
        from repro_torch.kernels import paged_attention as k
        from repro_torch.kernels.ref import NEG_INF, paged_view
        torch = self.torch
        cfg = self.cfg
        KV, G, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.head_dim
        L = MAX_LEN
        T = L // BLOCK
        gen = torch.Generator(device=self.dev).manual_seed(2)
        pools, nb = self._pools(gen, cfg.num_layers)
        perm = torch.randperm(nb, generator=gen, device=self.dev)
        table = perm[:BATCH * T].reshape(BATCH, T).to(torch.int32)
        table[2, T // 2:] = nb                     # short row: zero blocks
        pos = torch.tensor([L - 28, L // 4 + 5, L // 2 - 4, L - 1],
                           device=self.dev)
        mask = torch.where(torch.arange(L, device=self.dev)[None, :]
                           <= pos[:, None], 0.0, NEG_INF).to(torch.float32)
        mask[3] = NEG_INF                          # fully masked row -> zeros
        wblk = torch.gather(table, 1, (pos // BLOCK)[:, None])[:, 0]
        wblk = wblk.to(torch.int32).contiguous()
        woff = (pos % BLOCK).to(torch.int32)
        wok = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=self.dev)
        q = torch.randn((BATCH, KV, G, hd), generator=gen, device=self.dev)
        kn = torch.randn((BATCH, KV, hd), generator=gen, device=self.dev)
        vn = torch.randn((BATCH, KV, hd), generator=gen, device=self.dev)
        kp, vp = pools[0]
        # the plain version in float64, its pools written in float64 (the
        # same values)
        kp2, vp2 = kp.double(), vp.double()
        out = k.paged_attention_decode(q, kp, vp, table, mask, kn, vn, wblk,
                                       woff, wok)
        out2 = k.paged_attention_decode(q, kp, vp, table, mask, kn, vn, wblk,
                                        woff, wok)
        ref = k.plain(q.double(), kp2, vp2, table, mask.double(), kn.double(),
                      vn.double(), wblk, woff, wok)
        self.sync()
        d, r = rel_err(out.double(), ref)
        pools_same = (torch.equal(kp.double(), kp2)
                      and torch.equal(vp.double(), vp2))
        zero_row = bool((out[3] == 0).all())
        same = torch.equal(out, out2)
        splits = k.kv_splits(BATCH, KV, G, hd, T, self.sms)
        print(f"  K1 B={BATCH} KV={KV} G={G} hd={hd} bs={BLOCK} T={T}: "
              f"max|diff| vs the float64 plain version {d:.3e} rel "
              f"{r:.3e}; pools bit-identical after the write: {pools_same}; "
              f"fully-masked row zeros: {zero_row}; {splits} CTAs of "
              f"{k.threads(G, hd)} threads per (row, kv head); two calls "
              f"bit-identical: {same}")
        self.check(same, "K1: two calls differ")
        self.check(r <= 1e-5, f"K1 rel {r:.3e} > 1e-5")
        self.check(pools_same, "K1 pools differ from the plain write")
        self.check(zero_row, "K1 fully-masked row not zero")
        mask[3] = 0.0                              # time with all rows live

        def run_kernel():
            for kp, vp in pools:
                k.paged_attention_decode(q, kp, vp, table, mask, kn, vn, wblk,
                                         woff, wok)

        def run_plain():
            for kp, vp in pools:
                k.plain(q, kp, vp, table, mask, kn, vn, wblk, woff, wok)

        H = KV * G
        views = [(paged_view(kp, table).permute(0, 2, 1, 3)
                  .expand(BATCH, H, L, hd).contiguous(),
                  paged_view(vp, table).permute(0, 2, 1, 3)
                  .expand(BATCH, H, L, hd).contiguous()) for kp, vp in pools]
        qh = q.reshape(BATCH, H, 1, hd)
        am = mask[:, None, None, :]

        def run_library():
            for kv, vv in views:
                F.scaled_dot_product_attention(qh, kv, vv, attn_mask=am)

        ms = cuda_time(run_kernel, 20)
        dev_ms = device_ms(run_kernel, "paged_decode_kernel<true>")
        plain_ms = cuda_time(run_plain, 10)
        lib_ms = cuda_time(run_library, 20)
        nl = len(pools)
        # bytes: q in, out, mask, table, the new K/V rows read and written,
        # and the K/V of every visible position; FLOPs: q.k and p.v over
        # the visible positions of every query head
        vis = int((mask > NEG_INF / 2).sum().item())
        nbytes = nl * 4 * (2 * q.numel() + mask.numel() + table.numel()
                           + 4 * kn.numel() + 2 * vis * KV * hd)
        flops = nl * 4 * hd * KV * G * vis
        b_ms, by, _ = bound(nbytes, flops)
        self.records["paged_attention_decode"] = dict(
            name="paged_attention_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:212",
            max_abs_err=d, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms)
        del views
        print(f"  K1 per decode step ({nl} launches a step): kernel {ms:.4f} ms "
              f"(device time {fmt(dev_ms, 4)}), "
              f"plain {plain_ms:.4f} ms, SDPA on the gathered view "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({by}), roofline share "
              f"{100 * b_ms / ms:.2f}%")
        self.records["paged_attention_decode"]["groups"] = \
            self._attn_groups(True)

    def _attn_groups(self, write):
        """K1 (`write`) or K4 at ATTN_GROUPS, batch 4 over 8 blocks of 16,
        softcap 50: against the float64 plain version (1e-5), K1's pools
        bit-identical to the plain write (K4's unchanged), a fully masked
        row exact zeros, two calls bit-identical; one launch's device time
        beside its bound (the bytes and FLOPs of the k1 phase's count).
        Returns {"G x hd": {"device_ms": a launch's, "bound_ms": ...}}."""
        from repro_torch.kernels import paged_attention as k
        from repro_torch.kernels.ref import NEG_INF
        torch = self.torch
        name = "K1" if write else "K4"
        KV, T, cap = 8, MAX_LEN // BLOCK, 50.0
        nb = BATCH * T
        gen = torch.Generator(device=self.dev).manual_seed(11 + write)
        times = {}
        for G, hd, arch in ATTN_GROUPS:
            kp = torch.randn((nb + 1, BLOCK, KV, hd), generator=gen,
                             device=self.dev)
            vp = torch.randn((nb + 1, BLOCK, KV, hd), generator=gen,
                             device=self.dev)
            kp[nb] = vp[nb] = 0.0
            table = torch.randperm(nb, generator=gen, device=self.dev)
            table = table.reshape(BATCH, T).to(torch.int32)
            pos = torch.tensor([MAX_LEN - 28, 37, 100, MAX_LEN - 1],
                               device=self.dev)
            mask = torch.where(torch.arange(MAX_LEN, device=self.dev)[None]
                               <= pos[:, None], 0.0, NEG_INF)
            mask[1] = NEG_INF                      # fully masked row -> zeros
            q = torch.randn((BATCH, KV, G, hd), generator=gen,
                            device=self.dev)
            kn = torch.randn((BATCH, KV, hd), generator=gen, device=self.dev)
            vn = torch.randn((BATCH, KV, hd), generator=gen, device=self.dev)
            wblk = torch.gather(table, 1, (pos // BLOCK)[:, None])[:, 0]
            wblk = wblk.to(torch.int32).contiguous()
            woff = (pos % BLOCK).to(torch.int32)
            wok = torch.tensor([1, 1, 1, 0], dtype=torch.int32,
                               device=self.dev)
            kp2, vp2 = kp.double(), vp.double()
            if write:
                def call():
                    return k.paged_attention_decode(
                        q, kp, vp, table, mask, kn, vn, wblk, woff, wok,
                        softcap=cap)
                out, out2 = call(), call()
                ref = k.plain(q.double(), kp2, vp2, table, mask.double(),
                              kn.double(), vn.double(), wblk, woff, wok,
                              softcap=cap)
            else:
                def call():
                    return k.paged_attention(q, kp, vp, table, mask,
                                             softcap=cap)
                out, out2 = call(), call()
                ref = k.plain_attend(q.double(), kp2, vp2, table,
                                     mask.double(), softcap=cap)
            self.sync()
            d, r = rel_err(out.double(), ref)
            pools = (torch.equal(kp.double(), kp2)
                     and torch.equal(vp.double(), vp2))
            zero_row = bool((out[1] == 0).all())
            same = torch.equal(out, out2)
            dev_ms = device_ms(lambda: [call() for _ in range(10)],
                               f"paged_decode_kernel<{str(write).lower()}>")
            per = None if dev_ms is None else dev_ms / 10
            vis = int((mask > NEG_INF / 2).sum().item())
            nbytes = 4 * (2 * q.numel() + mask.numel() + table.numel()
                          + 4 * write * kn.numel() + 2 * vis * KV * hd)
            b_ms, by, _ = bound(nbytes, 4 * hd * KV * G * vis)
            times[f"{G} x {hd}"] = dict(device_ms=per, bound_ms=b_ms)
            kept = "as the plain write" if write else "unchanged"
            print(f"  {name} G={G} hd={hd} ({arch}): KV={KV} B={BATCH} "
                  f"T={T} softcap {cap:g}, {k.threads(G, hd)} threads, "
                  f"{k.kv_splits(BATCH, KV, G, hd, T, self.sms)} CTAs per "
                  f"(row, kv head): rel diff vs the float64 plain version "
                  f"{r:.3e}; pools {kept}: "
                  f"{pools}; fully masked row zeros: {zero_row}; two calls "
                  f"bit-identical: {same}; device time a launch "
                  f"{fmt(per, 4)}, bound {b_ms:.5f} ms ({by}), roofline "
                  f"share {share(b_ms, per)}")
            self.check(r <= 1e-5 and pools and zero_row and same,
                       f"{name} at G={G} hd={hd}: rel {r:.3e}, pools "
                       f"{pools}, zero row {zero_row}, same {same}")
        return times

    def k2(self):
        """Chunked prefill at the engine's chunk-step shapes."""
        import torch.nn.functional as F
        from repro_torch.kernels import paged_prefill as k
        from repro_torch.kernels.ref import NEG_INF, paged_view
        torch = self.torch
        cfg = self.cfg
        KV, G, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.head_dim
        R = CHUNK * G
        L = MAX_LEN
        T = L // BLOCK
        gen = torch.Generator(device=self.dev).manual_seed(3)
        pools, nb = self._pools(gen, cfg.num_layers)
        perm = torch.randperm(nb, generator=gen, device=self.dev)
        table = perm[:BATCH * T].reshape(BATCH, T).to(torch.int32).contiguous()
        start = torch.tensor([0, CHUNK, 3 * L // 8 - 1, L - 2 * CHUNK + 4],
                             device=self.dev)
        ntok = torch.tensor([16, 16, 16, 1], device=self.dev)
        j = torch.arange(CHUNK, device=self.dev)[None, :]
        qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
        qpe = torch.repeat_interleave(qpos, G, dim=1).to(torch.int32)
        qpe = qpe.contiguous()
        qlast = qpe.amax(1).to(torch.int32).contiguous()
        q = torch.randn((BATCH, KV, R, hd), generator=gen, device=self.dev)
        kp, vp = pools[0]
        out = k.paged_prefill(q, kp, vp, table, qpe, qlast)
        out2 = k.paged_prefill(q, kp, vp, table, qpe, qlast)
        ref = k.plain(q, kp, vp, table, qpe, qlast)
        self.sync()
        d, r = rel_err(out, ref)
        same = torch.equal(out, out2)
        splits = k.kv_splits(BATCH, KV, R, T, BLOCK, hd, self.sms)
        print(f"  K2 B={BATCH} KV={KV} R={R} hd={hd} bs={BLOCK} T={T}: "
              f"max|diff| {d:.3e} rel {r:.3e}; {splits} CTAs per row tile "
              f"along K/V; two calls bit-identical: {same}")
        self.check(r <= 1e-5, f"K2 rel {r:.3e} > 1e-5")
        self.check(same, "K2: two calls differ")

        def run_kernel():
            for kp, vp in pools:
                k.paged_prefill(q, kp, vp, table, qpe, qlast)

        def run_plain():
            for kp, vp in pools:
                k.plain(q, kp, vp, table, qpe, qlast)

        H = KV * G
        qh = q.reshape(BATCH, KV, CHUNK, G, hd).permute(0, 1, 3, 2, 4)
        qh = qh.reshape(BATCH, H, CHUNK, hd).contiguous()
        am = torch.where(torch.arange(L, device=self.dev)[None, None, :]
                         <= qpos[:, :, None], 0.0, NEG_INF)[:, None]
        views = [(paged_view(kp, table).permute(0, 2, 1, 3)
                  .expand(BATCH, H, L, hd).contiguous(),
                  paged_view(vp, table).permute(0, 2, 1, 3)
                  .expand(BATCH, H, L, hd).contiguous()) for kp, vp in pools]

        def run_library():
            for kv, vv in views:
                F.scaled_dot_product_attention(qh, kv, vv,
                                               attn_mask=am.float())

        ms = cuda_time(run_kernel, 20)
        dev_ms = device_ms(run_kernel, "paged_prefill_kernel")
        plain_ms = cuda_time(run_plain, 10)
        lib_ms = cuda_time(run_library, 20)
        nl = cfg.num_layers
        # K/V a row must read: blocks up to its qlast; scores over visible
        # positions only
        kv_pos = sum(min(L, int(ql) + 1) for ql in qlast.tolist())
        vis = int((qpe.long()[:, :, None]
                   >= torch.arange(L, device=self.dev)[None, None, :])
                  .sum().item())
        nbytes = nl * 4 * (2 * q.numel() + 2 * kv_pos * KV * hd
                           + qpe.numel() + table.numel())
        flops = nl * 4 * KV * hd * vis
        b_ms, by, _ = bound(nbytes, flops)
        self.records["paged_prefill"] = dict(
            name="paged_prefill", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_prefill.cu",
            replaces="src/repro/kernels/paged_prefill.py:173",
            max_abs_err=d, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms)
        del views
        print(f"  K2 per chunk step ({nl} launches): kernel {ms:.4f} ms "
              f"(device time {fmt(dev_ms, 4)}), plain {plain_ms:.4f} ms, SDPA on the gathered view "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({by}), roofline share "
              f"{100 * b_ms / ms:.2f}%")

    def k4(self):
        """Read-only paged attention (the cross attention's decode read) at
        seamless-m4t-medium's decode shapes (timed: its 12 layers) and at
        gemma3's head shapes; rows of encoder length 0, 1, a partial last
        block and the whole view."""
        import torch.nn.functional as F
        from repro_torch.kernels import paged_attention as k
        from repro_torch.kernels.ref import NEG_INF, paged_view
        torch = self.torch
        L = MAX_LEN
        T = L // BLOCK
        lens = [0, 1, 6 * BLOCK + 4, L]
        gen = torch.Generator(device=self.dev).manual_seed(6)
        timed = None
        for cfg in (self.s2s, self.cfg):
            KV, hd = cfg.num_kv_heads, cfg.head_dim
            G = cfg.num_heads // KV
            nb = BATCH * T
            pools = []
            for _ in range(cfg.num_layers if cfg is self.s2s else 1):
                kp = torch.randn((nb + 1, BLOCK, KV, hd), generator=gen,
                                 device=self.dev)
                vp = torch.randn((nb + 1, BLOCK, KV, hd), generator=gen,
                                 device=self.dev)
                kp[nb] = 0.0
                vp[nb] = 0.0
                pools.append((kp, vp))
            table = torch.randperm(nb, generator=gen, device=self.dev)
            table = table.reshape(BATCH, T).to(torch.int32)
            table[1, 1:] = nb                      # short row: zero blocks
            table[2, -1] = nb
            n = torch.tensor(lens, device=self.dev)
            mask = torch.where(torch.arange(L, device=self.dev)[None, :]
                               < n[:, None], 0.0, NEG_INF).to(torch.float32)
            q = torch.randn((BATCH, KV, G, hd), generator=gen,
                            device=self.dev)
            kp, vp = pools[0]
            kp0, vp0 = kp.clone(), vp.clone()
            out = k.paged_attention(q, kp, vp, table, mask)
            out2 = k.paged_attention(q, kp, vp, table, mask)
            ref = k.plain_attend(q.double(), kp.double(), vp.double(), table,
                                 mask.double())
            self.sync()
            d, r = rel_err(out.double(), ref)
            unchanged = torch.equal(kp, kp0) and torch.equal(vp, vp0)
            zero_row = bool((out[0] == 0).all())
            same = torch.equal(out, out2)
            print(f"  K4 {cfg.name}: B={BATCH} KV={KV} G={G} hd={hd} "
                  f"bs={BLOCK} T={T}, encoder lengths {lens}: max|diff| vs "
                  f"the float64 plain version "
                  f"{d:.3e} rel {r:.3e}; pools unchanged: {unchanged}; "
                  f"length-0 row exact zeros: {zero_row}; "
                  f"{k.kv_splits(BATCH, KV, G, hd, T, self.sms)} CTAs per "
                  f"(row, kv head); two calls bit-identical: {same}")
            self.check(same, f"K4 {cfg.name}: two calls differ")
            self.check(r <= 1e-5, f"K4 {cfg.name} rel {r:.3e} > 1e-5")
            self.check(unchanged, f"K4 {cfg.name} wrote its read-only pools")
            self.check(zero_row, f"K4 {cfg.name} length-0 row not zero")
            if cfg is self.s2s:
                timed = (KV, G, hd, pools, table, mask, q, d)
        KV, G, hd, pools, table, mask, q, d = timed

        def run_kernel():
            for kp, vp in pools:
                k.paged_attention(q, kp, vp, table, mask)

        def run_plain():
            for kp, vp in pools:
                k.plain_attend(q, kp, vp, table, mask)

        H = KV * G
        views = [(paged_view(kp, table).permute(0, 2, 1, 3)
                  .expand(BATCH, H, L, hd).contiguous(),
                  paged_view(vp, table).permute(0, 2, 1, 3)
                  .expand(BATCH, H, L, hd).contiguous()) for kp, vp in pools]
        qh = q.reshape(BATCH, H, 1, hd)
        am = mask[:, None, None, :]

        def run_library():
            for kv, vv in views:
                F.scaled_dot_product_attention(qh, kv, vv, attn_mask=am)

        ms = cuda_time(run_kernel, 20)
        dev_ms = device_ms(run_kernel, "paged_decode_kernel<false>")
        plain_ms = cuda_time(run_plain, 10)
        lib_ms = cuda_time(run_library, 20)
        nl = len(pools)
        # bytes: q in, out, mask, table and the K/V of every visible
        # position; FLOPs: q.k and p.v over the visible positions
        vis = int((mask > NEG_INF / 2).sum().item())
        nbytes = nl * 4 * (2 * q.numel() + mask.numel() + table.numel()
                           + 2 * vis * KV * hd)
        flops = nl * 4 * hd * KV * G * vis
        b_ms, by, _ = bound(nbytes, flops)
        self.records["paged_attention"] = dict(
            name="paged_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:226",
            max_abs_err=d, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms)
        del views
        print(f"  K4 per seamless decode step ({nl} launches a step, "
              f"{k.kv_splits(BATCH, KV, G, hd, T, self.sms)} CTAs of "
              f"{k.threads(G, hd)} threads per (row, kv head)): kernel "
              f"{ms:.4f} ms (device time {fmt(dev_ms, 4)}), plain "
              f"{plain_ms:.4f} ms, SDPA on the gathered "
              f"view {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({by}; "
              f"{nbytes / 1e6:.3f} MB), roofline share "
              f"{100 * b_ms / ms:.2f}%")
        self.records["paged_attention"]["groups"] = self._attn_groups(False)

    # -- phase 4 -------------------------------------------------------------
    def _requests(self, cfg, ring=False, prompts=None, max_new=MAX_NEW):
        """6 requests of `max_new` tokens, 2 of them sampled; prompts of 20
        to 120 tokens, or, for the ring paths, 520 to 600 (every window-512
        ring wraps), or of the range `prompts`."""
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        rng = np.random.default_rng(SEED + (13 if ring else 11))
        lo, hi = RING_PROMPTS if ring else (20, MAX_LEN - MAX_NEW)
        if prompts is not None:
            lo, hi = prompts
        reqs = []
        for i in range(6):
            plen = int(rng.integers(lo, hi + 1))
            kw = dict(prompt=rng.integers(0, cfg.vocab_size, plen)
                      .astype(np.int32), max_new=max_new, seed=1000 + i)
            if i in (1, 4):
                kw.update(temperature=0.8, top_k=40)
            reqs.append(GenRequest(**kw))
        return reqs

    def _profile_steps(self, eng, reqs, per_kind: int = 2):
        """Serve `reqs` on `eng`, profiling single steps (from the third on)
        until `per_kind` steps with prefill work (chunk steps; admission
        steps of the legacy prefill) and `per_kind` decode steps are
        captured, then stop; print each step's wall time, device busy time
        (the sum of its device events) and top kernels.  Profiling single
        steps keeps the trace small; a step whose kind (foreseen from the
        queue and the slots: an admission or a prefilling slot means
        prefill work) is already captured runs unprofiled, since reading
        a trace of tens of thousands of ops takes seconds.  Returns each
        kind's device busy ms, a list per kind."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for r in reqs:
            eng.submit(r)
        prefill = "chunk" if eng.chunked else "admission + decode"
        seen = {prefill: 0, "decode": 0}
        busy_ms = {prefill: [], "decode": []}
        n = 0
        while eng.scheduler.busy and min(seen.values()) < per_kind:
            n += 1
            sch = eng.scheduler
            ahead = ((sch.pending and sch.free_slot() is not None)
                     or any(s.prefilling for _, s in sch.active_slots()))
            if n < 3 or seen[prefill if ahead else "decode"] >= per_kind:
                eng.step()
                continue
            before = (eng.prefill_tokens_total, eng.scheduler.pending)
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                eng.step()
                self.sync()
            wall = (time.perf_counter() - t0) * 1e3
            admitted = (eng.prefill_tokens_total > before[0]
                        or eng.scheduler.pending < before[1])
            kind = prefill if admitted else "decode"
            if seen[kind] >= per_kind:
                continue
            seen[kind] += 1
            # device events only: an aten op's entry carries the device
            # time of the kernels it launched, which are entries too (the
            # averages are read once: a trace holds tens of thousands of
            # ops)
            avg = prof.key_averages()
            ev = [e for e in avg if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
            ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
            busy = sum(e.self_device_time_total for e in ev) / 1e3
            busy_ms[kind].append(busy)
            ops = sum(e.count for e in avg if e.key.startswith("aten::"))
            print(f"  profiled {kind} step {n}: wall {wall:.1f} ms "
                  f"(profiler on), device busy {busy:.1f} ms "
                  f"({100 * busy / wall:.1f}%), {ops} aten ops; top:")
            # the top 8, then the port's own kernels below them
            port = [e for e in ev[8:] if re.search(
                r"emt_|paged_|bitserial|split_sum|stats_finish", e.key)]
            for e in ev[:8] + port:
                print(f"    {e.self_device_time_total / 1e3:8.2f} ms "
                      f"{e.count:6d}x {e.key[:80]}")
        return busy_ms

    def _counters(self):
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import paged_attention as k1
        from repro_torch.kernels import paged_prefill as k2
        return {"paged_attention_decode": k1.paged_attention_decode,
                "paged_attention": k1.paged_attention,
                "paged_prefill": k2.paged_prefill,
                "emt_matmul": k3.emt_matmul,
                "emt_matmul_tc": k3._forward_tc,
                "emt_matmul_int8": k3._forward_int8,
                "emt_matmul_experts": k3.emt_matmul_experts,
                "emt_matmul_dx": k3.emt_matmul_dx,
                "emt_matmul_dw": k3.emt_matmul_dw,
                "emt_matmul_experts_dx": k3.emt_matmul_experts_dx,
                "emt_matmul_experts_dw": k3.emt_matmul_experts_dw,
                "emt_bitserial": k5.emt_bitserial}

    @contextlib.contextmanager
    def _counting_steps(self, steps: dict):
        """Count the model's chunk and decode steps in `steps`."""
        from repro_torch.models import lm
        orig = {n: getattr(lm, n) for n in steps}

        def counted(name):
            def call(*args, **kw):
                steps[name] += 1
                return orig[name](*args, **kw)
            return call

        for n in steps:
            setattr(lm, n, counted(n))
        try:
            yield
        finally:
            for n, fn in orig.items():
                setattr(lm, n, fn)

    def _serve(self, cfg, params, label, per_kind, paged=True, ring=False,
               prompts=None, max_len=None, max_new=MAX_NEW):
        """Profile `per_kind` prefill and decode steps of one run of the 6
        requests on `cfg` (its first steps, unprofiled, warm the path up),
        then serve them on a fresh engine with every launch count reset
        just before and read just after.  `paged` chooses the KV layout;
        `ring` the long prompts and max_len of the ring paths; `prompts`
        (lo, hi), `max_len` and `max_new` another prompt range, cache
        length and request length.  Returns (summary, launches, metrics,
        results)."""
        import numpy as np
        from repro_torch.serve.engine import ServingEngine
        torch = self.torch
        if max_len is None:
            max_len = RING_MAX_LEN if ring else MAX_LEN

        def make():
            return ServingEngine(cfg, params, batch_size=BATCH,
                                 max_len=max_len, seed=SEED,
                                 fresh_noise=False, paged=paged,
                                 block_size=BLOCK, prefill_chunk=CHUNK,
                                 device=self.dev)

        busy = self._profile_steps(
            make(), self._requests(cfg, ring, prompts, max_new), per_kind)
        eng = make()
        reqs = self._requests(cfg, ring, prompts, max_new)
        counters = self._counters()
        steps = {"chunk_step": 0, "decode_step": 0}
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        for w in counters.values():
            w.launches = 0
        t0 = time.perf_counter()
        with self._counting_steps(steps):
            results = eng.serve(reqs, stagger=2)
            self.sync()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        ntok = sum(len(r.tokens) for r in results)
        m = eng.metrics()
        corners = {k: v * 1e-6 / ntok
                   for k, v in m["corner_energy_pj"].items()}
        print(f"  engine ({label}): {len(results)} requests, prompts "
              f"{[len(r.prompt) for r in reqs]}, {m['steps']} steps, "
              f"{ntok} generated tokens in {wall:.3f} s -> "
              f"{ntok / wall:.2f} tok/s; modeled EMT energy "
              f"{m['total_energy_pj'] * 1e-6 / ntok:.3f} uJ/token, per "
              f"corner {json.dumps(corners)}; peak device memory "
              f"{peak / 2**30:.2f} GiB")
        print(f"  launches in the served run ({label}): {launches}; "
              f"model steps {steps}")
        for r in results:
            print(f"    rid {r.rid}: {r.done_reason} tokens "
                  f"{r.tokens.tolist()} energy {r.energy_pj:.6g} pJ")
        self.check(len(results) == 6, f"{len(results)} results, want 6")
        for r in results:
            ok = (r.done_reason == "max_new" and len(r.tokens) == max_new
                  and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size))
                  .all() and np.isfinite(r.energy_pj) and r.energy_pj > 0)
            self.check(bool(ok), f"request {r.rid} result malformed: {r}")
        self.check(eng.energy_conserved(results), "energy not conserved")
        total = sum(m["corner_energy_pj"].values())
        self.check(abs(total - m["total_energy_pj"])
                   <= 1e-6 * m["total_energy_pj"],
                   f"{label}: corners sum to {total}, total "
                   f"{m['total_energy_pj']}")
        summary = dict(tok_s=ntok / wall, wall_s=wall, tokens=ntok,
                       steps=m["steps"], chunk_steps=steps["chunk_step"],
                       decode_steps=steps["decode_step"],
                       uj_per_token=m["total_energy_pj"] * 1e-6 / ntok,
                       uj_per_token_by_corner=corners, peak_gib=peak / 2**30,
                       peak_above_resident_gib=(peak - resident) / 2**30,
                       step_busy_ms=busy)
        return summary, launches, m, results

    def _check_launches(self, label, launches, steps, per_step):
        """Every kernel of the path launched; those with a fixed count per
        step launched exactly that often."""
        for name, want in per_step.items():
            n = launches[name]
            if want is None:
                self.check(n > 0, f"{label}: {name} was launched {n} times")
            else:
                self.check(n == want * steps,
                           f"{label}: {name} launched {n} times in {steps} "
                           f"steps, want {want} per step")

    def engine(self):
        """The analog path: K1, K2 and K3 (183 per step), no K5."""
        L = self.cfg.num_layers
        summary, launches, m, self.engine_results = self._serve(
            self.cfg, self.params, "analog", 1)
        self._check_launches("analog", launches, m["steps"], {
            "paged_attention_decode": None, "paged_prefill": None,
            "emt_matmul": 7 * L + 1, "emt_matmul_tc": None,
            "emt_bitserial": 0, "paged_attention": 0})
        for name in ("paged_attention_decode", "paged_prefill",
                     "emt_matmul"):
            self.records[name]["launches"] = launches[name]
        self.records.setdefault("emt_matmul_tc", {})["serve_launches"] = \
            launches["emt_matmul_tc"]
        self.engine_summary = summary

    def engine_mixed(self):
        """The mixed placement: K1, K2, K3 on attention and the unembed
        (105 per step), K5 on the MLPs (78 per step)."""
        L = self.mixed.num_layers
        summary, launches, m, _ = self._serve(self.mixed, self.params,
                                              "mixed", 1)
        self._check_launches("mixed", launches, m["steps"], {
            "paged_attention_decode": None, "paged_prefill": None,
            "emt_matmul": 4 * L + 1, "emt_bitserial": 3 * L,
            "paged_attention": 0})
        self.check(set(m["corner_energy_pj"]) == {"pcm", "rram"},
                   f"mixed corners {sorted(m['corner_energy_pj'])}")
        self.records["emt_bitserial"]["launches"] = launches["emt_bitserial"]
        self.mixed_summary = summary

    def engine_seamless(self):
        """The enc-dec path through the legacy bucketed prefill: per
        admission 217 K3 calls (84 encoder, 132 decoder, the unembed); per
        decode step 12 K1 (self attention), 12 K4 (cross attention) and 109
        K3 (12 x 9 projections + the unembed); no K2, no K5."""
        cfg = self.s2s
        L, E = cfg.num_layers, cfg.encoder_layers
        summary, launches, m, results = self._serve(cfg, self.s2s_params,
                                                    "seamless", 1)
        steps, admitted = m["steps"], len(results)
        self._check_launches("seamless", launches, steps, {
            "paged_attention_decode": L, "paged_attention": L,
            "paged_prefill": 0, "emt_bitserial": 0})
        k3 = launches["emt_matmul"]
        per_admission = 7 * E + 11 * L + 1
        self.check(k3 == per_admission * admitted + (9 * L + 1) * steps,
                   f"seamless: emt_matmul launched {k3} times for "
                   f"{admitted} admissions and {steps} decode steps, want "
                   f"{per_admission} and {9 * L + 1} each")
        self.check(m["prefill_tokens_total"] == 0,
                   "seamless: the legacy prefill booked chunk tokens")
        self.records["paged_attention"]["launches"] = \
            launches["paged_attention"]
        self.s2s_summary = summary

    def _engine_ring(self, paged):
        """gemma3-1b's published 5:1 stack cut to RING_LAYERS (12: 10 ring
        layers of window 512, 2 global) on 6 requests of 520-600 tokens.
        Paged: per decode step 12 K1 (10 on ring tables, 2 on the global
        ones), per chunk step 2 K2 (the global layers; a ring layer's chunk
        attends in plain PyTorch, as in JAX), 85 K3 per step.  Contiguous:
        85 K3 per step, nothing else (its attention is plain, as in
        JAX)."""
        cfg = self.ring
        L, G = cfg.num_layers, cfg.blocks().count("global")
        label = "ring paged" if paged else "ring contiguous"
        summary, launches, m, _ = self._serve(cfg, self.params, label, 1,
                                              paged=paged, ring=True)
        chunk, decode = summary["chunk_steps"], summary["decode_steps"]
        self.check(chunk + decode == m["steps"] and chunk > 0 and decode > 0,
                   f"{label}: {chunk} chunk + {decode} decode steps, "
                   f"{m['steps']} engine steps")
        want = {"paged_attention_decode": L * decode if paged else 0,
                "paged_prefill": G * chunk if paged else 0,
                "emt_matmul": (7 * L + 1) * m["steps"],
                "paged_attention": 0, "emt_bitserial": 0}
        for name, n in want.items():
            self.check(launches[name] == n,
                       f"{label}: {name} launched {launches[name]} times, "
                       f"want {n} ({chunk} chunk and {decode} decode steps)")
        key = "ring_paged_launches" if paged else "ring_contiguous_launches"
        for name in ("paged_attention_decode", "paged_prefill",
                     "emt_matmul"):
            self.records[name][key] = launches[name]
        self.ring_summaries[label] = summary

    def engine_ring_paged(self):
        self._engine_ring(True)

    def engine_ring_contiguous(self):
        self._engine_ring(False)

    def _ring_steps(self, cfg, paged):
        """Three model steps on the ring stack at full width (the published
        5:1 pattern, RING_LAYERS deep), from a
        fresh cache (paged, or contiguous): one history chunk step that
        writes positions [0, 530 / 589 / 505 / 300) (three rings wrap;
        K3 at M = 4 x 589), then a chunk step (two rows wrapped, one
        crossing the wrap, one decode lane), then a decode step at
        positions 546 / 605 / 521 / 301 (writes mid-block, three of the
        rings wrapped).  Returns [(step, logits or None, projections it
        runs)]; the history step's logits are not held."""
        import numpy as np
        from repro_torch.models import lm
        from repro_torch.models.context import Ctx
        from repro_torch.serve.engine import view_bucket
        from repro_torch.serve.kv_pool import PagedKV
        torch = self.torch
        hist = np.asarray([530, 589, 505, 300])
        ntok = np.asarray([CHUNK, CHUNK, CHUNK, 1])
        pos = hist + ntok
        win = cfg.sliding_window
        kw = {}
        if paged:
            lens = lm.paged_lens(cfg, RING_MAX_LEN)
            nb = BATCH * (RING_MAX_LEN // BLOCK)
            nrb = BATCH * -(-win // BLOCK)
            kv = PagedKV(BATCH, RING_MAX_LEN, BLOCK, nb, win, nrb)
            for s in range(BATCH):
                self.check(kv.admit(s, int(pos[s]), MAX_NEW),
                           "admission refused")
                kv.ensure(s, int(pos[s]))
            view = view_bucket(int(pos.max()) + 1, BLOCK, RING_MAX_LEN)
            tg, tl = kv.gather_tables()
            kw = dict(page_tables={
                "global": torch.as_tensor(tg[:, :view // BLOCK],
                                          device=self.dev).contiguous(),
                "local": torch.as_tensor(tl, device=self.dev)},
                page_lens=lm.clamped_lens(lens, view))
            cache = lm.init_paged_cache(cfg, BATCH, RING_MAX_LEN, BLOCK, nb,
                                        nrb, device=self.dev)
        else:
            cache = lm.init_cache(cfg, BATCH, RING_MAX_LEN, device=self.dev)
        rng = np.random.default_rng(8)
        dev = self.dev
        act = torch.ones(BATCH, dtype=torch.bool, device=dev)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (BATCH, int(hist.max()))),
                               device=dev)
        zero = torch.zeros(BATCH, dtype=torch.long, device=dev)
        lm.chunk_step(self.params, cache, toks, zero,
                      torch.as_tensor(hist, device=dev), cfg,
                      Ctx(seed=SEED), active=act, **kw)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (BATCH, CHUNK)), device=dev)
        lc, cache, _ = lm.chunk_step(
            self.params, cache, toks, torch.as_tensor(hist, device=dev),
            torch.as_tensor(ntok, device=dev), cfg, Ctx(seed=SEED),
            active=act, **kw)
        nxt = torch.as_tensor(self._first_tokens(lc), device=dev)
        ld, cache, _ = lm.decode_step(
            self.params, cache, nxt, torch.as_tensor(pos, device=dev), cfg,
            Ctx(seed=SEED), active=act, **kw)
        n = 7 * cfg.num_layers + 1
        return [("history chunk step", None, n), ("chunk step", lc, n),
                ("decode step", ld, n)]

    def _step_pair(self, cfg, params=None):
        """One chunk step (over K/V history) then one decode step on `cfg`
        (and `params`, default the float32 tree), from a fresh cache.
        Returns [(step, logits or None, projections it runs)] in call
        order; the history step's logits are not held."""
        import numpy as np
        params = self.params if params is None else params
        from repro_torch.models import lm
        from repro_torch.models.context import Ctx
        from repro_torch.serve.kv_pool import PagedKV
        torch = self.torch
        nb = BATCH * (MAX_LEN // BLOCK)
        kv = PagedKV(BATCH, MAX_LEN, BLOCK, nb)
        for s in range(BATCH):
            self.check(kv.admit(s, 40, 8), "admission refused")
            kv.ensure(s, 40)
        view = 4 * BLOCK
        lens = lm.clamped_lens(lm.paged_lens(cfg, MAX_LEN), view)
        table = torch.as_tensor(kv.gather_tables()[0][:, :view // BLOCK],
                                device=self.dev).contiguous()
        rng = np.random.default_rng(5)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (BATCH, CHUNK)), device=self.dev)
        start = torch.tensor([0, CHUNK, CHUNK // 2, 0], device=self.dev)
        ntok = torch.tensor([CHUNK, CHUNK, CHUNK, CHUNK // 2 + 1],
                            device=self.dev)
        act = torch.ones(BATCH, dtype=torch.bool, device=self.dev)
        pt = {"global": table}
        cache = lm.init_paged_cache(cfg, BATCH, MAX_LEN, BLOCK, nb,
                                    device=self.dev)
        # history: positions [0, start) of the rows that have one
        lm.chunk_step(params, cache, toks, torch.zeros_like(start),
                      start.clamp(min=1), cfg, Ctx(seed=SEED),
                      active=start > 0, page_tables=pt, page_lens=lens)
        lc, cache, _ = lm.chunk_step(params, cache, toks, start, ntok,
                                     cfg, Ctx(seed=SEED), active=act,
                                     page_tables=pt, page_lens=lens)
        nxt = torch.as_tensor(self._first_tokens(lc), device=self.dev)
        ld, cache, _ = lm.decode_step(params, cache, nxt, start + ntok,
                                      cfg, Ctx(seed=SEED), active=act,
                                      page_tables=pt, page_lens=lens)
        # the projections that quantize their inputs (every placed path
        # but the expert stacks, which read their inputs undigitized)
        n = sum(1 for path, _, mode in cfg.placement_plan()
                if mode != "fp32" and not path.endswith("/moe/experts"))
        return [("history chunk step", None, n), ("chunk step", lc, n),
                ("decode step", ld, n)]

    def _s2s_steps(self, cfg):
        """The enc-dec path's model steps on `cfg` with random encoder
        frame embeddings (so that the cross K/V are not zero): three batch-1
        legacy prefills (buckets 16 and 64, and 100 at its exact length),
        their paged insert into slots 0-2, then one paged decode step at
        batch 4 with slot 3 idle (encoder length 0).  Returns [(step,
        logits, projections it runs)] in call order."""
        import numpy as np
        from repro_torch.models import lm
        from repro_torch.models.context import Ctx
        from repro_torch.serve.engine import paged_insert, view_bucket
        from repro_torch.serve.kv_pool import PagedKV
        torch = self.torch
        params, E, L = self.s2s_params, cfg.encoder_layers, cfg.num_layers
        nb = BATCH * (MAX_LEN // BLOCK)
        kv = PagedKV(BATCH, MAX_LEN, BLOCK, nb)
        cache = lm.init_paged_cache(cfg, BATCH, MAX_LEN, BLOCK, nb,
                                    device=self.dev)
        rng = np.random.default_rng(7)
        pos = np.zeros(BATCH, np.int64)
        out, first = [], []
        for slot, (plen, S) in enumerate(((13, 16), (40, 64), (100, 100))):
            toks = np.zeros((1, S), np.int64)
            toks[0, S - plen:] = rng.integers(0, cfg.vocab_size, plen)
            enc = rng.standard_normal((1, S, cfg.d_model), dtype=np.float32)
            batch = {"tokens": torch.as_tensor(toks, device=self.dev),
                     "enc_embeds": torch.as_tensor(enc, device=self.dev)}
            small = lm.init_cache(cfg, 1, MAX_LEN, device=self.dev)
            small, logits, _ = lm.prefill(params, batch, cfg, Ctx(seed=SEED),
                                          small)
            self.check(kv.admit(slot, S, MAX_NEW), "admission refused")
            paged_insert(cache, small, *kv.scatter_rows(slot))
            kv.ensure(slot, S)
            pos[slot] = S
            first.append(logits)
            out.append((f"prefill (encoder length {S})", logits,
                        7 * E + 11 * L + 1))
        view = view_bucket(int(pos.max()) + 1, BLOCK, MAX_LEN)
        table = torch.as_tensor(kv.gather_tables()[0][:, :view // BLOCK],
                                device=self.dev).contiguous()
        tok = np.zeros(BATCH, np.int64)
        tok[:3] = self._first_tokens(torch.cat(first))
        tok, pos = (torch.as_tensor(a, device=self.dev) for a in (tok, pos))
        ld, _, _ = lm.decode_step(
            params, cache, tok, pos, cfg, Ctx(seed=SEED), active=pos > 0,
            page_tables={"global": table},
            page_lens=lm.clamped_lens(lm.paged_lens(cfg, MAX_LEN), view),
            enc_lens=pos)
        out.append(("decode step (batch 4, one idle row)", ld, 9 * L + 1))
        return out

    def _first_tokens(self, logits):
        """Decode inputs shared by both paths (the first path's argmax)."""
        if not hasattr(self, "_tokens"):
            self._tokens = logits.argmax(-1).cpu().numpy()
        return self._tokens

    def _calls_vs_plain(self, cfg, label, expect, steps):
        """Every kernel call of `steps` (a step function) on `cfg` at full
        width, checked against its plain version on the same inputs (the
        real activations, pools and tables of the model); K1 against its
        plain version in float64, whose pools, written in float64, must
        hold the same values.  `expect` maps each kernel the path calls to
        its exact number of calls."""
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import ops
        from repro_torch.kernels import paged_attention as k1
        from repro_torch.kernels import paged_prefill as k2
        torch = self.torch
        worst = {"emt_matmul": 0.0, "emt_matmul_int8": 0.0,
                 "emt_matmul_experts": 0.0,
                 "emt_bitserial": 0.0, "paged_attention_decode": 0.0,
                 "paged_attention": 0.0, "paged_prefill": 0.0}
        counts = dict.fromkeys(worst, 0)
        pools_ok = {"paged_attention_decode": True, "paged_attention": True}
        stats = {"max_equal": True, "sum_rel": 0.0}
        names = ("_emt_matmul", "_emt_matmul_experts", "_emt_bitserial",
                 "_paged_decode", "_paged_attend", "_paged_prefill")
        orig = {n: getattr(ops, n) for n in names}

        def checked(name, attr, plain):
            def call(*args, **kw):
                y = orig[attr](*args, **kw)
                # K3's int8 weight operand (levels, scale) counts apart
                n = name + "_int8" if isinstance(args[1], tuple) else name
                worst[n] = max(worst[n], rel_err(y, plain(*args, **kw))[1])
                counts[n] += 1
                return y
            return call

        def dbl(a):
            return a.double() if torch.is_tensor(a) and a.is_floating_point() \
                else a

        def pooled(name, attr, plain, writes):
            """K1 against its plain write on pool copies (bit-identical
            pools after); K4 against its plain version on the same pools,
            which neither may change."""
            def call(q, kp, vp, *args, **kw):
                kp2, vp2 = kp.clone(), vp.clone()
                y = orig[attr](q, kp, vp, *args, **kw)
                if writes:
                    kp2, vp2 = kp2.double(), vp2.double()
                    ref = plain(q.double(), kp2, vp2,
                                *[dbl(a) for a in args], **kw)
                    kpd, vpd = kp.double(), vp.double()
                else:
                    ref = plain(q, kp, vp, *args, **kw)
                    kpd, vpd = kp, vp
                worst[name] = max(worst[name],
                                  rel_err(y.to(ref.dtype), ref)[1])
                pools_ok[name] &= bool(torch.equal(kpd, kp2)
                                       and torch.equal(vpd, vp2))
                counts[name] += 1
                return y
            return call

        def experts_call(x, w, sig, **kw):
            """K3's experts entry: the product against its plain version,
            and the noisy stack's max |w~| exactly, its sum within rtol
            1e-6 (float64 partials against a float32 sum)."""
            y, s, m = orig["_emt_matmul_experts"](x, w, sig, **kw)
            yp, sp, mp = k3.plain_experts_differentiable(x, w, sig, **kw)
            worst["emt_matmul_experts"] = max(worst["emt_matmul_experts"],
                                              rel_err(y, yp)[1])
            stats["max_equal"] &= bool(torch.equal(m, mp))
            stats["sum_rel"] = max(stats["sum_rel"], abs(
                float(s) - float(sp)) / max(float(sp), 1e-30))
            counts["emt_matmul_experts"] += 1
            return y, s, m

        pairs = [0, 0]                  # K5 GEMV (k, plane) pairs: needed, all
        k5_checked = checked("emt_bitserial", "_emt_bitserial", k5.plain)

        def k5_call(xq, *args, **kw):
            if xq.shape[0] <= k5.GEMV_MAX_M:
                pairs[0] += plane_pairs(xq, kw["bits"])
                pairs[1] += xq.shape[1] * kw["bits"]
            return k5_checked(xq, *args, **kw)

        with self._ops_through(
                _emt_matmul=checked("emt_matmul", "_emt_matmul", k3.plain),
                _emt_matmul_experts=experts_call,
                _emt_bitserial=k5_call,
                _paged_decode=pooled("paged_attention_decode",
                                     "_paged_decode", k1.plain, True),
                _paged_attend=pooled("paged_attention", "_paged_attend",
                                     k1.plain_attend, False),
                _paged_prefill=checked("paged_prefill", "_paged_prefill",
                                       k2.plain)):
            steps(cfg)
        for name, r in worst.items():
            f = " (float64)" if name == "paged_attention_decode" else ""
            print(f"  {label}: {name}: {counts[name]} calls on real "
                  f"activations, worst rel diff vs plain{f} {r:.3e}")
            self.check(counts[name] == expect.get(name, 0) and r <= 1e-5,
                       f"{label}: {name} on the model's activations: "
                       f"{counts[name]} calls (want {expect.get(name, 0)}), "
                       f"rel {r:.3e}")
        if counts["emt_matmul_experts"]:
            print(f"  {label}: emt_matmul_experts statistics vs plain: max "
                  f"|w~| equal on every call: {stats['max_equal']}; sum "
                  f"|w~| worst rel diff {stats['sum_rel']:.3e}")
            self.check(stats["max_equal"] and stats["sum_rel"] <= 1e-6,
                       f"{label}: expert statistics {stats}")
        if pairs[1]:
            print(f"  {label}: emt_bitserial (k, plane) pairs whose plane "
                  f"is zero in every row, on the real activations of its "
                  f"decode calls (M <= 16): "
                  f"{100 * (1 - pairs[0] / pairs[1]):.2f}% of {pairs[1]}")
        print(f"  {label}: K1 pools bit-identical to the plain write on "
              f"every call: {pools_ok['paged_attention_decode']}; K4 pools "
              f"unchanged on every call: {pools_ok['paged_attention']}")
        self.check(all(pools_ok.values()), f"{label}: pools {pools_ok}")

    def calls_vs_plain(self):
        """Two chunk steps and a decode step: 183 K3 calls each, 26 K2
        calls in each chunk step, 26 K1 calls in the decode step."""
        L = self.cfg.num_layers
        self._calls_vs_plain(self.cfg, "analog", {
            "emt_matmul": 3 * (7 * L + 1), "paged_attention_decode": L,
            "paged_prefill": 2 * L}, self._step_pair)

    def mixed_calls_vs_plain(self):
        L = self.mixed.num_layers
        self._calls_vs_plain(self.mixed, "mixed", {
            "emt_matmul": 3 * (4 * L + 1), "emt_bitserial": 3 * 3 * L,
            "paged_attention_decode": L, "paged_prefill": 2 * L},
            self._step_pair)

    def s2s_calls_vs_plain(self):
        """Three prefills (217 K3 calls each) and a decode step (109 K3,
        12 K1 and 12 K4 calls)."""
        self.__dict__.pop("_tokens", None)
        cfg = self.s2s
        L, E = cfg.num_layers, cfg.encoder_layers
        self._calls_vs_plain(cfg, "seamless", {
            "emt_matmul": 3 * (7 * E + 11 * L + 1) + 9 * L + 1,
            "paged_attention_decode": L, "paged_attention": L},
            self._s2s_steps)

    def ring_calls_vs_plain(self):
        """The ring paged steps: 6 K1 calls in the decode step (5 on
        wrapped ring tables), 1 K2 call in each chunk step, 43 K3 calls a
        step."""
        self.__dict__.pop("_tokens", None)
        L, G = self.ring.num_layers, self.ring.blocks().count("global")
        self._calls_vs_plain(self.ring, "ring paged", {
            "emt_matmul": 3 * (7 * L + 1), "paged_attention_decode": L,
            "paged_prefill": 2 * G},
            lambda cfg: self._ring_steps(cfg, True))

    def ring_logits_vs_plain(self):
        """Logits of the wrapped chunk step and the decode step: the paged
        ring path (K1, K2, K3) and the contiguous one (K3) against each
        other and each against its plain path, within 1e-3 at the 24-bit
        DAC (see _logits_vs_plain); at the served 8-bit DAC the gaps and
        the argmax agreement are reported."""
        import dataclasses
        from repro_torch.core.placement import map_corners
        from repro_torch.kernels import emt_matmul as k3
        plain = dict(_emt_matmul=k3.plain)
        dac24 = self.ring.replace(emt=map_corners(
            self.ring.emt, lambda e: e.replace(quant=dataclasses.replace(
                e.quant, a_bits=24))))
        for cfg, bits, limit in ((dac24, 24, 1e-3), (self.ring, 8, None)):
            self.__dict__.pop("_tokens", None)
            runs = {}
            for paged in (True, False):
                layout = "paged" if paged else "contiguous"

                def steps(c, paged=paged):
                    return self._ring_steps(c, paged)

                runs[layout] = self._run_path(cfg, steps)
                runs[layout + " plain"] = self._run_path(cfg, steps,
                                                         plain=plain)
            for a, b in (("paged", "paged plain"),
                         ("contiguous", "contiguous plain"),
                         ("paged", "contiguous")):
                self._compare(f"ring, {bits}-bit DAC: {a} vs {b} path",
                              runs[a], runs[b], limit=limit)

    @contextlib.contextmanager
    def _ops_through(self, **fns):
        """Route the kernel wrappers named (``ops._emt_matmul``, ...)
        through the functions given, for the duration."""
        from repro_torch.kernels import ops
        orig = {n: getattr(ops, n) for n in fns}
        for n, fn in fns.items():
            setattr(ops, n, fn)
        try:
            yield
        finally:
            for n, fn in orig.items():
                setattr(ops, n, fn)

    @contextlib.contextmanager
    def _record_levels(self, out: list):
        """Append every projection's DAC levels to `out`, in call order."""
        from repro_torch.core import emt_linear
        orig = emt_linear.quant_levels

        def record(*args, **kw):
            levels, scale = orig(*args, **kw)
            out.append(levels.detach())
            return levels, scale

        emt_linear.quant_levels = record
        try:
            yield
        finally:
            emt_linear.quant_levels = orig

    def _run_path(self, cfg, steps, plain=None, levels=None):
        """`steps` (a step function) on the kernel path, or, with `plain`
        given ({ops wrapper name: replacement}), on the plain path:
        attention through scatter + gather + _gqa_core
        (fused_paged_attn=False) and every projection through its plain
        version in place of K3 / K5."""
        with contextlib.ExitStack() as stack:
            if plain is not None:
                stack.enter_context(self._ops_through(**plain))
                cfg = cfg.replace(fused_paged_attn=False)
            if levels is not None:
                stack.enter_context(self._record_levels(levels))
            return steps(cfg)

    def _compare(self, label, a_steps, b_steps, limit=None):
        torch = self.torch
        for (what, a, _), (_, b, _) in zip(a_steps, b_steps):
            if a is None:
                continue
            d = (a - b).abs().max().item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
            held = f", limit {limit:g}" if limit is not None else ""
            print(f"  {label}, {what} logits: max|diff| {d:.3e} (|logit| "
                  f"max {b.abs().max().item():.3f}{held}), argmax agreement "
                  f"{agree:.2f}, finite {finite}")
            self.check(finite, f"{label} {what} logits not finite")
            if limit is not None:
                self.check(d <= limit, f"{label} {what} logits differ by "
                                       f"{d:.3e} > {limit:g}")

    def _logits_vs_plain(self, cfg, label, steps, quiet=True, dac8=True,
                         vs_f64=True):
        """End-to-end logits of the kernel path (K1, K2, K3, K4 and, on the
        mixed path, K5, as the path runs them) against the plain path on
        the card, noise on, over the model steps of `steps`.

        Held to 1e-3 with a 24-bit activation DAC (K5 then runs 23 planes):
        its levels are finer than float32's own rounding, so an analog
        projection is continuous in its input and the gap measures the
        kernels.  A bit-serial projection is not: a level one step higher
        can carry into a high bit, and every plane draws its own noise, so
        the output jumps by ~2^p * sigma * w.  The gated run therefore sets
        the bit-serial corners' read noise to zero (K5 still runs all 23
        planes; its noise is held bit-exact in the K5 phase and per call on
        real activations); the run with that noise on is reported beside
        it.  At the main paths' 8-bit DAC a float32 ulp of summation order
        can flip a level at a .5 tie, and the flips propagate; there the
        script reports the gap beside the gap between two plain paths that
        differ only in accumulation precision (float32 vs float64 matmul),
        and counts the DAC levels that differ between the kernel and plain
        paths.  With `quiet` False every corner keeps its noise in the gated
        run: the MoE experts' rule is bit-serial, but they read in analog
        (technique A), so their products are continuous in their inputs.
        `dac8` False leaves the 8-bit runs out, `vs_f64` False the plain
        float64 one (the cut architectures, gemma2-9b: each plain run over
        their tens of GB of weights takes seconds)."""
        import dataclasses
        from repro_torch.core.placement import as_placement, map_corners
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3

        def f64(plain):
            def call(x, w, sig, **kw):
                return plain(x.double(), w.double(), sig, **kw).float()
            return call

        def f64_experts(x, w, sig, **kw):
            return tuple(t.float() for t in k3.plain_experts(
                x.double(), w.double(), sig, **kw))

        def dac24(quiet_bitserial):
            def corner(e):
                e = e.replace(quant=dataclasses.replace(e.quant, a_bits=24))
                if quiet_bitserial and e.mode == "bitserial":
                    e = e.replace(device=dataclasses.replace(e.device,
                                                             amplitude=0.0))
                return e
            return cfg.replace(emt=map_corners(cfg.emt, corner))

        plain = dict(_emt_matmul=k3.plain, _emt_bitserial=k5.plain,
                     _emt_matmul_experts=k3.plain_experts_differentiable)
        plain64 = dict(_emt_matmul=f64(k3.plain),
                       _emt_bitserial=f64(k5.plain),
                       _emt_matmul_experts=f64_experts)
        p = as_placement(cfg.emt)
        bitserial = quiet and any(
            e.mode == "bitserial" for e in [r.emt for r in p.rules]
            + [p.default])
        self.__dict__.pop("_tokens", None)
        off = ", bit-serial read noise off" if bitserial else ""
        self._compare(f"{label}, 24-bit DAC{off}: kernel vs plain path",
                      self._run_path(dac24(quiet), steps),
                      self._run_path(dac24(quiet), steps, plain=plain),
                      limit=1e-3)
        if bitserial:
            self.__dict__.pop("_tokens", None)
            self._compare(f"{label}, 24-bit DAC, bit-serial read noise on: "
                          "kernel vs plain path",
                          self._run_path(dac24(False), steps),
                          self._run_path(dac24(False), steps, plain=plain))

        if not dac8:
            return
        self.__dict__.pop("_tokens", None)
        lk, lp, l64 = [], [], []
        kern = self._run_path(cfg, steps, levels=lk)
        ref = self._run_path(cfg, steps, plain=plain, levels=lp)
        self._compare(f"{label}, 8-bit DAC: kernel vs plain path", kern, ref)
        self._level_flips(label, "kernel vs plain path", lk, lp, kern)
        if not vs_f64:
            return
        ref64 = self._run_path(cfg, steps, plain=plain64, levels=l64)
        self._compare(f"{label}, 8-bit DAC: plain f32 vs plain f64 "
                      "accumulation", ref, ref64)
        self._level_flips(label, "plain f32 vs plain f64 accumulation", lp,
                          l64, kern)

    def logits_vs_plain(self):
        self._logits_vs_plain(self.cfg, "analog", self._step_pair)

    def mixed_logits_vs_plain(self):
        self._logits_vs_plain(self.mixed, "mixed", self._step_pair)

    def s2s_logits_vs_plain(self):
        self._logits_vs_plain(self.s2s, "seamless", self._s2s_steps)

    # -- phase 7: the prefix cache and the streaming front end ---------------
    def _replay(self, eng, schedule):
        """Apply a recorded schedule (engine step count, "submit" / request
        / rid or "cancel" / rid / reason) to a fresh engine, each event
        after as many model steps as it came after, stepping in between;
        returns {rid: result}."""
        out, events = {}, list(schedule)
        for _ in range(10_000):
            while events and events[0][0] == eng._steps:
                _, kind, a, b = events.pop(0)
                if kind == "submit":
                    self.check(eng.submit(a) == b, "replay: rid mismatch")
                else:
                    res = eng.cancel(a, b)
                    if res is not None:
                        out[res.rid] = res
            if not eng.scheduler.busy:
                break
            for res in eng.step():
                out[res.rid] = res
        self.check(not events and not eng.scheduler.busy,
                   f"replay: {len(events)} events left, busy "
                   f"{eng.scheduler.busy}")
        return out

    def _serve_spec(self, **kw):
        """gemma3-1b at published widths, all-global, analog, per-row DAC,
        frozen noise, paged, temperature 0: the default scenario matrix's
        base (benchmarks/matrix.py default_matrix) on the card."""
        from repro_torch.serve.spec import ServeSpec
        kw.setdefault("paged", True)
        return ServeSpec(arch=ARCH, mode="analog", smoke=False,
                         all_global=True, a_per_row=True, frozen_noise=True,
                         temperature=0.0, **kw)

    def _reset_launches(self):
        counters = self._counters()
        for w in counters.values():
            w.launches = 0
        return counters

    def _prefix_requests(self, spec):
        """The default matrix's shared-prefix cell at full-width lengths:
        8 requests of 128 tokens sharing a 64-token header (ratio 0.5),
        workload seed 11, max_new 8, request 0 (the continuation's donor)
        max_new 24; then request 1's prompt again (7 blocks hit, the last
        copied with 15 rows) and request 2's first 72 tokens with a new
        tail (4 blocks hit, 8 rows copied)."""
        import dataclasses
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        from repro_torch.serve.spec import ScenarioSpec, make_requests
        cell = ScenarioSpec(name="prefix", serve=spec, arrival="stagger",
                            stagger=2, n_requests=8, prompt_lo=128,
                            prompt_hi=128, shared_prefix_ratio=0.5,
                            max_new=8, workload_seed=11)
        reqs = make_requests(cell, self.cfg.vocab_size)
        reqs[0] = dataclasses.replace(reqs[0], max_new=24)
        fork = reqs[2].prompt.copy()
        fork[72:] = (fork[72:] + 1) % self.cfg.vocab_size
        reqs += [GenRequest(prompt=reqs[1].prompt.copy(), max_new=8, seed=8),
                 GenRequest(prompt=fork, max_new=8, seed=9)]
        return reqs

    def _prefix_run(self, spec, reqs):
        """Submit `reqs` one every 2 steps and step until idle; once request
        0 has generated PREFIX_CONT_AT tokens (its decode has filled block
        8), submit the continuation: request 0's prompt and those tokens.
        Returns (engine, {label: result}, prefix admissions as (label,
        cached_len, cow), model steps, launches, wall)."""
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        eng = spec.build_engine(self.cfg, self.params,
                                max_len=PREFIX_MAX_LEN, torch_device=self.dev)
        streamed, labels, admissions = {}, {}, []
        eng.on_token = lambda rid, t: streamed.setdefault(rid, []).append(t)
        if spec.prefix_cache:
            admit, admit_slot, current = eng.kv.admit_prefix, eng._admit, []

            def traced_admit(sid, rid, req):
                current[:] = [labels[rid]]
                return admit_slot(sid, rid, req)

            def traced(slot, prompt, max_new):
                res = admit(slot, prompt, max_new)
                if res is not None:
                    admissions.append((current[0], res["cached_len"],
                                       res["cow"]))
                return res

            eng._admit, eng.kv.admit_prefix = traced_admit, traced
        queue = [(f"r{i}", r) for i, r in enumerate(reqs)]
        results, cont = {}, None

        def step():
            nonlocal cont
            for res in eng.step():
                results[labels[res.rid]] = res
            got = streamed.get(0, [])
            if cont is None and len(got) >= PREFIX_CONT_AT:
                cont = GenRequest(prompt=np.concatenate(
                    [reqs[0].prompt, np.asarray(got[:PREFIX_CONT_AT],
                                                np.int32)]),
                    max_new=8, seed=10)
                labels[eng.submit(cont)] = "continuation"

        steps = {"chunk_step": 0, "decode_step": 0}
        self.sync()
        self.torch.cuda.reset_peak_memory_stats()
        counters = self._reset_launches()
        t0 = time.perf_counter()
        with self._counting_steps(steps):
            for label, r in queue:
                labels[eng.submit(r)] = label
                step()
                step()
            while eng.scheduler.busy or cont is None:
                step()
            self.sync()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in counters.items()}
        self.check(all(streamed[rid] == results[lab].tokens.tolist()
                       for rid, lab in labels.items()),
                   "prefix path: on_token streams differ from the results")
        return eng, results, admissions, steps, launches, wall

    def engine_prefix(self):
        """The prefix cache at full width: the shared-prefix workload with
        the cache off (default pool), then on (a pool small enough to
        evict registered blocks).  Tokens identical per request; the on
        run computes cached_prefix_tokens fewer prompt tokens, in fewer
        chunk steps, with a copy-on-write admission, a hit on a block that
        decode wrote, and an eviction; launches exact (K1 26 per decode
        step, K2 26 per chunk step, K3 183 per step)."""
        import numpy as np
        torch = self.torch
        L = self.cfg.num_layers
        off = self._serve_spec(block_size=BLOCK, prefill_chunk=CHUNK,
                               batch_size=BATCH, seed=SEED)
        on = off.replace(prefix_cache=True, num_blocks=PREFIX_ON_BLOCKS)
        self.check(on.build_config() == self.cfg,
                   "the prefix spec resolves another config")
        reqs = self._prefix_requests(off)
        runs = {}
        for tag, spec in (("off", off), ("on", on)):
            eng, res, adm, steps, launches, wall = self._prefix_run(spec,
                                                                     reqs)
            peak = torch.cuda.max_memory_allocated()
            m = eng.metrics()
            ntok = sum(len(r.tokens) for r in res.values())
            prefill_uj = sum(r.prefill_energy_pj for r in res.values()) * 1e-6
            print(f"  prefix cache {tag}: {len(res)} requests, "
                  f"{m['steps']} steps ({steps['chunk_step']} chunk, "
                  f"{steps['decode_step']} decode), {ntok} tokens in "
                  f"{wall:.3f} s -> {ntok / wall:.2f} tok/s; prompt tokens "
                  f"computed {m['prefill_tokens_total']}, served from the "
                  f"cache {m['cached_prefix_tokens']} (hits "
                  f"{eng.kv.prefix_hits}, evictions "
                  f"{eng.kv.prefix_evictions}, pool "
                  f"{eng.kv.pool_g.num_blocks} blocks); prefill energy "
                  f"{prefill_uj:.3f} uJ; peak device memory "
                  f"{peak / 2**30:.2f} GiB")
            print(f"  launches ({tag}): {launches}")
            self.check(eng.energy_conserved(list(res.values())),
                       f"prefix {tag}: energy not conserved")
            self._check_launches(f"prefix {tag}", launches, m["steps"], {
                "emt_matmul": 7 * L + 1, "emt_bitserial": 0,
                "paged_attention": 0})
            self.check(launches["paged_attention_decode"]
                       == L * steps["decode_step"]
                       and launches["paged_prefill"]
                       == L * steps["chunk_step"]
                       and sum(steps.values()) == m["steps"],
                       f"prefix {tag}: K1/K2 launches {launches} for steps "
                       f"{steps}, want {L} per decode / chunk step")
            want_new = {f"r{i}": r.max_new for i, r in enumerate(reqs)}
            want_new["continuation"] = 8
            for label, r in res.items():
                ok = (r.done_reason == "max_new"
                      and len(r.tokens) == want_new[label]
                      and ((r.tokens >= 0) & (r.tokens < self.cfg.vocab_size))
                      .all())
                self.check(bool(ok), f"prefix {tag}: {label} malformed {r}")
            runs[tag] = dict(eng=eng, res=res, adm=adm, steps=steps, m=m,
                             launches=launches, wall=wall, ntok=ntok,
                             peak=peak, prefill_uj=prefill_uj)
        a, b = runs["off"], runs["on"]
        self.check(sorted(a["res"]) == sorted(b["res"])
                   and len(a["res"]) == len(reqs) + 1,
                   f"prefix: results {sorted(a['res'])} / {sorted(b['res'])}")
        for label in a["res"]:
            ta, tb = a["res"][label].tokens, b["res"][label].tokens
            same = np.array_equal(ta, tb)
            print(f"    {label}: off {ta.tolist()} on {tb.tolist()}"
                  + ("" if same else "  <- DIFFERS"))
            self.check(same, f"prefix cache changed the tokens of {label}")
        cached = b["m"]["cached_prefix_tokens"]
        self.check(cached > 0 and b["m"]["prefill_tokens_total"]
                   == a["m"]["prefill_tokens_total"] - cached,
                   f"prefix: {cached} cached, prompt tokens computed "
                   f"{b['m']['prefill_tokens_total']} vs "
                   f"{a['m']['prefill_tokens_total']}")
        adm = {label: (n, cow) for label, n, cow in b["adm"]}
        print(f"  prefix admissions (label: cached_len, copy src -> dst): "
              f"{adm}")
        self.check(adm.get("r8", (0, None))[0] == 127
                   and adm["r8"][1] is not None,
                   f"prefix: repeat of r1 admitted as {adm.get('r8')}, want "
                   f"127 cached with a copied last block")
        self.check(adm.get("r9", (0, None))[0] == 72
                   and adm["r9"][1] is not None,
                   f"prefix: fork of r2 admitted as {adm.get('r9')}, want "
                   f"72 cached with a copied block")
        self.check(adm.get("continuation", (0,))[0] == 9 * BLOCK,
                   f"prefix: continuation admitted as "
                   f"{adm.get('continuation')}, want {9 * BLOCK} cached "
                   f"(block 8 written by decode)")
        self.check(b["eng"].kv.prefix_evictions > 0,
                   "prefix: no registered block was evicted")
        self.check(b["steps"]["chunk_step"] < a["steps"]["chunk_step"],
                   f"prefix: chunk steps {a['steps']} off, {b['steps']} on")
        b["eng"].kv.check()
        print(f"  prefix cache: prefill energy saved "
              f"{a['prefill_uj'] - b['prefill_uj']:.3f} uJ of "
              f"{a['prefill_uj']:.3f}; tok/s off {a['ntok'] / a['wall']:.2f},"
              f" on {b['ntok'] / b['wall']:.2f}")
        for name in ("paged_attention_decode", "paged_prefill",
                     "emt_matmul"):
            self.records.setdefault(name, {})["prefix_launches"] = \
                b["launches"][name]
        self._profile_steps(on.build_engine(
            self.cfg, self.params, max_len=PREFIX_MAX_LEN,
            torch_device=self.dev), reqs, 1)
        self.prefix_summary = {
            tag: dict(tok_s=r["ntok"] / r["wall"], wall_s=r["wall"],
                      tokens=r["ntok"], steps=r["m"]["steps"],
                      chunk_steps=r["steps"]["chunk_step"],
                      decode_steps=r["steps"]["decode_step"],
                      prefill_tokens=r["m"]["prefill_tokens_total"],
                      cached_prefix_tokens=r["m"]["cached_prefix_tokens"],
                      prefill_uj=r["prefill_uj"], peak_gib=r["peak"] / 2**30)
            for tag, r in runs.items()}

    def _poisson_cell(self):
        """The default matrix's Poisson cell at full width: (spec, cell,
        requests, max_len)."""
        from repro_torch.serve.engine import prefill_bucket
        from repro_torch.serve.spec import ScenarioSpec, make_requests
        spec = self._serve_spec(seed=7, batch_size=4, prefill_chunk=16,
                                block_size=8, max_pending=16)
        cell = ScenarioSpec(name="poisson", serve=spec, arrival="poisson",
                            rate_rps=4.0, n_requests=16, prompt_lo=6,
                            prompt_hi=20, max_new=12, workload_seed=5)
        return (spec, cell, make_requests(cell, self.cfg.vocab_size),
                prefill_bucket(cell.prompt_hi) + cell.max_new)

    def server_stream(self):
        """The default matrix's Poisson cell at full width through the
        launcher's serve_streaming (StreamingServer): 16 requests of 6-20
        tokens at 4 req/s, max_new 12, block 8, max_pending 16, workload
        seed 5; request POISSON_CANCEL is cancelled through its handle after
        its first token, every other request finishes.  The engine's submits
        and cancels are recorded against its step count, and a fresh engine
        replaying that schedule must give every result's tokens, done
        reason and energy (the server adds nothing to the engine's work);
        launches exact; the serving thread launches on the main thread's
        stream.  An engine.serve run of the same requests is compared on
        the logits (_schedule_gap): on the card a request's tokens depend
        on the schedule (a token computed in a decode step or in a chunk
        step, under another view bucket, sums in another float32 order,
        and a DAC level can flip at a tie; ROADMAP Queue 3)."""
        import numpy as np
        from repro_torch.kernels import _build
        from repro_torch.launch.serve import serve_streaming
        L = self.cfg.num_layers
        spec, cell, reqs, max_len = self._poisson_cell()

        def make():
            return spec.build_engine(self.cfg, self.params, max_len=max_len,
                                     torch_device=self.dev)

        eng = make()
        index = self.dev.index or 0
        streams, step = set(), eng.step

        def traced_step():
            streams.add(_build.stream(index))
            return step()

        eng.step = traced_step
        schedule, submit, cancel = [], eng.submit, eng.cancel

        def traced_submit(req):
            rid = submit(req)
            schedule.append((eng._steps, "submit", req, rid))
            return rid

        def traced_cancel(rid, reason="cancelled"):
            res = cancel(rid, reason)
            schedule.append((eng._steps, "cancel", rid, reason))
            return res

        eng.submit, eng.cancel = traced_submit, traced_cancel
        cancellers = []

        def on_handle(i, h):
            if i == POISSON_CANCEL:
                cancellers.append(_cancel_after_first_token(h))

        steps = {"chunk_step": 0, "decode_step": 0}
        self.sync()
        counters = self._reset_launches()
        with self._counting_steps(steps):
            results, wall, rejected, ttft, itl = serve_streaming(
                eng, reqs, rate=cell.rate_rps, deadline_s=spec.deadline_s,
                max_pending=spec.max_pending, seed=cell.workload_seed,
                on_handle=on_handle)
            self.sync()
        launches = {name: w.launches for name, w in counters.items()}
        for t in cancellers:
            t.join(timeout=60)
        self.check(len(cancellers) == 1 and not cancellers[0].is_alive(),
                   "Poisson: the cancelling client did not finish")
        m = eng.metrics()
        ntok = sum(len(r.tokens) for r in results)
        pct = lambda xs, q: float(np.percentile(np.asarray(xs) * 1e3, q))  # noqa: E731
        summary = dict(
            tok_s=ntok / wall, wall_s=wall, tokens=ntok, steps=m["steps"],
            chunk_steps=steps["chunk_step"],
            decode_steps=steps["decode_step"], rejected=rejected,
            ttft_ms_p50=pct(ttft, 50), ttft_ms_p99=pct(ttft, 99),
            itl_ms_p50=pct(itl, 50), itl_ms_p99=pct(itl, 99))
        print(f"  streaming @ {cell.rate_rps:g} req/s: {len(results)} "
              f"results, {ntok} tokens in {wall:.3f} s -> "
              f"{ntok / wall:.2f} tok/s; TTFT p50 {summary['ttft_ms_p50']:.1f}"
              f" ms / p99 {summary['ttft_ms_p99']:.1f} ms, inter-token p50 "
              f"{summary['itl_ms_p50']:.1f} ms / p99 "
              f"{summary['itl_ms_p99']:.1f} ms; rejected {rejected}; "
              f"{m['steps']} steps {steps}")
        print(f"  launches (Poisson stream): {launches}; serving-thread "
              f"streams {sorted(streams)}, main thread's "
              f"{_build.stream(index)}")
        self.check(streams == {_build.stream(index)},
                   f"serving thread launched on streams {streams}")
        self.check(rejected == 0 and len(results) == len(reqs),
                   f"Poisson: {len(results)} results, {rejected} rejected")
        self._check_launches("Poisson", launches, m["steps"], {
            "emt_matmul": 7 * L + 1, "emt_bitserial": 0,
            "paged_attention": 0})
        self.check(launches["paged_attention_decode"]
                   == L * steps["decode_step"]
                   and launches["paged_prefill"] == L * steps["chunk_step"]
                   and sum(steps.values()) == m["steps"],
                   f"Poisson: K1/K2 launches {launches} for steps {steps}")
        self.check(eng.energy_conserved(results),
                   "Poisson: energy not conserved")
        for r in results:
            want = "cancelled" if r.rid == POISSON_CANCEL else "max_new"
            self.check(r.done_reason == want and len(r.tokens) > 0,
                       f"Poisson: rid {r.rid} {r.done_reason}, want {want}")
        traced = {"stream": {}, "serve": {}}
        replay_eng = make()
        with self._token_trace(replay_eng, traced["stream"]):
            replay = self._replay(replay_eng, schedule)
        for r in results:
            b = replay.get(r.rid)
            self.check(b is not None and np.array_equal(r.tokens, b.tokens)
                       and r.done_reason == b.done_reason
                       and np.isclose(r.energy_pj, b.energy_pj, rtol=1e-9),
                       f"Poisson: rid {r.rid} {r.done_reason} "
                       f"{r.tokens.tolist()}, the replayed schedule gave "
                       f"{b}")
        serve_eng = make()
        with self._token_trace(serve_eng, traced["serve"]):
            ref = {r.rid: r.tokens for r in serve_eng.serve(reqs)}
        differ = {r.rid: int(np.argmin(np.append(
            r.tokens == ref[r.rid][:len(r.tokens)], False)))
            for r in results if not np.array_equal(
                r.tokens, ref[r.rid][:len(r.tokens)])}
        print(f"  Poisson vs its replayed schedule ({len(schedule)} submits "
              f"and cancels): {len(results)} results compared, request "
              f"{POISSON_CANCEL} cancelled after "
              f"{len(results[POISSON_CANCEL].tokens)} tokens; vs "
              f"engine.serve: {len(differ)} requests differ "
              f"{ {rid: (i, int(results[rid].tokens[i]), int(ref[rid][i])) for rid, i in differ.items()} } "
              f"(rid: first index, stream token, engine.serve token)")
        summary["serve_differs"] = len(differ)
        summary["serve_logit_gap"] = self._schedule_gap(
            results, differ, traced["stream"], traced["serve"],
            7 * L + 1)
        for name in ("paged_attention_decode", "paged_prefill",
                     "emt_matmul"):
            self.records.setdefault(name, {})["poisson_launches"] = \
                launches[name]
        self._profile_steps(make(), reqs, 1)
        self.poisson_summary = summary

    @contextlib.contextmanager
    def _token_trace(self, eng, out: dict):
        """Record, for every token `eng` samples, out[(rid, index)] =
        (logits row, [the DAC levels, as int8, of the input row that
        computes it, per projection in call order]).  That row is the
        request's slot at its last prompt position in its final prompt
        chunk, else at its one decode position; a prompt's earlier chunks
        are overwritten by its final one."""
        from repro_torch.core import emt_linear
        from repro_torch.serve import sampling
        torch = self.torch
        quant, sample = emt_linear.quant_levels, sampling.sample_tokens
        step = {}

        def levels(x, *args, **kw):
            lv, scale = quant(x, *args, **kw)
            rows = lv.detach().reshape(eng.batch_size, -1, lv.shape[-1])
            for i, s in eng.scheduler.active_slots():
                col = len(s.prompt) - s.pos - 1 if s.prefilling else 0
                step.setdefault((s.rid, len(s.generated)), []).append(
                    rows[i, min(col, rows.shape[1] - 1)].to(torch.int8))
            return lv, scale

        def sample_tokens(logits, *args):
            for i, s in eng.scheduler.active_slots():
                key = (s.rid, len(s.generated))
                out[key] = (logits[i].detach().clone(), step.pop(key, []))
            step.clear()
            return sample(logits, *args)

        emt_linear.quant_levels = levels
        sampling.sample_tokens = sample_tokens
        try:
            yield
        finally:
            emt_linear.quant_levels = quant
            sampling.sample_tokens = sample

    def _schedule_gap(self, results, differ, stream, serve, projections,
                      label="Poisson", probe=POISSON_PROBE):
        """Hold the logits of one schedule (`stream`: the Poisson stream's,
        traced on the replay of its schedule, which gave the stream's
        results bit for bit; or a speculative run's) to engine.serve's
        (`serve`) on every token of every request up to and including its
        first differing one (`differ`: rid -> index), within
        POISSON_LOGIT_TOL.  At each first difference and at `probe` print
        both runs' top-2 margins, the margin of each run's token over the
        other's, and the DAC levels that differ in the row computing it.
        Returns the largest logit gap."""
        worst, at = 0.0, None
        for r in results:
            n = min(len(r.tokens), differ.get(r.rid, len(r.tokens)) + 1)
            for i in range(n):
                d = (stream[(r.rid, i)][0] - serve[(r.rid, i)][0]).abs() \
                    .max().item()
                if d > worst:
                    worst, at = d, (r.rid, i)
        print(f"  {label} vs engine.serve: logits max|diff| {worst:.4e} at "
              f"(rid, token) {at} over every token up to each request's "
              f"first differing one, limit {POISSON_LOGIT_TOL:g}")
        self.check(worst <= POISSON_LOGIT_TOL,
                   f"{label}: logits differ from engine.serve's by "
                   f"{worst:.4e} at {at} > {POISSON_LOGIT_TOL:g}")
        for rid, i in sorted(set(differ.items()) | {probe}):
            (la, lva), (lb, lvb) = stream[(rid, i)], serve[(rid, i)]
            (va, ia), (vb, ib) = la.topk(2), lb.topk(2)
            ta, tb = int(ia[0]), int(ib[0])
            self.check(len(lva) == len(lvb) == projections,
                       f"{label}: {len(lva)} / {len(lvb)} projections "
                       f"traced for ({rid}, {i}), want {projections}")
            flips = [int((a != b).sum().item()) for a, b in zip(lva, lvb)]
            first = next((c for c, f in enumerate(flips) if f), None)
            print(f"  {label} (rid {rid}, token {i}): {ta} (over "
                  f"the runner-up {int(ia[1])} by {float(va[0] - va[1]):.4e},"
                  f" over {tb} by {float(la[ta] - la[tb]):.4e}), "
                  f"engine.serve {tb} (over the runner-up {int(ib[1])} by "
                  f"{float(vb[0] - vb[1]):.4e}, over {ta} by "
                  f"{float(lb[tb] - lb[ta]):.4e}); logits max|diff| "
                  f"{(la - lb).abs().max().item():.4e}; DAC levels that "
                  f"differ in its row: {sum(flips)} of "
                  f"{sum(a.numel() for a in lva)}, in "
                  f"{sum(f > 0 for f in flips)} of {len(flips)} "
                  f"projections, first at projection {first}; first 7 "
                  f"{flips[:7]}")
        return worst

    def _engine_calls_vs_plain(self, label, eng, waves):
        """Every kernel call of a served engine's steps held against its
        plain version (_calls_vs_plain): for each list of requests in
        `waves`, submit them, then step `eng` until it has run a decode
        step.  The model steps are counted: K3 must run 183 calls a step,
        K2 26 a chunk step and K1 26 a decode step, exactly.  Returns the
        step counts."""
        L = self.cfg.num_layers
        steps = {"chunk_step": 0, "decode_step": 0}
        expect = {}                     # filled once the steps are known

        def run(cfg):
            with self._counting_steps(steps):
                for wave in waves:
                    for r in wave:
                        eng.submit(r)
                    decoded = steps["decode_step"]
                    while steps["decode_step"] == decoded:
                        if not eng.scheduler.busy:
                            raise RuntimeError(f"{label}: the engine went "
                                               "idle before a decode step")
                        eng.step()
            expect.update(emt_matmul=(7 * L + 1) * sum(steps.values()),
                          paged_prefill=L * steps["chunk_step"],
                          paged_attention_decode=L * steps["decode_step"])

        self._calls_vs_plain(self.cfg, label, expect, run)
        print(f"  {label}: model steps checked {steps}")
        self.check(steps["chunk_step"] > 0 and steps["decode_step"] > 0,
                   f"{label}: steps {steps}")
        return steps

    def prefix_calls_vs_plain(self):
        """The prefix path's kernel calls on tables whose rows share blocks:
        the shared-prefix workload's request 1 (max_new 24) is served
        until its prompt is in the cache; then its repeat (7 blocks hit,
        the last copied with 15 rows) and a fork of it at token 72 (4
        blocks hit, 8 rows copied) are admitted beside it.  Every kernel
        call of the steps from that admission to a decode step (K2 over
        shared and copied blocks beside a decode lane, K1 over the three
        rows) is held to its plain version; the donor's prompt blocks are
        unchanged across them."""
        import dataclasses
        from repro_torch.serve.engine import GenRequest
        torch = self.torch
        spec = self._serve_spec(block_size=BLOCK, prefill_chunk=CHUNK,
                                batch_size=BATCH, seed=SEED,
                                prefix_cache=True,
                                num_blocks=PREFIX_ON_BLOCKS)
        donor = dataclasses.replace(self._prefix_requests(spec)[1],
                                    max_new=24)
        fork = donor.prompt.copy()
        fork[72:] = (fork[72:] + 1) % self.cfg.vocab_size
        eng = spec.build_engine(self.cfg, self.params,
                                max_len=PREFIX_MAX_LEN, torch_device=self.dev)
        copies, copy = [], eng._pool_copy

        def traced(cache, src, dst):
            copies.append((src, dst))
            return copy(cache, src, dst)

        eng._pool_copy = traced
        rid = eng.submit(donor)
        while eng.prefill_tokens_total < len(donor.prompt):
            eng.step()
        ids = torch.as_tensor(
            eng.kv.table_g[eng.scheduler.slot_of(rid), :8].astype("int64"),
            device=self.dev)
        before = [pool[ids].clone() for blk in eng.cache.values()
                  for pool in blk.values()]
        self._engine_calls_vs_plain("prefix", eng, [[
            GenRequest(prompt=donor.prompt.copy(), max_new=8, seed=8),
            GenRequest(prompt=fork, max_new=8, seed=9)]])
        rows = [eng.kv.table_g[i] for i, _ in eng.scheduler.active_slots()]
        owners = {}
        for row in rows:
            for b in set(row[row >= 0].tolist()):
                owners[b] = owners.get(b, 0) + 1
        shared = sorted(b for b, n in owners.items() if n > 1)
        after = [pool[ids] for blk in eng.cache.values()
                 for pool in blk.values()]
        same = all(torch.equal(a, b) for a, b in zip(before, after))
        print(f"  prefix: {len(rows)} rows in flight sharing blocks "
              f"{shared}; copy-on-write (src, dst) {copies}; cached "
              f"prompt tokens {eng.cached_prefix_tokens}; the donor's "
              f"prompt blocks unchanged: {same}")
        self.check(len(rows) == 3 and len(shared) == 7 and len(copies) == 2
                   and eng.cached_prefix_tokens == 127 + 72 and same,
                   f"prefix: rows {len(rows)}, shared {shared}, copies "
                   f"{copies}, cached {eng.cached_prefix_tokens}, donor "
                   f"unchanged {same}")

    def poisson_calls_vs_plain(self):
        """The Poisson path's kernel calls at its block size (8) and view
        buckets: three of the cell's requests are admitted and served to a
        decode step, then two more (chunk steps beside decode lanes) to
        the next decode step; every kernel call held to its plain
        version."""
        spec, _, reqs, max_len = self._poisson_cell()
        eng = spec.build_engine(self.cfg, self.params, max_len=max_len,
                                torch_device=self.dev)
        self._engine_calls_vs_plain("Poisson", eng, [reqs[:3], reqs[3:5]])

    # -- phase 9: speculative decoding and int8 weight streaming -----------
    def _spec_requests(self):
        """6 greedy requests, prompts of 20-96 tokens, max_new 32: every
        request runs several rounds within max_len 128."""
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        rng = np.random.default_rng(SEED + 17)
        return [GenRequest(prompt=rng.integers(
            0, self.cfg.vocab_size, int(rng.integers(
                SPEC_PROMPTS[0], SPEC_PROMPTS[1] + 1))).astype(np.int32),
            max_new=SPEC_MAX_NEW, seed=2000 + i) for i in range(6)]

    @contextlib.contextmanager
    def _spec_trace(self, eng, out: dict, log: dict):
        """Trace a speculative engine: out[(rid, index)] = (the verify
        lane's logits row, [the DAC levels, as int8, of that lane's input
        row, per projection]) for every token it commits (each one a
        target's argmax of a verify lane: lane j for a decode slot's j-th
        token, the last prompt lane for a prompt's first token); log counts
        the model steps (verify, draft chunk, draft decode) and the draft
        chunk's catch-up rows."""
        from repro_torch.core import emt_linear
        from repro_torch.models import lm
        torch = self.torch
        quant, chunk, decode = (emt_linear.quant_levels, lm.chunk_step,
                                lm.decode_step)
        book, step, on_token = eng._book_draft_step, eng.step, eng.on_token
        cur = {"on": False, "levels": [], "logits": None}
        events = []
        C = eng.spec_k + 1

        def levels(x, *args, **kw):
            lv, scale = quant(x, *args, **kw)
            if cur["on"]:
                cur["levels"].append(lv.detach().reshape(
                    eng.batch_size, -1, lv.shape[-1]).to(torch.int8))
            return lv, scale

        def chunk_step(*args, **kw):
            if not kw.get("all_lanes"):
                log["draft chunk"] += 1
                return chunk(*args, **kw)
            log["verify"] += 1
            cur.update(on=True, levels=[])
            try:
                logits, cache, aux = chunk(*args, **kw)
            finally:
                cur["on"] = False
            cur["logits"] = logits.detach()
            return logits, cache, aux

        def decode_step(*args, **kw):
            log["draft decode"] += 1
            return decode(*args, **kw)

        def book_draft(aux, rows, prefill_rows=None):
            if prefill_rows is None:
                return book(aux, rows)
            log["catch-up rows"] += len(set(rows) - set(prefill_rows))
            return book(aux, rows, prefill_rows)

        def traced_step():
            before = {s.rid: (i, s.prefilling, s.pos, len(s.prompt),
                              len(s.generated))
                      for i, s in eng.scheduler.active_slots()}
            events.clear()
            res = step()
            seen = {}
            for rid, tok in events:
                i, prefilling, pos, plen, n0 = before[rid]
                k = seen.get(rid, 0)
                seen[rid] = k + 1
                lane = min(C, plen - pos) - 1 if prefilling else k
                out[(rid, n0 + k)] = (cur["logits"][i, lane].clone(),
                                      [lv[i, lane] for lv in cur["levels"]])
            return res

        def token(rid, tok):
            events.append((rid, tok))
            if on_token is not None:
                on_token(rid, tok)

        emt_linear.quant_levels = levels
        lm.chunk_step, lm.decode_step = chunk_step, decode_step
        eng._book_draft_step, eng.step, eng.on_token = (book_draft,
                                                        traced_step, token)
        try:
            yield
        finally:
            emt_linear.quant_levels = quant
            lm.chunk_step, lm.decode_step = chunk, decode
            eng._book_draft_step, eng.step, eng.on_token = (book, step,
                                                            on_token)

    def _engine_spec(self, paged):
        """The speculative engine at gemma3-1b's published widths, cut to
        SPEC_LAYERS (all-global, analog on the default cell, per-row DAC,
        frozen noise, batch 4, block 16, built through
        ServeSpec(draft_placement="sram_digital", spec_k=4, temperature=0))
        against the plain engine of the same spec on 6 staggered requests.
        Launches exact from the round log: K3 7 L + 1 a model step (verify,
        draft chunk and draft decode alike), K2 L a
        verify step on the paged layout (its 5-lane query chunk), no K1 (the
        target never runs a decode step; the draft's cache is contiguous).
        The three ledger invariants at rtol 1e-6.  Tokens equal to the plain
        engine's up to each request's first differing one, and the logits
        of every token up to it within POISSON_LOGIT_TOL (_schedule_gap:
        the verify runs K3's tensor-core kernel where plain decode runs its
        GEMV, ROADMAP Queue 3).  Then one full round (four draft decodes
        and the verify) timed and its verify step profiled (paged only: the
        contiguous one differs in the attention alone), and every kernel
        call of a round of one
        draft decode (K3's GEMV at sigma 0) and the verify (K3 on the
        tensor cores at M = 20, K2 at C = 5 on the paged layout) against
        its plain version."""
        import numpy as np
        torch = self.torch
        L = self.spec_cfg.num_layers
        layout = "paged" if paged else "contiguous"
        label = f"speculative {layout}"
        plain_spec = self._serve_spec(paged=paged, batch_size=BATCH,
                                      block_size=BLOCK, max_len=MAX_LEN,
                                      prefill_chunk=CHUNK)
        spec = plain_spec.replace(draft_placement="sram_digital",
                                  spec_k=SPEC_K)
        runs = {}
        for name, sp in (("plain", plain_spec), ("speculative", spec)):
            eng = sp.build_engine(self.spec_cfg, self.params, torch_device=self.dev)
            traced = {}
            log = dict.fromkeys(("verify", "draft chunk", "draft decode",
                                 "catch-up rows"), 0)
            steps = {"chunk_step": 0, "decode_step": 0}
            self.sync()
            torch.cuda.reset_peak_memory_stats()
            counters = self._reset_launches()
            t0 = time.perf_counter()
            if name == "plain":
                with self._counting_steps(steps), \
                        self._token_trace(eng, traced):
                    res = eng.serve(self._spec_requests(), stagger=2)
                    self.sync()
            else:
                with self._spec_trace(eng, traced, log):
                    res = eng.serve(self._spec_requests(), stagger=2)
                    self.sync()
            wall = time.perf_counter() - t0
            launches = {n: w.launches for n, w in counters.items()}
            m = eng.metrics()
            ntok = sum(len(r.tokens) for r in res)
            runs[name] = dict(eng=eng, res=res, traced=traced, log=log,
                              launches=launches, m=m, wall=wall, ntok=ntok,
                              steps=steps,
                              peak=torch.cuda.max_memory_allocated())
        base, sp = runs["plain"], runs["speculative"]
        eng, m, log, launches = sp["eng"], sp["m"], sp["log"], sp["launches"]
        n_steps = log["verify"] + log["draft chunk"] + log["draft decode"]
        print(f"  {label}: round log: {log['verify']} verify steps (rounds), "
              f"{log['draft decode']} draft decodes, {log['draft chunk']} "
              f"draft chunks ({log['catch-up rows']} catch-up rows), "
              f"{m['spec_rounds']} slot rounds; engine steps {m['steps']} "
              f"(draft {m['draft_steps']}); launches {launches}")
        self.check(n_steps == m["steps"] and m["draft_steps"]
                   == log["draft chunk"] + log["draft decode"]
                   and log["verify"] > 0 and log["draft decode"] > 0,
                   f"{label}: round log {log} against metrics steps "
                   f"{m['steps']}, draft {m['draft_steps']}")
        want = {"emt_matmul": (7 * L + 1) * n_steps,
                "paged_prefill": L * log["verify"] if paged else 0,
                "paged_attention_decode": 0, "paged_attention": 0,
                "emt_bitserial": 0, "emt_matmul_int8": 0}
        for n, k in want.items():
            self.check(launches[n] == k, f"{label}: {n} launched "
                       f"{launches[n]} times, want {k} (round log {log})")
        res = sp["res"]
        total = m["total_energy_pj"]
        corners = m["corner_energy_pj"]
        dsum = sum(r.draft_energy_pj for r in res)
        inv = {
            "per-request + idle == total": (
                sum(r.energy_pj for r in res) + m["idle_energy_pj"], total),
            "corners == total": (sum(corners.values()), total),
            "draft per-request + draft idle == draft total": (
                dsum + m["draft_idle_energy_pj"], m["draft_total_energy_pj"]),
            "draft total == corner sram_digital": (
                m["draft_total_energy_pj"], corners.get("sram_digital", 0.0))}
        for what, (a, b) in inv.items():
            ok = bool(np.isclose(a, b, rtol=1e-6))
            print(f"  {label}: {what}: {a:.9g} vs {b:.9g} ({ok})")
            self.check(ok, f"{label}: {what}: {a} vs {b}")
        ref = {r.rid: r.tokens for r in base["res"]}
        differ = {r.rid: int(np.argmin(np.append(
            r.tokens == ref[r.rid][:len(r.tokens)], False)))
            for r in res if not np.array_equal(r.tokens, ref[r.rid])}
        for r in res:
            self.check(r.done_reason == "max_new"
                       and len(r.tokens) == SPEC_MAX_NEW,
                       f"{label}: rid {r.rid} {r.done_reason} "
                       f"{len(r.tokens)} tokens")
        toks = {r.rid: r.tokens for r in res}
        firsts = {rid: (i, int(toks[rid][i]), int(ref[rid][i]))
                  for rid, i in differ.items()}
        print(f"  {label} vs the plain engine: {len(differ)} of {len(res)} "
              f"requests differ {firsts} (rid: first index, speculative "
              f"token, plain token)")
        gap = self._schedule_gap(res, differ, sp["traced"], base["traced"],
                                 7 * L + 1, label=label, probe=(0, 1))
        per = {}
        for name, run in runs.items():
            c = run["m"]["corner_energy_pj"]
            per[name] = dict(
                traced_tok_s=run["ntok"] / run["wall"],
                traced_wall_s=run["wall"],
                tokens=run["ntok"], steps=run["m"]["steps"],
                uj_per_token=run["m"]["total_energy_pj"] * 1e-6
                / run["ntok"],
                analog_uj_per_token=c.get("analog", 0.0) * 1e-6
                / run["ntok"],
                peak_gib=run["peak"] / 2**30)
            print(f"  {label}, {name} engine: {run['ntok']} tokens in "
                  f"{run['wall']:.3f} s (traced, no warm-up run) -> "
                  f"{per[name]['traced_tok_s']:.2f}"
                  f" tok/s, {run['m']['steps']} steps; analog "
                  f"{per[name]['analog_uj_per_token']:.4f} uJ/token, total "
                  f"{per[name]['uj_per_token']:.4f} uJ/token; peak device "
                  f"memory {per[name]['peak_gib']:.2f} GiB")
        print(f"  {label}: accept rate {eng.accept_rate:.4f}, accepted-"
              f"length histogram {eng.accept_len_hist.tolist()}, draft "
              f"energy {m['draft_total_energy_pj'] * 1e-6:.4f} uJ "
              f"({100 * m['draft_total_energy_pj'] / total:.2f}% of total)")
        key = f"spec_{layout}_launches"
        for n in ("paged_prefill", "emt_matmul"):
            self.records[n][key] = launches[n]
        self.spec_summaries[label] = dict(
            speculative=per["speculative"], plain=per["plain"],
            accept_rate=eng.accept_rate,
            accept_len_hist=eng.accept_len_hist.tolist(),
            draft_uj=m["draft_total_energy_pj"] * 1e-6, round_log=log,
            differ=len(differ), logit_gap=gap)
        if paged:                       # the contiguous round's is alike
            self.spec_summaries[label].update(
                self._profile_verify(spec, label, paged))
        self._spec_round_vs_plain(spec, label, paged)

    def _round_engine(self, spec, drafts=SPEC_K):
        """A fresh speculative engine whose next step is a round of
        `drafts` draft decode steps and the verify (one 5-lane chunk step):
        4 requests of 5-token prompts admitted and prefilled through one
        verify chunk, each with `drafts` + 2 tokens to generate (the round
        drafts at most remaining - 1)."""
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        eng = spec.build_engine(self.spec_cfg, self.params, torch_device=self.dev)
        rng = np.random.default_rng(SEED + 19)
        for _ in range(BATCH):
            eng.submit(GenRequest(prompt=rng.integers(
                0, self.cfg.vocab_size, SPEC_K + 1).astype(np.int32),
                max_new=drafts + 2))
        eng.step()
        return eng

    def _profile_verify(self, spec, label, paged):
        """One round (4 draft decodes and the verify) timed on the host,
        untraced; then its verify chunk step replayed under torch.profiler
        (device_ms): the step's device busy time and K3's (tensor cores,
        M = 20) and K2's (C = 5) share of it.  The replay writes the same
        K/V rows the verify wrote, so it can repeat; a draft decode's K3 is
        the K3 phase's decode step."""
        from repro_torch.models import lm
        eng = self._round_engine(spec)
        chunk, seen = lm.chunk_step, []

        def capture(*args, **kw):
            if kw.get("all_lanes"):
                seen.append((args, kw))
            return chunk(*args, **kw)

        self.sync()
        t0 = time.perf_counter()
        lm.chunk_step = capture
        try:
            eng.step()
            self.sync()
        finally:
            lm.chunk_step = chunk
        wall = (time.perf_counter() - t0) * 1e3
        self.check(len(seen) == 1, f"{label}: {len(seen)} verify steps in "
                   f"a round")
        args, kw = seen[0]
        groups = {"busy": "", "k3": ("emt_matmul", "emt_matmul_tc",
                                     "split_sum")}
        if paged:
            groups["k2"] = "paged_prefill"
        got = device_ms(lambda: chunk(*args, **kw), groups,
                        need="paged_prefill" if paged else "emt_matmul_tc")
        print(f"  {label}: one round (4 draft decodes + the verify): wall "
              f"{wall:.1f} ms untraced; its verify step: device busy "
              f"{fmt(got['busy'])}, of it K3 {fmt(got['k3'])}"
              + (f" and K2 {fmt(got['k2'])}" if paged else ""))
        return dict(round_wall_ms=wall, verify_device_ms=got["busy"],
                    verify_k3_device_ms=got["k3"],
                    verify_k2_device_ms=got.get("k2"))

    def _spec_round_vs_plain(self, spec, label, paged):
        """Every kernel call of a round of one draft decode step (K3's GEMV
        at sigma 0) and the verify (K3 on the tensor cores at M = 20, K2 at
        C = 5 on the paged layout) held to its plain version."""
        L = self.spec_cfg.num_layers
        eng = self._round_engine(spec, drafts=1)
        log = dict.fromkeys(("verify", "draft chunk", "draft decode",
                             "catch-up rows"), 0)
        expect = {}

        def run(cfg):
            with self._spec_trace(eng, {}, log):
                eng.step()
            n = log["verify"] + log["draft chunk"] + log["draft decode"]
            expect.update(emt_matmul=(7 * L + 1) * n,
                          paged_prefill=L * log["verify"] if paged else 0)

        self._calls_vs_plain(self.spec_cfg, f"{label} round", expect, run)
        print(f"  {label} round: model steps checked {log}")
        self.check(log["verify"] == 1 and log["draft decode"] == 1,
                   f"{label} round: {log}")

    def engine_speculative_paged(self):
        self._engine_spec(True)

    def engine_speculative_contiguous(self):
        self._engine_spec(False)

    def engine_int8(self):
        """Phase 4's analog requests (paged, all-global) on the int8 tree
        (quantize_tree_for_serving, store_int8=True): 182 int8 K3 launches
        and 1 float32 K3 launch (the tied unembed) a step; the weight bytes
        against the float32 tree's, peak memory against phase 4's; every K3
        call of a chunk and a decode step against its plain version; the
        logits against the float32 engine's within 1e-3 at the 24-bit DAC
        (they differ at most by the float path's STE form w + (q s - w)
        against q s), the 8-bit gap reported."""
        import numpy as np
        L = self.cfg.num_layers
        cfg_q = self.cfg.replace(emt=self.cfg.emt.replace(store_int8=True))

        def nbytes(tree):
            return sum(t.numel() * t.element_size() for _, t in _flat(tree))

        fb, qb = nbytes(self.params), nbytes(self.params_q)
        print(f"  int8: weights {fb / 1e9:.3f} GB in float32, {qb / 1e9:.3f} "
              f"GB as int8 levels + scales (the tied embedding table, "
              f"{self.params['embed']['table'].numel() * 4 / 1e9:.3f} GB, "
              f"stays float32)")
        summary, launches, m, results = self._serve(cfg_q, self.params_q,
                                                    "int8", 1)
        self._check_launches("int8", launches, m["steps"], {
            "emt_matmul_int8": 7 * L, "emt_matmul": 1,
            "emt_matmul_tc": None,
            "paged_attention_decode": None, "paged_prefill": None,
            "emt_bitserial": 0, "paged_attention": 0})
        self.records["emt_matmul_int8"]["launches"] = \
            launches["emt_matmul_int8"]
        same = sum(np.array_equal(a.tokens, b.tokens) for a, b in
                   zip(self.engine_results, results))
        f32 = self.engine_summary
        print(f"  int8 engine vs the float32 engine (phase 4): peak device "
              f"memory {summary['peak_gib']:.2f} GiB against "
              f"{f32['peak_gib']:.2f} (both trees resident), of it above "
              f"the resident trees and caches "
              f"{summary['peak_above_resident_gib']:.4f} GiB against "
              f"{f32['peak_above_resident_gib']:.4f}; device busy of the "
              f"profiled steps (chunk, decode) "
              f"{summary['step_busy_ms']} ms against {f32['step_busy_ms']}; "
              f"{same} of {len(results)} requests' tokens identical")
        summary.update(weight_gb_f32=fb / 1e9, weight_gb_int8=qb / 1e9,
                       same_tokens_as_f32=int(same))
        self.int8_summary = summary
        self._calls_vs_plain(cfg_q, "int8", {
            "emt_matmul_int8": 3 * 7 * L, "emt_matmul": 3,
            "paged_attention_decode": L, "paged_prefill": 2 * L},
            lambda c: self._step_pair(c, self.params_q))
        for bits, limit in ((24, 1e-3), (8, None)):
            self.__dict__.pop("_tokens", None)
            cq = cfg_q.replace(emt=_dac_bits(cfg_q.emt, bits))
            cf = self.cfg.replace(emt=_dac_bits(self.cfg.emt, bits))
            a = self._run_path(cq, lambda c: self._step_pair(c,
                                                             self.params_q))
            b = self._run_path(cf, self._step_pair)
            self._compare(f"int8, {bits}-bit DAC: int8 vs float32 weights",
                          a, b, limit=limit)
            exact = all(x is None or self.torch.equal(x, y)
                        for (_, x, _), (_, y, _) in zip(a, b))
            print(f"  int8, {bits}-bit DAC: logits bit-identical to the "
                  f"float32 path's: {exact}")
        # no later phase reads the int8 tree: drop it before the larger
        # stacks of phases 10-12
        self.__dict__.pop("params_q", None)
        self.torch.cuda.empty_cache()

    # -- phase 10: mixture of experts ------------------------------------------
    def engine_moe(self):
        """moonshot-v1-16b-a3b at published widths, cut to MOE_LAYERS, on
        the mixed placement (attention analog on PCM; the routers on SRAM
        through K3 at N = 64; the experts technique A on RRAM through K3's
        experts entry, 3 launches a layer; the unembed analog on PCM),
        paged, chunked, batch 4: per step 5 L + 1 K3 and 3 L expert
        launches, K1 or K2 on attention, no K5."""
        from repro_torch.models import lm
        from repro_torch.serve.spec import build_config
        self.moe = build_config(MOE_ARCH, smoke=False, placement="mixed",
                                a_per_row=True,
                                model_overrides={"num_layers": MOE_LAYERS})
        cfg = self.moe
        t0 = time.perf_counter()
        self.moe_params = lm.init_model_params(cfg, SEED, device=self.dev)
        self.sync()
        n = sum(p.numel() for _, p in _flat(self.moe_params))
        print(f"model: {MOE_ARCH} published widths, {cfg.num_layers} of 48 "
              f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
              f"{cfg.head_dim} (kv {cfg.num_kv_heads}), {cfg.num_experts} "
              f"experts top-{cfg.experts_per_token} of d_ff {cfg.moe_d_ff}, "
              f"vocab {cfg.vocab_size}, untied lm_head: {n:,} parameters "
              f"(f32, {4 * n / 1e9:.2f} GB), init "
              f"{time.perf_counter() - t0:.2f} s")
        plan = {}
        for _, corner, mode in cfg.placement_plan():
            plan[(corner, mode)] = plan.get((corner, mode), 0) + 1
        print(f"  moe placement: {plan} sites per (corner, mode)")
        L = cfg.num_layers
        summary, launches, m, _ = self._serve(cfg, self.moe_params,
                                              "moe mixed", 1)
        self._check_launches("moe mixed", launches, m["steps"], {
            "emt_matmul": 5 * L + 1, "emt_matmul_experts": 3 * L,
            "paged_attention_decode": None, "paged_prefill": None,
            "emt_bitserial": 0, "paged_attention": 0, "emt_matmul_int8": 0})
        self.check(set(m["corner_energy_pj"]) == {"pcm", "rram",
                                                  "sram_digital"},
                   f"moe corners {sorted(m['corner_energy_pj'])}")
        self.records["emt_matmul_experts"] = dict(
            launches=launches["emt_matmul_experts"])
        self.moe_summary = summary

    def moe_calls_vs_plain(self):
        """A history chunk step, a chunk step (64 lanes: expert capacity 8)
        and a decode step (4 rows: capacity 4) of the MoE path: every K3
        call (21 a step), every expert call (12 a step) with its two
        statistics, every K1 and K2 call against its plain version on the
        model's activations; then the experts entry timed on the decode
        step's 12 calls."""
        L = self.moe.num_layers
        self.__dict__.pop("_tokens", None)
        self._calls_vs_plain(self.moe, "moe mixed", {
            "emt_matmul": 3 * (5 * L + 1), "emt_matmul_experts": 3 * 3 * L,
            "paged_attention_decode": L, "paged_prefill": 2 * L},
            lambda c: self._step_pair(c, self.moe_params))
        self._time_experts()

    def _time_experts(self):
        """K3's experts entry on the decode step's 12 calls (the real
        inputs and quantized stacks, M = 4), and on the same stacks at the
        chunk step's M = 8 (random inputs): event time, device time, the
        plain version, torch.bmm on the pre-noised stacks (a yardstick the
        port never calls; event and device time) and the bound."""
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import noisy_experts
        from repro_torch.models.moe import capacity
        torch = self.torch
        cfg = self.moe
        cap = capacity(cfg, BATCH)                    # a decode step's rows
        orig = ops._emt_matmul_experts
        calls = []

        def capture(x, w, sig, **kw):
            if x.shape[1] == cap and len(calls) < 3 * cfg.num_layers:
                calls.append((x, w, sig, kw))
            return orig(x, w, sig, **kw)

        self.__dict__.pop("_tokens", None)
        with self._ops_through(_emt_matmul_experts=capture):
            self._step_pair(self.moe, self.moe_params)
        self.check(len(calls) == 3 * cfg.num_layers,
                   f"captured {len(calls)} decode-step expert calls")
        gen = torch.Generator(device=self.dev).manual_seed(3)
        xs = [x for x, *_ in calls]
        xc = [torch.randn((x.shape[0], capacity(cfg, BATCH * CHUNK),
                           x.shape[2]), generator=gen, device=self.dev)
              for x in xs]
        worst = 0.0
        for x, w, sig, kw in calls:
            y, _, _ = k3.emt_matmul_experts(x, w, sig, **kw)
            worst = max(worst, rel_err(y, k3.plain_experts(
                x, w, sig, **kw)[0])[0])
        noisy = [noisy_experts(w, sig, **kw) for _, w, sig, kw in calls]

        def run(fn, inputs):
            for x, (_, w, sig, kw) in zip(inputs, calls):
                fn(x, w, sig, **kw)

        def run_library(inputs):
            for x, wn in zip(inputs, noisy):
                torch.bmm(x, wn)

        def step_bound(inputs):
            """Bytes (x, the stack and y once, the two statistics), FP32
            FLOPs and the hash's and select's operations once per weight
            element (HASH_OPS["K3"]; the statistics' float64 add and max
            per element run on other pipes and are not counted)."""
            nbytes = flops = elements = 0
            for x, (_, w, *_) in zip(inputs, calls):
                E, M, K = x.shape
                N = w.shape[2]
                nbytes += 4 * (E * M * K + E * K * N + E * M * N) + 8
                flops += 2 * E * M * K * N
                elements += E * K * N
            alu, fma = hash_ops("K3", elements)
            return bound(nbytes, flops, alu, fma), nbytes, alu

        keys = ("emt_matmul", "emt_matmul_tc", "emt_experts_tc", "split_sum",
                "stats_finish")
        ms = cuda_time(lambda: run(k3.emt_matmul_experts, xs), 5)
        lib_ms = cuda_time(lambda: run_library(xs), 5)
        chunk_ms = cuda_time(lambda: run(k3.emt_matmul_experts, xc), 3)
        chunk_lib_ms = cuda_time(lambda: run_library(xc), 3)
        dev_ms = device_ms(lambda: run(k3.emt_matmul_experts, xs), keys,
                           agree=True)
        chunk_dev_ms = device_ms(lambda: run(k3.emt_matmul_experts, xc),
                                 keys, agree=True)
        lib_dev_ms = device_ms(lambda: run_library(xs), "", agree=True)
        chunk_lib_dev_ms = device_ms(lambda: run_library(xc), "", agree=True)
        del noisy
        plain_ms = cuda_time(lambda: run(k3.plain_experts, xs), 2, warmup=1)
        (b_ms, by, term), nbytes, alu = step_bound(xs)
        (cb_ms, _, cterm), _, _ = step_bound(xc)
        L = cfg.num_layers
        self.records["emt_matmul_experts"].update(
            name="emt_matmul_experts", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_matmul.cu",
            replaces="src/repro/kernels/emt_matmul.py:57",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, chunk_ms=chunk_ms,
            chunk_device_ms=chunk_dev_ms, chunk_bound_ms=cb_ms,
            chunk_bound_term=cterm,
            chunk_library_ms=chunk_lib_ms,
            chunk_library_device_ms=chunk_lib_dev_ms)
        p = [k3.plan(x.shape[1], w.shape[2], x.shape[2], self.sms, True,
                     experts=x.shape[0]) for x, w, *_ in calls[:3]]
        print(f"  K3 experts per decode step ({len(calls)} calls, E "
              f"{xs[0].shape[0]}, M={cap}; plans {[(q.splits, q.ctas) for q in p]} "
              f"(slabs, CTAs) for wg, wu, wd): kernel {ms:.3f} ms (device "
              f"time {fmt(dev_ms)}; per MoE layer {ms / L:.3f} ms, device "
              f"{fmt(None if dev_ms is None else dev_ms / L)}), plain "
              f"{plain_ms:.3f} ms, torch.bmm on pre-noised stacks "
              f"{lib_ms:.3f} ms (device time {fmt(lib_dev_ms)}), bound "
              f"{b_ms:.3f} ms ({term}; "
              f"{nbytes / 1e9:.3f} GB, {alu / 1e9:.3f} G ALU-pipe ops; per "
              f"layer {b_ms / L:.3f} ms), roofline share "
              f"{100 * b_ms / ms:.2f}% of the event time, "
              f"{share(b_ms, dev_ms)} of the device time; max |diff| vs "
              f"plain {worst:.3e}")
        print(f"  K3 experts at the chunk step's M="
              f"{xc[0].shape[1]} (the same stacks): kernel {chunk_ms:.3f} ms "
              f"(device time {fmt(chunk_dev_ms)}), torch.bmm on pre-noised "
              f"stacks {chunk_lib_ms:.3f} ms (device time "
              f"{fmt(chunk_lib_dev_ms)}), bound {cb_ms:.3f} ms "
              f"({cterm}), share of the device time "
              f"{share(cb_ms, chunk_dev_ms)}")

    def moe_logits_vs_plain(self):
        """The MoE path's logits against its plain path at the 24-bit DAC
        (limit 1e-3) with every corner's noise on, the 8-bit gaps
        reported; then the MoE weights are dropped."""
        self._logits_vs_plain(self.moe, "moe mixed",
                              lambda c: self._step_pair(c, self.moe_params),
                              quiet=False)
        self.__dict__.pop("moe_params", None)
        self.torch.cuda.empty_cache()

    # -- phase 11: the recurrent stacks ---------------------------------------
    def _sites(self, cfg):
        """(K3, K5, expert K3) launches of one model step on `cfg`: its
        analog and bit-serial projections and three expert launches a MoE
        layer (the experts read in analog, whatever their rule)."""
        plan = cfg.placement_plan()
        experts = [p for p, _, _ in plan if p.endswith("/moe/experts")]
        rest = [m for p, _, m in plan if not p.endswith("/moe/experts")]
        return rest.count("analog"), rest.count("bitserial"), 3 * len(experts)

    def _arch_model(self, cfg, label, arch, depth):
        from repro_torch.models import lm
        t0 = time.perf_counter()
        params = lm.init_model_params(cfg, SEED, device=self.dev)
        self.sync()
        n = sum(p.numel() for _, p in _flat(params))
        print(f"model: {arch} {label}, {cfg.num_layers} of {depth} layers "
              f"{cfg.blocks()}, d_model {cfg.d_model}, vocab "
              f"{cfg.vocab_size}: {n:,} parameters (f32, {4 * n / 1e9:.2f} "
              f"GB), init {time.perf_counter() - t0:.2f} s")
        return params

    def engine_xlstm(self):
        """xlstm-350m at full width, analog (every projection technique A
        on the default cell, through K3), batch 4, contiguous (a stack
        without attention has nothing to page), the legacy bucketed prefill
        (the engine's only one for recurrent stacks): 166 K3 launches per
        admission and per decode step (21 mLSTM blocks x 7, 3 sLSTM x 6,
        the tied unembed), an admission's blocks (M = 32 or 64) on the
        tensor-core kernel and its unembed (the last position) and the
        decode steps' on the GEMV; no K1, K2, K4, K5.  Prompts
        of XLSTM_PROMPTS (at most 64 tokens: the reference's mLSTM NaN at a
        128-position chunk)."""
        from repro_torch.serve.spec import build_config
        self.xlstm = cfg = build_config(XLSTM_ARCH, "analog", smoke=False,
                                        a_per_row=True)
        self.xlstm_params = self._arch_model(cfg, "full width",
                                                  XLSTM_ARCH, 24)
        k3, k5, ex = self._sites(cfg)
        self.check((k3, k5, ex) == (166, 0, 0),
                   f"xlstm sites {(k3, k5, ex)}, want (166, 0, 0)")
        summary, launches, m, results = self._serve(
            cfg, self.xlstm_params, "xlstm analog", 1, paged=False,
            prompts=XLSTM_PROMPTS)
        steps, admitted = m["steps"], len(results)
        self._check_launches("xlstm analog", launches, steps, {
            "paged_attention_decode": 0, "paged_attention": 0,
            "paged_prefill": 0, "emt_bitserial": 0, "emt_matmul_experts": 0,
            "emt_matmul_int8": 0})
        self.check(launches["emt_matmul"] == k3 * (admitted + steps)
                   and launches["emt_matmul_tc"] == (k3 - 1) * admitted,
                   f"xlstm: K3 launched {launches['emt_matmul']} times "
                   f"({launches['emt_matmul_tc']} on the tensor cores) for "
                   f"{admitted} admissions and {steps} decode steps, want "
                   f"{k3} each ({k3 - 1} an admission on the tensor cores)")
        for name in ("emt_matmul", "emt_matmul_tc"):
            self.records.setdefault(name, {})["xlstm_launches"] = \
                launches[name]
        self.xlstm_summary = summary

    def engine_jamba(self):
        """jamba-v0.1-52b at published widths cut to JAMBA_LAYERS, on the
        mixed placement, paged, batch 4, the legacy bucketed prefill: per
        admission and per decode step 19 K3 (the mamba layers' in, xp, dt
        and out projections, the attention layer's four, the two routers
        on SRAM, the unembed on PCM), 6 expert K3 (wg, wu, wd of the two
        MoE layers, RRAM's rule read in analog) and 6 K5 (the dense MLPs
        of layers 0 and 2, bit-serial on RRAM); one K1 per decode step
        (the attention layer), no K2 (no chunked prefill), no K4.  The
        128-token buckets run the experts at 20 rows (the experts'
        tensor-core kernel)."""
        from repro_torch.serve.engine import prefill_bucket
        from repro_torch.serve.spec import build_config
        self.jamba = cfg = build_config(
            JAMBA_ARCH, smoke=False, placement="mixed", a_per_row=True,
            model_overrides={"num_layers": JAMBA_LAYERS})
        self.jamba_params = self._arch_model(
            cfg, f"published widths ({cfg.num_heads} heads of "
            f"{cfg.head_dim}, kv {cfg.num_kv_heads}; {cfg.num_experts} "
            f"experts top-{cfg.experts_per_token} of {cfg.moe_d_ff}; d_inner "
            f"{cfg.d_inner}, state {cfg.ssm_state}, dt_rank {cfg.dt_rank})",
            JAMBA_ARCH, 32)
        k3, k5, ex = self._sites(cfg)
        self.check((k3, k5, ex) == (19, 6, 6),
                   f"jamba sites {(k3, k5, ex)}, want (19, 6, 6)")
        buckets = sorted(prefill_bucket(len(r.prompt)) for r in
                         self._requests(cfg, prompts=JAMBA_PROMPTS))
        print(f"  jamba admission buckets {buckets}")
        self.check(128 in buckets, f"no 128-token bucket in {buckets}")
        summary, launches, m, results = self._serve(
            cfg, self.jamba_params, "jamba mixed", 1,
            prompts=JAMBA_PROMPTS, max_len=JAMBA_MAX_LEN)
        steps, admitted = m["steps"], len(results)
        self._check_launches("jamba mixed", launches, steps, {
            "paged_attention_decode": 1, "paged_attention": 0,
            "paged_prefill": 0, "emt_matmul_int8": 0})
        n = admitted + steps
        for name, per in (("emt_matmul", k3), ("emt_matmul_experts", ex),
                          ("emt_bitserial", k5)):
            self.check(launches[name] == per * n,
                       f"jamba: {name} launched {launches[name]} times for "
                       f"{admitted} admissions and {steps} decode steps, "
                       f"want {per} each")
        self.check(set(m["corner_energy_pj"]) == {"pcm", "rram",
                                                  "sram_digital"},
                   f"jamba corners {sorted(m['corner_energy_pj'])}")
        for name in ("emt_matmul", "emt_matmul_tc", "emt_matmul_experts",
                     "emt_bitserial", "paged_attention_decode"):
            self.records.setdefault(name, {})["jamba_launches"] = \
                launches[name]
        self.jamba_summary = summary

    def _recurrent_steps(self, cfg, params, prompts, max_len, paged):
        """The recurrent paths' model steps: batch-1 legacy prefills of
        `prompts` ((prompt length, bucket) pairs, left-padded as the engine
        pads) copied into slots 0-2 (state rows; jamba's K/V into its
        blocks through ``paged_insert``), then one decode step at batch 4
        with slot 3 idle.  Returns [(step, logits, projections it
        quantizes)] in call order."""
        import numpy as np
        from repro_torch.models import lm
        from repro_torch.models.context import Ctx
        from repro_torch.serve.engine import paged_insert, view_bucket
        from repro_torch.serve.kv_pool import PagedKV
        torch = self.torch
        recurrent = lm.recurrent_layers(cfg)
        n = sum(1 for path, _, mode in cfg.placement_plan()
                if mode != "fp32" and not path.endswith("/moe/experts"))
        if paged:
            nb = BATCH * -(-max_len // BLOCK)
            kv = PagedKV(BATCH, max_len, BLOCK, nb)
            cache = lm.init_paged_cache(cfg, BATCH, max_len, BLOCK, nb,
                                        device=self.dev)
        else:
            self.check(len(recurrent) == cfg.num_layers,
                       "a contiguous step holds state rows only")
            cache = lm.init_cache(cfg, BATCH, max_len, device=self.dev)
        rng = np.random.default_rng(7)
        pos = np.zeros(BATCH, np.int64)
        out, first = [], []
        for slot, (plen, S) in enumerate(prompts):
            toks = np.zeros((1, S), np.int64)
            toks[0, S - plen:] = rng.integers(0, cfg.vocab_size, plen)
            small = lm.init_cache(cfg, 1, max_len, device=self.dev)
            small, logits, _ = lm.prefill(
                params, {"tokens": torch.as_tensor(toks, device=self.dev)},
                cfg, Ctx(seed=SEED), small)
            if paged:
                self.check(kv.admit(slot, S, MAX_NEW), "admission refused")
                paged_insert(cache, small, *kv.scatter_rows(slot), slot=slot,
                             recurrent=recurrent)
                kv.ensure(slot, S)
            else:
                for name, blk in cache.items():
                    for key, t in blk.items():
                        t[slot] = small[name][key][0]
            pos[slot] = S
            first.append(logits)
            out.append((f"prefill (bucket {S})", logits, n))
        tok = np.zeros(BATCH, np.int64)
        tok[:len(first)] = self._first_tokens(torch.cat(first))
        tok, pos_d = (torch.as_tensor(a, device=self.dev) for a in (tok, pos))
        kw = {}
        if paged:
            view = view_bucket(int(pos.max()) + 1, BLOCK, max_len)
            kw = dict(page_tables={"global": torch.as_tensor(
                kv.gather_tables()[0][:, :view // BLOCK],
                device=self.dev).contiguous()},
                page_lens=lm.clamped_lens(lm.paged_lens(cfg, max_len), view))
        ld, _, _ = lm.decode_step(params, cache, tok, pos_d, cfg,
                                  Ctx(seed=SEED), active=pos_d > 0, **kw)
        out.append(("decode step (batch 4, one idle row)", ld, n))
        return out

    def _xlstm_steps(self, cfg):
        return self._recurrent_steps(cfg, self.xlstm_params, XLSTM_STEPS,
                                     MAX_LEN, paged=False)

    def _jamba_steps(self, cfg, steps=JAMBA_STEPS):
        return self._recurrent_steps(cfg, self.jamba_params, steps,
                                     JAMBA_MAX_LEN, paged=True)

    def xlstm_calls_vs_plain(self):
        """Three prefills and a decode step: 166 K3 calls each (the
        prefills' on the tensor-core kernel at M = 16-64, among them the
        mLSTM gates' N = 4 and the sLSTM up projection's 2,816)."""
        self.__dict__.pop("_tokens", None)
        k3, _, _ = self._sites(self.xlstm)
        self._calls_vs_plain(self.xlstm, "xlstm analog", {
            "emt_matmul": (len(XLSTM_STEPS) + 1) * k3}, self._xlstm_steps)

    def xlstm_logits_vs_plain(self):
        """The logits of the three prefills and the decode step against
        the plain path at the 24-bit DAC (1e-3), the 8-bit gaps reported;
        then the xlstm weights are dropped."""
        self._logits_vs_plain(self.xlstm, "xlstm analog", self._xlstm_steps)
        self.__dict__.pop("xlstm_params", None)
        self.torch.cuda.empty_cache()

    def jamba_calls_vs_plain(self):
        """Three prefills (buckets 128, 64 and 16: the experts at 20, 12
        and 4 rows) and a decode step (4 rows): every K3 call (19 a step:
        mamba's x_proj 8,192 -> 288 and dt_proj 256 -> 8,192 among them),
        every expert call (6 a step) with its two statistics, every K5 call
        (6 a step) and the decode step's K1 call against their plain
        versions; then the experts entry timed above 16 rows."""
        self.__dict__.pop("_tokens", None)
        k3, k5, ex = self._sites(self.jamba)
        n = len(JAMBA_STEPS) + 1
        self._calls_vs_plain(self.jamba, "jamba mixed", {
            "emt_matmul": n * k3, "emt_matmul_experts": n * ex,
            "emt_bitserial": n * k5, "paged_attention_decode": 1},
            self._jamba_steps)
        self._time_experts_m20()

    def _time_experts_m20(self):
        """K3's experts entry above 16 rows: the three expert calls of one
        jamba MoE layer at a 128-token admission (E = 16, M = 20, wg/wu
        4,096 -> 14,336 and wd 14,336 -> 4,096 on the experts' tensor-core
        kernel), on their real inputs and quantized stacks: event time,
        device time, the plain version, torch.bmm on the pre-noised stacks
        (a yardstick the port never calls; event and device time) and the
        bound.  Where the profiler's trace of a run loses events (a device
        time under the bytes bound), the device time is the event time of
        the run captured once as a CUDA graph and replayed (no host
        dispatch between its kernels); both are printed for the kernel and
        the yardstick.  One layer's stacks (11.3 GB quantized, as much
        again pre-noised) are held at a time."""
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import noisy_experts
        from repro_torch.models.moe import capacity
        torch = self.torch
        cfg = self.jamba
        rows = capacity(cfg, 128)
        orig = ops._emt_matmul_experts
        calls = []

        def capture(x, w, sig, **kw):
            if x.shape[1] == rows and len(calls) < 3:
                calls.append((x, w, sig, kw))
            return orig(x, w, sig, **kw)

        self.__dict__.pop("_tokens", None)
        with self._ops_through(_emt_matmul_experts=capture):
            self._jamba_steps(cfg)
        self.check(rows == 20 and len(calls) == 3,
                   f"captured {len(calls)} expert calls at M = {rows}")
        xs = [x for x, *_ in calls]
        worst = 0.0
        for x, w, sig, kw in calls:
            y, _, _ = k3.emt_matmul_experts(x, w, sig, **kw)
            worst = max(worst, rel_err(y, k3.plain_experts(
                x, w, sig, **kw)[0])[0])
        plain_ms = cuda_time(lambda: [k3.plain_experts(x, w, sig, **kw)
                                      for x, w, sig, kw in calls], 1,
                             warmup=1)
        noisy = [noisy_experts(w, sig, **kw) for _, w, sig, kw in calls]

        def run():
            for x, w, sig, kw in calls:
                k3.emt_matmul_experts(x, w, sig, **kw)

        def run_library():
            for x, wn in zip(xs, noisy):
                torch.bmm(x, wn)

        nbytes = flops = elements = 0
        for x, w, *_ in calls:
            E, M, K = x.shape
            N = w.shape[2]
            nbytes += 4 * (E * M * K + E * K * N + E * M * N) + 8
            flops += 2 * E * M * K * N
            elements += E * K * N
        alu, fma = hash_ops("K3", elements)
        # the products on the tensor cores: four TF32 products (the
        # weight in three pieces, x in two), no FP32-pipe FLOPs
        b_ms, by, term = bound(nbytes, 0, alu, fma, tc=4 * flops)
        tc_ms = 4 * flops / TF32_FLOPS * 1e3
        keys = ("emt_experts_tc", "split_sum", "stats_finish", "emt_matmul")
        ms = cuda_time(run, 5)
        lib_ms = cuda_time(run_library, 5)
        dev_ms = device_ms(run, keys, agree=True)
        lib_dev_ms = device_ms(run_library, "", agree=True)
        replay_ms = graph_ms(run)
        lib_replay_ms = graph_ms(run_library)
        del noisy
        # a profiled device time under the bytes bound (3.35 TB/s), or
        # under 0.9 of the same work replayed back to back from a CUDA
        # graph, cannot be: the trace lost events (seen for the kernel and
        # the yardstick); the graph replay's time stands in
        src = {}
        for name, v, g in (("kernel", dev_ms, replay_ms),
                           ("torch.bmm", lib_dev_ms, lib_replay_ms)):
            src[name] = "profiler"
            if v is None or v < b_ms or (g is not None and v < 0.9 * g):
                src[name] = "graph replay" if g is not None else "none"
                print(f"  ({name}'s profiled device time, {fmt(v)}, is "
                      f"not measured (none, under the bytes bound "
                      f"{b_ms:.3f} ms or under 0.9 of the graph replay's "
                      f"{fmt(g)}: the trace lost events); the graph "
                      f"replay's stands in)")
        if src["kernel"] != "profiler":
            dev_ms = replay_ms
        if src["torch.bmm"] != "profiler":
            lib_dev_ms = lib_replay_ms
        p = [k3.plan(x.shape[1], w.shape[2], x.shape[2], self.sms, True,
                     experts=x.shape[0]) for x, w, *_ in calls]
        self.records.setdefault("emt_matmul_experts", {}).update(
            source_above_16="src/repro_torch/kernels/csrc/emt_experts_tc.cu",
            m20_layer_ms=ms, m20_layer_device_ms=dev_ms,
            m20_layer_device_source=src["kernel"],
            m20_layer_graph_ms=replay_ms,
            m20_layer_plain_ms=plain_ms, m20_layer_library_ms=lib_ms,
            m20_layer_library_device_ms=lib_dev_ms,
            m20_layer_library_device_source=src["torch.bmm"],
            m20_layer_library_graph_ms=lib_replay_ms, m20_layer_bound_ms=b_ms,
            m20_layer_bound_by=by, m20_layer_tc_ms=tc_ms,
            m20_max_abs_err=worst)
        print(f"  K3 experts above 16 rows, one jamba MoE layer at a "
              f"128-token admission (3 calls, E {xs[0].shape[0]}, M={rows}; "
              f"plans {[(q.splits, q.ctas) for q in p]} (slabs, CTAs) for "
              f"wg, wu, wd; the experts' tensor-core kernel): kernel "
              f"{ms:.3f} ms (device time {fmt(dev_ms)}, {src['kernel']}; "
              f"graph replay {fmt(replay_ms)}), plain {plain_ms:.3f} ms, "
              f"torch.bmm on pre-noised stacks {lib_ms:.3f} ms (device time "
              f"{fmt(lib_dev_ms)}, {src['torch.bmm']}; graph replay "
              f"{fmt(lib_replay_ms)}), bound {b_ms:.3f} ms ({term}; "
              f"{nbytes / 1e9:.3f} GB, {alu / 1e9:.3f} G ALU-pipe ops; four "
              f"TF32 products {tc_ms:.3f} ms), roofline share "
              f"{share(b_ms, ms)} of the event time, "
              f"{share(b_ms, dev_ms)} of the device time; max |diff| vs "
              f"plain {worst:.3e}")

    def jamba_logits_vs_plain(self):
        """The logits of the 128 and 16 buckets' prefills and the decode
        step (JAMBA_LOGIT_STEPS) against the plain path at the 24-bit
        DAC (limit 1e-3) with the bit-serial corner's read noise off (the
        MLPs on K5; the experts, whose rule is that corner, then read
        without noise), the run with it on and the 8-bit gaps reported;
        then the jamba weights are dropped."""
        self._logits_vs_plain(
            self.jamba, "jamba mixed",
            lambda c: self._jamba_steps(c, JAMBA_LOGIT_STEPS))
        self.__dict__.pop("jamba_params", None)
        self.torch.cuda.empty_cache()

    # -- phase 12: the five last architectures -------------------------------
    def engine_gemma2(self):
        """gemma2-9b at full published width, analog, paged, chunked
        prefill, batch 4, 6 requests of GEMMA2_MAX_NEW tokens: 295 K3 a
        step (42 layers x 7 and the tied unembed), K1 42 a decode step and
        K2 42 a chunk step (max_len 128 is below the 4,096 window: every
        layer pages through the global table), softcap 50 in both and 30
        on the logits; no K4, K5, int8 or expert K3."""
        from repro_torch.models import lm
        from repro_torch.serve.spec import build_config
        self.gemma2 = cfg = build_config(GEMMA2_ARCH, "analog", smoke=False,
                                         a_per_row=True)
        self.gemma2_params = self._arch_model(
            cfg, f"full width ({cfg.num_heads} heads over "
            f"{cfg.num_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, window "
            f"{cfg.sliding_window}, softcaps {cfg.attn_softcap:g} / "
            f"{cfg.final_softcap:g}, tied scaled embedding)", GEMMA2_ARCH, 42)
        k3, k5, ex = self._sites(cfg)
        L = cfg.num_layers
        self.check((k3, k5, ex, L) == (295, 0, 0, 42),
                   f"gemma2 sites {(k3, k5, ex)} over {L} layers, want "
                   f"(295, 0, 0) over 42")
        ring = lm.ring_layers(cfg, lm.paged_lens(cfg, MAX_LEN))
        print(f"  gemma2 blocks {cfg.blocks().count('local')} local, "
              f"{cfg.blocks().count('global')} global; max_len {MAX_LEN}: "
              f"layers paging through ring tables (lm.ring_layers): "
              f"{sorted(ring) or 'none'}")
        summary, launches, m, _ = self._serve(
            cfg, self.gemma2_params, "gemma2 analog", 1,
            max_new=GEMMA2_MAX_NEW)
        chunk, decode = summary["chunk_steps"], summary["decode_steps"]
        want = {"emt_matmul": k3 * m["steps"],
                "paged_attention_decode": L * decode,
                "paged_prefill": (L - len(ring)) * chunk,
                "paged_attention": 0, "emt_bitserial": 0,
                "emt_matmul_int8": 0, "emt_matmul_experts": 0}
        print(f"  gemma2 launches want {want} ({chunk} chunk and {decode} "
              f"decode steps)")
        for name, n in want.items():
            self.check(chunk + decode == m["steps"] and launches[name] == n,
                       f"gemma2: {name} launched {launches[name]} times, "
                       f"want {n} ({chunk} chunk and {decode} decode steps "
                       f"of {m['steps']})")
        for name in ("paged_attention_decode", "paged_prefill", "emt_matmul",
                     "emt_matmul_tc"):
            self.records.setdefault(name, {})["gemma2_launches"] = \
                launches[name]
        self.gemma2_summary = summary

    def gemma2_calls_vs_plain(self):
        """A history chunk step, a chunk step and a decode step (_step_pair):
        every K3 call (295 a step), K2 call (42 a chunk step) and K1 call
        (42, in float64) against its plain version."""
        self.__dict__.pop("_tokens", None)
        cfg, L = self.gemma2, self.gemma2.num_layers
        self._calls_vs_plain(cfg, "gemma2 analog", {
            "emt_matmul": 3 * 295, "paged_attention_decode": L,
            "paged_prefill": 2 * L},
            lambda c: self._step_pair(c, self.gemma2_params))

    def gemma2_logits_vs_plain(self):
        """The chunk and decode steps' logits against the plain path at the
        24-bit DAC (1e-3), the 8-bit gap and its level flips reported;
        then the gemma2 weights are dropped."""
        self._logits_vs_plain(
            self.gemma2, "gemma2 analog",
            lambda c: self._step_pair(c, self.gemma2_params), vs_f64=False)
        self.__dict__.pop("gemma2_params", None)
        self.torch.cuda.empty_cache()

    def _cut_steps(self, cfg, params):
        """One prefill and one decode step at batch 4 with row 3 idle, paged
        (max_len 128, block 16).  A stack that chunks: one chunk step of
        16, 9 and 16 tokens from position 0.  An M-RoPE or embeds stack
        (the legacy path): one legacy prefill of batch 3, a 32-token bucket
        (prompts of 32, 20 and 13 tokens, left-padded), scattered into
        slots 0-2; an embeds stack's prefill takes random embeddings (the
        engine serves all-zero ones, which give all-zero K/V and logits
        and would hold nothing; the seamless phase's encoder frames are
        random for the same reason).  Returns [(step, logits, projections
        it quantizes)]."""
        import numpy as np
        from repro_torch.models import lm
        from repro_torch.models.context import Ctx
        from repro_torch.serve.engine import (can_chunk, paged_insert,
                                              view_bucket)
        from repro_torch.serve.kv_pool import PagedKV
        torch = self.torch
        n = sum(1 for path, _, mode in cfg.placement_plan()
                if mode != "fp32" and not path.endswith("/moe/experts"))
        nb = BATCH * (MAX_LEN // BLOCK)
        kv = PagedKV(BATCH, MAX_LEN, BLOCK, nb)
        cache = lm.init_paged_cache(cfg, BATCH, MAX_LEN, BLOCK, nb,
                                    device=self.dev)
        lens = lm.paged_lens(cfg, MAX_LEN)
        rng = np.random.default_rng(9)
        act = torch.tensor([True, True, True, False], device=self.dev)

        def tables(pos):
            view = view_bucket(int(pos.max()) + 1, BLOCK, MAX_LEN)
            return dict(page_tables={"global": torch.as_tensor(
                kv.gather_tables()[0][:, :view // BLOCK],
                device=self.dev).contiguous()},
                page_lens=lm.clamped_lens(lens, view))

        if can_chunk(cfg):
            ntok = np.array([CHUNK, 9, CHUNK, 1])
            for s in range(3):
                self.check(kv.admit(s, int(ntok[s]), MAX_NEW),
                           "admission refused")
                kv.ensure(s, int(ntok[s]))
            toks = rng.integers(0, cfg.vocab_size, (BATCH, CHUNK))
            first, cache, _ = lm.chunk_step(
                params, cache, torch.as_tensor(toks, device=self.dev),
                torch.zeros(BATCH, dtype=torch.int64, device=self.dev),
                torch.as_tensor(ntok, device=self.dev), cfg, Ctx(seed=SEED),
                active=act, **tables(ntok))
            pos = np.where(np.arange(BATCH) < 3, ntok, 0)
            label = "chunk step (16, 9 and 16 tokens, row 3 idle)"
        else:
            S, plens = 32, (32, 20, 13)
            toks = np.zeros((3, S), np.int64)
            for r, plen in enumerate(plens):
                toks[r, S - plen:] = rng.integers(0, cfg.vocab_size, plen)
            batch = {"tokens": torch.as_tensor(toks, device=self.dev)}
            if cfg.input_kind == "embeds":
                batch["embeds"] = torch.as_tensor(rng.standard_normal(
                    (3, S, cfg.d_model), dtype=np.float32), device=self.dev)
            small = lm.init_cache(cfg, 3, MAX_LEN, device=self.dev)
            small, first, _ = lm.prefill(params, batch, cfg, Ctx(seed=SEED),
                                         small)
            for s in range(3):
                self.check(kv.admit(s, S, MAX_NEW), "admission refused")
                paged_insert(cache, {name: {k: t[s:s + 1]
                                            for k, t in blk.items()}
                                     for name, blk in small.items()},
                             *kv.scatter_rows(s))
                kv.ensure(s, S)
            pos = np.array([S, S, S, 0])
            label = (f"legacy prefill (batch 3, bucket {S}, prompts "
                     f"{plens})")
        tok = np.zeros(BATCH, np.int64)
        tok[:3] = self._first_tokens(first)[:3]
        tok, pos_d = (torch.as_tensor(a, device=self.dev) for a in (tok, pos))
        ld, _, _ = lm.decode_step(params, cache, tok, pos_d, cfg,
                                  Ctx(seed=SEED), active=act, **tables(pos))
        return [(label, first, n),
                ("decode step (batch 4, one idle row)", ld, n)]

    def model_cut_archs(self):
        """CUT_ARCHS at published widths, their depth cut
        (model_overrides), one after another, each model's memory freed
        before the next: _cut_steps' two steps with every launch count
        reset just before and read just after (exact: K3 and expert K3 at
        the placement's sites a step, K1 a layer in the decode step, K2 a
        layer in a chunk step), every kernel call against its plain version
        on the way, then the logits against the plain path at the 24-bit
        DAC (1e-3)."""
        from repro_torch.serve.engine import can_chunk
        from repro_torch.serve.spec import build_config
        torch = self.torch
        self.cut_summaries = {}
        for arch, depth, published, place in CUT_ARCHS:
            t0 = time.perf_counter()
            kw = (dict(placement="mixed") if place == "mixed"
                  else dict(mode="analog"))
            cfg = build_config(arch, smoke=False, a_per_row=True,
                               model_overrides={"num_layers": depth}, **kw)
            desc = (f"{place}, {cfg.num_heads} heads over "
                    f"{cfg.num_kv_heads} of {cfg.head_dim}, d_ff "
                    f"{cfg.d_ff}, rope {cfg.rope_type}, input "
                    f"{cfg.input_kind}")
            if cfg.num_experts:
                desc += (f", {cfg.num_experts} experts top-"
                         f"{cfg.experts_per_token} of {cfg.moe_d_ff}")
            params = self._arch_model(cfg, desc, arch, published)
            k3, k5, ex = self._sites(cfg)
            L = cfg.num_layers
            chunked = can_chunk(cfg)
            counters = self._counters()
            for w in counters.values():
                w.launches = 0
            self.__dict__.pop("_tokens", None)
            torch.cuda.reset_peak_memory_stats()
            # calls (checked against their plain versions) and launches
            want = {"emt_matmul": 2 * k3, "emt_matmul_experts": 2 * ex,
                    "emt_bitserial": 2 * k5, "paged_attention_decode": L,
                    "paged_prefill": L if chunked else 0,
                    "paged_attention": 0, "emt_matmul_int8": 0}
            self._calls_vs_plain(cfg, arch, want,
                                 lambda c: self._cut_steps(c, params))
            launches = {name: w.launches for name, w in counters.items()}
            print(f"  {arch}: launches in the two steps {launches}")
            for name, n in want.items():
                self.check(launches[name] == n,
                           f"{arch}: {name} launched {launches[name]} "
                           f"times, want {n}")
            short = arch.split("-")[0]
            for name in ("emt_matmul", "emt_matmul_experts",
                         "paged_attention_decode", "paged_prefill"):
                if launches[name]:
                    self.records.setdefault(name, {})[
                        f"{short}_launches"] = launches[name]
            self._logits_vs_plain(cfg, arch,
                                  lambda c: self._cut_steps(c, params),
                                  quiet=False, dac8=False)
            peak = torch.cuda.max_memory_allocated() / 2**30
            del params
            torch.cuda.empty_cache()
            secs = time.perf_counter() - t0
            self.cut_summaries[arch] = dict(layers=L, published=published,
                                            launches=launches,
                                            peak_gib=peak, seconds=secs)
            print(f"  {arch}: peak device memory {peak:.2f} GiB; "
                  f"{secs:.2f} s")

    def _level_flips(self, path, label, la, lb, steps):
        """Count the DAC levels that differ between two runs of `steps`
        (as a step function returned them: (step, logits, projections)),
        per projection in call order, for every step whose logits are
        held."""
        total_calls = sum(n for _, _, n in steps)
        self.check(len(la) == len(lb) == total_calls,
                   f"{len(la)} / {len(lb)} projections, want {total_calls}")
        c0 = 0
        for what, logits, n in steps:
            calls = range(c0, c0 + n)
            c0 += n
            if logits is None:
                continue
            flips = [int((la[c] != lb[c]).sum().item()) for c in calls]
            total = sum(la[c].numel() for c in calls)
            first = next((c for c, f in enumerate(flips) if f), None)
            print(f"  {path}, 8-bit DAC, {what}, {label}: DAC levels that "
                  f"differ: first 7 projections' inputs {flips[:7]}; all "
                  f"projections {sum(flips)} of {total}; "
                  f"first at projection {first}")

    # -- phase 8: training ----------------------------------------------------
    def k3_backward(self):
        """K3-dx and K3-dw at gemma3-1b's training shapes (M = 8 x 128
        tokens; the five distinct projection shapes and the tied unembed's
        table.T) and at the CNN's odd K = 27 and K = 576 (M = 32 x 32 x 32):
        held to their float64 plain versions, dw bit for bit to the float32
        plain pass on integer x and g in [-4, 4] (x^T g exact in float32
        and in 3xTF32, whatever the order), two calls bit-identical; K3's
        forward at the same M beside them (the tensor-core kernel, held to
        its float64 plain version, two calls bit-identical, and x = I to
        fluctuate bit for bit at the first shape); times per gemma3
        training step beside the FP32-pipe bound and the tensor-core bound
        (3xTF32; 4 products for the forward)."""
        from repro_torch.core import hashrng, noise, quant, regularizer
        from repro_torch.core.emt_linear import _tag_plane
        from repro_torch.core.noise import noise_factor
        from repro_torch.kernels import emt_matmul as k
        torch = self.torch
        emt = self.cfg.emt
        dev = emt.device
        L = self.cfg.num_layers
        M = TRAIN_BATCH * TRAIN_SEQ
        blk = self.params["decoder"]["layer_000"]
        cases = []          # (label, w, rho_raw, tag, M, calls a step)
        for grp, w, per in (("attn", "wq", 1), ("attn", "wk", 2),
                            ("attn", "wo", 1), ("ffn", "wg", 2),
                            ("ffn", "wd", 1)):
            p = blk[grp][w]
            tag = f"dec/layer_000/{'mlp' if grp == 'ffn' else grp}/{w}"
            cases.append((w, p["w"], p["rho_raw"], tag, M, per * L))
        cases.append(("unembed, table.T", self.params["embed"]["table"].T,
                      self.params["lm_head"]["rho_raw"], "unembed", M, 1))
        gen = torch.Generator(device=self.dev).manual_seed(6)
        raw = torch.tensor(regularizer.rho_init_raw(4.0), device=self.dev)
        for K, tag in ((27, "s0b0/c1"), (576, "s0b0/c2")):
            w = torch.randn((K, 64), generator=gen, device=self.dev) / K ** .5
            cases.append((f"CNN {tag}", w, raw, tag,
                          CNN_BATCH * 32 * 32, 0))
        keys_dx = ("gemm_3xtf32", "noise_bits", "split_sum")
        keys_dw = ("gemm_3xtf32", "dw_slab_epilogue", "partial_sum")
        need = "gemm_3xtf32"
        tot = {}

        def add(key, v, n):
            """tot[key] += v * n; None (not measured) once any is None."""
            if key in tot and tot[key] is None or v is None:
                tot[key] = None
            else:
                tot[key] = tot.get(key, 0.0) + v * n

        worst = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
        for i, (label, w, rho_raw, tag, Mc, per_step) in enumerate(cases):
            wq, _ = quant.quantize_weights(w, emt.quant)
            rho = regularizer.rho_from_raw(rho_raw)
            sig = dev.sigma_rel(rho)
            kw = dict(device=dev, seed=SEED, plane=_tag_plane(tag))
            K, N = wq.shape
            x = torch.randn((Mc, K), generator=gen, device=self.dev)
            g = torch.randn((Mc, N), generator=gen, device=self.dev)
            dx = k.emt_matmul_dx(g, wq, sig, **kw)
            dw, dsig = k.emt_matmul_dw(x, g, wq, sig, **kw)
            dw2, dsig2 = k.emt_matmul_dw(x, g, wq, sig, **kw)
            same = (torch.equal(dx, k.emt_matmul_dx(g, wq, sig, **kw))
                    and torch.equal(dw, dw2) and torch.equal(dsig, dsig2))
            del dw2
            xi = torch.randint(-4, 5, x.shape, generator=gen,
                               device=self.dev).float()
            gi = torch.randint(-4, 5, g.shape, generator=gen,
                               device=self.dev).float()
            exact = torch.equal(k.emt_matmul_dw(xi, gi, wq, sig, **kw)[0],
                                k.plain_dw(xi, gi, wq, sig, **kw)[0])
            del xi, gi
            dx64 = k.plain_dx(g.double(), wq, sig, **kw)
            d_dx, r_dx = rel_err(dx.double(), dx64)
            del dx64
            dw64, dsig64 = k.plain_dw(x.double(), g.double(), wq, sig, **kw)
            d_dw, r_dw = rel_err(dw.double(), dw64)
            del dw64
            terms = torch.sum(torch.abs(torch.matmul(x.T.double(), g.double())
                                        * wq.double())).item()
            r_sig = abs(dsig.item() - dsig64.item()) / max(terms, 1e-30)
            self.sync()
            worst["dx"] = max(worst["dx"], d_dx)
            worst["dw"] = max(worst["dw"], d_dw)
            layout = "transposed" if wq.stride(0) == 1 else "n-major"
            p = k.plan_dx(Mc, K, N, self.sms)
            q = k.plan_dw(Mc, K, N, self.sms)
            print(f"  K3 backward {label} {K}x{N} ({layout}) at M={Mc}: dx "
                  f"rel {r_dx:.3e} ({p.splits} N slab(s), {p.ctas} CTAs), "
                  f"dw rel {r_dw:.3e} ({q.splits} M slab(s), {q.ctas} "
                  f"CTAs), dsigma {dsig.item():.6e} vs {dsig64.item():.6e} "
                  f"(rel to sum|terms| {r_sig:.3e}); dw on integer x, g "
                  f"bit-identical to the float32 plain pass: {exact}; two "
                  f"calls bit-identical: {same}")
            self.check(r_dx <= K3_BWD_TOL and r_dw <= K3_BWD_TOL
                       and r_sig <= K3_BWD_TOL,
                       f"K3 backward {label}: rel dx {r_dx:.3e}, dw "
                       f"{r_dw:.3e}, dsigma {r_sig:.3e} > {K3_BWD_TOL}")
            self.check(exact and same, f"K3 backward {label}: dw vs the "
                       f"plain pass {exact}, two calls {same}")
            # times: the kernels, their plain versions and the yardsticks
            # (torch.matmul on the pre-noised weight; x^T g then the factor)
            f = noise_factor(hashrng.tile_state_offsets(
                SEED, 0, 0, (K, N), dev.state_offsets, dev.state_probs,
                kw["plane"], device=self.dev), sig)
            wn = wq * f
            # the forward against its float64 plain version (the same
            # noisy weight), two calls bit-identical, and x = I
            y = k.emt_matmul(x, wq, sig, **kw)
            same = torch.equal(y, k.emt_matmul(x, wq, sig, **kw))
            d_fwd, r_fwd = rel_err(y.double(),
                                   torch.matmul(x.double(), wn.double()))
            del y
            worst["fwd"] = max(worst["fwd"], d_fwd)
            pf = k.plan(Mc, N, K, self.sms, wq.stride(1) == 1)
            msg = (f"  K3 forward {label} {K}x{N} ({layout}) at M={Mc}: rel "
                   f"{r_fwd:.3e} to float64 ({pf.splits} K slab(s), "
                   f"{pf.ctas} CTAs); two calls bit-identical: {same}")
            self.check(r_fwd <= K3_FWD_TOL and same,
                       f"K3 forward {label}: rel {r_fwd:.3e} > {K3_FWD_TOL} "
                       f"or two calls differ ({same})")
            if i == 0:
                eye = torch.eye(K, device=self.dev)
                exact = torch.equal(
                    k.emt_matmul(eye, wq, sig, **kw),
                    noise.fluctuate(wq, rho, dev, emt.noise, seed=SEED,
                                    plane=kw["plane"]))
                del eye
                msg += f"; x = I bit-exact with fluctuate: {exact}"
                self.check(exact, f"K3 forward {label}: x = I differs from "
                           f"fluctuate")
            print(msg)
            it = 3 if K * N < 50e6 else 2
            t = dict(
                fwd=cuda_time(lambda: k.emt_matmul(x, wq, sig, **kw), it),
                fwd_lib=cuda_time(lambda: torch.matmul(x, wn), it),
                dx=cuda_time(lambda: k.emt_matmul_dx(g, wq, sig, **kw), it),
                dx_lib=cuda_time(lambda: torch.matmul(g, wn.T), it),
                dw=cuda_time(lambda: k.emt_matmul_dw(x, g, wq, sig, **kw),
                             it),
                dw_lib=cuda_time(lambda: torch.matmul(x.T, g).mul_(f), it),
                dx_plain=cuda_time(lambda: k.plain_dx(g, wq, sig, **kw), 1,
                                   warmup=1),
                dw_plain=cuda_time(lambda: k.plain_dw(x, g, wq, sig, **kw),
                                   1, warmup=1),
                fwd_plain=cuda_time(lambda: k.plain(x, wq, sig, **kw), 1,
                                    warmup=1))
            del wn, f
            t["dx_dev"] = device_ms(
                lambda: k.emt_matmul_dx(g, wq, sig, **kw), keys_dx,
                need=need)
            t["dw_dev"] = device_ms(
                lambda: k.emt_matmul_dw(x, g, wq, sig, **kw), keys_dw,
                need=need)
            t["fwd_dev"] = device_ms(
                lambda: k.emt_matmul(x, wq, sig, **kw),
                ("emt_matmul_tc", "split_sum"), need="emt_matmul_tc")
            alu, fma = hash_ops("K3", K * N)
            mkn = 2 * Mc * K * N
            # (bytes, FP32 FLOPs, ALU ops, other FP32-pipe ops, TF32
            # FLOPs): the products on the tensor cores (the forward's 4,
            # dx's and dw's 3), and "_fp32" the same work with the product
            # on the FP32 pipe
            b = dict(
                fwd=(4 * (Mc * K + K * N + Mc * N), 0, alu, fma, 4 * mkn),
                fwd_3p=(4 * (Mc * K + K * N + Mc * N), 0, alu, fma, 3 * mkn),
                fwd_fp32=(4 * (Mc * K + K * N + Mc * N), mkn, alu, fma, 0),
                dx=(4 * (Mc * N + K * N + Mc * K), 0, alu, fma, 3 * mkn),
                dw=(4 * (Mc * K + Mc * N + 2 * K * N), 3 * K * N, alu, fma,
                    3 * mkn),
                dx_fp32=(4 * (Mc * N + K * N + Mc * K), mkn, alu, fma, 0),
                dw_fp32=(4 * (Mc * K + Mc * N + 2 * K * N),
                         mkn + 3 * K * N, alu, fma, 0))
            bms = {n: bound(*v) for n, v in b.items()}
            print(f"    per call: forward {t['fwd']:.3f} ms, device "
                  f"{fmt(t['fwd_dev'])} (torch.matmul on the pre-noised "
                  f"weight {t['fwd_lib']:.3f}, plain {t['fwd_plain']:.3f}, "
                  f"bound {bms['fwd'][0]:.3f} {bms['fwd'][2]}, "
                  f"{share(bms['fwd'][0], t['fwd_dev'])} of it; FP32-pipe "
                  f"bound {bms['fwd_fp32'][0]:.3f}); dx {t['dx']:.3f} "
                  f"ms, device {fmt(t['dx_dev'])} (yardstick "
                  f"{t['dx_lib']:.3f}, plain {t['dx_plain']:.3f}, bound "
                  f"{bms['dx'][0]:.3f} {bms['dx'][2]}, "
                  f"{share(bms['dx'][0], t['dx_dev'])} of it; FP32-pipe "
                  f"bound {bms['dx_fp32'][0]:.3f}); dw {t['dw']:.3f} ms, "
                  f"device {fmt(t['dw_dev'])} (yardstick "
                  f"{t['dw_lib']:.3f}, plain {t['dw_plain']:.3f}, bound "
                  f"{bms['dw'][0]:.3f} {bms['dw'][2]}, "
                  f"{share(bms['dw'][0], t['dw_dev'])} of it; FP32-pipe "
                  f"bound {bms['dw_fp32'][0]:.3f})")
            if per_step:
                for n, v in t.items():
                    add(n, v, per_step)
                for n, v in b.items():
                    for i, part in enumerate(v):
                        add(f"{n}_b{i}", part, per_step)
            del x, g, dx, dw
        bnd = {n: bound(*(tot[f"{n}_b{i}"] for i in range(5)))
               for n in ("fwd", "fwd_3p", "dx", "dw", "fwd_fp32", "dx_fp32",
                         "dw_fp32")}
        print(f"  per gemma3-1b training step ({7 * L + 1} calls each, "
              f"M={M}): forward {tot['fwd']:.2f} ms, device "
              f"{fmt(tot['fwd_dev'], 2)} (yardstick {tot['fwd_lib']:.2f}, "
              f"plain {tot['fwd_plain']:.2f}, bound {bnd['fwd'][0]:.2f} "
              f"{bnd['fwd'][2]}, {share(bnd['fwd'][0], tot['fwd_dev'])} of "
              f"it; at dx's 3 products {bnd['fwd_3p'][0]:.2f}, "
              f"{share(bnd['fwd_3p'][0], tot['fwd_dev'])}; FP32-pipe bound "
              f"{bnd['fwd_fp32'][0]:.2f}, "
              f"{share(bnd['fwd_fp32'][0], tot['fwd_dev'])} of it); dx "
              f"{tot['dx']:.2f} ms, device "
              f"{fmt(tot['dx_dev'], 2)} (yardstick {tot['dx_lib']:.2f}, bound "
              f"{bnd['dx'][0]:.2f} {bnd['dx'][2]}, "
              f"{share(bnd['dx'][0], tot['dx_dev'])} of it; FP32-pipe bound "
              f"{bnd['dx_fp32'][0]:.2f}); dw {tot['dw']:.2f} ms, device "
              f"{fmt(tot['dw_dev'], 2)} (yardstick {tot['dw_lib']:.2f}, bound "
              f"{bnd['dw'][0]:.2f} {bnd['dw'][2]}, "
              f"{share(bnd['dw'][0], tot['dw_dev'])} of it; FP32-pipe bound "
              f"{bnd['dw_fp32'][0]:.2f})")
        src = "src/repro_torch/kernels/csrc/emt_matmul_bwd.cu"
        replaces = ("src/repro/kernels/emt_matmul.py:57 (no TPU backward "
                    "kernel: XLA's VJP of src/repro/core/noise.py:102)")
        for name, key in (("emt_matmul_dx", "dx"), ("emt_matmul_dw", "dw")):
            self.records[name] = dict(
                name=name, route="cuda", source=src, replaces=replaces,
                launches=None, max_abs_err=worst[key], ms=tot[key],
                device_ms=tot[f"{key}_dev"], plain_ms=tot[f"{key}_plain"],
                bound_ms=bnd[key][0], bound_by=bnd[key][1],
                library_ms=tot[f"{key}_lib"],
                fp32_bound_ms=bnd[f"{key}_fp32"][0])
        self.records.setdefault("emt_matmul_tc", {}).update(
            name="emt_matmul_tc", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_matmul_fwd.cu",
            replaces="src/repro/kernels/emt_matmul.py:57",
            launches=None, max_abs_err=worst["fwd"], ms=tot["fwd"],
            device_ms=tot["fwd_dev"], plain_ms=tot["fwd_plain"],
            bound_ms=bnd["fwd"][0], bound_by=bnd["fwd"][1],
            library_ms=tot["fwd_lib"], fp32_bound_ms=bnd["fwd_fp32"][0])
        self.records.setdefault("emt_matmul", {}).update(
            train_ms=tot["fwd"], train_bound_ms=bnd["fwd"][0],
            train_library_ms=tot["fwd_lib"])

    def _free_serving(self):
        """Drop the serving phases' weights before the training phases."""
        for name in ("params", "s2s_params", "moe_params"):
            self.__dict__.pop(name, None)
        self.torch.cuda.empty_cache()
        print(f"  device memory in use: "
              f"{self.torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def _counted(self, train_step, per_step: list):
        """train_step with every launch count reset before and read after
        each call (appended to per_step)."""
        counters = self._counters()

        def step(state, batch):
            for c in counters.values():
                c.launches = 0
            out = train_step(state, batch)
            self.sync()
            per_step.append({n: counters[n].launches for n in TRAIN_KERNELS})
            return out
        return step

    def _check_counts(self, label, per_step, want):
        for i, got in enumerate(per_step):
            self.check(got == want, f"{label} step {i}: launches {got}, "
                                    f"want {want}")

    def _grad_report(self, label, grads, leaves, skip=()):
        """Every leaf of `leaves` (path suffixes) but those of `skip` (the
        MoE routers' rho: their SRAM corner keeps it fixed, trainable_rho
        False) finite with a nonzero gradient."""
        def held(p):
            return p.endswith(leaves) and not (skip and p.endswith(skip))
        bad = [p for p, gr in _flat(grads)
               if held(p) and not (
                   bool(self.torch.isfinite(gr).all())
                   and gr.abs().max().item() > 0)]
        n = sum(1 for p, _ in _flat(grads) if held(p))
        print(f"  {label}: {n} gradient leaves ({', '.join(leaves)}) finite "
              f"and nonzero: {n - len(bad)} of {n}")
        self.check(not bad, f"{label}: zero or non-finite gradients {bad[:5]}")

    def train_gemma3(self):
        """launch.train's path at full width: gemma3-1b as published (22
        ring layers, window 512, 4 global), analog, float32, AdamW, lam
        1e-6, batch 8 x 128.  A gradient step at step 0: finite nonzero
        gradients on every w and rho_raw and exact launch counts (K3,
        K3-dx, K3-dw 183 each); two steps through train_loop (checkpoint at
        step 2), the step-2 checkpoint restored bit for bit, the third step
        profiled; then a fresh train_loop resumes from step 2 and its third
        step must equal the uninterrupted one bit for bit."""
        import dataclasses
        import shutil
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.launch import train as launch
        from repro_torch.train.loop import train_loop
        from repro_torch.train.step import make_grad_fn
        from torch.profiler import DeviceType, ProfilerActivity, profile
        torch = self.torch
        self._free_serving()
        ckpt = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = ["--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--lam", "1e-6",
                "--opt", "adamw", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
        t0 = time.perf_counter()
        run = launch.setup(argv, torch_device="cuda", seed=SEED)
        self.sync()
        L = run.cfg.num_layers
        want = dict(emt_matmul=7 * L + 1, emt_matmul_tc=7 * L + 1,
                    emt_matmul_dx=7 * L + 1, emt_matmul_dw=7 * L + 1,
                    emt_bitserial=0, emt_matmul_experts=0,
                    emt_matmul_experts_dx=0, emt_matmul_experts_dw=0)
        n = sum(p.numel() for _, p in _flat(run.state["params"]))
        state_gb = sum(t.numel() * t.element_size()
                       for _, t in _flat(run.state)) / 1e9
        print(f"  launch.train {' '.join(argv)}: {run.cfg.name}, "
              f"{run.cfg.blocks().count('local')} ring + "
              f"{run.cfg.blocks().count('global')} global layers, {n:,} "
              f"parameters, train state {state_gb:.2f} GB (float32 weights "
              f"and AdamW m, v), set up in {time.perf_counter() - t0:.2f} s")
        # 1. gradients at step 0
        counters = self._reset_launches()
        loss, _, grads = make_grad_fn(run.cfg, run.tcfg.lam)(
            run.state["params"], run.data.batch_at(0), 0)
        self.sync()
        got = {n: counters[n].launches for n in TRAIN_KERNELS}
        print(f"  gradient step: loss {loss.item():.4f}, launches {got}")
        self.check(got == want, f"train gradient step launches {got}")
        self.check(bool(torch.isfinite(loss)), "train loss not finite")
        self._grad_report("gemma3-1b step 0", grads,
                          ("/w", "rho_raw", "embed/table"))
        del grads
        # 2. two steps through the loop; the checkpoint at step 2
        per_step = []
        counted = self._counted(run.train_step, per_step)
        torch.cuda.reset_peak_memory_stats()
        box = [run.state]
        run.state = None
        t0 = time.perf_counter()
        state2, hist = train_loop(box.pop(), counted, run.data.batch_at,
                                  dataclasses.replace(run.loop, total_steps=2,
                                                      log_every=1))
        loop_s = time.perf_counter() - t0
        # 3. the checkpoint restores bit for bit
        t0 = time.perf_counter()
        restored, meta = CheckpointManager(ckpt).restore(2, state2)
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_flat(restored), _flat(state2)))
        ckpt_gb = os.path.getsize(os.path.join(
            ckpt, "step_000000002", "state.npz")) / 1e9
        print(f"  checkpoint step {meta['step']} ({ckpt_gb:.2f} GB, sha256 "
              f"checked): restored in {restore_s:.1f} s, bit-identical: "
              f"{same}")
        self.check(same, "train checkpoint restore differs")
        del restored
        # 4. the third step, uninterrupted and profiled
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state3, m3 = counted(state2, run.data.batch_at(2))
        wall = (time.perf_counter() - t0) * 1e3
        del state2
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
        ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        ops = sum(e.count for e in prof.key_averages()
                  if e.key.startswith("aten::"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in hist] + [float(m3["loss"])]
        times = [h["step_time_s"] for h in hist]
        norms = [round(h["grad_norm"], 4) for h in hist]
        print(f"  steps 1-2 through train_loop: {loop_s:.1f} s with the "
              f"async checkpoint, step times {times} s (synchronized); "
              f"losses {losses}, grad norms {norms}")
        print(f"  step 3 profiled: wall {wall:.1f} ms (profiler on), device "
              f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%), {ops} aten "
              f"ops; peak device memory {peak:.2f} GiB; top:")
        for e in ev[:10]:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x {e.key[:80]}")
        self.check(all(math.isfinite(v) for v in losses),
                   f"train losses {losses}")
        self._check_counts("train", per_step, want)
        self.train_summary = dict(
            steps=len(per_step), losses=losses, step_time_s=times,
            step3_busy_ms=busy, step3_wall_ms=wall, aten_ops=ops,
            peak_gib=peak, state_gb=state_gb, ckpt_gb=ckpt_gb,
            restore_s=restore_s)
        for name in ("emt_matmul_dx", "emt_matmul_dw"):
            self.records[name]["launches"] = sum(c[name] for c in per_step)
        self.records.setdefault("emt_matmul", {})["train_launches"] = sum(
            c["emt_matmul"] for c in per_step)
        self.records.setdefault("emt_matmul_tc", {})["launches"] = sum(
            c["emt_matmul_tc"] for c in per_step)
        # 5. a fresh loop resumes from the step-2 checkpoint
        shutil.rmtree(os.path.join(ckpt, "step_000000003"),
                      ignore_errors=True)
        logs, resumed_steps = [], []
        t0 = time.perf_counter()
        resumed, hist3 = train_loop(
            state3, self._counted(run.train_step, resumed_steps),
            run.data.batch_at, dataclasses.replace(run.loop, total_steps=3,
                                                   log_every=1),
            log=logs.append)
        resume_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_flat(resumed), _flat(state3)))
        print(f"  resumed run: {logs[0]!r}, one step in {resume_s:.1f} s "
              f"with the restore and the save; loss {hist3[-1]['loss']:.6f} "
              f"vs {float(m3['loss']):.6f} uninterrupted; state "
              f"bit-identical to the uninterrupted step 3: {same}")
        self.check(logs and logs[0] == "[loop] resumed from step 2",
                   f"resume: {logs[:1]}")
        self.check(same and hist3[-1]["loss"] == float(m3["loss"]),
                   "resumed step differs from the uninterrupted one")
        self._check_counts("resumed", resumed_steps, want)
        self.train_params = resumed["params"]
        self.train_run = run
        del resumed, state3
        shutil.rmtree(ckpt, ignore_errors=True)

    def _compare_grads(self, label, a, b, limit):
        """Loss and every gradient leaf of two runs: each leaf's max |diff|
        over its max |value|; the per-layer rho_raw scalars as one vector."""
        torch = self.torch
        (la, ga), (lb, gb) = a, b
        fa, fb = dict(_flat(ga)), dict(_flat(gb))
        r_loss = abs(la.item() - lb.item()) / abs(lb.item())
        worst = []
        rho = [p for p in fb if p.endswith("rho_raw")]
        for p in fb:
            if p in rho:
                continue
            d = (fa[p].to(fb[p].device) - fb[p]).abs().max().item()
            worst.append((d / max(fb[p].abs().max().item(), 1e-30), p))
        if rho:
            va = torch.stack([fa[p].reshape(()).to(fb[p].device)
                              for p in rho])
            vb = torch.stack([fb[p].reshape(()) for p in rho])
            d = (va - vb).abs().max().item()
            worst.append((d / max(vb.abs().max().item(), 1e-30),
                          f"rho_raw x{len(rho)}"))
        worst.sort(reverse=True)
        finite = all(bool(torch.isfinite(t).all()) for t in fa.values())
        print(f"  {label}: loss {la.item():.6f} vs {lb.item():.6f} (rel "
              f"{r_loss:.3e}); {len(worst)} gradient groups, worst rel "
              f"{worst[0][0]:.3e} ({worst[0][1]}), then "
              + ", ".join(f"{r:.2e} {p}" for r, p in worst[1:4])
              + f"; finite {finite} (limit {limit:g})")
        self.check(finite and r_loss <= limit and worst[0][0] <= limit,
                   f"{label}: loss rel {r_loss:.3e}, worst gradient "
                   f"{worst[0]}")

    def train_vs_plain(self):
        """One full-width gemma3-1b gradient step (the trained weights of
        the phase before, step 3's batch and noise) through the kernels
        (K3, K3-dx, K3-dw) and through their plain versions on the card
        with the same VJP, at a 24-bit DAC (levels finer than float32's
        rounding, so a level tie decides nothing): the loss and every
        gradient leaf within TRAIN_PLAIN_TOL."""
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.train.step import make_grad_fn
        run = self.train_run
        cfg = run.cfg.replace(emt=_dac_bits(run.cfg.emt, 24))
        grad_fn = make_grad_fn(cfg, run.tcfg.lam)
        batch = run.data.batch_at(3)
        loss, _, gk = grad_fn(self.train_params, batch, 3)
        kern = (loss, gk)
        with self._ops_through(_emt_matmul=k3.plain_differentiable):
            loss, _, gp = grad_fn(self.train_params, batch, 3)
        self._compare_grads("gemma3-1b, 24-bit DAC: kernels vs plain",
                            kern, (loss, gp), TRAIN_PLAIN_TOL)
        del kern, gk, gp, self.train_params, self.train_run
        self.torch.cuda.empty_cache()

    @contextlib.contextmanager
    def _relu_gates(self, out: list):
        """Append every F.relu's open gates (input > 0), in call order."""
        import torch.nn.functional as F
        orig = F.relu

        def record(x, *args, **kw):
            out.append(x.detach() > 0)
            return orig(x, *args, **kw)

        F.relu = record
        try:
            yield
        finally:
            F.relu = orig

    def train_cnn(self):
        """vgg16_cifar (channels 64/128/256, 2 blocks a stage, 32 x 32
        images, 10 classes) on SyntheticImages, batch 32, AdamW at a
        constant lr 5e-3, lam 3e-8 (the reference's paper_repro settings),
        under A+B (analog reads through K3, K3-dx, K3-dw; trainable rho)
        and A+B+C (bit-serial reads through K5 with the ideal-matmul VJP).
        Gradients at step 0 held to the plain versions on the card at a
        24-bit DAC (bit-serial read noise off there: a bit-serial read is
        discontinuous in its level); then CNN_STEPS steps at the paper's
        8-bit DAC with exact launch counts, finite losses, and every rho
        moved by technique B."""
        from repro_torch.configs import paper_cnn
        from repro_torch.data.synthetic import SyntheticImages
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.train.optimizer import constant_schedule
        from repro_torch.train.step import (TrainConfig, init_state,
                                            make_grad_fn, make_train_step)
        torch = self.torch
        data = SyntheticImages(num_classes=10, image_size=32, device=self.dev)
        self.cnn_summary = {}
        for regime in ("A+B", "A+B+C"):
            cfg = paper_cnn.vgg16_cifar(paper_cnn.regime(regime))
            convs = 2 * len(cfg.channels) * cfg.blocks_per_stage
            bitserial = regime == "A+B+C"
            want = dict(emt_matmul=0 if bitserial else convs + 1,
                        emt_matmul_tc=0 if bitserial else convs + 1,
                        emt_matmul_dx=0 if bitserial else convs,
                        emt_matmul_dw=0 if bitserial else convs + 1,
                        emt_bitserial=convs + 1 if bitserial else 0,
                        emt_matmul_experts=0, emt_matmul_experts_dx=0,
                        emt_matmul_experts_dw=0)
            tcfg = TrainConfig(lam=CNN_LAM, lr=CNN_LR)
            train_step, opt = make_train_step(
                cfg, tcfg, schedule=constant_schedule(CNN_LR))
            state = init_state(cfg, opt, SEED, device=self.dev)
            # gradients against the plain versions
            check = cfg.replace(emt=_dac_bits(cfg.emt, 24, quiet=True))
            grad_fn = make_grad_fn(check, CNN_LAM)
            batch = data.batch(CNN_BATCH, 0)
            gates_k, gates_p = [], []
            with self._relu_gates(gates_k):
                loss, _, gk = grad_fn(state["params"], batch, 0)
            kern = (loss, gk)
            with self._ops_through(
                    _emt_matmul=k3.plain_differentiable,
                    _emt_bitserial=k5.plain_differentiable), \
                    self._relu_gates(gates_p):
                loss, _, gp = grad_fn(state["params"], batch, 0)
            flips = sum(int((a != b).sum()) for a, b in zip(gates_k, gates_p))
            print(f"  vgg16_cifar {regime}: ReLU gates that differ between "
                  f"the two runs: {flips} of "
                  f"{sum(a.numel() for a in gates_k):,}")
            self._compare_grads(f"vgg16_cifar {regime}, 24-bit DAC"
                                + (", read noise off" if bitserial else "")
                                + ": kernels vs plain", kern, (loss, gp),
                                CNN_PLAIN_TOL)
            del kern, gk, gp, gates_k, gates_p
            rho0 = {p: t.detach().clone() for p, t in
                    _flat(state["params"]) if p.endswith("rho_raw")}
            per_step, losses, k5_calls = [], [], []
            step = self._counted(train_step, per_step)

            def recorded(xq, w, sig, **kw):
                """K5 as the step calls it, its inputs kept (last step)."""
                k5_calls.append((xq.detach(), w.detach(), sig.detach(), kw))
                return k5.emt_bitserial(xq, w, sig, **kw)

            t0 = time.perf_counter()
            for i in range(CNN_STEPS):
                last = bitserial and i == CNN_STEPS - 1
                with (self._ops_through(_emt_bitserial=recorded) if last
                      else contextlib.nullcontext()):
                    state, m = step(state, data.batch(CNN_BATCH, i))
                losses.append(float(m["loss"]))
            secs = time.perf_counter() - t0
            if k5_calls:
                # the step's K5 calls replayed on their inputs: their
                # device time alone (the kernel and its split sums)
                def replay():
                    for xq, w, sig, kw in k5_calls:
                        k5.emt_bitserial(xq, w, sig, **kw)
                cnn_dev = device_ms(replay, ("bitserial", "split_sum"),
                                    agree=True)
                shapes = sorted({(x.shape[0], *w.shape)
                                 for x, w, *_ in k5_calls})
                (cnn_b, _, cnn_term), _, _, cnn_issue = k5_bound(
                    k5, [(x.shape[0], *w.shape, kw.get("bits", 7))
                         for x, w, _, kw in k5_calls])
                print(f"  vgg16_cifar A+B+C: the {len(k5_calls)} K5 calls of "
                      f"a step (M, K, N: {shapes}), device time "
                      f"{fmt(cnn_dev)}, bound {cnn_b:.3f} ms ({cnn_term}), "
                      f"share of the device time {share(cnn_b, cnn_dev)}; "
                      f"the kernel's ALU-pipe issue as compiled "
                      f"{cnn_issue:.3f} ms")
                self.records.setdefault("emt_bitserial", {}).update(
                    cnn_device_ms=cnn_dev, cnn_bound_ms=cnn_b,
                    cnn_bound_term=cnn_term)
                del k5_calls[:]
            params = dict(_flat(state["params"]))
            moved = sum(not torch.equal(params[p], v) for p, v in rho0.items())
            rho = [params[p].item() for p in rho0]
            start = float(next(iter(rho0.values())))
            print(f"  vgg16_cifar {regime}: {CNN_STEPS} steps in {secs:.2f} "
                  f"s, losses {losses}, launches a step {per_step[0]}, "
                  f"rho_raw moved in {moved} of {len(rho0)} layers (from "
                  f"{start:.6f} to {min(rho):.6f}..{max(rho):.6f}); energy "
                  f"{float(m['energy_uj']):.4f} uJ a batch, acc "
                  f"{float(m['acc']):.3f}")
            self.check(all(math.isfinite(v) for v in losses),
                       f"CNN {regime} losses {losses}")
            self.check(moved == len(rho0) and moved == convs + 1,
                       f"CNN {regime}: rho moved in {moved} of {len(rho0)}")
            self._check_counts(f"CNN {regime}", per_step, want)
            self.cnn_summary[regime] = dict(losses=losses, seconds=secs,
                                            launches=per_step[0])
            for name in ("emt_matmul_dx", "emt_matmul_dw"):
                rec = self.records.setdefault(name, {})
                rec["cnn_launches"] = rec.get("cnn_launches", 0) + sum(
                    c[name] for c in per_step)
            del state

    # -- phase 13: training the mixture-of-experts and recurrent families ----
    def k3_experts_backward(self):
        """The experts' K3-dx and K3-dw (one launch each over a stack of
        experts, expert e hashed at rows e * K + k) at the training paths'
        shapes: moonshot-v1-16b-a3b's 64 experts at M = 120 (capacity of a
        1,024-token batch), (K, N) = (2,048, 1,408) for wg/wu and (1,408,
        2,048) for wd, and jamba's 16 at M = 20 (a 128-token batch), 4,096
        <-> 14,336.  Each held to its float64 plain version within
        K3_BWD_TOL (dx, dw with the sum |w~| term gs sgn(w~), dsigma), dw
        bit for bit to the float32 plain pass on integer x, g and gs, two
        calls bit-identical; timed by event and by device beside its plain
        version, the torch.bmm yardsticks on pre-noised stacks (bmm(g,
        w~^T); bmm(x^T, g) * f) and the bound (bytes, 3xTF32 products, the
        hash).  "ms" sums one moonshot training step's 3 L calls."""
        from repro_torch.configs import get_config
        from repro_torch.core import quant, regularizer
        from repro_torch.core.emt_linear import _tag_plane
        from repro_torch.kernels import emt_matmul as k
        from repro_torch.kernels.ref import _noise, noisy_experts
        from repro_torch.models.moe import capacity
        torch = self.torch
        keys_dx = ("gemm_3xtf32", "noise_bits", "split_sum")
        keys_dw = ("gemm_3xtf32", "dw_slab_epilogue", "partial_sum")
        worst = {"dx": 0.0, "dw": 0.0}
        totals = {}
        graphs = set()       # the device times a graph replay stands in for
        for arch, layers, tokens in ((MOE_ARCH, TRAIN_MOE_LAYERS,
                                      TRAIN_BATCH * TRAIN_SEQ),
                                     (JAMBA_ARCH, TRAIN_JAMBA_LAYERS,
                                      JAMBA_TRAIN_BATCH * JAMBA_TRAIN_SEQ)):
            cfg = get_config(arch, placement="mixed").replace(
                num_layers=layers)
            moe = sum(1 for p, _, _ in cfg.placement_plan()
                      if p.endswith("/moe/experts"))
            tag = next(p for p, _, _ in cfg.placement_plan()
                       if p.endswith("/moe/experts"))
            emt = cfg.emt_at(tag)
            E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
            M = capacity(cfg, tokens)
            tot = totals[arch] = {}
            gen = torch.Generator(device=self.dev).manual_seed(12)
            sig = emt.device.sigma_rel(regularizer.rho_from_raw(
                torch.tensor(regularizer.rho_init_raw(emt.rho_init),
                             device=self.dev)))
            for proj, K, N, per in (("wg", D, F, 2), ("wd", F, D, 1)):
                kw = dict(device=emt.device, seed=SEED,
                          plane=_tag_plane(tag.replace("experts", proj)))
                w = torch.randn((E, K, N), generator=gen,
                                device=self.dev) / K ** .5
                wq, _ = quant.quantize_weights(w, emt.quant)
                del w
                x = torch.randn((E, M, K), generator=gen, device=self.dev)
                g = torch.randn((E, M, N), generator=gen, device=self.dev)
                # the sum |w~|'s cotangent, far above a training step's
                # lam rho / N so that its term gs sgn(w~) shows in dw
                gs = torch.tensor(0.5, device=self.dev)
                zeros = int((wq == 0).sum())
                dx = k.emt_matmul_experts_dx(g, wq, sig, **kw)
                dw, dsig = k.emt_matmul_experts_dw(x, g, wq, sig, gs, **kw)
                dw2, dsig2 = k.emt_matmul_experts_dw(x, g, wq, sig, gs, **kw)
                same = (torch.equal(dx, k.emt_matmul_experts_dx(
                    g, wq, sig, **kw)) and torch.equal(dw, dw2)
                        and torch.equal(dsig, dsig2))
                del dw2
                xi = torch.randint(-4, 5, x.shape, generator=gen,
                                   device=self.dev).float()
                gi = torch.randint(-4, 5, g.shape, generator=gen,
                                   device=self.dev).float()
                gsi = torch.tensor(3.0, device=self.dev)
                exact = torch.equal(
                    k.emt_matmul_experts_dw(xi, gi, wq, sig, gsi, **kw)[0],
                    k.plain_experts_dw(xi, gi, wq, sig, gsi, **kw)[0])
                del xi, gi
                dx64 = k.plain_experts_dx(g.double(), wq, sig, **kw)
                d_dx, r_dx = rel_err(dx.double(), dx64)
                del dx64
                dw64, dsig64 = k.plain_experts_dw(x.double(), g.double(),
                                                  wq, sig, gs, **kw)
                d_dw, r_dw = rel_err(dw.double(), dw64)
                terms = torch.sum(dw64.abs() * wq.double().abs()).item()
                del dw64
                r_sig = abs(dsig.item() - dsig64.item()) / max(terms, 1e-30)
                self.sync()
                worst["dx"] = max(worst["dx"], d_dx)
                worst["dw"] = max(worst["dw"], d_dw)
                p = k.plan_dx(M, K, N, self.sms, experts=E)
                q = k.plan_dw(M, K, N, self.sms, experts=E)
                print(f"  experts backward {arch} {proj} E={E} M={M} "
                      f"{K}x{N} ({zeros:,} exact zeros in w): dx rel "
                      f"{r_dx:.3e} ({p.splits} N slab(s), {p.ctas} CTAs), "
                      f"dw rel {r_dw:.3e} ({q.splits} M slab(s), {q.ctas} "
                      f"CTAs), dsigma {dsig.item():.6e} vs "
                      f"{dsig64.item():.6e} (rel to sum|terms| "
                      f"{r_sig:.3e}); dw on integer x, g, gs bit-identical "
                      f"to the float32 plain pass: {exact}; two calls "
                      f"bit-identical: {same}")
                self.check(r_dx <= K3_BWD_TOL and r_dw <= K3_BWD_TOL
                           and r_sig <= K3_BWD_TOL,
                           f"experts backward {arch} {proj}: rel dx "
                           f"{r_dx:.3e}, dw {r_dw:.3e}, dsigma {r_sig:.3e} "
                           f"> {K3_BWD_TOL}")
                self.check(exact and same, f"experts backward {arch} "
                           f"{proj}: dw vs the plain pass {exact}, two "
                           f"calls {same}")
                del dx, dw
                # the yardsticks: torch.bmm on the pre-noised stack, and
                # x^T g then the factor
                wn = noisy_experts(wq, sig, **kw)
                f = torch.stack([_noise(wq[i], sig, emt.device, SEED,
                                        kw["plane"], row0=i * K)[1]
                                 for i in range(E)])
                t = dict(
                    dx=cuda_time(lambda: k.emt_matmul_experts_dx(
                        g, wq, sig, **kw), 3),
                    dx_lib=cuda_time(lambda: torch.bmm(
                        g, wn.transpose(1, 2)), 3),
                    dw=cuda_time(lambda: k.emt_matmul_experts_dw(
                        x, g, wq, sig, gs, **kw), 3),
                    dw_lib=cuda_time(lambda: torch.bmm(
                        x.transpose(1, 2), g).mul_(f), 3),
                    dx_plain=cuda_time(lambda: k.plain_experts_dx(
                        g, wq, sig, **kw), 1, warmup=1),
                    dw_plain=cuda_time(lambda: k.plain_experts_dw(
                        x, g, wq, sig, gs, **kw), 1, warmup=1))
                # device times; where the profiler's traces lost the
                # events, the run captured once as a CUDA graph and
                # replayed (no host dispatch between its kernels)
                runs = dict(
                    dx=(lambda: k.emt_matmul_experts_dx(g, wq, sig, **kw),
                        keys_dx),
                    dw=(lambda: k.emt_matmul_experts_dw(x, g, wq, sig, gs,
                                                        **kw), keys_dw),
                    dx_lib=(lambda: torch.bmm(g, wn.transpose(1, 2)), ""),
                    dw_lib=(lambda: torch.bmm(x.transpose(1, 2), g).mul_(f),
                            ""))
                for key, (fn, keys) in runs.items():
                    v = device_ms(fn, keys, need=keys[0] if keys else "")
                    if v is None:
                        v = graph_ms(fn)
                        graphs.add(key)
                        print(f"    ({key}: the profiler's device time not "
                              f"measured; the graph replay's, {fmt(v)}, "
                              f"stands in)")
                    t[f"{key}_dev"] = v
                del wn, f
                alu, fma = hash_ops("K3", E * K * N)
                mkn = 2 * E * M * K * N
                # (bytes, FP32 FLOPs, ALU ops, other FP32-pipe ops, TF32
                # FLOPs): 3xTF32 products; dw's epilogue c = gw + gs sgn,
                # c f, c w and its product with a, once an element
                b = dict(dx=(4 * (E * M * N + E * K * N + E * M * K), 0,
                             alu, fma, 3 * mkn),
                         dw=(4 * (E * M * K + E * M * N + 2 * E * K * N) + 4,
                             4 * E * K * N, alu, fma, 3 * mkn))
                bms = {n: bound(*v) for n, v in b.items()}
                print(f"    per call: dx {t['dx']:.3f} ms, device "
                      f"{fmt(t['dx_dev'])} (torch.bmm on the pre-noised "
                      f"stack {t['dx_lib']:.3f}, device "
                      f"{fmt(t['dx_lib_dev'])}; plain {t['dx_plain']:.3f}; "
                      f"bound {bms['dx'][0]:.3f} {bms['dx'][2]}, "
                      f"{share(bms['dx'][0], t['dx_dev'])} of it); dw "
                      f"{t['dw']:.3f} ms, device {fmt(t['dw_dev'])} "
                      f"(torch.bmm then the factor {t['dw_lib']:.3f}, device "
                      f"{fmt(t['dw_lib_dev'])}; plain {t['dw_plain']:.3f}; "
                      f"bound {bms['dw'][0]:.3f} {bms['dw'][2]}, "
                      f"{share(bms['dw'][0], t['dw_dev'])} of it)")
                n = per * moe
                for key, v in t.items():
                    tot[key] = (None if v is None or tot.get(key, 0.0) is None
                                else tot.get(key, 0.0) + v * n)
                for key, v in b.items():
                    for i, part in enumerate(v):
                        tot[f"{key}_b{i}"] = tot.get(f"{key}_b{i}", 0) + \
                            part * n
                del x, g, wq
                torch.cuda.empty_cache()
            tot["calls"] = 3 * moe
            for key in ("dx", "dw"):
                tot[f"{key}_bound"] = bound(*(tot[f"{key}_b{i}"]
                                              for i in range(5)))
            print(f"  per {arch} training step ({layers} layers, "
                  f"{3 * moe} calls each, E={E}, M={M}): dx {tot['dx']:.3f}"
                  f" ms, device {fmt(tot['dx_dev'])} (yardstick "
                  f"{tot['dx_lib']:.3f}, device {fmt(tot['dx_lib_dev'])}; "
                  f"bound {tot['dx_bound'][0]:.3f} {tot['dx_bound'][2]}, "
                  f"{share(tot['dx_bound'][0], tot['dx_dev'])} of it); dw "
                  f"{tot['dw']:.3f} ms, device {fmt(tot['dw_dev'])} "
                  f"(yardstick {tot['dw_lib']:.3f}, device "
                  f"{fmt(tot['dw_lib_dev'])}; bound "
                  f"{tot['dw_bound'][0]:.3f} {tot['dw_bound'][2]}, "
                  f"{share(tot['dw_bound'][0], tot['dw_dev'])} of it)")
        src = "src/repro_torch/kernels/csrc/emt_matmul_bwd.cu"
        replaces = ("src/repro/kernels/emt_matmul.py:57 (no TPU backward "
                    "kernel: XLA's VJP of src/repro/models/moe.py:59-71 "
                    "_emt_stacked + einsum)")
        moon, jam = totals[MOE_ARCH], totals[JAMBA_ARCH]
        for name, key in (("emt_matmul_experts_dx", "dx"),
                          ("emt_matmul_experts_dw", "dw")):
            self.records[name] = dict(
                name=name, route="cuda", source=src, replaces=replaces,
                launches=None, max_abs_err=worst[key], ms=moon[key],
                device_ms=moon[f"{key}_dev"], plain_ms=moon[f"{key}_plain"],
                bound_ms=moon[f"{key}_bound"][0],
                bound_by=moon[f"{key}_bound"][1],
                library_ms=moon[f"{key}_lib"],
                library_device_ms=moon[f"{key}_lib_dev"],
                jamba_ms=jam[key], jamba_device_ms=jam[f"{key}_dev"],
                jamba_plain_ms=jam[f"{key}_plain"],
                jamba_bound_ms=jam[f"{key}_bound"][0],
                jamba_library_ms=jam[f"{key}_lib"],
                jamba_library_device_ms=jam[f"{key}_lib_dev"],
                device_source=("graph replay" if {key, f"{key}_lib"} & graphs
                               else "profiler"))

    @contextlib.contextmanager
    def _no_checkpoint(self):
        """train_loop's checkpoints off, for the duration: its
        CheckpointManager restores and saves nothing (gemma3's phase holds
        the checkpoint's round trip; a moonshot state is 29 GB)."""
        from repro_torch.train import loop

        class Off:
            def __init__(self, *args, **kw):
                pass

            def restore_latest(self, template):
                return None, None

            def save(self, *args, **kw):
                pass

            def wait(self):
                pass

        orig = loop.CheckpointManager
        loop.CheckpointManager = Off
        try:
            yield
        finally:
            loop.CheckpointManager = orig

    def _lm_run(self, cfg, batch, seq, lam=1e-6):
        """A training run of `cfg` built as launch.setup builds one (AdamW,
        lam, TRAIN_STEPS steps, the port's seeded init, SyntheticLM)."""
        from repro_torch.data.synthetic import SyntheticLM
        from repro_torch.launch.train import Run
        from repro_torch.train.loop import LoopConfig
        from repro_torch.train.optimizer import OptimizerConfig
        from repro_torch.train.step import (TrainConfig, init_state,
                                            make_train_step)
        cfg = cfg.replace(dtype=self.torch.float32)
        tcfg = TrainConfig(lam=lam, lr=3e-4, total_steps=TRAIN_STEPS,
                           opt=OptimizerConfig(name="adamw"))
        train_step, opt = make_train_step(cfg, tcfg)
        state = init_state(cfg, opt, SEED, device=self.dev)
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                           batch_size=batch, d_model=cfg.d_model,
                           input_kind=cfg.input_kind, encdec=cfg.is_encdec,
                           device=self.dev)
        loop = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                          ckpt_dir=os.path.join(ROOT, "build",
                                                "chip_smoke_no_ckpt"))
        return Run(cfg, tcfg, train_step, state, data, loop)

    def _train_want(self, cfg):
        """Launches of one training step of `cfg` (every call above 16
        rows): every analog site's K3 forward on the tensor cores, K3-dx
        and K3-dw; K5 on every bit-serial site (its ideal-matmul VJP
        launches nothing); three expert launches a MoE layer and their dx
        and dw."""
        k3, k5, ex = self._sites(cfg)
        return dict(emt_matmul=k3, emt_matmul_tc=k3,
                    emt_matmul_dx=k3, emt_matmul_dw=k3, emt_bitserial=k5,
                    emt_matmul_experts=ex, emt_matmul_experts_dx=ex,
                    emt_matmul_experts_dw=ex)

    def _train_path(self, label, run, want, leaves):
        """(1) A gradient step at step 0: exact launch counts `want`,
        finite nonzero gradients on every leaf ending in `leaves`; (2)
        TRAIN_STEPS steps through train_loop with its checkpoints off,
        each step's launches exact, the last profiled (device busy, aten
        ops; the top kernels), peak memory.  Returns (summary, the trained
        parameters); the optimizer state is dropped."""
        import dataclasses
        from repro_torch.train.loop import train_loop
        from repro_torch.train.step import make_grad_fn
        from torch.profiler import DeviceType, ProfilerActivity, profile
        torch = self.torch
        n = sum(p.numel() for _, p in _flat(run.state["params"]))
        state_gb = sum(t.numel() * t.element_size()
                       for _, t in _flat(run.state)) / 1e9
        print(f"  {label}: {run.cfg.name}, {run.cfg.num_layers} layers "
              f"{run.cfg.blocks()}, {n:,} parameters, train state "
              f"{state_gb:.2f} GB (float32 weights and AdamW m, v), batch "
              f"{run.data.batch_size} x {run.data.seq_len}")
        counters = self._reset_launches()
        loss, _, grads = make_grad_fn(run.cfg, run.tcfg.lam)(
            run.state["params"], run.data.batch_at(0), 0)
        self.sync()
        got = {k: counters[k].launches for k in TRAIN_KERNELS}
        print(f"  {label} gradient step: loss {loss.item():.4f}, launches "
              f"{got}")
        self.check(got == want, f"{label} gradient step launches {got}, "
                   f"want {want}")
        self.check(bool(torch.isfinite(loss)), f"{label} loss not finite")
        self._grad_report(f"{label} step 0", grads, leaves,
                          skip=("router/rho_raw",))
        del grads
        per_step, box = [], {}
        counted = self._counted(run.train_step, per_step)

        def step(state, batch):
            if len(per_step) < TRAIN_STEPS - 1:
                return counted(state, batch)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = counted(state, batch)
            box["wall"] = (time.perf_counter() - t0) * 1e3
            box["prof"] = prof
            return out

        torch.cuda.reset_peak_memory_stats()
        state, run.state = run.state, None
        t0 = time.perf_counter()
        with self._no_checkpoint():
            state, hist = train_loop(state, step, run.data.batch_at,
                                     dataclasses.replace(run.loop,
                                                         log_every=1,
                                                         metrics_path=None))
        loop_s = time.perf_counter() - t0
        events = box["prof"].key_averages()
        ev = [e for e in events if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
        ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        ops = sum(e.count for e in events if e.key.startswith("aten::"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in hist]
        times = [h["step_time_s"] for h in hist]
        norms = [round(h["grad_norm"], 4) for h in hist]
        wall = box["wall"]
        print(f"  {label}: {len(hist)} steps through train_loop in "
              f"{loop_s:.1f} s (checkpoints off), step times {times} s "
              f"(synchronized, the last profiled); losses {losses}, grad "
              f"norms {norms}")
        print(f"  {label} step {TRAIN_STEPS} profiled: wall {wall:.1f} ms "
              f"(profiler on), device busy {busy:.1f} ms "
              f"({100 * busy / wall:.1f}%), {ops} aten ops; peak device "
              f"memory {peak:.2f} GiB; top:")
        for e in ev[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x {e.key[:80]}")
        self.check(len(per_step) == TRAIN_STEPS
                   and all(math.isfinite(v) for v in losses),
                   f"{label}: {len(per_step)} steps, losses {losses}")
        self._check_counts(label, per_step, want)
        summary = dict(steps=len(per_step), losses=losses, grad_norms=norms,
                       step_time_s=times, step3_busy_ms=busy,
                       step3_wall_ms=wall, aten_ops=ops, peak_gib=peak,
                       state_gb=state_gb, params=n, launches=per_step[-1])
        params = state["params"]
        del state
        torch.cuda.empty_cache()
        return summary, params, per_step

    @contextlib.contextmanager
    def _kinks(self, record=None, replay=None, flips=None):
        """The recurrent gates' kinks, ``torch.clamp_max(x, 0.0)`` (the
        exponential input gates, i = exp(min(i~, 0))) and
        ``torch.clamp_min(x, 1.0)`` (the sLSTM's normalizer, max(n, 1)):
        each call's clamped positions appended to `record` in call order;
        or, with `replay`, taken from it (popped) as where(clamped, bound,
        x), whose gradient follows the recorded branch and whose value
        differs from the clamp's only where x, within float32 noise of the
        bound, fell on the other side (those positions counted in
        flips[0])."""
        torch = self.torch
        orig = {"clamp_max": torch.clamp_max, "clamp_min": torch.clamp_min}

        def kink(name, bound, clamped_of):
            def call(x, v, *args, **kw):
                if v != bound or args or kw:
                    return orig[name](x, v, *args, **kw)
                mine = clamped_of(x.detach())
                if replay is None:
                    record.append(mine)
                    return orig[name](x, v)
                clamped = replay.pop(0)
                flips[0] += int((clamped != mine).sum())
                return torch.where(clamped, torch.tensor(
                    bound, dtype=x.dtype, device=x.device), x)
            return call

        torch.clamp_max = kink("clamp_max", 0.0, lambda x: x > 0)
        torch.clamp_min = kink("clamp_min", 1.0, lambda x: x < 1)
        try:
            yield
        finally:
            torch.clamp_max = orig["clamp_max"]
            torch.clamp_min = orig["clamp_min"]

    @contextlib.contextmanager
    def _dac_replay(self, record=None, replay=None):
        """Every projection's DAC (levels, scale) appended to `record` in
        call order; or, with `replay`, taken from it (popped) with the
        straight-through gradient kept, levels = x / scale + detach(
        recorded - x / scale), as quant_levels builds its own."""
        from repro_torch.core import emt_linear
        orig = emt_linear.quant_levels

        def quant(x, bits, axis=None):
            if replay is None:
                levels, scale = orig(x, bits, axis=axis)
                record.append((levels.detach(), scale))
                return levels, scale
            levels, scale = replay.pop(0)
            xs = x / scale
            return xs + (levels - xs).detach(), scale

        emt_linear.quant_levels = quant
        try:
            yield
        finally:
            emt_linear.quant_levels = orig

    def _train_vs_plain(self, label, cfg, lam, params, batch, step,
                        to_host=False, kinks=False):
        """The loss and every gradient leaf of one step through the kernels
        (K3, its experts entry, K5) and through their plain versions with
        the same VJPs, at `cfg` (a 24-bit DAC), within TRAIN_PLAIN_TOL;
        `to_host` moves the kernels' gradients to the host before the plain
        run (the two sets would not fit the card beside the weights).
        `kinks`: the plain run takes the kernel run's branch at every kink
        of the recurrent gates (_kinks) and its DAC levels (_dac_replay):
        the gradient is not continuous at a kink (one position of x within
        float32 noise of 0 at an sLSTM input gate moved that gate's weight
        gradient by 7% of its largest value at xlstm's smoke widths on the
        CPU, 26% at full width on the H100), and with the kinks alone
        replayed the two runs' forward differences still grew through
        xlstm's 24 blocks into its first layers' gradients (1.6e-3 on the
        H100); the positions whose branch the replay decided are
        printed."""
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.train.step import make_grad_fn
        torch = self.torch
        grad_fn = make_grad_fn(cfg, lam)
        branches, flips, levels = [], [0], []
        with contextlib.ExitStack() as stack:
            if kinks:
                stack.enter_context(self._kinks(record=branches))
                stack.enter_context(self._dac_replay(record=levels))
            loss, _, gk = grad_fn(params, batch, step)
        if to_host:
            gk = {p: t.cpu() for p, t in _flat(gk)}
        kern = (loss, gk)
        n = sum(b.numel() for b in branches)
        with contextlib.ExitStack() as stack:
            stack.enter_context(self._ops_through(
                _emt_matmul=k3.plain_differentiable,
                _emt_matmul_experts=k3.plain_experts_differentiable,
                _emt_bitserial=k5.plain_differentiable))
            if kinks:
                stack.enter_context(self._kinks(replay=branches,
                                                flips=flips))
                stack.enter_context(self._dac_replay(replay=levels))
            loss, _, gp = grad_fn(params, batch, step)
        if kinks:
            print(f"  {label}: the gates' kinks and the DAC levels replayed "
                  f"in the plain run: {flips[0]} of {n:,} kink positions "
                  f"took the kernel run's branch against their own")
            self.check(not branches and not levels,
                       f"{label}: {len(branches)} kink calls and "
                       f"{len(levels)} DAC calls left unreplayed")
        self._compare_grads(label, kern, (loss, gp), TRAIN_PLAIN_TOL)
        del kern, gk, gp
        torch.cuda.empty_cache()

    def train_moe(self):
        """moonshot-v1-16b-a3b at published widths cut to
        TRAIN_MOE_LAYERS of 48, on the mixed placement (attention analog
        on PCM; routers on SRAM through K3 at N = 64; the experts technique
        A on RRAM through the experts entry, their gradient through the
        experts' K3-dx and K3-dw), float32, AdamW, lam 1e-6, batch 8 x 128
        (expert capacity 120): a gradient step (launches exact: K3,
        K3-dx, K3-dw 5 L + 1 each, all on the tensor cores; the experts
        entry, its dx and its dw 3 L each; no K5), TRAIN_STEPS steps
        through train_loop (checkpoints off), the last profiled; then the
        trained weights' loss and every gradient through the kernels
        against the plain versions at a 24-bit DAC (TRAIN_PLAIN_TOL)."""
        from repro_torch.configs import get_config
        self._free_serving()
        cfg = get_config(MOE_ARCH, placement="mixed").replace(
            num_layers=TRAIN_MOE_LAYERS)
        run = self._lm_run(cfg, TRAIN_BATCH, TRAIN_SEQ)
        L = cfg.num_layers
        want = self._train_want(run.cfg)
        self.check(want["emt_matmul"] == 5 * L + 1
                   and want["emt_matmul_experts"] == 3 * L,
                   f"moonshot sites {want}")
        summary, params, per_step = self._train_path(
            "moonshot mixed", run, want,
            ("/w", "/wg", "/wu", "/wd", "rho_raw", "embed/table"))
        for name in ("emt_matmul_experts_dx", "emt_matmul_experts_dw"):
            self.records.setdefault(name, {})["launches"] = sum(
                c[name] for c in per_step)
        self.records.setdefault("emt_matmul_experts", {})[
            "train_launches"] = sum(c["emt_matmul_experts"]
                                    for c in per_step)
        self._train_vs_plain(
            "moonshot mixed, 24-bit DAC: kernels vs plain",
            run.cfg.replace(emt=_dac_bits(run.cfg.emt, 24)), run.tcfg.lam,
            params, run.data.batch_at(TRAIN_STEPS), TRAIN_STEPS)
        self.train_moe_summary = summary
        del params, run
        self.torch.cuda.empty_cache()

    def train_xlstm(self):
        """xlstm-350m at full width through launch.setup's path (analog,
        AdamW, lam 1e-6, batch 8 x 64: the reference's mLSTM gives NaN on a
        128-position chunk): a gradient step (K3, K3-dx, K3-dw 166 each,
        all on the tensor cores, as a served admission's projections),
        TRAIN_STEPS steps through train_loop (checkpoints off), the last
        profiled; then the trained weights' loss and every gradient
        through the kernels against the plain versions at a 24-bit DAC,
        the plain run on the kernel run's branch at the gates' kinks and on
        its DAC levels."""
        from repro_torch.launch import train as launch
        argv = ["--arch", XLSTM_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
                str(XLSTM_TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--lam",
                "1e-6", "--opt", "adamw", "--ckpt-dir",
                os.path.join(ROOT, "build", "chip_smoke_no_ckpt")]
        run = launch.setup(argv, torch_device="cuda", seed=SEED)
        print(f"  launch.train {' '.join(argv)}")
        want = self._train_want(run.cfg)
        self.check(want["emt_matmul"] == 166, f"xlstm sites {want}")
        summary, params, _ = self._train_path(
            "xlstm analog", run, want, ("/w", "rho_raw", "embed/table"))
        self._train_vs_plain(
            "xlstm analog, 24-bit DAC, kinks and levels replayed: kernels "
            "vs plain", run.cfg.replace(emt=_dac_bits(run.cfg.emt, 24)),
            run.tcfg.lam, params, run.data.batch_at(TRAIN_STEPS),
            TRAIN_STEPS, kinks=True)
        self.train_xlstm_summary = summary
        del params, run
        self.torch.cuda.empty_cache()

    def train_jamba_vs_plain(self):
        """jamba-v0.1-52b at published widths cut to TRAIN_JAMBA_LAYERS of
        32 (mamba + a dense MLP on K5, technique C's ideal-matmul VJP;
        mamba + MoE, the experts through the experts entry at M = 20) on
        the mixed placement: one gradient step, no optimizer state, at
        batch 2 x 64 and a 24-bit DAC with the bit-serial MLPs' read noise
        off (a bit-serial read is not continuous in its level; the experts
        on that corner read in analog and keep theirs): launches exact,
        finite nonzero gradients, peak memory; then the loss and every
        gradient leaf against the plain versions (the kernels' gradients
        moved to the host first) within TRAIN_PLAIN_TOL."""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.placement import LayerRule
        from repro_torch.data.synthetic import SyntheticLM
        from repro_torch.models import lm
        from repro_torch.train.step import make_grad_fn
        torch = self.torch
        cfg = get_config(JAMBA_ARCH, placement="mixed").replace(
            num_layers=TRAIN_JAMBA_LAYERS, dtype=torch.float32)
        emt = _dac_bits(cfg.emt, 24)
        emt = dataclasses.replace(emt, rules=tuple(
            LayerRule(r.pattern, r.emt.replace(device=dataclasses.replace(
                r.emt.device, amplitude=0.0)))
            if r.pattern == "*/mlp/*" and r.emt.mode == "bitserial" else r
            for r in emt.rules))
        cfg = cfg.replace(emt=emt)
        want = self._train_want(cfg)
        self.check(want["emt_bitserial"] > 0
                   and want["emt_matmul_experts"] == 3,
                   f"jamba sites {want}")
        params = self._arch_model(cfg, "published widths", JAMBA_ARCH, 32)
        for _, p in _flat(params):
            p.requires_grad_(True)
        data = SyntheticLM(vocab_size=cfg.vocab_size,
                           seq_len=JAMBA_TRAIN_SEQ,
                           batch_size=JAMBA_TRAIN_BATCH, d_model=cfg.d_model,
                           device=self.dev)
        batch = data.batch_at(0)
        torch.cuda.reset_peak_memory_stats()
        counters = self._reset_launches()
        t0 = time.perf_counter()
        loss, _, grads = make_grad_fn(cfg, 1e-6)(params, batch, 0)
        self.sync()
        secs = time.perf_counter() - t0
        got = {k: counters[k].launches for k in TRAIN_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  jamba mixed gradient step ({cfg.blocks()}, batch "
              f"{JAMBA_TRAIN_BATCH} x {JAMBA_TRAIN_SEQ}): loss "
              f"{loss.item():.4f} in {secs:.2f} s, launches {got}; peak "
              f"device memory {peak:.2f} GiB")
        self.check(got == want, f"jamba gradient step launches {got}, "
                   f"want {want}")
        self._grad_report("jamba mixed step 0", grads,
                          ("/w", "/wg", "/wu", "/wd", "rho_raw", "A_log",
                           "embed/table"), skip=("router/rho_raw",))
        del grads
        torch.cuda.empty_cache()
        self._train_vs_plain("jamba mixed, 24-bit DAC (bit-serial MLPs "
                             "read noise off): kernels vs plain", cfg, 1e-6,
                             params, batch, 0, to_host=True)
        self.train_jamba_summary = dict(
            loss=loss.item(), step_s=secs, peak_gib=peak, launches=got,
            params=sum(p.numel() for _, p in _flat(params)))
        del params
        torch.cuda.empty_cache()


def _cancel_after_first_token(handle, timeout: float = 600.0):
    """Cancel `handle` from a client thread once its first token arrived
    (a client hanging up after the first token); returns the thread."""
    import threading

    def run():
        if handle.next_token(timeout=timeout) is not None:
            handle.cancel()

    t = threading.Thread(target=run, name="cancel-after-first", daemon=True)
    t.start()
    return t


def _dac_bits(emt, bits: int, quiet: bool = False):
    """`emt` (a config or a placement) with every corner's activation DAC
    at `bits`; `quiet` also turns the bit-serial corners' read noise off."""
    import dataclasses
    from repro_torch.core.placement import map_corners

    def corner(e):
        e = e.replace(quant=dataclasses.replace(e.quant, a_bits=bits))
        if quiet and e.mode == "bitserial":
            e = e.replace(device=dataclasses.replace(e.device, amplitude=0.0))
        return e
    return map_corners(emt, corner)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    s = Smoke()
    t_start = time.perf_counter()
    phases = [("device", s.device_info), ("build", s.build),
              ("model", s.model), ("model, seamless", s.seamless_model),
              ("K3 emt_matmul", s.k3),
              ("K3 emt_matmul, int8 weights", s.k3_int8),
              ("K1 paged_attention_decode", s.k1),
              ("K2 paged_prefill", s.k2), ("K4 paged_attention", s.k4),
              ("K5 emt_bitserial", s.k5),
              ("K3 backward", s.k3_backward),
              ("engine, analog", s.engine),
              ("engine, mixed placement", s.engine_mixed),
              ("engine, seamless", s.engine_seamless),
              ("engine, ring paged", s.engine_ring_paged),
              ("engine, ring contiguous", s.engine_ring_contiguous),
              ("kernel calls vs plain, analog", s.calls_vs_plain),
              ("kernel calls vs plain, mixed", s.mixed_calls_vs_plain),
              ("kernel calls vs plain, seamless", s.s2s_calls_vs_plain),
              ("kernel calls vs plain, ring", s.ring_calls_vs_plain),
              ("logits vs plain, analog", s.logits_vs_plain),
              ("logits vs plain, mixed", s.mixed_logits_vs_plain),
              ("logits vs plain, seamless", s.s2s_logits_vs_plain),
              ("logits vs plain, ring", s.ring_logits_vs_plain),
              ("engine, prefix cache", s.engine_prefix),
              ("server, Poisson stream", s.server_stream),
              ("kernel calls vs plain, prefix", s.prefix_calls_vs_plain),
              ("kernel calls vs plain, Poisson", s.poisson_calls_vs_plain),
              ("engine, speculative paged", s.engine_speculative_paged),
              ("engine, speculative contiguous",
               s.engine_speculative_contiguous),
              ("engine, int8", s.engine_int8),
              ("engine, moe mixed", s.engine_moe),
              ("kernel calls vs plain, moe", s.moe_calls_vs_plain),
              ("logits vs plain, moe", s.moe_logits_vs_plain),
              ("engine, xlstm analog", s.engine_xlstm),
              ("kernel calls vs plain, xlstm", s.xlstm_calls_vs_plain),
              ("logits vs plain, xlstm", s.xlstm_logits_vs_plain),
              ("engine, jamba mixed", s.engine_jamba),
              ("kernel calls vs plain, jamba", s.jamba_calls_vs_plain),
              ("logits vs plain, jamba", s.jamba_logits_vs_plain),
              ("engine, gemma2 analog", s.engine_gemma2),
              ("kernel calls vs plain, gemma2", s.gemma2_calls_vs_plain),
              ("logits vs plain, gemma2", s.gemma2_logits_vs_plain),
              ("model, cut archs", s.model_cut_archs),
              ("train, gemma3-1b analog", s.train_gemma3),
              ("train vs plain", s.train_vs_plain),
              ("train, paper CNN", s.train_cnn),
              ("K3 experts backward", s.k3_experts_backward),
              ("train, moonshot mixed", s.train_moe),
              ("train, xlstm analog", s.train_xlstm),
              ("train, jamba mixed vs plain", s.train_jamba_vs_plain)]
    for name, fn in phases:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            s.sync()
        except Exception:                                # phase boundary
            traceback.print_exc()
            s.fail(f"phase {name} raised")
            if name in ("device", "build", "model", "model, seamless"):
                break
        print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if s.failures:
        print(f"chip_smoke FAILED: {s.failures}", file=sys.stderr)
        return 1
    print("engine, analog: " + json.dumps(s.engine_summary))
    print("engine, mixed placement: " + json.dumps(s.mixed_summary))
    print("engine, seamless: " + json.dumps(s.s2s_summary))
    for label, summary in s.ring_summaries.items():
        print(f"engine, {label}: " + json.dumps(summary))
    print("engine, prefix cache: " + json.dumps(s.prefix_summary))
    print("server, Poisson stream: " + json.dumps(s.poisson_summary))
    for label, summary in s.spec_summaries.items():
        print(f"engine, {label}: " + json.dumps(summary))
    print("engine, int8: " + json.dumps(s.int8_summary))
    print("engine, moe mixed: " + json.dumps(s.moe_summary))
    print("engine, xlstm analog: " + json.dumps(s.xlstm_summary))
    print("engine, jamba mixed: " + json.dumps(s.jamba_summary))
    print("engine, gemma2 analog: " + json.dumps(s.gemma2_summary))
    print("model, cut archs: " + json.dumps(s.cut_summaries))
    print("train, gemma3-1b analog: " + json.dumps(s.train_summary))
    print("train, paper CNN: " + json.dumps(s.cnn_summary))
    print("train, moonshot mixed: " + json.dumps(s.train_moe_summary))
    print("train, xlstm analog: " + json.dumps(s.train_xlstm_summary))
    print("train, jamba mixed: " + json.dumps(s.train_jamba_summary))
    print(s.smi)
    print(json.dumps({"kernels": [s.records[n] for n in
                                  ("paged_attention_decode", "paged_prefill",
                                   "emt_matmul", "emt_matmul_tc",
                                   "paged_attention",
                                   "emt_bitserial", "emt_matmul_dx",
                                   "emt_matmul_dw", "emt_matmul_int8",
                                   "emt_matmul_experts",
                                   "emt_matmul_experts_dx",
                                   "emt_matmul_experts_dw")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
