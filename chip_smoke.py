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
   640) through gemma3-1b as published: 22 sliding-window layers (window
   512, every ring wraps) and 4 global, analog, per-row DAC scale, frozen
   noise, chunked prefill; on the paged layout (per-slot rings of blocks
   for the local layers) with exact launch counts, K1 26 per decode step,
   K2 4 per chunk step (the global layers), K3 183 per step, and on the
   contiguous layout (JAX's default engine; K3 183 per step, no K1 or
   K2).  Then, on a history chunk step that wraps the rings, a chunk step
   and a decode step: every paged kernel call held to its plain version
   (K1 on the ring tables to its float64 plain version), and the logits
   of the paged and contiguous paths against each other and each against
   its plain path, 1e-3 at the 24-bit DAC, the 8-bit gaps reported.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Every "ms" is the kernel's time in one
main-path step: K1 = the 26 decode-attention launches of a gemma3 decode
step, K2 = the 26 prefill launches of a chunk step, K3 = the 183 noisy
matmuls of an analog decode step, K4 = the 12 cross-attention launches of
a seamless decode step, K5 = the 78 bit-serial MLP matmuls of a mixed
decode step; K3's and K5's records also carry ``chunk_ms``,
``chunk_bound_ms`` and ``chunk_library_ms``, the same matmuls and their
yardstick at M = 64, and K1's, K4's and K5's
``device_ms`` (K5's also ``chunk_device_ms``), the kernels' device time in
that step from torch.profiler, null where no trace recorded them (not
measured).  "launches" counts
K1-K3 in the analog run, K4 in the seamless run and K5 in the mixed run;
K1-K3 also carry ``ring_paged_launches`` and ``ring_contiguous_launches``,
their counts in the two ring runs.
Bounds are the largest of the bytes over the H100 SXM's published 3.35
TB/s, the FP32 pipe's operations (FLOPs, and for the noisy matmuls the
hash's integer multiplies and the noise factor's FMULs as two each) over
its 67 TFLOP/s (no tensor cores) and, for the noisy matmuls, the integer
ALU pipe's operations of the noise hash and the state select over 64 lanes
per SM x 132 SMs x 1.98 GHz (16.7 TOP/s).  Those counts are the kernels'
own (HASH_OPS), matched against their SASS by scripts/sass_ops.py.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
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
# (2 XOR, 1 shift, 2 IMAD) and those two values (2 FMUL).  K5's tiled
# kernel (M > 16): per plane hash_mix, compare + select and w * factor;
# per element hash_rc.  scripts/sass_ops.py counts the GEMV loops' SASS
# on sm_90a: K5's plane loop issues 7 LOP3, 5 SHF, 1 ISETP, 1 FSEL, 4 IMAD
# and M FFMA per element-plane (plus ~0.75 of loop control), K3's K walk
# 17.4 ALU-pipe operations per element, ~25 instructions in all: below
# the ALU pipe's 64 lanes, 128 an SM a clock issue.
HASH_OPS = {
    "K3": dict(alu=17, imad=6, fmul=1),
    "K5 GEMV": dict(alu=14, imad=4, fmul=0, alu_el=3, imad_el=2, fmul_el=2),
    "K5 tiled": dict(alu=16, imad=4, fmul=1, alu_el=1, imad_el=2, fmul_el=0),
}
ARCH = "gemma3-1b"
SEAMLESS = "seamless-m4t-medium"
BATCH, BLOCK, CHUNK, MAX_LEN, MAX_NEW = 4, 16, 16, 128, 8
SEED = 0
# the ring paths: prompts past gemma3-1b's 512-position window, so that
# every ring wraps
RING_MAX_LEN, RING_PROMPTS = 640, (520, 600)


def bound(nbytes: float, flops: float, alu: float = 0.0, fma: float = 0.0):
    """(ms, "bytes" or "operations", the term that bounds): the largest of
    the bytes over the memory rate, the FP32 pipe's operations (the FLOPs
    and `fma` other operations there, IMAD and FMUL, two FLOPs' worth
    each) and the integer ALU pipe's `alu` operations over their peak
    rates."""
    terms = [(nbytes / HBM_BPS * 1e3, "bytes", "bytes"),
             ((flops + 2 * fma) / FP32_FLOPS * 1e3, "operations",
              "FP32 pipe" if fma else "FP32 FLOPs"),
             (alu / INT32_OPS * 1e3, "operations", "INT32 ALU pipe")]
    return max(terms, key=lambda t: t[0])


def hash_ops(kind: str, elements: int, planes: int = 1):
    """(ALU-pipe ops, other FP32-pipe ops) of the noise hash and select of
    `elements` weight elements on `planes` planes (HASH_OPS[kind])."""
    c = HASH_OPS[kind]
    alu = elements * (c["alu"] * planes + c.get("alu_el", 0))
    fma = elements * ((c["imad"] + c["fmul"]) * planes + c.get("imad_el", 0)
                      + c.get("fmul_el", 0))
    return alu, fma


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


def device_ms(fn, key, tries: int = 3):
    """Device time (ms) of the kernels whose name contains `key` (a string
    or a tuple of them) in one run of fn, from torch.profiler: the kernels
    alone, without the host's dispatch gaps that a CUDA-event time of short
    launches includes.  A trace that holds none of them (the profiler on
    the card has dropped a run's device events) is taken again, up to
    `tries` times; None (not measured, null in the record) if none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    keys = (key,) if isinstance(key, str) else key
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if any(k in e.key for k in keys)) / 1e3
        if ms > 0:
            return ms
    print(f"  (torch.profiler recorded no device time for {keys} in "
          f"{tries} traces: not measured)")
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
        # the published stack: 5 sliding-window (ring) layers to 1 global
        self.ring = build_config(ARCH, "analog", smoke=False, a_per_row=True)
        self.check(self.ring.blocks().count("global") == 4
                   and self.ring.sliding_window == 512,
                   f"ring stack {self.ring.blocks()}")
        # every projection of the three paths is active (it has a rho_raw)
        # and a local layer has a global one's weights: one parameter tree
        # serves all three
        shapes = [[(k, tuple(v.shape)) for k, v in _flat(lm.specs(c))]
                  for c in (self.cfg, self.mixed, self.ring)]
        self.check(shapes[0] == shapes[1] == shapes[2],
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
            """Bytes (each input read once, y written once), FP32 FLOPs and
            the hash's and select's operations, once per weight element
            (HASH_OPS["K3"])."""
            nbytes = sum(4 * (M * K + K * N + M * N)
                         for K, N in (wq.shape for wq, *_ in calls))
            flops = sum(2 * M * wq.numel() for wq, *_ in calls)
            alu, fma = hash_ops("K3", sum(wq.numel() for wq, *_ in calls))
            return bound(nbytes, flops, alu, fma), nbytes, flops

        # event times first, the kernel beside its yardstick, then the
        # profiler's device times
        keys = ("emt_matmul", "split_sum")
        ms = cuda_time(lambda: run(k.emt_matmul, xs), 5)
        lib_ms = cuda_time(run_library, 5)
        chunk_ms = cuda_time(lambda: run(k.emt_matmul, xc), 3)
        chunk_lib_ms = cuda_time(lambda: run_library(xc), 3)
        dev_ms = device_ms(lambda: run(k.emt_matmul, xs), keys)
        chunk_dev_ms = device_ms(lambda: run(k.emt_matmul, xc), keys)
        del noisy
        plain_ms = cuda_time(lambda: run(k.plain, xs), 2, warmup=1)
        (b_ms, by, bterm), nbytes, flops = step_bound(BATCH)
        (cb_ms, cby, cterm), _, cflops = step_bound(BATCH * CHUNK)
        self.records["emt_matmul"] = dict(
            name="emt_matmul", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_matmul.cu",
            replaces="src/repro/kernels/emt_matmul.py:57",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, chunk_ms=chunk_ms,
            chunk_bound_ms=cb_ms, chunk_library_ms=chunk_lib_ms)
        print(f"  K3 per decode step ({len(prepared)} calls, M={BATCH}): "
              f"kernel {ms:.3f} ms (device time {fmt(dev_ms)}), plain "
              f"{plain_ms:.3f} ms, torch.matmul on pre-noised weights "
              f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({bterm}; "
              f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP), roofline "
              f"share {100 * b_ms / ms:.2f}%")
        print(f"  K3 per chunk step ({len(prepared)} calls, "
              f"M={BATCH * CHUNK}): kernel {chunk_ms:.3f} ms (device time "
              f"{fmt(chunk_dev_ms)}), torch.matmul on pre-noised weights "
              f"{chunk_lib_ms:.3f} ms (loses by "
              f"{chunk_ms / chunk_lib_ms:.3f}x), bound "
              f"{cb_ms:.3f} ms ({cterm}; {cflops / 1e9:.3f} GFLOP), roofline "
              f"share {100 * cb_ms / chunk_ms:.2f}%")
        # per distinct (K, N, layout) at M = 4: which calls lead the step
        groups = {}
        for i, (wq, *_) in enumerate(prepared):
            groups.setdefault((*wq.shape, wq.stride(1) == 1), []).append(i)
        for (K, N, n_major), idx in groups.items():
            calls = [prepared[i] for i in idx]
            inputs = [xs[i] for i in idx]
            g_ms = cuda_time(lambda: run(k.emt_matmul, inputs, calls), 5)
            g_dev = device_ms(lambda: run(k.emt_matmul, inputs, calls), keys)
            (g_b, _, g_term), g_bytes, _ = step_bound(BATCH, calls)
            print(f"  K3 {K}x{N}{'' if n_major else ' (transposed)'} at "
                  f"M={BATCH}: {len(idx)} calls a step, {g_ms:.4f} ms "
                  f"(device time {fmt(g_dev, 4)}), bound {g_b:.4f} ms "
                  f"({g_term}; {g_bytes / 1e9:.3f} GB), share of the device "
                  f"time {share(g_b, g_dev)}")

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
            # levels 2^p on the identity (the tiled kernel) and on BATCH of
            # its rows (the GEMV kernel) return 2^p x plane p's noisy weight
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
        dev_ms = device_ms(lambda: run(k.emt_bitserial, xs), keys)
        chunk_dev_ms = device_ms(lambda: run(k.emt_bitserial, xc), keys)
        del lib
        plain_ms = cuda_time(lambda: run(k.plain, xs), 1, warmup=1)

        def step_bound(inputs, idx=range(len(prepared))):
            """Bytes (each input read once, y written once), FP32 FLOPs and
            the hash's and select's operations (every weight element on
            every plane, as the kernel that serves M computes them:
            HASH_OPS), and the share of (k, plane) pairs whose plane is not
            zero in every row."""
            nbytes = flops = alu = fma = pairs = total = 0
            for i in idx:
                x, (wq, *_) = inputs[i], prepared[i]
                M, (K, N) = x.shape[0], wq.shape
                nbytes += 4 * (M * K + K * N + M * N)
                flops += 2 * M * N * K * bits
                a, f = hash_ops("K5 GEMV" if M <= k.GEMV_MAX_M
                                else "K5 tiled", N * K, bits)
                alu, fma = alu + a, fma + f
                pairs += plane_pairs(x, bits)
                total += K * bits
            return bound(nbytes, flops, alu, fma), nbytes, alu, pairs / total

        (b_ms, by, bterm), nbytes, alu, need = step_bound(xs)
        (cb_ms, cby, cterm), _, calu, _ = step_bound(xc)
        self.records["emt_bitserial"] = dict(
            name="emt_bitserial", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_bitserial.cu",
            replaces="src/repro/kernels/emt_bitserial.py:69",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms, device_ms=dev_ms,
            chunk_ms=chunk_ms, chunk_device_ms=chunk_dev_ms,
            chunk_bound_ms=cb_ms, chunk_library_ms=chunk_lib_ms)
        print(f"  K5 per decode step ({len(prepared)} calls, M={BATCH}, "
              f"{bits} planes): kernel {ms:.3f} ms (device time "
              f"{fmt(dev_ms)}), plain {plain_ms:.3f} ms, torch.bmm on "
              f"planes and pre-noised weights {lib_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({bterm}; {nbytes / 1e9:.3f} GB, "
              f"{alu / 1e9:.3f} G ALU-pipe ops), roofline share "
              f"{100 * b_ms / ms:.2f}% (of the device time "
              f"{share(b_ms, dev_ms)}); (k, plane) pairs whose plane "
              f"is zero in every row: {100 * (1 - need):.2f}%")
        print(f"  K5 per chunk step ({len(prepared)} calls, "
              f"M={BATCH * CHUNK}): kernel {chunk_ms:.3f} ms (device time "
              f"{fmt(chunk_dev_ms)}), torch.bmm on planes and pre-noised "
              f"weights {chunk_lib_ms:.3f} ms (loses by "
              f"{chunk_ms / chunk_lib_ms:.3f}x), bound {cb_ms:.3f} ms "
              f"({cterm}; "
              f"{calu / 1e9:.3f} G ALU-pipe ops), roofline share "
              f"{100 * cb_ms / chunk_ms:.2f}%")
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
            (g_b, _, g_term), _, _, g_need = step_bound(xs, idx)
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

    # -- phase 4 -------------------------------------------------------------
    def _requests(self, cfg, ring=False):
        """6 requests, 2 of them sampled; prompts of 20 to 120 tokens, or,
        for the ring paths, 520 to 600 (every window-512 ring wraps)."""
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        rng = np.random.default_rng(SEED + (13 if ring else 11))
        lo, hi = RING_PROMPTS if ring else (20, MAX_LEN - MAX_NEW)
        reqs = []
        for i in range(6):
            plen = int(rng.integers(lo, hi + 1))
            kw = dict(prompt=rng.integers(0, cfg.vocab_size, plen)
                      .astype(np.int32), max_new=MAX_NEW, seed=1000 + i)
            if i in (1, 4):
                kw.update(temperature=0.8, top_k=40)
            reqs.append(GenRequest(**kw))
        return reqs

    def _profile_steps(self, eng, reqs, per_kind: int = 2):
        """Serve `reqs` on `eng`, profiling single steps (from the third on)
        until `per_kind` steps with prefill work (chunk steps; admission
        steps of the legacy prefill) and `per_kind` decode steps are
        captured; print each step's wall time, device busy time (the sum of
        its device events) and top kernels.  Profiling single steps keeps
        the trace small."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for r in reqs:
            eng.submit(r)
        prefill = "chunk" if eng.chunked else "admission + decode"
        seen = {prefill: 0, "decode": 0}
        n = 0
        while eng.scheduler.busy:
            n += 1
            if n < 3 or min(seen.values()) >= per_kind:
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
            # time of the kernels it launched, which are entries too
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
            ev.sort(key=lambda e: e.self_device_time_total, reverse=True)
            busy = sum(e.self_device_time_total for e in ev) / 1e3
            ops = sum(e.count for e in prof.key_averages()
                      if e.key.startswith("aten::"))
            print(f"  profiled {kind} step {n}: wall {wall:.1f} ms "
                  f"(profiler on), device busy {busy:.1f} ms "
                  f"({100 * busy / wall:.1f}%), {ops} aten ops; top:")
            for e in ev[:8]:
                print(f"    {e.self_device_time_total / 1e3:8.2f} ms "
                      f"{e.count:6d}x {e.key[:80]}")

    def _counters(self):
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import paged_attention as k1
        from repro_torch.kernels import paged_prefill as k2
        return {"paged_attention_decode": k1.paged_attention_decode,
                "paged_attention": k1.paged_attention,
                "paged_prefill": k2.paged_prefill,
                "emt_matmul": k3.emt_matmul,
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

    def _serve(self, cfg, params, label, per_kind, paged=True, ring=False):
        """Serve the 6 requests on `cfg` (after one warm-up run) with every
        launch count reset just before and read just after; profile
        `per_kind` prefill and decode steps of a third run.  `paged`
        chooses the KV layout; `ring` the long prompts and max_len of the
        ring paths.  Returns (summary, launches, metrics, results)."""
        import numpy as np
        from repro_torch.serve.engine import ServingEngine
        torch = self.torch

        def make():
            return ServingEngine(cfg, params, batch_size=BATCH,
                                 max_len=RING_MAX_LEN if ring else MAX_LEN,
                                 seed=SEED, fresh_noise=False, paged=paged,
                                 block_size=BLOCK, prefill_chunk=CHUNK,
                                 device=self.dev)

        make().serve(self._requests(cfg, ring), stagger=2)     # warm-up
        eng = make()
        reqs = self._requests(cfg, ring)
        counters = self._counters()
        steps = {"chunk_step": 0, "decode_step": 0}
        self.sync()
        torch.cuda.reset_peak_memory_stats()
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
            ok = (r.done_reason == "max_new" and len(r.tokens) == MAX_NEW
                  and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size))
                  .all() and np.isfinite(r.energy_pj) and r.energy_pj > 0)
            self.check(bool(ok), f"request {r.rid} result malformed: {r}")
        self.check(eng.energy_conserved(results), "energy not conserved")
        total = sum(m["corner_energy_pj"].values())
        self.check(abs(total - m["total_energy_pj"])
                   <= 1e-6 * m["total_energy_pj"],
                   f"{label}: corners sum to {total}, total "
                   f"{m['total_energy_pj']}")
        self._profile_steps(make(), self._requests(cfg, ring), per_kind)
        summary = dict(tok_s=ntok / wall, wall_s=wall, tokens=ntok,
                       steps=m["steps"], chunk_steps=steps["chunk_step"],
                       decode_steps=steps["decode_step"],
                       uj_per_token=m["total_energy_pj"] * 1e-6 / ntok,
                       uj_per_token_by_corner=corners, peak_gib=peak / 2**30)
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
        summary, launches, m, _ = self._serve(self.cfg, self.params,
                                              "analog", 2)
        self._check_launches("analog", launches, m["steps"], {
            "paged_attention_decode": None, "paged_prefill": None,
            "emt_matmul": 7 * L + 1, "emt_bitserial": 0,
            "paged_attention": 0})
        for name in ("paged_attention_decode", "paged_prefill",
                     "emt_matmul"):
            self.records[name]["launches"] = launches[name]
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
        """gemma3-1b as published (22 ring layers of window 512, 4 global)
        on 6 requests of 520-600 tokens.  Paged: per decode step 26 K1
        (22 on ring tables, 4 on the global one), per chunk step 4 K2 (the
        global layers; a ring layer's chunk attends in plain PyTorch, as
        in JAX), 183 K3 per step.  Contiguous: 183 K3 per step, nothing
        else (its attention is plain, as in JAX)."""
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
        """Three model steps on the published stack at full width, from a
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

    def _step_pair(self, cfg):
        """One chunk step (over K/V history) then one decode step on `cfg`,
        from a fresh cache.  Returns [(step, logits or None, projections
        it runs)] in call order; the history step's logits are not held."""
        import numpy as np
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
        lm.chunk_step(self.params, cache, toks, torch.zeros_like(start),
                      start.clamp(min=1), cfg, Ctx(seed=SEED),
                      active=start > 0, page_tables=pt, page_lens=lens)
        lc, cache, _ = lm.chunk_step(self.params, cache, toks, start, ntok,
                                     cfg, Ctx(seed=SEED), active=act,
                                     page_tables=pt, page_lens=lens)
        nxt = torch.as_tensor(self._first_tokens(lc), device=self.dev)
        ld, cache, _ = lm.decode_step(self.params, cache, nxt, start + ntok,
                                      cfg, Ctx(seed=SEED), active=act,
                                      page_tables=pt, page_lens=lens)
        n = 7 * cfg.num_layers + 1
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
        worst = {"emt_matmul": 0.0, "emt_bitserial": 0.0,
                 "paged_attention_decode": 0.0, "paged_attention": 0.0,
                 "paged_prefill": 0.0}
        counts = dict.fromkeys(worst, 0)
        pools_ok = {"paged_attention_decode": True, "paged_attention": True}
        names = ("_emt_matmul", "_emt_bitserial", "_paged_decode",
                 "_paged_attend", "_paged_prefill")
        orig = {n: getattr(ops, n) for n in names}

        def checked(name, attr, plain):
            def call(*args, **kw):
                y = orig[attr](*args, **kw)
                worst[name] = max(worst[name],
                                  rel_err(y, plain(*args, **kw))[1])
                counts[name] += 1
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

        pairs = [0, 0]                  # K5 GEMV (k, plane) pairs: needed, all
        k5_checked = checked("emt_bitserial", "_emt_bitserial", k5.plain)

        def k5_call(xq, *args, **kw):
            if xq.shape[0] <= k5.GEMV_MAX_M:
                pairs[0] += plane_pairs(xq, kw["bits"])
                pairs[1] += xq.shape[1] * kw["bits"]
            return k5_checked(xq, *args, **kw)

        with self._ops_through(
                _emt_matmul=checked("emt_matmul", "_emt_matmul", k3.plain),
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
        """The ring paged steps: 26 K1 calls in the decode step (22 on
        wrapped ring tables), 4 K2 calls in each chunk step, 183 K3 calls
        a step."""
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

    def _logits_vs_plain(self, cfg, label, steps):
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
        paths."""
        import dataclasses
        from repro_torch.core.placement import as_placement, map_corners
        from repro_torch.kernels import emt_bitserial as k5
        from repro_torch.kernels import emt_matmul as k3

        def f64(plain):
            def call(x, w, sig, **kw):
                return plain(x.double(), w.double(), sig, **kw).float()
            return call

        def dac24(quiet_bitserial):
            def corner(e):
                e = e.replace(quant=dataclasses.replace(e.quant, a_bits=24))
                if quiet_bitserial and e.mode == "bitserial":
                    e = e.replace(device=dataclasses.replace(e.device,
                                                             amplitude=0.0))
                return e
            return cfg.replace(emt=map_corners(cfg.emt, corner))

        plain = dict(_emt_matmul=k3.plain, _emt_bitserial=k5.plain)
        plain64 = dict(_emt_matmul=f64(k3.plain),
                       _emt_bitserial=f64(k5.plain))
        p = as_placement(cfg.emt)
        bitserial = any(e.mode == "bitserial"
                        for e in [r.emt for r in p.rules] + [p.default])
        self.__dict__.pop("_tokens", None)
        quiet = ", bit-serial read noise off" if bitserial else ""
        self._compare(f"{label}, 24-bit DAC{quiet}: kernel vs plain path",
                      self._run_path(dac24(True), steps),
                      self._run_path(dac24(True), steps, plain=plain),
                      limit=1e-3)
        if bitserial:
            self.__dict__.pop("_tokens", None)
            self._compare(f"{label}, 24-bit DAC, bit-serial read noise on: "
                          "kernel vs plain path",
                          self._run_path(dac24(False), steps),
                          self._run_path(dac24(False), steps, plain=plain))

        self.__dict__.pop("_tokens", None)
        lk, lp, l64 = [], [], []
        kern = self._run_path(cfg, steps, levels=lk)
        ref = self._run_path(cfg, steps, plain=plain, levels=lp)
        ref64 = self._run_path(cfg, steps, plain=plain64, levels=l64)
        self._compare(f"{label}, 8-bit DAC: kernel vs plain path", kern, ref)
        self._compare(f"{label}, 8-bit DAC: plain f32 vs plain f64 "
                      "accumulation", ref, ref64)
        self._level_flips(label, "kernel vs plain path", lk, lp, kern)
        self._level_flips(label, "plain f32 vs plain f64 accumulation", lp,
                          l64, kern)

    def logits_vs_plain(self):
        self._logits_vs_plain(self.cfg, "analog", self._step_pair)

    def mixed_logits_vs_plain(self):
        self._logits_vs_plain(self.mixed, "mixed", self._step_pair)

    def s2s_logits_vs_plain(self):
        self._logits_vs_plain(self.s2s, "seamless", self._s2s_steps)

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
              ("K1 paged_attention_decode", s.k1),
              ("K2 paged_prefill", s.k2), ("K4 paged_attention", s.k4),
              ("K5 emt_bitserial", s.k5),
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
              ("logits vs plain, ring", s.ring_logits_vs_plain)]
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
    print(s.smi)
    print(json.dumps({"kernels": [s.records[n] for n in
                                  ("paged_attention_decode", "paged_prefill",
                                   "emt_matmul", "paged_attention",
                                   "emt_bitserial")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
