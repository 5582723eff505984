#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc each, in parallel) and print ptxas' registers / shared memory /
   spills;
3. hold every kernel against its plain PyTorch version on the card at the
   main path's shapes (gemma3-1b, batch 4, block 16, chunk 16) and time it,
   its plain version and one PyTorch library call computing the same
   function (a yardstick the port never calls), beside its bound;
4. serve 6 staggered requests through the port's ServingEngine at full
   gemma3-1b width (random weights from a seed; analog, all-global,
   per-row DAC scale, frozen noise, paged KV, chunked prefill), with every
   kernel's launch count reset just before and read just after; then hold
   every kernel call of one chunk step and one decode step to its plain
   version on the model's activations, and those steps' logits to the
   plain path's (1e-3 with a 24-bit activation DAC; the main path's 8-bit
   DAC gap is reported with the level flips that cause it).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Every "ms" is the kernel's time in one
main-path step: K1 = the 26 decode-attention launches of a decode step,
K2 = the 26 prefill launches of a chunk step, K3 = the 183 noisy matmuls of
a decode step.  Bounds use the H100 SXM's published 3.35 TB/s and
67 TFLOP/s (FP32, no tensor cores).
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
ARCH = "gemma3-1b"
BATCH, BLOCK, CHUNK, MAX_LEN, MAX_NEW = 4, 16, 16, 128, 8
SEED = 0


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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
        torch = self.torch
        self.cfg = build_config(ARCH, "analog", smoke=False, a_per_row=True)
        t0 = time.perf_counter()
        self.params = lm.init_model_params(self.cfg, SEED, device=self.dev)
        self.sync()
        n = sum(p.numel() for _, p in _flat(self.params))
        print(f"model: {ARCH} full width, {self.cfg.num_layers} layers, "
              f"{n:,} parameters (f32), init "
              f"{time.perf_counter() - t0:.2f} s")

    def k3(self):
        """Technique-A matmul at every projection of one decode step."""
        import math
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
        # correctness at every distinct (K, N), decode and chunk row counts
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
                yp = k.plain(x, wq, sig, device=emt.device, seed=SEED,
                             plane=plane)
                self.sync()
                d, r = rel_err(y, yp)
                worst = max(worst, d)
                print(f"  K3 {M}x{K} @ {K}x{N}"
                      f"{' (tied unembed, transposed)' if wq.stride(0) == 1 else ''}"
                      f": max|diff| {d:.3e} rel {r:.3e}")
                self.check(r <= 1e-5, f"K3 {M}x{K}x{N} rel {r:.3e} > 1e-5")
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
        # timing: one decode step's 183 calls, in model order
        xs = [torch.randn((BATCH, wq.shape[0]), generator=gen, device=self.dev)
              for wq, *_ in prepared]

        def run_kernel():
            for x, (wq, rho, sig, plane) in zip(xs, prepared):
                k.emt_matmul(x, wq, sig, device=emt.device, seed=SEED,
                             plane=plane)

        def run_plain():
            for x, (wq, rho, sig, plane) in zip(xs, prepared):
                k.plain(x, wq, sig, device=emt.device, seed=SEED, plane=plane)

        noisy = [noise.fluctuate(wq, rho, emt.device, emt.noise, seed=SEED,
                                 plane=plane)
                 for wq, rho, sig, plane in prepared]

        def run_library():
            for x, wn in zip(xs, noisy):
                torch.matmul(x, wn)

        ms = cuda_time(run_kernel, 5)
        lib_ms = cuda_time(run_library, 5)
        del noisy
        plain_ms = cuda_time(run_plain, 2, warmup=1)
        nbytes = sum(4 * (BATCH * K + K * N + BATCH * N)
                     for (K, N) in (tuple(wq.shape) for wq, *_ in prepared))
        flops = sum(2 * BATCH * math.prod(wq.shape) for wq, *_ in prepared)
        b_ms, by = bound(nbytes, flops)
        self.records["emt_matmul"] = dict(
            name="emt_matmul", route="cuda",
            source="src/repro_torch/kernels/csrc/emt_matmul.cu",
            replaces="src/repro/kernels/emt_matmul.py:57",
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms)
        print(f"  K3 per decode step ({len(prepared)} calls, M={BATCH}): "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul on "
              f"pre-noised weights {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({by}; {nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP), "
              f"roofline share {100 * b_ms / ms:.2f}%")

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
        kp2, vp2 = kp.clone(), vp.clone()
        out = k.paged_attention_decode(q, kp, vp, table, mask, kn, vn, wblk,
                                       woff, wok)
        ref = k.plain(q, kp2, vp2, table, mask, kn, vn, wblk, woff, wok)
        self.sync()
        d, r = rel_err(out, ref)
        pools_same = torch.equal(kp, kp2) and torch.equal(vp, vp2)
        zero_row = bool((out[3] == 0).all())
        print(f"  K1 B={BATCH} KV={KV} G={G} hd={hd} bs={BLOCK} T={T}: "
              f"max|diff| {d:.3e} rel {r:.3e}; pools bit-identical after the "
              f"write: {pools_same}; fully-masked row zeros: {zero_row}")
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
        plain_ms = cuda_time(run_plain, 10)
        lib_ms = cuda_time(run_library, 20)
        nl = cfg.num_layers
        # bytes: q in, out, mask, table, the new K/V rows read and written,
        # and the K/V of every visible position; FLOPs: q.k and p.v over
        # the visible positions of every query head
        vis = int((mask > NEG_INF / 2).sum().item())
        nbytes = nl * 4 * (2 * q.numel() + mask.numel() + table.numel()
                           + 4 * kn.numel() + 2 * vis * KV * hd)
        flops = nl * 4 * hd * KV * G * vis
        b_ms, by = bound(nbytes, flops)
        self.records["paged_attention_decode"] = dict(
            name="paged_attention_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:212",
            max_abs_err=d, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms)
        del views
        print(f"  K1 per decode step ({nl} launches): kernel {ms:.4f} ms, "
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
        ref = k.plain(q, kp, vp, table, qpe, qlast)
        self.sync()
        d, r = rel_err(out, ref)
        print(f"  K2 B={BATCH} KV={KV} R={R} hd={hd} bs={BLOCK} T={T}: "
              f"max|diff| {d:.3e} rel {r:.3e}")
        self.check(r <= 1e-5, f"K2 rel {r:.3e} > 1e-5")

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
        b_ms, by = bound(nbytes, flops)
        self.records["paged_prefill"] = dict(
            name="paged_prefill", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_prefill.cu",
            replaces="src/repro/kernels/paged_prefill.py:173",
            max_abs_err=d, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=by, library_ms=lib_ms)
        del views
        print(f"  K2 per chunk step ({nl} launches): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA on the gathered view "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({by}), roofline share "
              f"{100 * b_ms / ms:.2f}%")

    # -- phase 4 -------------------------------------------------------------
    def _requests(self):
        import numpy as np
        from repro_torch.serve.engine import GenRequest
        rng = np.random.default_rng(SEED + 11)
        reqs = []
        for i in range(6):
            plen = int(rng.integers(20, MAX_LEN - MAX_NEW + 1))
            kw = dict(prompt=rng.integers(0, self.cfg.vocab_size, plen)
                      .astype(np.int32), max_new=MAX_NEW, seed=1000 + i)
            if i in (1, 4):
                kw.update(temperature=0.8, top_k=40)
            reqs.append(GenRequest(**kw))
        return reqs

    def _profile_steps(self, eng, reqs, per_kind: int = 2):
        """Serve `reqs` on `eng`, profiling single steps (from the third on)
        until `per_kind` chunk steps and `per_kind` decode steps are
        captured; print each step's wall time, device busy time and top
        kernels.  Profiling single steps keeps the trace small."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for r in reqs:
            eng.submit(r)
        seen = {"chunk": 0, "decode": 0}
        n = 0
        while eng.scheduler.busy:
            n += 1
            if n < 3 or min(seen.values()) >= per_kind:
                eng.step()
                continue
            before = eng.prefill_tokens_total
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                eng.step()
                self.sync()
            wall = (time.perf_counter() - t0) * 1e3
            kind = "chunk" if eng.prefill_tokens_total > before else "decode"
            if seen[kind] >= per_kind:
                continue
            seen[kind] += 1
            ev = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0) > 0]
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

    def engine(self):
        import numpy as np
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import paged_attention as k1
        from repro_torch.kernels import paged_prefill as k2
        from repro_torch.serve.engine import ServingEngine
        torch = self.torch

        def make():
            return ServingEngine(self.cfg, self.params, batch_size=BATCH,
                                 max_len=MAX_LEN, seed=SEED,
                                 fresh_noise=False, paged=True,
                                 block_size=BLOCK, prefill_chunk=CHUNK,
                                 device=self.dev)

        make().serve(self._requests(), stagger=2)        # warm-up
        eng = make()
        reqs = self._requests()
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        for w in (k1.paged_attention_decode, k2.paged_prefill,
                  k3.emt_matmul):
            w.launches = 0
        t0 = time.perf_counter()
        results = eng.serve(reqs, stagger=2)
        self.sync()
        wall = time.perf_counter() - t0
        launches = {"paged_attention_decode": k1.paged_attention_decode
                    .launches, "paged_prefill": k2.paged_prefill.launches,
                    "emt_matmul": k3.emt_matmul.launches}
        peak = torch.cuda.max_memory_allocated()
        ntok = sum(len(r.tokens) for r in results)
        m = eng.metrics()
        print(f"  engine: {len(results)} requests, prompts "
              f"{[len(r.prompt) for r in reqs]}, {m['steps']} steps, "
              f"{ntok} generated tokens in {wall:.3f} s -> "
              f"{ntok / wall:.2f} tok/s; modeled EMT energy "
              f"{m['total_energy_pj'] * 1e-6 / ntok:.3f} uJ/token; peak "
              f"device memory {peak / 2**30:.2f} GiB")
        print(f"  launches in the served run: {launches}")
        for r in results:
            print(f"    rid {r.rid}: {r.done_reason} tokens "
                  f"{r.tokens.tolist()} energy {r.energy_pj:.6g} pJ")
        for name, n in launches.items():
            self.check(n > 0, f"{name} was launched {n} times on the main path")
            self.records[name]["launches"] = n
        self.check(len(results) == 6, f"{len(results)} results, want 6")
        for r in results:
            ok = (r.done_reason == "max_new" and len(r.tokens) == MAX_NEW
                  and ((r.tokens >= 0) & (r.tokens < self.cfg.vocab_size))
                  .all() and np.isfinite(r.energy_pj) and r.energy_pj > 0)
            self.check(bool(ok), f"request {r.rid} result malformed: {r}")
        self.check(eng.energy_conserved(results), "energy not conserved")
        self._profile_steps(make(), self._requests())
        self.engine_summary = dict(tok_s=ntok / wall, wall_s=wall,
                                   tokens=ntok, steps=m["steps"],
                                   uj_per_token=m["total_energy_pj"] * 1e-6
                                   / ntok, peak_gib=peak / 2**30)

    def _step_pair(self, cfg):
        """One chunk step (over K/V history) then one decode step on `cfg`,
        from a fresh cache.  Returns (chunk logits, decode logits)."""
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
        table = torch.as_tensor(kv.gather_table()[:, :view // BLOCK],
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
        return lc, ld

    def _first_tokens(self, logits):
        """Decode inputs shared by both paths (the first path's argmax)."""
        if not hasattr(self, "_tokens"):
            self._tokens = logits.argmax(-1).cpu().numpy()
        return self._tokens

    def calls_vs_plain(self):
        """Every kernel call of an analog chunk step and decode step at full
        width, checked against its plain version on the same inputs (the
        real activations, pools and tables of the model)."""
        from repro_torch.kernels import ops
        from repro_torch.kernels import emt_matmul as k3
        from repro_torch.kernels import paged_attention as k1
        from repro_torch.kernels import paged_prefill as k2
        worst = {"emt_matmul": 0.0, "paged_attention_decode": 0.0,
                 "paged_prefill": 0.0}
        counts = dict.fromkeys(worst, 0)
        pools_ok = [True]
        orig = (ops._emt_matmul, ops._paged_decode, ops._paged_prefill)

        def emt(x, w, sig, **kw):
            y = orig[0](x, w, sig, **kw)
            worst["emt_matmul"] = max(worst["emt_matmul"],
                                      rel_err(y, k3.plain(x, w, sig, **kw))[1])
            counts["emt_matmul"] += 1
            return y

        def dec(q, kp, vp, *args, **kw):
            kp2, vp2 = kp.clone(), vp.clone()
            y = orig[1](q, kp, vp, *args, **kw)
            ref = k1.plain(q, kp2, vp2, *args, **kw)
            worst["paged_attention_decode"] = max(
                worst["paged_attention_decode"], rel_err(y, ref)[1])
            pools_ok[0] &= bool(self.torch.equal(kp, kp2)
                                and self.torch.equal(vp, vp2))
            counts["paged_attention_decode"] += 1
            return y

        def pre(*args, **kw):
            y = orig[2](*args, **kw)
            worst["paged_prefill"] = max(worst["paged_prefill"],
                                         rel_err(y, k2.plain(*args, **kw))[1])
            counts["paged_prefill"] += 1
            return y

        ops._emt_matmul, ops._paged_decode, ops._paged_prefill = \
            emt, dec, pre
        try:
            self._step_pair(self.cfg)
        finally:
            ops._emt_matmul, ops._paged_decode, ops._paged_prefill = orig
        for name, r in worst.items():
            print(f"  {name}: {counts[name]} calls on real activations, "
                  f"worst rel diff vs plain {r:.3e}")
            self.check(counts[name] > 0 and r <= 1e-5,
                       f"{name} on the model's activations: rel {r:.3e}")
        print(f"  K1 pools bit-identical to the plain write on every call: "
              f"{pools_ok[0]}")
        self.check(pools_ok[0], "K1 pools differ from the plain write")

    @contextlib.contextmanager
    def _projections_through(self, fn):
        """Route every analog projection through `fn` in place of K3."""
        from repro_torch.kernels import ops
        orig = ops._emt_matmul
        ops._emt_matmul = fn
        try:
            yield
        finally:
            ops._emt_matmul = orig

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

    def _run_path(self, cfg, plain=None, levels=None):
        """One chunk + decode step pair on the kernel path, or, with
        `plain` given, on the plain path: attention through scatter + gather
        + _gqa_core (fused_paged_attn=False) and every projection through
        `plain` in place of K3."""
        with contextlib.ExitStack() as stack:
            if plain is not None:
                stack.enter_context(self._projections_through(plain))
                cfg = cfg.replace(fused_paged_attn=False)
            if levels is not None:
                stack.enter_context(self._record_levels(levels))
            return self._step_pair(cfg)

    def _compare(self, label, a_pair, b_pair, limit=None):
        torch = self.torch
        for (a, b), what in zip(zip(a_pair, b_pair),
                                ("chunk step", "decode step")):
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

    def logits_vs_plain(self):
        """End-to-end logits of the kernel path (K1, K2, K3) against the
        plain path on the card, analog mode with noise on.

        Held to 1e-3 with a 24-bit activation DAC: its levels are finer
        than float32's own rounding, so the model is continuous in its
        inputs and the gap measures the kernels.  At the main path's 8-bit
        DAC a float32 ulp of summation order can flip a level at a .5 tie,
        and the flips propagate; there the script reports the gap beside
        the gap between two plain paths that differ only in accumulation
        precision (float32 vs float64 matmul), and counts the DAC levels
        that differ between the kernel and plain paths."""
        import dataclasses
        from repro_torch.kernels import emt_matmul as k3
        emt = self.cfg.emt

        def plain_f64(x, w, sig, **kw):
            return k3.plain(x.double(), w.double(), sig, **kw).float()

        fine = self.cfg.replace(emt=emt.replace(
            quant=dataclasses.replace(emt.quant, a_bits=24)))
        self.__dict__.pop("_tokens", None)
        self._compare("analog, 24-bit DAC: kernel vs plain path",
                      self._run_path(fine),
                      self._run_path(fine, plain=k3.plain), limit=1e-3)

        self.__dict__.pop("_tokens", None)
        lk, lp, l64 = [], [], []
        kern = self._run_path(self.cfg, levels=lk)
        plain = self._run_path(self.cfg, plain=k3.plain, levels=lp)
        f64 = self._run_path(self.cfg, plain=plain_f64, levels=l64)
        self._compare("analog, 8-bit DAC: kernel vs plain path", kern, plain)
        self._compare("analog, 8-bit DAC: plain f32 vs plain f64 "
                      "accumulation", plain, f64)
        self._level_flips("kernel vs plain path", lk, lp)
        self._level_flips("plain f32 vs plain f64 accumulation", lp, l64)

    def _level_flips(self, label, la, lb):
        """Count the DAC levels that differ between two runs of the step
        pair, per projection in call order: 7 per layer + the unembed per
        step; the pair runs a history chunk step, the chunk step, then the
        decode step."""
        per_step = 7 * self.cfg.num_layers + 1
        self.check(len(la) == len(lb) == 3 * per_step,
                   f"{len(la)} / {len(lb)} projections, want {3 * per_step}")
        for step, what in ((1, "chunk step"), (2, "decode step")):
            calls = range(step * per_step, (step + 1) * per_step)
            flips = [int((la[c] != lb[c]).sum().item()) for c in calls]
            total = sum(la[c].numel() for c in calls)
            first = next((c for c, f in enumerate(flips) if f), None)
            print(f"  analog, 8-bit DAC, {what}, {label}: DAC levels that "
                  f"differ: layer 0 (its 7 projections' inputs) {flips[:7]}; "
                  f"all projections {sum(flips)} of {total}; first at "
                  f"projection {first}")


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
              ("model", s.model), ("K3 emt_matmul", s.k3),
              ("K1 paged_attention_decode", s.k1),
              ("K2 paged_prefill", s.k2), ("engine", s.engine),
              ("kernel calls vs plain", s.calls_vs_plain),
              ("logits vs plain", s.logits_vs_plain)]
    for name, fn in phases:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            s.sync()
        except Exception:                                # phase boundary
            traceback.print_exc()
            s.fail(f"phase {name} raised")
            if name in ("device", "build", "model"):
                break
        print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if s.failures:
        print(f"chip_smoke FAILED: {s.failures}", file=sys.stderr)
        return 1
    print("engine: " + json.dumps(s.engine_summary))
    print(s.smi)
    print(json.dumps({"kernels": [s.records[n] for n in
                                  ("paged_attention_decode", "paged_prefill",
                                   "emt_matmul")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
