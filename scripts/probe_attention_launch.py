"""Where a decode-attention launch (K1 fused write + attend, K4 read-only)
spends its time on the card.

For the gemma3-1b decode shape (B 4, KV 1, G 4, hd 256) and the
seamless-m4t-medium one (B 4, KV 16, G 1, hd 64), block 16, T = 8 blocks
(`chip_smoke.py`'s max_len 128), this prints:

* the device time a launch (torch.profiler, 26 launches back to back) of
  both kernels for every cluster size S in 1, 2, 4, 8 and 64, 128 or 256
  threads a CTA, called through the C entries with those dims (the planner,
  ``paged_attention.kv_splits`` / ``threads``, picks one of them);
* the host time a call (no synchronisation inside the loop, best of three
  loops of 3000 calls) of the K1 and K4 wrappers, of two of K1's parts
  (the output allocation and the bare C call, the cluster launch) and of
  one ``scaled_dot_product_attention`` call on the gathered view, the
  yardstick ``chip_smoke.py`` times.

Usage: PYTHONPATH=src python scripts/probe_attention_launch.py
Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import _build, splitk
from repro_torch.kernels import paged_attention as k
from repro_torch.kernels.ref import NEG_INF, paged_view

LAUNCHES = 26


def device_us(fn, key: str) -> float:
    """Device time (us) a launch of the kernels named `key` in one fn()."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if key in e.key]
    return (sum(e.self_device_time_total for e in ev)
            / max(1, sum(e.count for e in ev)))


def host_us(fn, n: int = 3000) -> float:
    """Host time (us) a call of fn, best of three loops."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def inputs(KV: int, G: int, hd: int, dev):
    B, bs, T = 4, 16, 8
    L = T * bs
    g = torch.Generator(device=dev).manual_seed(0)
    nb = B * T
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=dev)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=dev)
    table = torch.randperm(nb, generator=g, device=dev).reshape(B, T)
    table = table.to(torch.int32)
    pos = torch.tensor([L - 28, L // 4 + 5, L // 2 - 4, L - 1], device=dev)
    mask = torch.where(torch.arange(L, device=dev)[None, :] <= pos[:, None],
                       0.0, NEG_INF).to(torch.float32)
    wblk = torch.gather(table, 1, (pos // bs)[:, None])[:, 0].contiguous()
    woff = (pos % bs).to(torch.int32)
    wok = torch.ones(B, dtype=torch.int32, device=dev)
    q = torch.randn((B, KV, G, hd), generator=g, device=dev)
    kn = torch.randn((B, KV, hd), generator=g, device=dev)
    vn = torch.randn((B, KV, hd), generator=g, device=dev)
    return (q, kp, vp, table, mask, kn, vn, wblk, woff, wok), (B, bs, T)


def probe(KV: int, G: int, hd: int, dev) -> None:
    args, (B, bs, T) = inputs(KV, G, hd, dev)
    q, kp, vp, table, mask = args[:5]
    out = torch.empty_like(q)
    sms = splitk.sm_count(dev.index or 0)
    stream = _build.stream(dev.index or 0)
    decode, attend = k._fn("paged_decode_f32"), k._fn("paged_attend_f32")
    ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in args + (out,)])
    pa = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in args[:5] + (out,)])
    scale = 1.0 / hd ** 0.5
    print(f"== B {B} KV {KV} G {G} hd {hd} bs {bs} T {T}: the planner's "
          f"S {k.kv_splits(B, KV, G, hd, T, sms)}, threads "
          f"{k.threads(G, hd)}")
    for S in (1, 2, 4, 8):
        for nt in (64, 128, 256):
            if -(-G * hd // nt) > k.MAX_GH // k.MAX_THREADS:
                continue
            dims = (ctypes.c_int * 8)(B, KV, G, hd, bs, T, S, nt)

            def run(fn=decode, p=ptrs):
                for _ in range(LAUNCHES):
                    _build.check(fn(p, dims, scale, 0.0, stream), "probe")

            w = device_us(run, "paged_decode_kernel<true>")
            r = device_us(lambda: run(attend, pa),
                          "paged_decode_kernel<false>")
            print(f"  S {S}, {nt} threads: device {w:.2f} us a launch "
                  f"(K1), {r:.2f} (K4)")
    dims = k._launch(B, KV, G, hd, bs, T, sms)[0]
    parts = {
        "K1 wrapper": lambda: k.paged_attention_decode(*args),
        "K4 wrapper": lambda: k.paged_attention(q, kp, vp, table, mask),
        "output allocation": lambda: torch.empty_like(q),
        "bare C call (K1)": lambda: decode(ptrs, dims, scale, 0.0, stream),
    }
    H = KV * G
    L = T * bs
    kv = paged_view(kp, table).permute(0, 2, 1, 3).expand(B, H, L, hd)
    kv = kv.contiguous()
    qh = q.reshape(B, H, 1, hd)
    am = mask[:, None, None, :]
    parts["SDPA on the gathered view"] = lambda: \
        F.scaled_dot_product_attention(qh, kv, kv, attn_mask=am)
    for name, fn in parts.items():
        print(f"  host: {name} {host_us(fn):.2f} us a call")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_attention_launch: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    probe(1, 4, 256, dev)
    probe(16, 1, 64, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
