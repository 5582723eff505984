"""Time variants of K3's experts entry above 16 rows (the tensor-core
kernel, src/repro_torch/kernels/csrc/emt_experts_tc.cu) on the card, at
one jamba-v0.1-52b MoE layer's three calls of a 128-token admission: 16
experts at M = 20 rows (a capacity of 20), wg and wu 4,096 x 14,336 and
wd 14,336 x 4,096, on random stacks (0.02 x N(0, 1)) made from a seed.

Each variant is a copy of the kernel sources with one stage removed or
changed by a text substitution, built with the port's nvcc flags into
build/experts_variants/<name>/ and loaded in place of the port's library,
so the port's own wrapper launches it.  Every variant is timed by CUDA
events around 5 runs of the three calls, by torch.profiler (the kernel
alone; chip_smoke.device_ms with `agree`) and by the same three calls
captured as a CUDA graph and replayed (chip_smoke.graph_ms), beside
whether its output equals the base's bit for bit (a removed stage
computes garbage, so that says only whether the substitution took, or
that a changed one keeps the bits).  `torch.bmm` on the same stacks is
timed the same way, as the yardstick.  `ncu` does not run on the card's
machine; timing what is left when a stage is gone is how this repository
finds which stage sets a kernel's pace.

Variants: base; no_hash (the noise factor 1: no hash, no select); no_stats
(the |w~| sum and max not taken); no_wload (the weight's boxes not
loaded: the consumers read a stale stage); no_mma (no wgmma: the
fragments are built and dropped); stream (no hash, split or wgmma: the
weight streamed through the ring, read and released, nothing else);
two_wg (two consumer warpgroups, 128 columns a CTA, at every row count,
in place of four at 32 rows or fewer).

Usage: python scripts/experts_variants.py [--variants base,no_hash,...]
           [--rounds 2]
(a name repeated is timed at each place, so variants can alternate on one
card.)  Needs a CUDA card and nvcc; about a minute with the builds.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "experts_variants")
SRC = "emt_experts_tc"
MMA = ("      wgmma_rs(d[r], a[0], dl, !fresh);    // x_lo . hi\n"
       "      wgmma_rs(d[r], a[2], dh, 1);         // x_hi . lo\n"
       "      wgmma_rs(d[r], a[1], dh, 1);         // x_hi . mid\n"
       "      wgmma_rs(d[r], a[0], dh, 1);         // x_hi . hi\n")
VARIANTS = {
    "base": [],
    "no_hash": [("const float v = __fmul_rn(wr[2 * r + c], "
                 "repro::factor<NS>(h, F));",
                 "const float v = wr[2 * r + c];")],
    "no_stats": [("  const bool stats = blockIdx.y == 0;",
                  "  const bool stats = false;")],
    "no_wload": [("          bar_arrive_tx(&w_full[s], G::kWStageBytes);\n"
                  "#pragma unroll\n"
                  "          for (int q = 0; q < kCols / kWBox; ++q)",
                  "          bar_arrive(&w_full[s]);\n"
                  "          for (int q = 0; q < 0; ++q)")],
    "no_mma": [(MMA, "")],
    "stream": [("    build(a0, 0);\n",
                "    for (int i = 0; i < 16; ++i) tsum += wr[i];\n"
                "    smax = fmaxf(smax, (float)(prk[0] & 1));\n"),
               ("    build(a1, 1);\n", ""), ("    build(a0, 2);\n", ""),
               ("    build(a1, 3);\n", ""), (MMA, "")],
    "two_wg": [("  static constexpr int kCW = R == 1 && NT <= 32 ? 4 : 2;",
                "  static constexpr int kCW = 2;"),
               ("  static constexpr int kWS = kCW == 4 ? 5 : R == 1 ? 8 : 6;",
                "  static constexpr int kWS = R == 1 ? 8 : 6;"),
               ("constexpr int cta_cols(int M) { return M <= 32 ? 256 : 128; }",
                "constexpr int cta_cols(int M) { return 128; }")],
}
# jamba's layer: (K, N) of wg, wu and wd; 16 experts at 20 rows
SHAPES = ((4096, 14336), (4096, 14336), (14336, 4096))
E, M = 16, 20


def build(names) -> dict:
    """{variant: its library}, one nvcc per variant, all started together;
    raises with nvcc's output if a build fails."""
    from repro_torch.kernels import _build
    procs = {}
    for name in dict.fromkeys(names):
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(d, "csrc"))
        path = os.path.join(d, "csrc", SRC + ".cu")
        with open(path) as f:
            text = f.read()
        for a, b in VARIANTS[name]:
            if a not in text:
                raise ValueError(f"{name}: the source has no {a!r}")
            text = text.replace(a, b)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(d, SRC + ".so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             os.path.join(d, "csrc"), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    names = a.variants.split(",")
    import torch
    if not torch.cuda.is_available():
        print("experts_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core.device import DeviceModel
    from repro_torch.kernels import _build
    from repro_torch.kernels import emt_matmul as k3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs = build(names)
    dev = DeviceModel()
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(1)
    ws = [torch.randn((E, K, N), generator=g, device=cuda) * 0.02
          for K, N in SHAPES]
    xs = [torch.randn((E, M, K), generator=g, device=cuda)
          for K, _ in SHAPES]
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    kw = dict(device=dev, seed=3, plane=5)
    cols = k3.experts_tc_cols

    def run():
        return [k3.emt_matmul_experts(x, w, sig, **kw)[0]
                for x, w in zip(xs, ws)]

    def bmm():
        return [torch.bmm(x, w) for x, w in zip(xs, ws)]

    def times(fn, key):
        return (chip_smoke.cuda_time(fn, 5),
                chip_smoke.device_ms(fn, key, agree=True),
                chip_smoke.graph_ms(fn))

    base = None
    for _ in range(a.rounds):
        for name in names:
            _build._libs[SRC] = ctypes.CDLL(libs[name])
            k3._fn.cache_clear()
            k3._launch_experts.cache_clear()
            k3.experts_tc_cols = (lambda m: 128) if name == "two_wg" else cols
            y = run()
            if name == "base":
                base = y
            same = (None if base is None else
                    all(torch.equal(p, q) for p, q in zip(y, base)))
            ev, dv, gr = times(run, ("emt_experts_tc", "split_sum",
                                     "stats_finish"))
            print(f"{name:9s} event {ev:.3f} ms, device "
                  f"{chip_smoke.fmt(dv)}, graph replay "
                  f"{chip_smoke.fmt(gr)}; equal to base: {same}",
                  flush=True)
        ev, dv, gr = times(bmm, "")
        print(f"torch.bmm event {ev:.3f} ms, device {chip_smoke.fmt(dv)}, "
              f"graph replay {chip_smoke.fmt(gr)}", flush=True)
    k3.experts_tc_cols = cols
    return 0


if __name__ == "__main__":
    sys.exit(main())
