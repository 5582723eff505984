"""Time variants of K3's GEMV (M <= 16; src/repro_torch/kernels/csrc/
emt_matmul.cu) on the card: the int8 loader (emt_matmul_i8) at gemma3-1b's
182 projections of a decode step and the experts entry
(emt_matmul_experts_f32) at moonshot-v1-16b-a3b's 12 calls of a decode
step (M = 4) and of a chunk step (M = 8), with the float32 GEMV at the
gemma3-1b shapes beside them.

Each variant is a copy of the kernel sources with one stage removed by a
text substitution, built with the port's nvcc flags into
build/gemv_variants/<name>/ and loaded in place of the port's library, so
the port's own wrappers launch it.  Every number is the device time
(torch.profiler, the kernels' own durations: the GEMV, its split sum and
the experts' statistics pass; a trace counts once another holds as many
device events, chip_smoke.device_ms's `agree`) of one step's calls, each
call on its own weight (the steps stream their weights from device
memory, as served),
beside each variant's largest error against the plain version: a removed
stage computes garbage, so that error says only that the substitution
took.  `ncu` does not run on the card's machine; timing what is left when
a stage is gone is how this repository finds which stage sets a kernel's
pace.

Variants: base; no_hash (the noise factor 1: no hash, no select); no_stats
(the experts' |w~| sum and max not taken); no_fma (each noisy weight added
once into one accumulator instead of M FMAs); no_loads (the weight
synthesized from its row and column instead of read).  Each names its
text in the current body and, where it differs, in the body before the
int8 and experts GEMVs' redesign (the `--root` of an older checkout).
The current body's ring also: stages+1, stages-1 (one stage more or
less) and float_rows4 (float32 stages of 4 rows a warp, not 2).

Usage: python scripts/gemv_variants.py [--variants base,no_hash,...]
           [--root DIR] [--paths int8,float,experts]
(--variants: default base and the four with a stage removed; a name
repeated is built once and timed at each place, so variants can alternate
on one card.  --root: build the kernel sources of another checkout DIR,
e.g. an unpacked `git archive` of the parent commit.)  Needs a CUDA card
and nvcc; about a minute with the builds.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "gemv_variants")
SRC = "emt_matmul"

# The body before the redesign: one template for the float, int8 and
# experts GEMVs (int8 through a shared float tile between two barriers).
OLD_I8_NOISY = ("          v[j] = noisy<NS>(dequant(word, j, sc[4 * jj + j]),\n"
                "                           row0 + (uint32_t)(k0 + lr),\n"
                "                           (uint32_t)(ln + 4 * jj + j), pk, F);\n")
OLD_F_NOISY = ("        wp[j] = noisy<NS>(f4(wc[u], j), row0 + (uint32_t)(kb + kk),\n"
               "                          (uint32_t)(n + j), pk, F);\n")
OLD_STATS = ("      if constexpr (EX) {\n"
             "#pragma unroll\n"
             "        for (int j = 0; j < 4; ++j) {\n"
             "          const float a = fabsf(wp[j]);\n"
             "          ssum += a;\n"
             "          smax = fmaxf(smax, a);\n"
             "        }\n"
             "      }\n")
OLD_I8_FMA = ("        for (int m = 0; m < M; ++m) {\n"
              "          acc[m][0] = fmaf(xv[m], t.x, acc[m][0]);\n"
              "          acc[m][1] = fmaf(xv[m], t.y, acc[m][1]);\n"
              "          acc[m][2] = fmaf(xv[m], t.z, acc[m][2]);\n"
              "          acc[m][3] = fmaf(xv[m], t.w, acc[m][3]);\n"
              "        }\n")
OLD_F_FMA = ("        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv[m], wp[j], "
             "acc[m][j]);\n")
OLD_I8_LOAD = ("      return load_q16(w + k * swk + ln, 1, k < ke ? min(16, N - ln) "
               ": 0,\n                      vw == 16);\n")
OLD_F_LOAD = ("      v[u] = k < ke ? load_n4(w, k * swk, n, N, vw)\n"
              "                    : make_float4(0.f, 0.f, 0.f, 0.f);\n")
SYN_I8 = ("(uint32_t)k * 0x9E3779B9u, (uint32_t)k * 0x85EBCA6Bu, "
          "(uint32_t)ln * 0x9E3779B9u, (uint32_t)(k ^ ln)")

# The current body: the int8 and experts GEMVs' ring kernel
# (emt_matmul_gemv_ring); the float32 GEMV keeps the body above.
NEW_NOISY = ("      wp[j] = __fmul_rn(wt[j], factor<NS>(hash_mix_folded(cs[j], "
             "rp), F));\n")
NEW_STATS = "    if constexpr (EX) take_stats(wp, ssum, smax);\n"
NEW_FMA = ("      for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xr[m], wp[j], "
           "acc[m][j]);\n")
NEW_I8_LOAD = "        copy_async<16>(dst, src, b);\n"
NEW_F_LOAD = "          copy_async<16>(d, p, b);\n"
NEW_I8_READ = "      word = ring_word(st, i, lane);\n"
NEW_F_READ = "      v = ring_f4(st, i, lane);\n"

RING_STAGES = "  static constexpr int kStages = I8 ? 5 : 3;\n"
RING_ROWS = "  static constexpr int kRows = I8 ? 4 : 2;\n"

# name: alternatives, each a list of (old text, new text) in emt_matmul.cu;
# the first alternative whose texts are all found is applied
VARIANTS = {
    "base": [[]],
    "no_hash": [
        [(NEW_NOISY, "      wp[j] = wt[j];\n")],
        [(OLD_I8_NOISY, "          v[j] = dequant(word, j, sc[4 * jj + j]);\n"),
         (OLD_F_NOISY, "        wp[j] = f4(wc[u], j);\n")]],
    "no_stats": [[(NEW_STATS, "")], [(OLD_STATS, "")]],
    "no_fma": [
        [(NEW_FMA, "      for (int j = 0; j < 4 && m == 0; ++j) acc[0][j] += "
                   "wp[j];\n")],
        [(OLD_I8_FMA, "        for (int m = 0; m < 1; ++m) {\n"
                      "          acc[0][0] += t.x; acc[0][1] += t.y;\n"
                      "          acc[0][2] += t.z; acc[0][3] += t.w;\n"
                      "        }\n"),
         (OLD_F_FMA, "        for (int j = 0; j < 4 && m == 0; ++j) acc[0][j] "
                     "+= wp[j];\n")]],
    "no_loads": [
        [(NEW_I8_LOAD, "        (void)src;\n"), (NEW_F_LOAD, ""),
         (NEW_I8_READ, "      word = (uint32_t)(kb + kk) * 0x9E3779B9u ^ "
                       "(uint32_t)lane;\n"),
         (NEW_F_READ, "      v = make_float4((float)kk, (float)lane, 1.f, "
                      "2.f);\n")],
        [(OLD_I8_LOAD, f"      return make_uint4({SYN_I8});\n"),
         (OLD_F_LOAD, "      v[u] = make_float4((float)k, (float)n, 1.f, "
                      "2.f);\n")]],
    # the ring one stage deeper, or one shallower (int8 6 or 4 stages of
    # 4 KB, float32 4 or 2 of 8 KB), or float32 stages of 4 rows (16 KB)
    "stages+1": [[(RING_STAGES, "  static constexpr int kStages = I8 ? 6 : 4;\n")]],
    "stages-1": [[(RING_STAGES, "  static constexpr int kStages = I8 ? 4 : 2;\n")]],
    "float_rows4": [[(RING_ROWS, "  static constexpr int kRows = I8 ? 4 : 4;\n")]],
}

# gemma3-1b's decode-step projections (K, N, calls a step) at M = 4 (the
# tied unembed, float32 in the int8 tree, left out)
GEMMA = {"wq": (1152, 1024, 26), "wkv": (1152, 256, 52),
         "wo": (1024, 1152, 26), "wgu": (1152, 6912, 52),
         "wd": (6912, 1152, 26)}
# moonshot-v1-16b-a3b's expert stacks (E, K, N, calls a step at 4 layers)
MOONSHOT = {"wgu": (64, 2048, 1408, 8), "wd": (64, 1408, 2048, 4)}
KEYS = ("emt_matmul", "split_sum", "stats_finish")


def substitute(text: str, name: str) -> str:
    for alt in VARIANTS[name]:
        if all(old in text for old, _ in alt):
            for old, new in alt:
                text = text.replace(old, new)
            return text
    raise SystemExit(f"{name}: no alternative's texts all found in "
                     f"{SRC}.cu")


def build(names, csrc):
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        path = os.path.join(d, f"{SRC}.cu")
        with open(path) as f:
            text = substitute(f.read(), name)
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", d, "-o",
               os.path.join(d, f"{SRC}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"{name}: built, {spills} bytes of spill stores in all",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="base,no_hash,no_stats,no_fma,"
                    "no_loads")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--paths", default="int8,float,experts")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemv_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from repro_torch.core.device import DeviceModel
    from repro_torch.kernels import _build
    from repro_torch.kernels import emt_matmul as k
    names = a.variants.split(",")
    paths = a.paths.split(",")
    csrc = os.path.join(os.path.abspath(a.root), "src", "repro_torch",
                        "kernels", "csrc")
    build(list(dict.fromkeys(names)), csrc)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"sources: {csrc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    dev = DeviceModel()
    gen = torch.Generator(device=cuda).manual_seed(0)
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    # one weight a call, as a step streams them
    steps = {}
    if "int8" in paths or "float" in paths:
        for s, (K, N, calls) in GEMMA.items():
            for i in range(calls):
                x = torch.randn((4, K), generator=gen, device=cuda)
                if "int8" in paths:
                    q = torch.randint(-127, 128, (K, N), generator=gen,
                                      device=cuda, dtype=torch.int8)
                    scale = torch.rand(N, generator=gen, device=cuda) / 100
                    steps.setdefault(("int8", s), []).append(
                        (k.emt_matmul, x, (q, scale), i))
                if "float" in paths:
                    w = torch.randn((K, N), generator=gen, device=cuda) / 30
                    steps.setdefault(("float", s), []).append(
                        (k.emt_matmul, x, w, i))
    if "experts" in paths:
        for s, (E, K, N, calls) in MOONSHOT.items():
            for i in range(calls):
                w = torch.randn((E, K, N), generator=gen, device=cuda) / 30
                for M in (4, 8):
                    x = torch.randn((E, M, K), generator=gen, device=cuda)
                    steps.setdefault((f"experts M={M}", s), []).append(
                        (k.emt_matmul_experts, x, w, i))
    kw = dict(device=dev, seed=0)
    # the plain version of each group's first call (a sample of the step)
    want = {}
    for key, calls in steps.items():
        fn, x, w, i = calls[0]
        ref = k.plain_experts if fn is k.emt_matmul_experts else k.plain
        want[key] = ref(x, w, sig, plane=i, **kw)
        want[key] = want[key][0] if isinstance(want[key], tuple) else \
            want[key]

    def run(calls):
        for fn, x, w, i in calls:
            fn(x, w, sig, plane=i, **kw)

    paths_seen = list(dict.fromkeys(p for p, _ in steps))
    for name in names:
        _build._libs[SRC] = ctypes.CDLL(os.path.join(OUT, name, f"{SRC}.so"))
        k._fn.cache_clear()
        cells = []
        for path in paths_seen:
            groups = {s: calls for (p, s), calls in steps.items()
                      if p == path}
            got = device_ms(lambda: run([c for cs in groups.values()
                                         for c in cs]), KEYS, agree=True)
            parts, worst = [], 0.0
            for s, calls in groups.items():
                g = device_ms(lambda: run(calls), KEYS, agree=True)
                fn, x, w, i = calls[0]
                y = fn(x, w, sig, plane=i, **kw)
                y = y[0] if isinstance(y, tuple) else y
                ref = want[path, s]
                worst = max(worst, ((y - ref).abs().max()
                                    / ref.abs().max()).item())
                parts.append(f"{s} {g:.4f}" if g is not None
                             else f"{s} not measured")
            total = "not measured" if got is None else f"{got:.4f} ms"
            cells.append(f"{path} {total} ({', '.join(parts)}; rel "
                         f"{worst:.2e})")
        print(f"{name}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
