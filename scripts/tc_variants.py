"""Time variants of the tensor-core kernels on the card: K3's (the 3xTF32
template, src/repro_torch/kernels/csrc/emt_tc.cuh; K3's forward at M > 16
in emt_matmul_fwd.cu, its backward in emt_matmul_bwd.cu) and K5's above
16 rows (the K5 mode below).

Each variant is a copy of the kernel sources with one stage removed or
changed by a text substitution, built with the port's nvcc flags into
build/tc_variants/<name>/ and timed (CUDA events) at gemma3-1b's weight
shapes (the tied unembed's table.T among them): the forward at a chunk
step's M = 64 and a training step's M = 1,024, K3-dx and K3-dw at
M = 1,024, each beside its error against the float64 plain version: a
removed stage computes garbage, so its error says only that the
substitution took.  The forward is also timed with its two-state noise
bits the other way round from the planner's rule (tc_bits_words: the
bits pass where x has more than one 128-row tile), as "fwd+bits" at
M = 64 and "fwd-bits" at M = 1,024.  `ncu` does not run on the card's
machine; timing what is left when a stage is gone is how this repository
finds which stage sets a kernel's pace.

Usage: python scripts/tc_variants.py [--variants base,no_mma,...]
           [--kernels fwd,dx,dw] [--splits 1,2,3]
           [--shapes wq,wk,wg,wd,unembed] [--baseline DIR]
(--splits: force the slab counts of every timed kernel instead of the
planner's, one timed row per count; --baseline: also build K3-dx and
K3-dw from the kernel sources of another checkout DIR, e.g. an unpacked
`git archive` of the parent commit, as the variant "baseline").  A name
repeated in --variants is built once and timed at each place, so
variants can alternate on one card.  Needs a CUDA card and nvcc.

K5 mode (`--kernels k5`; src/repro_torch/kernels/csrc/emt_bitserial.cu
above 16 rows): python scripts/tc_variants.py --kernels k5
[--variants base,no_hash,no_mma,no_loads] [--baseline DIR] [--splits ...]
builds this checkout's K5 source with each variant's substitution into
build/tc_variants/k5/this/ (and, with --baseline, DIR's into
build/tc_variants/k5/baseline/, timed first), loads each checkout's own
wrapper module (kernels/emt_bitserial.py, its own plan) with the variant
library in place of the port's, and prints the device time
(torch.profiler, the kernel and its split sum; chip_smoke.device_ms with
`agree`) of the mixed path's chunk step (78 calls at M = 64, gemma3-1b's
wg/wu/wd, each on its own weight) and of vgg16_cifar's 13 calls of an
A+B+C step (batch 32, 7 planes), per shape, beside each variant's error
against the plain version.  Variants, each with its text in the
tensor-core body and, where named, in the tiled body that it replaced
(the parent commit's): base; no_hash (the noise hash removed: the
tensor-core body's state bits are its (row, col) and plane terms XORed,
the compare and select kept; the tiled body's noisy weight is the raw
weight); no_mma (no products: the tensor-core body issues no wgmma, and
the compiler may then drop some of the fragments' build; the tiled body
keeps one add a thread and k-step in place of its 4 x 4 FMAs); no_loads
(the weight synthesized from its row and column instead of read).  The
tensor-core body's alone: no_planes (the producer stores no planes) and
rows64 (one 64-row tile a CTA at every M, by the plan the kernel follows:
above 64 rows each weight element is hashed once per 64 rows, not 128).
A variant that does not apply to a checkout's source is reported and
skipped.
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
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "tc_variants")

MMA = ("          wgmma_tf32(d, desc(a_lo + o), desc(b_hi + o), !fresh || kk > 0);\n"
       "          wgmma_tf32(d, desc(a_hi + o), desc(b_lo + o), 1);\n"
       "          if constexpr (P == 3)\n"
       "            wgmma_tf32(d, desc(a_hi + o), desc(b_1 + o), 1);\n"
       "          wgmma_tf32(d, desc(a_hi + o), desc(b_hi + o), 1);\n")
MID = ("          if constexpr (P == 3)\n"
       "            wgmma_tf32(d, desc(a_hi + o), desc(b_1 + o), 1);\n")
STORE = ("      store_groups<AM, 0, 2, kLive>(va, sp, ti.m0, c0, pt, st, aux);\n"
         "      store_groups<BL, 1, P>(vb, sp + 2 * kTileFloats, ti.n0, c0, "
         "pt, st,\n"
         "                             aux);\n")
COPY = ("        copy_groups<AM, kLive>(r, A, ti.m0, kb + t * kBK, ke, pt);\n"
        "        if constexpr (!Q8)\n"
        "          copy_groups<BL>(r + kTileFloats, B, ti.n0, kb + t * kBK, "
        "ke, pt);\n")
FWD_PIECES = ("  static constexpr int kConsumerRegs = 152;\n"
              "  static constexpr int kBPieces = 3;\n")
# name: [(file, old text, new text)]
VARIANTS = {
    "base": [],
    # the producers and the epilogue alone: no products
    "no_mma": [("emt_tc.cuh", MMA, "")],
    # the consumers alone: the producers neither copy nor store
    "no_producer": [("emt_tc.cuh", STORE, ""), ("emt_tc.cuh", COPY, "")],
    # the producers copy but do not transform (no operand function, no
    # split, no stores)
    "no_transform": [("emt_tc.cuh", STORE, "")],
    # the tensor cores' own accumulation over the whole slab
    "no_promotion": [
        ("emt_tc.cuh", "!fresh || kk > 0", "1"),
        ("emt_tc.cuh",
         "      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);\n",
         ""),
        ("emt_tc.cuh", "    st.epilogue(acc, ti, tid);",
         "    st.epilogue(d, ti, tid);")],
    # the forward's three pieces of B with three products (no x_hi.mid),
    # its two raw stages kept
    "fwd_3_products": [("emt_tc.cuh", MID, "")],
    # the forward on two rna pieces of B (3xTF32, three products) and
    # three raw stages: the template as K3's backward runs it
    "fwd_2_pieces": [("emt_matmul_fwd.cu", FWD_PIECES,
                      "  static constexpr int kConsumerRegs = 152;\n")],
    # the same with two raw stages (against fwd_2_pieces: the raw ring's
    # depth alone)
    "fwd_2_pieces_raw2": [
        ("emt_matmul_fwd.cu", FWD_PIECES,
         "  static constexpr int kConsumerRegs = 152;\n"),
        ("emt_tc.cuh", "  return P == 2 ? 3 : 2;", "  return 2;"),
        ("emt_tc.cuh", "static_assert(smem_bytes<3>() == kSmemBytes, "
         "\"one CTA per SM either way\");", "")],
    # the forward at M <= 64 on the whole row tile: the second consumer
    # warpgroup multiplies zeros, the producers copy and transform them
    "no_half_rows": [
        ("emt_matmul_fwd.cu", "  const bool half = M <= repro::tc::kBM / 2;",
         "  const bool half = false;")],
    # K3-dx hashing every weight element in the producers (once per 128-row
    # tile of g) instead of reading noise_bits' state bits
    "hash_in_producers": [
        ("emt_matmul_bwd.cu",
         "      return __fmul_rn(v, (aux >> (n & 31)) & 1u ? F.f[1] : F.f[0]);",
         "      return repro::noisy<NS>(v, (uint32_t)k, (uint32_t)n, pk, F);")],
    # K3-dw without its epilogue (no dw, no dsigma)
    "no_dw_epilogue": [
        ("emt_matmul_bwd.cu",
         "    // elements i and i + 1 are columns n and n + 1 of row k (n even)\n",
         "    if (p.K > 0) return;\n")],
    # K3-dx's consumers on 160 registers (its producers on 96)
    "dx_regs160": [
        ("emt_matmul_bwd.cu",
         "  static constexpr int kConsumerRegs = 152;\n  struct Args {\n"
         "    float* out;\n    int M, N;\n    const uint32_t* bits;",
         "  static constexpr int kConsumerRegs = 160;\n  struct Args {\n"
         "    float* out;\n    int M, N;\n    const uint32_t* bits;")],
}
# K5 (emt_bitserial.cu above 16 rows): name -> alternatives, each a list of
# (old text, new text); the first alternative whose texts are all found in
# the checkout's source is applied (the tensor-core body, then the tiled
# body that it replaced); a variant with none found does not apply there
K5_VARIANTS = {
    "base": [[]],
    # no noise hash: the tensor-core body's state bits are its (row, col)
    # and plane terms XORed, the compare and select kept; the tiled body's
    # noisy weight is the raw weight
    "no_hash": [
        [("      const uint32_t h0 = repro::hash_mix_folded(prk[r] ^ pcn[c], "
          "pks);\n"
          "      const uint32_t h1 = repro::hash_mix_folded(prk[r + 1] ^ "
          "pcn[c], pks);\n",
          "      const uint32_t h0 = prk[r] ^ pcn[c] ^ pks;\n"
          "      const uint32_t h1 = prk[r + 1] ^ pcn[c] ^ pks;\n")],
        [("        ws[kk][nn] = noisy_rc<NS>(wv[e], rc[e], pk, F);\n",
          "        ws[kk][nn] = wv[e];\n")]],
    # no products: the tensor-core body issues no wgmma (and the compiler
    # may then drop some of the fragments' build); the tiled body keeps
    # one add a thread and k-step in place of its 4 x 4 FMAs
    "no_mma": [
        [("      wgmma_rs(d[r], a[2], db, !fresh);\n"
          "      wgmma_rs(d[r], a[1], db, 1);\n"
          "      wgmma_rs(d[r], a[0], db, 1);\n", "      (void)db;\n")],
        [("          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);\n"
          "          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);\n"
          "          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);\n"
          "          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);\n",
          "          if (i == 0) acc[0][0] += b.x;\n")]],
    # the weight synthesized from its row and column instead of read
    "no_loads": [
        [("        cp_async8(dst, bytes ? p : w, bytes);\n",
          "        (void)bytes;\n"),
         ("      const float2 v = *reinterpret_cast<const float2*>(\n"
          "          wring + 2 * (((t & 1) * 8 + r) * kConsumers + tid));\n"
          "      wr[2 * r] = v.x;\n"
          "      wr[2 * r + 1] = v.y;\n",
          "      wr[2 * r] = (float)(k0 + r);\n"
          "      wr[2 * r + 1] = (float)(na - r);\n")],
        [("      wv[e] = (k < ke && n < N) ? w[k * swk + n * swn] : 0.f;\n",
          "      wv[e] = (float)(k ^ n);\n")]],
    # the producer stores no planes: the ring's tiles are left as they are
    "no_planes": [
        [("          *reinterpret_cast<uint4*>(st + chunk_at(pr + 32 * i, cg)) =\n"
          "              make_uint4(v[0], v[1], v[2], v[3]);\n",
          "          (void)v;\n")]],
    # one 64-row tile a CTA at every M (K5_PLAN_ROWS: the kernel takes the
    # plan's rows): each weight element hashed once per 64 rows, not 128
    "rows64": [[]],
}
# a variant's CTA rows in the wrapper's plan, where not tc_rows(M)'s (not
# applicable to a wrapper without tc_rows)
K5_PLAN_ROWS = {"rows64": 64}
# vgg16_cifar's K5 calls of a training step at batch 32 (M, K, N, calls):
# each stage's first convolution from the previous stage's channels, its
# three others, and the head
CNN_STEP = [(32768, 27, 64, 1), (32768, 576, 64, 3), (8192, 576, 128, 1),
            (8192, 1152, 128, 3), (2048, 1152, 256, 1), (2048, 2304, 256, 3),
            (32, 256, 10, 1)]
SHAPES = {"wq": (1152, 1024, False), "wk": (1152, 256, False),
          "wo": (1024, 1152, False), "wg": (1152, 6912, False),
          "wd": (6912, 1152, False), "unembed": (1152, 262144, True)}
SOURCES = {"fwd": "emt_matmul_fwd", "dx": "emt_matmul_bwd",
           "dw": "emt_matmul_bwd"}


def build(names, sources, baseline=None):
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC if name != "baseline" else os.path.join(
            baseline, "src", "repro_torch", "kernels", "csrc"), d)
        for f, old, new in VARIANTS.get(name, ()):
            path = os.path.join(d, f)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"{name}: substitution not found in {f}")
            open(path, "w").write(text.replace(old, new))
        for src in sources:
            if not os.path.exists(os.path.join(d, f"{src}.cu")):
                continue
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", d, "-o",
                   os.path.join(d, f"{src}.so"), os.path.join(d, f"{src}.cu")]
            procs[name, src] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (name, src), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{log[-3000:]}")
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"{name} {src}: built, {spills} bytes of spill stores in all",
              flush=True)


def build_k5(names, csrc, tag):
    """The K5 source of `csrc` with each variant's substitution, built
    into OUT/k5/<tag>/<name>/emt_bitserial.so; the names built (a variant
    none of whose alternatives is found is reported and left out)."""
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        d = os.path.join(OUT, "k5", tag, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        path = os.path.join(d, "emt_bitserial.cu")
        text = open(path).read()
        for alt in K5_VARIANTS[name]:
            if all(old in text for old, _ in alt):
                for old, new in alt:
                    text = text.replace(old, new)
                break
        else:
            print(f"k5 {tag} {name}: does not apply to this source",
                  flush=True)
            continue
        open(path, "w").write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", d, "-o",
             os.path.join(d, "emt_bitserial.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k5 {tag} {name}: nvcc failed\n{log[-3000:]}")
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                                log))
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"k5 {tag} {name}: built, registers {regs}, {spills} bytes "
              f"of spill stores in all", flush=True)
    return list(procs)


def run_k5(a) -> None:
    """The K5 mode: the chunk step's and the CNN step's calls, timed per
    variant, on --baseline's checkout first where given (module
    docstring)."""
    import importlib.util

    import torch
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms
    from repro_torch.core.device import DeviceModel
    from repro_torch.kernels import _build, splitk
    names = list(dict.fromkeys(a.variants.split(",")))
    checkouts = [("baseline", os.path.abspath(a.baseline))] if a.baseline \
        else []
    checkouts.append(("this", ROOT))
    modules, built = {}, {}
    for tag, root in checkouts:
        spec = importlib.util.spec_from_file_location(
            f"k5_{tag}", os.path.join(root, "src", "repro_torch", "kernels",
                                      "emt_bitserial.py"))
        modules[tag] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(modules[tag])
        planned = hasattr(modules[tag], "tc_rows")
        for n in names:
            if n in K5_PLAN_ROWS and not planned:
                print(f"k5 {tag} {n}: does not apply to this wrapper")
        built[tag] = build_k5(
            [n for n in names if planned or n not in K5_PLAN_ROWS],
            os.path.join(root, "src", "repro_torch", "kernels", "csrc"), tag)
        print(f"k5 {tag}: {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cuda = torch.device("cuda")
    dev = DeviceModel()
    gen = torch.Generator(device=cuda).manual_seed(0)
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    bits = 7

    def levels(M, K):
        return torch.round(torch.randn((M, K), generator=gen, device=cuda)
                           * 40).clamp(-127, 127)

    groups = {}
    for s, (K, N) in (("wg", (1152, 6912)), ("wu", (1152, 6912)),
                      ("wd", (6912, 1152))):
        groups["chunk", s] = [
            (levels(64, K),
             torch.randn((K, N), generator=gen, device=cuda) / 30, i)
            for i in range(26)]
    for M, K, N, calls in CNN_STEP:
        groups["cnn", f"{M}x{K}x{N}"] = [
            (levels(M, K),
             torch.randn((K, N), generator=gen, device=cuda) / 30, i)
            for i in range(calls)]
    kw = dict(device=dev, bits=bits, seed=0)
    ref = modules["this"].plain
    want = {key: ref(*calls[0][:2], sig, base_plane=7 * calls[0][2], **kw)
            for key, calls in groups.items()}
    keys = ("bitserial", "split_sum")
    splits = [int(v) for v in a.splits.split(",")] if a.splits else [None]
    for tag, _ in checkouts:
        k5 = modules[tag]
        plan, rows = k5.plan, getattr(k5, "tc_rows", None)

        def run(calls):
            for x, w, i in calls:
                k5.emt_bitserial(x, w, sig, base_plane=7 * i, **kw)

        for sp in splits:
            def forced(M, N, K, sms, n_major=True, bits=7, sp=sp):
                p = plan(M, N, K, sms, n_major, bits)
                if sp is None or M <= k5.GEMV_MAX_M:
                    return p
                per = splitk.cdiv(splitk.cdiv(K, p.bk), sp)
                return splitk.Plan(M, N, K, p.bm, p.bn, p.bk,
                                   splitk.cdiv(splitk.cdiv(K, p.bk), per),
                                   per * p.bk)
            k5.plan = forced
            for name in [n for n in names if n in built[tag]]:
                if rows is not None:
                    k5.tc_rows = (rows if name not in K5_PLAN_ROWS else
                                  lambda M, r=K5_PLAN_ROWS[name]: r)
                _build._libs["emt_bitserial"] = ctypes.CDLL(
                    os.path.join(OUT, "k5", tag, name, "emt_bitserial.so"))
                k5._fn.cache_clear()
                k5._launch.cache_clear()
                cells = []
                for path in dict.fromkeys(p for p, _ in groups):
                    mine = {s: c for (p, s), c in groups.items() if p == path}
                    total = device_ms(lambda: run([c for cs in mine.values()
                                                   for c in cs]), keys,
                                      agree=True)
                    parts, worst = [], 0.0
                    for s, calls in mine.items():
                        t = device_ms(lambda: run(calls), keys, agree=True)
                        x, w, i = calls[0]
                        y = k5.emt_bitserial(x, w, sig, base_plane=7 * i,
                                             **kw)
                        r = want[path, s]
                        worst = max(worst, ((y - r).abs().max()
                                            / r.abs().max()).item())
                        p = k5.plan(x.shape[0], w.shape[1], w.shape[0],
                                    splitk.sm_count(0))
                        parts.append(f"{s} " + ("not measured" if t is None
                                                else f"{t:.4f}")
                                     + f" ({p.splits} slabs)")
                    cells.append(f"{path} " + ("not measured" if total is None
                                               else f"{total:.4f} ms")
                                 + f" ({', '.join(parts)}; rel {worst:.2e})")
                where = "" if sp is None else f" splits {sp}"
                print(f"k5 {tag} {name}{where}: " + " | ".join(cells),
                      flush=True)
        k5.plan = plan
        if rows is not None:
            k5.tc_rows = rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kernels", default="fwd,dx,dw")
    ap.add_argument("--splits", default="")
    ap.add_argument("--shapes", default="wq,wk,wg,wd,unembed")
    ap.add_argument("--baseline", default="")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tc_variants: needs a CUDA card", file=sys.stderr)
        return 2
    if "k5" in a.kernels.split(","):
        if a.variants == ",".join(VARIANTS):
            a.variants = "base,no_hash,no_mma,no_loads"
        run_k5(a)
        a.kernels = ",".join(k for k in a.kernels.split(",") if k != "k5")
        if not a.kernels:
            return 0
    from repro_torch.core.device import DeviceModel
    from repro_torch.kernels import _build, splitk
    from repro_torch.kernels import emt_matmul as k
    names = a.variants.split(",")
    kernels = a.kernels.split(",")
    if a.baseline:
        names = ["baseline", *names, "baseline"]
    build(list(dict.fromkeys(names)), sorted({SOURCES[n] for n in kernels}),
          a.baseline and os.path.abspath(a.baseline))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cuda = torch.device("cuda")
    dev = DeviceModel()
    gen = torch.Generator(device=cuda).manual_seed(0)
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    npar = ctypes.addressof(k.noise_params(dev))
    stream = _build.stream(0)
    M = 1024
    data = {}
    for s in a.shapes.split(","):
        K, N, tr = SHAPES[s]
        x = torch.randn(M, K, generator=gen, device=cuda)
        g = torch.randn(M, N, generator=gen, device=cuda)
        w = torch.randn((N, K) if tr else (K, N), generator=gen, device=cuda)
        data[s] = (x, g, w.T if tr else w)
    kw = dict(device=dev, seed=0, plane=7)
    # the forward's float64 references at both row counts: x times the
    # noisy weight (the plain version on I gives it exactly)
    want = {}
    if "fwd" in kernels:
        for s, (x, _, w) in data.items():
            wn = k.plain(torch.eye(w.shape[0], device=cuda), w, sig,
                         **kw).double()
            for rows in (64, M):
                want[s, rows] = torch.matmul(x[:rows].double(), wn)
            del wn
    plan_waves = splitk.plan_waves

    def forced(splits):
        def plan(M_, N_, K_, **kw):
            p = plan_waves(M_, N_, K_, **kw)
            if splits is None:
                return p
            kt = splitk.cdiv(K_, p.bk)
            per = splitk.cdiv(kt, splits)
            return splitk.Plan(M_, N_, K_, p.bm, p.bn, p.bk,
                               splitk.cdiv(kt, per), per * p.bk)
        return plan

    def timed(fn, iters):
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

    def rel(a_, b_):
        return ((a_.double() - b_).abs().max() / b_.abs().max()).item()

    splits = [int(s) for s in a.splits.split(",")] if a.splits else [None]
    P, U = ctypes.c_void_p, ctypes.c_uint
    for name in names:
        fns = {}
        for src in sorted({SOURCES[n] for n in kernels}):
            path = os.path.join(OUT, name, f"{src}.so")
            if not os.path.exists(path):
                continue
            lib = ctypes.CDLL(path)
            for entry in (("emt_matmul_tc_f32",) if src == "emt_matmul_fwd"
                          else ("emt_matmul_dx_f32", "emt_matmul_dw_f32")):
                fn = getattr(lib, entry)
                fn.argtypes = [P] * (8 if entry == "emt_matmul_dw_f32"
                                     else 7) + [U, U, P, P]
                fn.restype = ctypes.c_int
                fns[entry] = fn
        for sp in splits:
            splitk.plan_waves = forced(sp)
            for c in (k._launch, k._launch_dx, k._launch_dw):
                c.cache_clear()
            row = []
            for s, (x, g, w) in data.items():
                K, N, _ = SHAPES[s]
                it = 3 if N > 100000 else 20
                cells = []
                for rows in ((64, M) if "emt_matmul_tc_f32" in fns else ()):
                    xm = x[:rows]
                    p, _, dims = k._launch(0, rows, N, K, *xm.stride(),
                                           *w.stride())
                    y, part = splitk.outputs(p, xm)
                    planned = k.tc_bits_words(rows, N, K)
                    other = 0 if planned else N * splitk.cdiv(K, 32)
                    for tag, words in (("fwd", planned),
                                       ("fwd-bits" if planned else "fwd+bits",
                                        other)):
                        bits = torch.empty(max(words, 1), dtype=torch.int32,
                                           device=cuda)

                        def run_fwd(words=words, bits=bits):
                            assert fns["emt_matmul_tc_f32"](
                                xm.data_ptr(), w.data_ptr(), y.data_ptr(),
                                part, bits.data_ptr() if words else None,
                                sig.data_ptr(), dims, 0, 7, npar,
                                stream) == 0
                        t = timed(run_fwd, it)
                        e = rel(y, want[s, rows])
                        cells.append(f"{tag} M={rows} {t:.4f} ms "
                                     f"({p.splits}; rel {e:.2e})")
                if "dx" in kernels and "emt_matmul_dx_f32" in fns:
                    p, _, dims = k._launch_dx(0, M, K, N, *g.stride(),
                                              *w.stride())
                    dx, part = splitk.outputs(p, g)
                    bits = torch.empty(K * splitk.cdiv(N, 32),
                                       dtype=torch.int32, device=cuda)

                    def run_dx():
                        assert fns["emt_matmul_dx_f32"](
                            g.data_ptr(), w.data_ptr(), dx.data_ptr(), part,
                            bits.data_ptr(), sig.data_ptr(), dims, 0, 7,
                            npar, stream) == 0
                    t = timed(run_dx, it)
                    e = rel(dx, k.plain_dx(g.double(), w, sig, **kw))
                    cells.append(f"dx {t:.4f} ms ({p.splits}; rel {e:.2e})")
                if "dw" in kernels and "emt_matmul_dw_f32" in fns:
                    q, _, dims_w = k._launch_dw(0, M, K, N, *x.stride(),
                                                *g.stride(), *w.stride())
                    n_ws, n_part = k.dw_buffer_floats(q)
                    dw = torch.empty(K, N, device=cuda)
                    pt = torch.empty(n_part, device=cuda)
                    ws = torch.empty(max(n_ws, 1), device=cuda)

                    def run_dw():
                        assert fns["emt_matmul_dw_f32"](
                            x.data_ptr(), g.data_ptr(), w.data_ptr(),
                            dw.data_ptr(), ws.data_ptr(), pt.data_ptr(),
                            sig.data_ptr(), dims_w, 0, 7, npar,
                            stream) == 0
                    t = timed(run_dw, it)
                    e = rel(dw, k.plain_dw(x.double(), g.double(), w, sig,
                                           **kw)[0])
                    cells.append(f"dw {t:.4f} ms ({q.splits}; rel {e:.2e})")
                row.append(f"{s} " + ", ".join(cells))
            print(f"{name}: " + " | ".join(row), flush=True)
    splitk.plan_waves = plan_waves
    return 0


if __name__ == "__main__":
    sys.exit(main())
