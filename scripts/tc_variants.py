"""Time variants of K3's tensor-core kernels (the 3xTF32 template,
src/repro_torch/kernels/csrc/emt_tc.cuh; K3's forward at M > 16 in
emt_matmul_fwd.cu, its backward in emt_matmul_bwd.cu) on the card.

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
