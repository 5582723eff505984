"""Count, from their SASS, the instructions that the noisy matmuls' GEMV
kernels and K5's tensor-core kernel issue per (weight element, plane), by
the pipe that executes them.

    PYTHONPATH=src python scripts/sass_ops.py [--dump DIR]

Builds K3 (``emt_matmul.cu``) and K5 (``emt_bitserial.cu``) with the port's
nvcc flags, disassembles them with ``cuobjdump -sass`` and, for each GEMV
kernel at M = 4 on a two-state corner, takes every loop (a backward branch)
that holds FFMAs: K5's plane loop, K3's K walk (the float32 GEMV's, and
the int8 and experts GEMVs' ring walk).  An element-plane issues M
FFMAs into the accumulators, so a loop's opcodes over its FFMAs / M are the
opcodes per element-plane.  K5's tensor-core kernel (``bitserial_tc`` on a
two-state corner, one and two row tiles): its plane loop, the loop that
holds the HGMMAs (wgmma), 6 a plane and row tile (two k16 steps, three
pieces) for a consumer thread's 16 weight elements, so an element-plane
is 3 / 8 of an HGMMA a row tile.  It prints them grouped by pipe, as Nsight
Compute's pipeline descriptions group them on sm_90: the integer ALU pipe
(bit and logic operations, shifts, compares, selects, integer adds), the
FMA pipe (FP32 FFMA, FMUL, FADD, and the integer multiplies IMAD), the
load/store unit and the rest.  ``chip_smoke.py``'s bounds for K3 and K5
take their integer operations from these counts.  ``--dump DIR`` also
writes each kernel's SASS there.  Needs nvcc and cuobjdump (the CUDA
toolkit), not a card.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

from repro_torch.kernels import _build

M = 4
# the opcode that marks a kernel's loop, and its count per element-plane
# (FFMA, M for the GEMVs unless named here)
MARKERS = {"K5 bitserial_tc<2, 1>": ("HGMMA", 0.375),
           "K5 bitserial_tc<2, 2>": ("HGMMA", 0.75)}
KERNELS = {            # (source, mangled-name fragment of <M = 4, NS = 2>)
    "K5 bitserial_gemv_n<4, 2>": ("emt_bitserial", "bitserial_gemv_nILi4ELi2E"),
    "K5 bitserial_tc<2, 1>": ("emt_bitserial", "bitserial_tcILi2ELi1E"),
    "K5 bitserial_tc<2, 2>": ("emt_bitserial", "bitserial_tcILi2ELi2E"),
    "K5 bitserial_gemv_k<4, 2>": ("emt_bitserial", "bitserial_gemv_kILi4ELi2E"),
    "K3 emt_matmul_gemv_n<4, 2>": ("emt_matmul", "emt_matmul_gemv_nILi4ELi2E"),
    "K3 emt_matmul_gemv_ring<4, 2, int8>": (
        "emt_matmul", "emt_matmul_gemv_ringILi4ELi2ELb1ELb0E"),
    "K3 emt_matmul_gemv_ring<4, 2, experts>": (
        "emt_matmul", "emt_matmul_gemv_ringILi4ELi2ELb0ELb1E"),
    "K3 emt_matmul_gemv_k<4, 2>": ("emt_matmul",
                                   "emt_matmul_gemv_kILi4ELi2ELb0E"),
}
FMA = {"FFMA", "FMUL", "FADD", "IMAD", "IMUL"}
ALU = {"LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL", "FSEL", "IADD3",
       "IADD", "LEA", "PRMT", "MOV", "IMNMX", "FMNMX", "FSETP", "PLOP3",
       "IABS", "VIADD", "VIMNMX", "P2R", "R2P", "BMSK", "POPC", "FLO"}
LSU = {"LD", "LDG", "LDS", "LDC", "ULDC", "LDGSTS", "ST", "STG", "STS",
       "LDSM", "ATOMS", "RED", "LDL", "STL"}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def pipe(op: str) -> str:
    base = op.split(".")[0]
    if base in FMA:
        return "fma"
    if base in ALU:
        return "alu"
    if base in LSU:
        return "lsu"
    return "other"


def functions(sass: str) -> dict:
    """{mangled name: SASS text} of a cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def parse(text: str):
    """[(address, opcode, instruction)] and {label: address}."""
    insns, labels, pending = [], {}, []
    for line in text.splitlines():
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if not m:
            continue
        addr, ins = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[lab] = addr
        pending = []
        toks = [t for t in ins.split() if not t.startswith("@")]
        insns.append((addr, toks[0] if toks else "", ins))
    return insns, labels


def loops(insns, labels):
    """[(first, last address)] of every backward branch's body."""
    out = []
    for addr, op, ins in insns:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"(\.L_x_\d+)", ins)
        tgt = labels.get(m.group(1)) if m else None
        if tgt is None:
            m = re.search(r"0x([0-9a-f]+)\s*$", ins)
            tgt = int(m.group(1), 16) if m else None
        if tgt is not None and tgt <= addr:
            out.append((tgt, addr))
    return out


def report(label: str, text: str) -> None:
    insns, labels = parse(text)
    found = False
    marker, per_plane = MARKERS.get(label, ("FFMA", M))
    for lo, hi in sorted(loops(insns, labels), key=lambda s: s[1] - s[0]):
        body = [op for a, op, _ in insns if lo <= a <= hi]
        ffma = sum(op.split(".")[0] == "FFMA" for op in body)
        marks = sum(op.split(".")[0] == marker for op in body)
        if not marks:
            continue
        found = True
        per = marks / per_plane              # element-planes an iteration
        by_pipe = collections.Counter(pipe(op) for op in body)
        ops = collections.Counter(op for op in body)
        print(f"{label}: loop {lo:#x}-{hi:#x}, {len(body)} instructions, "
              f"{per:g} element-planes an iteration; per element-plane: "
              + ", ".join(f"{p} {by_pipe[p] / per:.2f}"
                          for p in ("alu", "fma", "lsu", "other"))
              + f" (IMAD {sum(o.startswith('IMAD') for o in body) / per:.2f},"
              f" FFMA {ffma / per:.2f}, {marker} {marks / per:.2f})")
        print("    " + ", ".join(f"{op} {n / per:.2f}"
                                 for op, n in ops.most_common()))
    if not found:
        raise SystemExit(f"{label}: no loop with {marker}s found")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dump", help="directory to write each kernel's SASS")
    a = ap.parse_args()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    infos = _build.build(tuple({src for src, _ in KERNELS.values()}))
    listings = {src: functions(subprocess.run(
        [tool, "-sass", str(info.path)], capture_output=True, text=True,
        check=True).stdout) for src, info in infos.items()}
    for label, (src, frag) in KERNELS.items():
        hits = [n for n in listings[src] if frag in n]
        if len(hits) != 1:
            raise SystemExit(f"{label}: {len(hits)} functions match {frag}")
        text = listings[src][hits[0]]
        if a.dump:
            os.makedirs(a.dump, exist_ok=True)
            name = re.sub(r"\W+", "_", label).strip("_")
            with open(os.path.join(a.dump, f"{name}.sass"), "w") as f:
                f.write(text)
        report(label, text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
