"""Does the float32 plain version of the chunked prefill give the same bits
on every call on this host's CPU?

The `gpu` test of the chunked-prefill kernel (tests/test_torch_gpu.py,
test_k2_matches_plain) holds the kernel to this plain version
(repro_torch.kernels.ref.paged_prefill_ref, reached through ops on CPU
tensors).  This script runs that test's largest case (bs 16, G 4, C 16,
hd 256, B 4, KV 2, T 6) on the CPU and counts, under each setting,
the calls whose output differs from the setting's first call, with the
worst relative difference (max |diff| / max |ref|):

* the same tensors called again in one process;
* copies of the inputs placed at shifted 4-byte offsets (alignment);
* the same with one CPU thread;
* the scores' batched matmul alone (torch.bmm), at shifted offsets;
* fresh processes, each calling twice on fresh copies of the inputs (as
  the test does), with the default thread count, with one thread, and
  with MKL_CBWR=COMPATIBLE (MKL's reproducible code path): how many
  processes see their two calls differ, and how many first calls differ
  from the first process's.

The inputs are drawn as the test draws them (on the card when there is
one, so that the values are the test's and the in-process calls run with
CUDA initialised, as in the test) and written to build/k2_probe_inputs.pt
for the child processes, which use the CPU only.

Usage: PYTHONPATH=src python scripts/probe_k2_plain_repeat.py [--calls 32]
[--procs 12]
"""
from __future__ import annotations

import argparse
import io
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
INPUTS = ROOT / "build" / "k2_probe_inputs.pt"


def make_inputs():
    """The test's case, drawn as the test draws it (on the card when there
    is one, so the values are the test's), then moved to the CPU."""
    bs, G, C, hd = 16, 4, 16, 256
    B, KV, T = 4, 2, 6
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    g = torch.Generator(device=dev).manual_seed(bs + G + C + hd)
    nb = B * T + 1
    q = torch.randn((B, C, KV * G, hd), generator=g, device=dev)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=dev)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=dev)
    table = torch.randperm(nb, generator=g, device=dev)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    start = torch.tensor([0, bs - 1, T * bs - C, 0])
    ntok = torch.tensor([C, 1, C, C])
    j = torch.arange(C)[None, :]
    qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
    qpos[3] = -1
    return q.cpu(), kp.cpu(), vp.cpu(), table.cpu(), qpos


def shifted(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts `off` floats into a fresh
    buffer."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp_min(1e-30)).item()


def tally(outs):
    diffs = [rel(o, outs[0]) for o in outs[1:]]
    return sum(d > 0 for d in diffs), max(diffs, default=0.0)


def in_process(args, calls: int):
    q, kp, vp, table, qpos = args
    rows = []
    same = [ops.paged_prefill(q, kp, vp, table, qpos) for _ in range(calls)]
    rows.append(("same tensors", calls, *tally(same)))
    for threads in (torch.get_num_threads(), 1):
        prev = torch.get_num_threads()
        torch.set_num_threads(threads)
        outs = [ops.paged_prefill(shifted(q, i % 16), shifted(kp, i % 16),
                                  shifted(vp, i % 16), table, qpos)
                for i in range(calls)]
        torch.set_num_threads(prev)
        rows.append((f"shifted offsets, {threads} thread(s)", calls,
                     *tally(outs)))
    B, C, H, hd = q.shape
    q2 = q.reshape(B, C * H, hd)
    k2 = kp[table.long()].reshape(B, -1, hd * kp.shape[2])[..., :hd]
    outs = [torch.bmm(shifted(q2, i % 16),
                      shifted(k2, i % 16).transpose(1, 2))
            for i in range(calls)]
    rows.append(("torch.bmm alone, shifted offsets", calls, *tally(outs)))
    return rows


def child() -> None:
    """Two calls, each on fresh copies of the inputs (as the test's
    .cpu() copies are), both written to stdout."""
    args = torch.load(INPUTS)
    ys = [ops.paged_prefill(*[a.clone() for a in args]) for _ in range(2)]
    buf = io.BytesIO()
    torch.save(ys, buf)
    sys.stdout.buffer.write(buf.getvalue())


def processes(procs: int):
    rows = []
    base = dict(os.environ)
    for label, extra in (("default threads", {}),
                         ("1 thread", {"OMP_NUM_THREADS": "1"}),
                         ("MKL_CBWR=COMPATIBLE", {"MKL_CBWR": "COMPATIBLE"})):
        firsts, inner = [], []
        for _ in range(procs):
            r = subprocess.run([sys.executable, __file__, "--child"],
                               env={**base, **extra}, capture_output=True,
                               check=True)
            ys = torch.load(io.BytesIO(r.stdout))
            firsts.append(ys[0])
            inner.append(rel(ys[1], ys[0]))
        rows.append((f"processes, {label}, first calls", procs,
                     *tally(firsts)))
        print(f"processes, {label}: the two calls of a process differ in "
              f"{sum(d > 0 for d in inner)} of {procs}, worst rel "
              f"{max(inner):.3e}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=32)
    ap.add_argument("--procs", type=int, default=12)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child()
        return
    print(f"torch {torch.__version__}, {os.cpu_count()} CPUs, "
          f"card {torch.cuda.is_available()}, "
          f"{torch.get_num_threads()} threads, capability "
          f"{torch.backends.cpu.get_cpu_capability()}, "
          f"mkl {torch.backends.mkl.is_available()}, "
          f"mkldnn {torch.backends.mkldnn.is_available()}")
    args = make_inputs()
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(args, INPUTS)
    for rows in (lambda: in_process(args, a.calls),
                 lambda: processes(a.procs)):
        for label, n, differ, worst in rows():
            print(f"{label}: {differ} of {n - 1} calls differ from the "
                  f"first, worst rel {worst:.3e}")


if __name__ == "__main__":
    main()
