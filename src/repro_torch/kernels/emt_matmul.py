"""Technique-A noisy crossbar matmul: CUDA kernel wrappers + plain
versions, forward and backward.

Replaces ``repro/kernels/emt_matmul.py::emt_matmul_pallas``: computes
``y = x @ (w * (1 + a_l * sigma))`` with the RTN offsets hashed inside the
weight tile from each element's global (row, col), the runtime step seed and
the layer plane, so no noise tensor reaches device memory.  The source and
its design note: ``csrc/emt_matmul.cu`` (a GEMV-style kernel for M <= 16,
a tiled one above; both split K by :func:`plan`).

:func:`emt_matmul` is differentiable with the VJP XLA gives JAX's
``fluctuate`` + ``@``: ``dx = g @ (w f)^T``, ``dw = (x^T g) f`` and
``dsigma = sum (x^T g) w a``, with ``f = fl(1 + a sigma)``.  The port's
forward never materializes the noise, so its backward hashes it again in
two kernels of ``csrc/emt_matmul_bwd.cu``, both on the 3xTF32 tensor-core
template ``csrc/emt_tc.cuh``: :func:`emt_matmul_dx` (K3-dx, the noise in
the weight operand's transform) and :func:`emt_matmul_dw` (K3-dw, x^T g
with the noise in its epilogue).

The weight operand may also be int8 conductance levels with a float32
scale per column, ``(w_int8, w_scale)``, the ``store_int8`` serving form
(``core/emt_linear.py``): the kernels read the levels and dequantize them
in registers (``emt_matmul_i8`` in ``csrc/emt_matmul.cu``), and the plain
version dequantizes first.  It is serve-only: a gradient through it
raises, and K3-dx and K3-dw take float32 weights only.

On a CPU tensor each wrapper computes its plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches its kernel or
raises.  ``emt_matmul.launches`` (float32 weights),
``_forward_int8.launches`` (int8 weights), ``emt_matmul_dx.launches``
and ``emt_matmul_dw.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import hashrng
from repro_torch.core.device import DeviceModel
from repro_torch.kernels import _build, splitk
from repro_torch.kernels.ref import emt_matmul_dw_ref as plain_dw
from repro_torch.kernels.ref import emt_matmul_dx_ref as plain_dx
from repro_torch.kernels.ref import emt_matmul_ref as plain

MAX_STATES = 8
# csrc/emt_matmul.cu: the GEMV kernel takes M <= GEMV_MAX_M rows (templated
# on 1-4, 8 and 16); its CTA covers 128 columns of an n-major weight (slabs
# in multiples of 32 rows), or 32 columns of any other weight (multiples of
# 128), and stages its slab's x rows, at most GEMV_X_BYTES, in shared
# memory; the tiled kernel covers 64 x 64 outputs in 32-row K tiles.
# K3's backward (csrc/emt_tc.cuh) covers 128 x 128 outputs in 32-deep
# reduction tiles, one CTA per SM.
GEMV_MAX_M = 16
GEMV_X_BYTES = 24 * 1024
GEMV_N = dict(bn=128, bk=32, min_slab=64)
GEMV_K = dict(bn=32, bk=128, min_slab=256)
TILED = dict(bm=64, bn=64, bk=32, min_slab=64)
TC = dict(bm=128, bn=128, bk=32)


class NoiseParams(ctypes.Structure):
    """Mirror of ``repro::NoiseParams`` in csrc/common.cuh."""
    _fields_ = [("n_states", ctypes.c_int),
                ("thr", ctypes.c_float * (MAX_STATES - 1)),
                ("off", ctypes.c_float * MAX_STATES),
                ("t2", ctypes.c_uint32)]


def _uniform(bits: int) -> float:
    """The uniform a hash draw `bits` gives: fl32(bits) * 2^-32, as the
    kernels and hashrng round it (one rounding of the exact integer)."""
    return float(np.float32(bits)) * 2.0 ** -32


def int_threshold(thr: float) -> int:
    """The least uint32 `bits` with _uniform(bits) >= thr (that is
    monotonic in bits, so u >= thr iff bits >= this).  The kernels' two-state
    lookup compares the hash bits with it: one integer compare, no
    conversion."""
    lo, hi = 0, 2 ** 32
    while lo < hi:
        mid = (lo + hi) // 2
        if _uniform(mid) >= thr:
            hi = mid
        else:
            lo = mid + 1
    if lo == 2 ** 32:
        raise ValueError(f"state threshold {thr} above every uniform")
    return lo


def noise_params(device: DeviceModel) -> NoiseParams:
    """The RTN state table as the kernel compares it (float32 thresholds
    and offsets, computed exactly as hashrng does), built once per table."""
    return _noise_params(device.state_offsets, device.state_probs)


@functools.lru_cache(maxsize=None)
def _noise_params(offsets: tuple, probs: tuple) -> NoiseParams:
    n = len(offsets)
    if n > MAX_STATES:
        raise ValueError(f"{n} RTN states exceed the kernel's {MAX_STATES}")
    p = NoiseParams()
    p.n_states = n
    for i, t in enumerate(hashrng.state_thresholds(probs)):
        p.thr[i] = t
    for i, o in enumerate(hashrng.state_offset_table(offsets)):
        p.off[i] = o
    if n == 2:
        p.t2 = int_threshold(p.thr[0])
    return p


@functools.lru_cache(maxsize=None)
def _fn(lib: str, entry: str, pointers: int = 6):
    """The C entry `entry` of `lib`: `pointers` pointer arguments, then the
    seed and the plane, the noise table and the stream."""
    fn = getattr(_build.library(lib), entry)
    if fn.argtypes is None:
        P, U = ctypes.c_void_p, ctypes.c_uint
        fn.argtypes = [P] * pointers + [U, U, P, P]
        fn.restype = ctypes.c_int
    return fn


def plan(M: int, N: int, K: int, sms: int, n_major: bool) -> splitk.Plan:
    """The kernel's cut of (M, K) @ (K, N): K split until the grid holds two
    CTAs per SM (what ~128 registers per thread allow), in whole chunks or
    tiles.  `n_major`: the weight's N stride is 1.

    An int8 weight takes the same cut: its loader's step (32 rows n-major,
    128 k-major, the 32-row tile) is the float loader's slab granularity,
    and the split counts CTAs, not bytes, because at int8 the hash's
    operations, not the weight's bytes, bound the product (a gemma3-1b
    decode step: 1.016 ms on the ALU pipe against 0.570 ms of bytes), so
    the split that fills every SM stays."""
    if M <= GEMV_MAX_M:
        kw = GEMV_N if n_major else GEMV_K
        rows = M if M <= 4 else 8 if M <= 8 else 16      # the row template
        max_slab = GEMV_X_BYTES // (4 * rows) // kw["bk"] * kw["bk"]
        return splitk.plan(M, N, K, bm=M, sms=sms, max_slab=max_slab, **kw)
    return splitk.plan(M, N, K, sms=sms, **TILED)


def plan_dx(M: int, K: int, N: int, sms: int) -> splitk.Plan:
    """K3-dx's cut of g (M, N) @ w^T (N, K): 128 x 128 output tiles of
    (M, K), N split into whole 32-column tiles by splitk.plan_waves."""
    return splitk.plan_waves(M, K, N, sms=sms, **TC)


def plan_dw(M: int, K: int, N: int, sms: int) -> splitk.Plan:
    """K3-dw's cut of x^T (K, M) @ g (M, N): 128 x 128 output tiles of
    (K, N), M split into whole 32-row tiles by splitk.plan_waves."""
    return splitk.plan_waves(K, N, M, sms=sms, **TC)


def dw_buffer_floats(p: splitk.Plan) -> tuple:
    """(workspace, partials) floats of K3-dw's two buffers under plan_dw's
    plan `p`, as the C entry reads them: the slabs' partial x^T g
    (p.splits * K * N, none without a split), and four partials of dsigma
    per output tile (its 32-row quarters) then dsigma itself."""
    return (p.splits * p.M * p.N if p.splits > 1 else 0), 4 * p.tiles + 1


@functools.lru_cache(maxsize=4096)
def _launch(index, M, N, K, sxm, sxk, swk, swn):
    """(plan, the C entry's int64 dims array, its address) for one call
    shape on device `index`; the cache keeps the array alive."""
    p = plan(M, N, K, splitk.sm_count(index), swn == 1)
    dims = (ctypes.c_longlong * 9)(M, N, K, p.splits, p.k_slab, sxm, sxk,
                                   swk, swn)
    return p, dims, ctypes.addressof(dims)


@functools.lru_cache(maxsize=4096)
def _launch_dx(index, M, K, N, sgm, sgn, swk, swn):
    p = plan_dx(M, K, N, splitk.sm_count(index))
    dims = (ctypes.c_longlong * 9)(M, K, N, p.splits, p.k_slab, sgm, sgn,
                                   swk, swn)
    return p, dims, ctypes.addressof(dims)


def _check(what: str, a: torch.Tensor, w: torch.Tensor, sig: torch.Tensor,
           k_w: int):
    """Raise unless a, w and sig are float32 on one CUDA device, a's
    columns match w's dim `k_w` and sig is a scalar; returns the device
    index."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[k_w]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    index = a.get_device()
    f32 = torch.float32
    if not (a.dtype is f32 and w.dtype is f32 and sig.dtype is f32
            and w.get_device() == index and sig.get_device() == index):
        raise ValueError(f"{what}: inputs, w and sig must be float32 on "
                         f"{a.device}, got {a.dtype}, {w.dtype}, {sig.dtype} "
                         f"on {a.device}, {w.device}, {sig.device}")
    if sig.numel() != 1:
        raise ValueError(f"{what}: sig must be a scalar tensor")
    return index


def _on_cpu(what: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs); False for a CUDA
    one; raises for any other device."""
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{what}: unsupported device {t.device}")


def _check_int8(x, q, scale, sig) -> int:
    """Raise unless q is int8 (K, N) and scale N contiguous float32 values
    ((1, N) or (N,)), both on x's CUDA device (x and sig as _check wants
    them); returns the device index."""
    if q.dim() != 2 or x.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"emt_matmul: shapes {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    index = x.get_device()
    if not (q.dtype is torch.int8 and scale.dtype is torch.float32
            and scale.numel() == q.shape[1] and scale.is_contiguous()
            and q.get_device() == index and scale.get_device() == index):
        raise ValueError(
            f"emt_matmul: int8 weights need levels int8 (K, N) and a "
            f"contiguous float32 scale of N on {x.device}, got {q.dtype} "
            f"{tuple(q.shape)}, {scale.dtype} {tuple(scale.shape)} on "
            f"{q.device}, {scale.device}")
    f32 = torch.float32
    if not (x.dtype is f32 and sig.dtype is f32 and sig.numel() == 1
            and sig.get_device() == index):
        raise ValueError(f"emt_matmul: x and sig must be float32 on "
                         f"{x.device} (sig a scalar), got {x.dtype}, "
                         f"{sig.dtype} on {sig.device}")
    return index


def _forward(x, w, sig, *, device: DeviceModel, seed: int = 0,
             plane: int = 0):
    if _on_cpu("emt_matmul", x):
        return plain(x, w, sig, device=device, seed=seed, plane=plane)
    if isinstance(w, tuple):
        return _forward_int8(x, *w, sig, device=device, seed=seed,
                             plane=plane)
    index = _check("emt_matmul", x, w, sig, 0)
    M, K = x.shape
    N = w.shape[1]
    p, _, dims = _launch(index, M, N, K, *x.stride(), *w.stride())
    y, part = splitk.outputs(p, x)
    err = _fn("emt_matmul", "emt_matmul_f32")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), part, sig.data_ptr(), dims,
        int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF,
        ctypes.addressof(noise_params(device)), _build.stream(index))
    _build.check(err, "emt_matmul")
    emt_matmul.launches += 1
    return y


def _forward_int8(x, q, scale, sig, *, device: DeviceModel, seed: int,
                  plane: int):
    """The int8 kernels (``emt_matmul_i8``): levels q (K, N) int8 of any
    strides, scale N contiguous float32 values."""
    index = _check_int8(x, q, scale, sig)
    M, K = x.shape
    N = q.shape[1]
    p, _, dims = _launch(index, M, N, K, *x.stride(), *q.stride())
    y, part = splitk.outputs(p, x)
    err = _fn("emt_matmul", "emt_matmul_i8", 7)(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), part,
        sig.data_ptr(), dims, int(seed) & 0xFFFFFFFF,
        int(plane) & 0xFFFFFFFF, ctypes.addressof(noise_params(device)),
        _build.stream(index))
    _build.check(err, "emt_matmul_int8")
    _forward_int8.launches += 1
    return y


def emt_matmul_dx(g: torch.Tensor, w: torch.Tensor, sig: torch.Tensor, *,
                  device: DeviceModel, seed: int = 0, plane: int = 0):
    """K3-dx: g (M, N) @ noisy(w (K, N))^T -> (M, K) float32, the noise
    hashed at w's logical (k, n) as in the forward; g and w of any
    strides."""
    if _on_cpu("emt_matmul_dx", g):
        return plain_dx(g, w, sig, device=device, seed=seed, plane=plane)
    index = _check("emt_matmul_dx", g, w, sig, 1)
    M, N = g.shape
    K = w.shape[0]
    p, _, dims = _launch_dx(index, M, K, N, *g.stride(), *w.stride())
    dx, part = splitk.outputs(p, g)
    npar = noise_params(device)
    # a two-state table's noise-state bits, one per weight element (freed
    # on return)
    bits = (torch.empty(K * splitk.cdiv(N, 32), dtype=torch.int32,
                        device=g.device) if npar.n_states == 2 else None)
    err = _fn("emt_matmul_bwd", "emt_matmul_dx_f32", 7)(
        g.data_ptr(), w.data_ptr(), dx.data_ptr(), part,
        None if bits is None else bits.data_ptr(), sig.data_ptr(), dims,
        int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF,
        ctypes.addressof(npar), _build.stream(index))
    _build.check(err, "emt_matmul_dx")
    emt_matmul_dx.launches += 1
    return dx


@functools.lru_cache(maxsize=4096)
def _launch_dw(index, M, K, N, sxm, sxk, sgm, sgn, swk, swn):
    p = plan_dw(M, K, N, splitk.sm_count(index))
    dims = (ctypes.c_longlong * 11)(M, K, N, p.splits, p.k_slab, sxm, sxk,
                                    sgm, sgn, swk, swn)
    return p, dims, ctypes.addressof(dims)


def emt_matmul_dw(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                  sig: torch.Tensor, *, device: DeviceModel, seed: int = 0,
                  plane: int = 0):
    """K3-dw: (dw, dsigma) of y = x (M, K) @ noisy(w (K, N)) for the
    cotangent g (M, N): dw = (x^T g) * f (K, N), contiguous, and dsigma =
    sum (x^T g) * w * a, a float32 scalar summed in a fixed order (one
    partial per 32-row quarter of each 128 x 128 tile of dw, then those in
    order); x, g and w of any strides."""
    if _on_cpu("emt_matmul_dw", x):
        return plain_dw(x, g, w, sig, device=device, seed=seed, plane=plane)
    index = _check("emt_matmul_dw", x, w, sig, 0)
    K, N = w.shape
    if (g.shape != (x.shape[0], N) or g.dtype is not torch.float32
            or g.get_device() != index):
        raise ValueError(f"emt_matmul_dw: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} for x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} on {x.device}")
    p, _, dims = _launch_dw(index, x.shape[0], K, N, *x.stride(),
                            *g.stride(), *w.stride())
    n_ws, n_part = dw_buffer_floats(p)
    dw = torch.empty((K, N), dtype=torch.float32, device=x.device)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    # the slabs' workspace, freed on return (the returned dsigma, a view of
    # `part`, holds none of it)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    err = _fn("emt_matmul_bwd", "emt_matmul_dw_f32", 8)(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), dw.data_ptr(),
        None if ws is None else ws.data_ptr(), part.data_ptr(), sig.data_ptr(), dims, int(seed) & 0xFFFFFFFF,
        int(plane) & 0xFFFFFFFF, ctypes.addressof(noise_params(device)),
        _build.stream(index))
    _build.check(err, "emt_matmul_dw")
    emt_matmul_dw.launches += 1
    return dw, part[n_part - 1]


class _NoisyMatmul(torch.autograd.Function):
    """y = x @ noisy(w) through `impl` = (forward, dx, dw) functions, with
    the VJP of JAX's ``fluctuate`` + ``@``; dx and dw run only for the
    inputs that need them."""

    @staticmethod
    def forward(ctx, x, w, sig, impl, kw):
        ctx.save_for_backward(x, w, sig)
        ctx.impl, ctx.kw = impl, kw
        return impl[0](x, w, sig, **kw)

    @staticmethod
    def backward(ctx, g):
        x, w, sig = ctx.saved_tensors
        _, fdx, fdw = ctx.impl
        need_x, need_w, need_sig = ctx.needs_input_grad[:3]
        g = g.contiguous()
        dx = fdx(g, w, sig, **ctx.kw) if need_x else None
        dw = dsig = None
        if need_w or need_sig:
            dw, dsig = fdw(x, g, w, sig, **ctx.kw)
            dsig = dsig.reshape(sig.shape).to(sig.dtype)
        return (dx, dw if need_w else None, dsig if need_sig else None,
                None, None)


class _Int8Serving(torch.autograd.Function):
    """The int8 operand's product where an input requires a gradient: the
    forward runs, a backward raises (store_int8 is serve-only)."""

    @staticmethod
    def forward(ctx, x, q, scale, sig, forward, kw):
        return forward(x, (q, scale), sig, **kw)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "emt_matmul: no gradient flows through int8 weights "
            "(store_int8 is serve-only; K3-dx and K3-dw take float32 "
            "weights): train on the float tree and quantize it with "
            "quantize_tree_for_serving")


def differentiable(forward, dx, dw):
    """The product x @ noisy(w) through `forward`, differentiable through
    `dx` and `dw` when grad mode is on and an input requires it (else the
    forward alone, with no autograd bookkeeping: the serving path).  An
    int8 operand ``(levels, scale)`` is not differentiable (_Int8Serving)."""
    def call(x, w, sig, *, device: DeviceModel, seed: int = 0,
             plane: int = 0):
        kw = dict(device=device, seed=seed, plane=plane)
        if isinstance(w, tuple):
            q, scale = w
            if torch.is_grad_enabled() and (x.requires_grad
                                            or scale.requires_grad
                                            or sig.requires_grad):
                return _Int8Serving.apply(x, q, scale, sig, forward, kw)
            return forward(x, (q, scale), sig, **kw)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                        or sig.requires_grad):
            return _NoisyMatmul.apply(x, w, sig, (forward, dx, dw), kw)
        return forward(x, w, sig, **kw)
    return call


_kernels = differentiable(_forward, emt_matmul_dx, emt_matmul_dw)
# the plain versions on any device, with the same VJP (the card's plain
# training path)
plain_differentiable = differentiable(plain, plain_dx, plain_dw)


def emt_matmul(x: torch.Tensor, w, sig: torch.Tensor, *,
               device: DeviceModel, seed: int = 0, plane: int = 0):
    """x (M, K) @ noisy(w (K, N)) -> (M, N) float32, differentiable in x,
    w and sig.

    `w` may have any strides (the tied unembed passes the embedding table's
    transpose without a copy); the noise still hashes the logical
    (row = K index, col = N index).  `w` may also be ``(w_int8, w_scale)``:
    int8 levels (K, N) of any strides and their per-column float32 scale
    (1, N), dequantized in the kernel as fl(float(q) * scale) before the
    noise (serve-only).  `sig` is sigma_rel(rho) as a one-element float32
    tensor on x's device (read by the kernel, no host sync).
    """
    return _kernels(x, w, sig, device=device, seed=seed, plane=plane)


emt_matmul.launches = 0
_forward_int8.launches = 0
emt_matmul_dx.launches = 0
emt_matmul_dw.launches = 0
