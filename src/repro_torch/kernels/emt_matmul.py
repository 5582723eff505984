"""Technique-A noisy crossbar matmul: CUDA kernel wrappers + plain
versions, forward and backward.

Replaces ``repro/kernels/emt_matmul.py::emt_matmul_pallas``: computes
``y = x @ (w * (1 + a_l * sigma))`` with the RTN offsets hashed inside the
weight tile from each element's global (row, col), the runtime step seed and
the layer plane, so no noise tensor reaches device memory.  The source and
its design note: ``csrc/emt_matmul.cu`` (a GEMV-style kernel for M <= 16)
and ``csrc/emt_matmul_fwd.cu`` (M > 16, on the tensor cores: the 3xTF32
template ``csrc/emt_tc.cuh`` with the noisy weight split into three TF32
pieces, so x = I still returns it bit for bit); both split K by
:func:`plan`.

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
in registers (``emt_matmul_i8`` in ``csrc/emt_matmul.cu``,
``emt_matmul_tc_i8`` in ``csrc/emt_matmul_fwd.cu``), and the plain version
dequantizes first.  It is serve-only: a gradient through it raises, and
K3-dx and K3-dw take float32 weights only.

:func:`emt_matmul_experts` computes a stack of E experts' products in one
launch (``emt_matmul_experts_f32``, the GEMV with an expert grid axis, at
M <= 16; above, ``emt_matmul_experts_tc_f32`` in
``csrc/emt_experts_tc.cu``, on the tensor cores with the noisy weight
built in registers as wgmma's A operand), expert
e's weight hashed at rows e * K + k of the folded (E * K, N) stack, as
JAX's MoE layer draws its noise (``repro/models/moe.py`` ``_emt_stacked``;
the TPU kernel's row base ``k0_base``), and returns the noisy stack's
sum |w~| and max |w~| beside the product, from per-CTA partials over
disjoint weight regions summed in a fixed order (float64).  Its gradient
on the card runs the experts' K3-dx and K3-dw
(:func:`emt_matmul_experts_dx`, :func:`emt_matmul_experts_dw`: the two
kernels of ``csrc/emt_matmul_bwd.cu`` over the stack in one launch each,
the grid's y the expert, the noise hashed again at rows e * K + k), with
the VJP XLA gives JAX's ``_emt_stacked`` + ``einsum`` + technique B's
sum |w~|: the sum's cotangent gs adds gs * sgn(w~) to x^T g before the
factor; the max is not differentiable (it feeds only the energy).

On a CPU tensor each wrapper computes its plain version
(:mod:`repro_torch.kernels.ref`); on a CUDA tensor it launches its kernel or
raises.  ``emt_matmul.launches`` (float32 weights),
``_forward_int8.launches`` (int8 weights), ``emt_matmul_experts.launches``,
``emt_matmul_dx.launches``, ``emt_matmul_dw.launches``,
``emt_matmul_experts_dx.launches`` and ``emt_matmul_experts_dw.launches``
count kernel launches, one a call; ``_forward_tc.launches`` counts the
calls of the first two that ran on the tensor-core kernel (M > 16).
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
from repro_torch.kernels.ref import \
    emt_matmul_experts_dw_ref as plain_experts_dw
from repro_torch.kernels.ref import \
    emt_matmul_experts_dx_ref as plain_experts_dx
from repro_torch.kernels.ref import emt_matmul_experts_ref as plain_experts
from repro_torch.kernels.ref import emt_matmul_ref as plain

MAX_STATES = 8
# csrc/emt_matmul.cu: the GEMV kernel takes M <= GEMV_MAX_M rows (templated
# on 1-4, 8 and 16); its CTA covers 128 columns of an n-major weight (slabs
# in multiples of 32 rows), or 32 columns of any other weight (multiples of
# 128), and stages its slab's x rows, at most GEMV_X_BYTES, in shared
# memory.  K3's forward above GEMV_MAX_M rows and its backward (the
# template csrc/emt_tc.cuh) cover 128 x 128 outputs in 32-deep reduction
# tiles, one CTA per SM.
GEMV_MAX_M = 16
GEMV_X_BYTES = 24 * 1024
# The int8 and experts GEMVs (n-major, M <= 16) stream the weight through a
# ring of shared-memory stages (csrc/emt_matmul.cu's Ring, mirrored here),
# each holding `rows` slab rows of the CTA's 128 columns (the 8 warps' 4
# int8 or 2 float32 rows each), `stages - 1` stages in flight; the
# end-of-slab reduction reuses the ring.  Beside it the slab's x rows, at
# most GEMV_X_BYTES; two CTAs a SM within the SMEM_PER_SM bytes an SM
# gives its CTAs (less RESERVED_SMEM each).
GEMV_RING = {True: dict(stages=5, rows=32, stage_bytes=4096),
             False: dict(stages=3, rows=16, stage_bytes=8192)}
SMEM_PER_SM = 227 * 1024
RESERVED_SMEM = 1024
GEMV_N = dict(bn=128, bk=32, min_slab=64)
GEMV_K = dict(bn=32, bk=128, min_slab=256)
TC = dict(bm=128, bn=128, bk=32)
# The experts entry above GEMV_MAX_M rows (csrc/emt_experts_tc.cu,
# mirrored here): a CTA of experts_tc_cols(M) // 64 consumer warpgroups
# and a producer one covers that many weight columns by one x row tile of
# experts_tile_rows(M) rows up to row_tile rows, two of row_tile above
# (later row tiles in the grid), in 32-deep k-tiles, one CTA an SM.  Its
# shared memory: x's ring stages of two TF32 pieces (x_stages by (row
# tiles, tile rows)), the weight's (w_stages by columns and row tiles; 32
# rows of the CTA's columns), 1 KB of alignment, the static mbarriers (a
# full and an empty one a stage) and the statistics' slots (12 bytes a
# consumer warp).
EXPERTS_TC = dict(bk=32, row_tile=64,
                  x_stages={(1, 24): 8, (1, 32): 8, (1, 48): 6, (1, 64): 5,
                            (2, 64): 3},
                  w_stages={(256, 1): 5, (128, 1): 8, (128, 2): 6})


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


def plan(M: int, N: int, K: int, sms: int, n_major: bool,
         experts: int = 0) -> splitk.Plan:
    """The kernel's cut of (M, K) @ (K, N).  At M <= 16 (the GEMV): K split
    until the grid holds two CTAs per SM (what ~128 registers per thread
    allow), in whole chunks.  Above: the tensor-core kernel's 128 x 128
    tiles, K split by splitk.plan_waves (one CTA per SM) in whole 32-row
    k-tiles.  `n_major`: the weight's N stride is 1.

    An int8 weight takes the float weight's cut, and so does a stack of
    experts at one expert: each column's sum then runs in one order on
    every loader (the slabs in order, in each the 8 warps in order, warp w
    over rows w, w + 8, ...), so int8 products equal the float32 GEMV's on
    the dequantized weight and a one-expert stack equals K3, bit for bit.
    The n-major int8 and experts GEMVs stream the weight through a ring
    of 32- or 16-row stages (GEMV_RING), which the 32-row chunks fill
    whole; the split counts CTAs, not bytes, so that every SM holds two
    CTAs' rings in flight and hashes.

    `experts`: a stack of that many products in one grid (the experts
    entry, :func:`emt_matmul_experts`), whose split counts every
    expert's tiles; 0 (the default), K3's single product.  Above 16 rows
    a stack takes the experts' tensor-core kernel's cut (experts_tc_cols(M)
    columns by experts_tc_rows(M) rows a CTA, one CTA an SM, K in whole
    32-row k-tiles by splitk.plan_waves), a single product K3's."""
    if M <= GEMV_MAX_M:
        kw = GEMV_N if n_major else GEMV_K
        rows = M if M <= 4 else 8 if M <= 8 else 16      # the row template
        max_slab = GEMV_X_BYTES // (4 * rows) // kw["bk"] * kw["bk"]
        return splitk.plan(M, N, K, bm=M, sms=sms, max_slab=max_slab,
                           experts=max(experts, 1), **kw)
    if experts:
        return splitk.plan_waves(M, N, K, sms=sms, bm=experts_tc_rows(M),
                                 bn=experts_tc_cols(M),
                                 bk=EXPERTS_TC["bk"], experts=experts)
    return splitk.plan_waves(M, N, K, sms=sms, **TC)


def experts_tc_rows(M: int) -> int:
    """The x rows a CTA of the experts' tensor-core kernel covers at M >
    16 rows: one row tile up to 64 rows, two above (csrc/emt_experts_tc.cu
    row_tiles), which share each k-tile's noisy weight, so a weight element
    is hashed once a call wherever M <= 128."""
    t = EXPERTS_TC["row_tile"]
    return t if M <= t else 2 * t


def experts_tile_rows(M: int) -> int:
    """The rows of one row tile at M > 16 rows, wgmma's N: M rounded up to
    24, 32, 48 or 64 up to 64 rows, 64 above (csrc/emt_experts_tc.cu
    tile_rows)."""
    for n in (24, 32, 48):
        if M <= n:
            return n
    return 64


def experts_tc_cols(M: int) -> int:
    """The weight columns a CTA of the experts' tensor-core kernel covers
    at M > 16 rows: 256 (four consumer warpgroups) up to 32 rows, 128 above
    (csrc/emt_experts_tc.cu cta_cols)."""
    return 256 if M <= 32 else 128


def experts_tc_smem(M: int) -> int:
    """Shared-memory bytes of one CTA of the experts' tensor-core kernel
    at M rows, as its launcher sizes it (dynamic) and declares it
    (static)."""
    g = EXPERTS_TC
    tiles = experts_tc_rows(M) // g["row_tile"]
    rows, cols = experts_tile_rows(M), experts_tc_cols(M)
    xs, ws = g["x_stages"][tiles, rows], g["w_stages"][cols, tiles]
    stage = 2 * tiles * rows * g["bk"] * 4
    weights = ws * g["bk"] * cols * 4
    return xs * stage + weights + 1024 + 2 * 8 * (xs + ws) + cols // 64 * 48


def experts_grid(p: splitk.Plan) -> tuple:
    """The experts' tensor-core launch's grid under plan `p`, as the C
    entry builds it: (column tiles, row tiles, experts x slabs)."""
    return (splitk.cdiv(p.N, p.bn), splitk.cdiv(p.M, p.bm), p.E * p.splits)


def gemv_ring_smem(M: int, k_slab: int, int8: bool) -> int:
    """Shared-memory bytes of one CTA of the int8 (`int8`) or experts GEMV
    at M <= 16 rows over a slab of `k_slab` rows, as its launcher sizes
    it: the ring's stages, then the slab's x rows at the row template, and
    the experts' statistics (a float64 and a float32 a warp)."""
    ring = GEMV_RING[int8]
    rows = M if M <= 4 else 8 if M <= 8 else 16      # the row template
    stats = 0 if int8 else 12 * 8
    return ring["stages"] * ring["stage_bytes"] + 4 * rows * k_slab + stats


def tc_bits_words(M: int, N: int, K: int) -> int:
    """The words of noise-state bits the tensor-core forward reads for a
    two-state table (one bit a weight element, N rows of ceil(K / 32)):
    where x has more than one 128-row tile, so that each element is hashed
    once a call, not once a row tile; 0 (the producers hash) at one."""
    return N * splitk.cdiv(K, 32) if M > TC["bm"] else 0


def plan_dx(M: int, K: int, N: int, sms: int,
            experts: int = 0) -> splitk.Plan:
    """K3-dx's cut of g (M, N) @ w^T (N, K): 128 x 128 output tiles of
    (M, K), N split into whole 32-column tiles by splitk.plan_waves.
    `experts`: a stack of that many products in one grid (the experts'
    dx), whose split counts every expert's tiles; 0, one product."""
    return splitk.plan_waves(M, K, N, sms=sms, experts=max(experts, 1),
                             **TC)


def plan_dw(M: int, K: int, N: int, sms: int,
            experts: int = 0) -> splitk.Plan:
    """K3-dw's cut of x^T (K, M) @ g (M, N): 128 x 128 output tiles of
    (K, N), M split into whole 32-row tiles by splitk.plan_waves;
    `experts` as plan_dx's."""
    return splitk.plan_waves(K, N, M, sms=sms, experts=max(experts, 1),
                             **TC)


def dw_buffer_floats(p: splitk.Plan) -> tuple:
    """(workspace, partials) floats of K3-dw's two buffers under plan_dw's
    plan `p`, as the C entry reads them: the slabs' partial x^T g
    (p.splits * E * K * N, none without a split), and four partials of
    dsigma per output tile (its 32-row quarters; an expert's tiles after
    the earlier experts') then dsigma itself."""
    return ((p.splits * p.E * p.M * p.N if p.splits > 1 else 0),
            4 * p.tiles + 1)


@functools.lru_cache(maxsize=4096)
def _launch(index, M, N, K, sxm, sxk, swk, swn):
    """(plan, the C entry's int64 dims array, its address) for one call
    shape on device `index`; the cache keeps the array alive."""
    p = plan(M, N, K, splitk.sm_count(index), swn == 1)
    dims = (ctypes.c_longlong * 9)(M, N, K, p.splits, p.k_slab, sxm, sxk,
                                   swk, swn)
    return p, dims, ctypes.addressof(dims)


def _forward_tc(x, w, scale, y, part, sig, dims, *, device: DeviceModel,
                seed: int, plane: int, index: int):
    """K3 at M > 16 on the tensor cores (``csrc/emt_matmul_fwd.cu``): the
    float32 weight w, or int8 levels w with their scale, into y (and the
    slabs' `part`), after _check or _check_int8."""
    npar = noise_params(device)
    seed, plane = int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF
    if scale is None:
        M, K = x.shape
        words = (tc_bits_words(M, w.shape[1], K)
                 if npar.n_states == 2 else 0)
        # a two-state table's noise-state bits (freed on return)
        bits = (torch.empty(words, dtype=torch.int32, device=x.device)
                if words else None)
        err = _fn("emt_matmul_fwd", "emt_matmul_tc_f32", 7)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part,
            None if bits is None else bits.data_ptr(), sig.data_ptr(), dims,
            seed, plane, ctypes.addressof(npar), _build.stream(index))
    else:
        err = _fn("emt_matmul_fwd", "emt_matmul_tc_i8", 7)(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(), part,
            sig.data_ptr(), dims, seed, plane, ctypes.addressof(npar),
            _build.stream(index))
    _build.check(err, "emt_matmul_tc")
    _forward_tc.launches += 1


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
    if M > GEMV_MAX_M:
        _forward_tc(x, w, None, y, part, sig, dims, device=device, seed=seed,
                    plane=plane, index=index)
    else:
        err = _fn("emt_matmul", "emt_matmul_f32")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part, sig.data_ptr(),
            dims, int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF,
            ctypes.addressof(noise_params(device)), _build.stream(index))
        _build.check(err, "emt_matmul")
    emt_matmul.launches += 1
    return y


def _forward_int8(x, q, scale, sig, *, device: DeviceModel, seed: int,
                  plane: int):
    """The int8 kernels (``emt_matmul_i8``, ``emt_matmul_tc_i8`` at
    M > 16): levels q (K, N) int8 of any strides, scale N contiguous
    float32 values."""
    index = _check_int8(x, q, scale, sig)
    M, K = x.shape
    N = q.shape[1]
    p, _, dims = _launch(index, M, N, K, *x.stride(), *q.stride())
    y, part = splitk.outputs(p, x)
    if M > GEMV_MAX_M:
        _forward_tc(x, q, scale, y, part, sig, dims, device=device,
                    seed=seed, plane=plane, index=index)
    else:
        err = _fn("emt_matmul", "emt_matmul_i8", 7)(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), part,
            sig.data_ptr(), dims, int(seed) & 0xFFFFFFFF,
            int(plane) & 0xFFFFFFFF, ctypes.addressof(noise_params(device)),
            _build.stream(index))
        _build.check(err, "emt_matmul_int8")
    _forward_int8.launches += 1
    return y


@functools.lru_cache(maxsize=4096)
def _launch_experts(index, E, M, N, K, sxe, sxm, sxk, swe, swk):
    """(plan, the experts entry's int64 dims array, its address) for one
    call shape; dims[12] is the number of per-CTA statistics slots."""
    p = plan(M, N, K, splitk.sm_count(index), True, experts=E)
    dims = (ctypes.c_longlong * 13)(M, N, K, p.splits, p.k_slab, sxm, sxk,
                                    swk, 1, E, sxe, swe, p.ctas)
    return p, dims, ctypes.addressof(dims)


def _forward_experts(x, w, sig, *, device: DeviceModel, seed: int = 0,
                     plane: int = 0):
    """The experts kernel: (y (E, M, N), sum |w~|, max |w~|)."""
    if _on_cpu("emt_matmul_experts", x):
        return plain_experts(x, w, sig, device=device, seed=seed,
                             plane=plane)
    if (x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]
            or x.shape[2] != w.shape[1]):
        raise ValueError(f"emt_matmul_experts: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    index = _check("emt_matmul_experts", x[0], w[0], sig, 0)
    if w.stride(2) != 1:
        raise ValueError("emt_matmul_experts: the expert weights must be "
                         f"n-major (stride 1 along N), got strides "
                         f"{w.stride()}")
    E, M, K = x.shape
    N = w.shape[2]
    p, _, dims = _launch_experts(index, E, M, N, K, x.stride(0),
                                 x.stride(1), x.stride(2), w.stride(0),
                                 w.stride(1))
    y, part = splitk.outputs(p, x)
    # per-CTA partial sums and maxima (float64), then the two results
    parts = torch.empty(2 * p.ctas, dtype=torch.float64, device=x.device)
    stats = torch.empty(2, dtype=torch.float32, device=x.device)
    lib, entry = (("emt_matmul", "emt_matmul_experts_f32")
                  if M <= GEMV_MAX_M else
                  ("emt_experts_tc", "emt_matmul_experts_tc_f32"))
    err = _fn(lib, entry, 8)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), part, parts.data_ptr(),
        stats.data_ptr(), sig.data_ptr(), dims, int(seed) & 0xFFFFFFFF,
        int(plane) & 0xFFFFFFFF, ctypes.addressof(noise_params(device)),
        _build.stream(index))
    _build.check(err, "emt_matmul_experts")
    emt_matmul_experts.launches += 1
    return y.view(E, M, N), stats[0], stats[1]


def _check_experts(what: str, a: torch.Tensor, w: torch.Tensor,
                   sig: torch.Tensor, k_w: int) -> int:
    """Raise unless a (E, M, .) and w (E, K, N) are stacks of one E whose
    a's last dim matches w's dim `k_w` + 1, float32 on one CUDA device with
    sig (_check); returns the device index."""
    if (a.dim() != 3 or w.dim() != 3 or a.shape[0] != w.shape[0]
            or a.shape[0] < 1):
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    return _check(what, a[0], w[0], sig, k_w)


@functools.lru_cache(maxsize=4096)
def _launch_experts_dx(index, E, M, K, N, sge, sgm, sgn, swe, swk, swn):
    p = plan_dx(M, K, N, splitk.sm_count(index), experts=E)
    dims = (ctypes.c_longlong * 12)(M, K, N, p.splits, p.k_slab, sgm, sgn,
                                    swk, swn, E, sge, swe)
    return p, dims, ctypes.addressof(dims)


def emt_matmul_experts_dx(g: torch.Tensor, w: torch.Tensor,
                          sig: torch.Tensor, *, device: DeviceModel,
                          seed: int = 0, plane: int = 0):
    """The experts' K3-dx: g (E, M, N) @ noisy(w (E, K, N))^T -> (E, M, K)
    float32 in one launch, expert e's noise hashed at rows e * K + k as in
    the forward; g and w of any strides."""
    if _on_cpu("emt_matmul_experts_dx", g):
        return plain_experts_dx(g, w, sig, device=device, seed=seed,
                                plane=plane)
    index = _check_experts("emt_matmul_experts_dx", g, w, sig, 1)
    E, M, N = g.shape
    K = w.shape[1]
    p, _, dims = _launch_experts_dx(index, E, M, K, N, *g.stride(),
                                    *w.stride())
    dx, part = splitk.outputs(p, g)
    npar = noise_params(device)
    # a two-state table's noise-state bits of the folded stack (freed on
    # return)
    bits = (torch.empty(E * K * splitk.cdiv(N, 32), dtype=torch.int32,
                        device=g.device) if npar.n_states == 2 else None)
    err = _fn("emt_matmul_bwd", "emt_matmul_experts_dx_f32", 7)(
        g.data_ptr(), w.data_ptr(), dx.data_ptr(), part,
        None if bits is None else bits.data_ptr(), sig.data_ptr(), dims,
        int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF,
        ctypes.addressof(npar), _build.stream(index))
    _build.check(err, "emt_matmul_experts_dx")
    emt_matmul_experts_dx.launches += 1
    return dx.view(E, M, K)


@functools.lru_cache(maxsize=4096)
def _launch_experts_dw(index, E, M, K, N, sxe, sxm, sxk, sge, sgm, sgn, swe,
                       swk, swn):
    p = plan_dw(M, K, N, splitk.sm_count(index), experts=E)
    dims = (ctypes.c_longlong * 15)(M, K, N, p.splits, p.k_slab, sxm, sxk,
                                    sgm, sgn, swk, swn, E, sxe, sge, swe)
    return p, dims, ctypes.addressof(dims)


def emt_matmul_experts_dw(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                          sig: torch.Tensor, gs=None, *,
                          device: DeviceModel, seed: int = 0,
                          plane: int = 0):
    """The experts' K3-dw: (dw, dsigma) of y[e] = x[e] (M, K) @ noisy(w[e]
    (K, N)) for the cotangent g (E, M, N) of the product and `gs` (a
    float32 scalar tensor on the device, read by the kernel, or None) of
    the noisy stack's sum |w~|: c = x[e]^T g[e] + gs * sgn(w~), dw = c * f
    (E, K, N), contiguous, and dsigma = sum c * w * a over the stack, a
    float32 scalar summed in a fixed order (four partials a 128 x 128 tile
    of each expert's dw, expert by expert, then those in order); one
    launch, expert e's noise at rows e * K + k; x, g and w of any
    strides."""
    if _on_cpu("emt_matmul_experts_dw", x):
        return plain_experts_dw(x, g, w, sig, gs, device=device, seed=seed,
                                plane=plane)
    index = _check_experts("emt_matmul_experts_dw", x, w, sig, 0)
    E, M, K = x.shape
    N = w.shape[2]
    if (g.shape != (E, M, N) or g.dtype is not torch.float32
            or g.get_device() != index):
        raise ValueError(f"emt_matmul_experts_dw: g {tuple(g.shape)} "
                         f"{g.dtype} on {g.device} for x {tuple(x.shape)} "
                         f"@ w {tuple(w.shape)} on {x.device}")
    if gs is None:
        # no sum |w~| term: c = gw + (+-0), gw's value
        gs = torch.zeros(1, dtype=torch.float32, device=x.device)
    if (gs.numel() != 1 or gs.dtype is not torch.float32
            or gs.get_device() != index):
        raise ValueError(f"emt_matmul_experts_dw: gs must be a float32 "
                         f"scalar on {x.device}, got {gs.dtype} "
                         f"{tuple(gs.shape)} on {gs.device}")
    gs = gs.reshape(1).contiguous()
    p, _, dims = _launch_experts_dw(index, E, M, K, N, *x.stride(),
                                    *g.stride(), *w.stride())
    n_ws, n_part = dw_buffer_floats(p)
    dw = torch.empty((E, K, N), dtype=torch.float32, device=x.device)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    # the slabs' workspace, freed on return
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    err = _fn("emt_matmul_bwd", "emt_matmul_experts_dw_f32", 9)(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), dw.data_ptr(),
        None if ws is None else ws.data_ptr(), part.data_ptr(),
        gs.data_ptr(), sig.data_ptr(), dims,
        int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF,
        ctypes.addressof(noise_params(device)), _build.stream(index))
    _build.check(err, "emt_matmul_experts_dw")
    emt_matmul_experts_dw.launches += 1
    return dw, part[n_part - 1]


class _NoisyExperts(torch.autograd.Function):
    """(y, sum |w~|, max |w~|) of a stack of experts through `impl` =
    (forward, dx, dw) functions, with the VJP XLA gives JAX's
    ``_emt_stacked`` + ``einsum`` and technique B's sum |w~| over the
    noisy stack: the sum's cotangent joins the product's in dw's
    epilogue; the max is not differentiable.  dx runs only where x needs
    a gradient, dw only where w or sigma does."""

    @staticmethod
    def forward(ctx, x, w, sig, impl, kw):
        ctx.save_for_backward(x, w, sig)
        ctx.impl, ctx.kw = impl, kw
        y, s, m = impl[0](x, w, sig, **kw)
        ctx.mark_non_differentiable(m)
        return y, s, m

    @staticmethod
    def backward(ctx, gy, gs, _):
        x, w, sig = ctx.saved_tensors
        _, fdx, fdw = ctx.impl
        need_x, need_w, need_sig = ctx.needs_input_grad[:3]
        gy = gy.contiguous()
        dx = fdx(gy, w, sig, **ctx.kw) if need_x else None
        dw = dsig = None
        if need_w or need_sig:
            dw, dsig = fdw(x, gy, w, sig, gs, **ctx.kw)
            dsig = dsig.reshape(sig.shape).to(sig.dtype)
        return (dx, dw if need_w else None, dsig if need_sig else None,
                None, None)


def experts_differentiable(forward, dx, dw):
    """The stack's products and statistics through `forward`,
    differentiable through `dx` and `dw` (_NoisyExperts) when grad mode is
    on and an input requires it; else the forward alone (the serving
    path)."""
    def call(x, w, sig, *, device: DeviceModel, seed: int = 0,
             plane: int = 0):
        kw = dict(device=device, seed=seed, plane=plane)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                        or sig.requires_grad):
            return _NoisyExperts.apply(x, w, sig, (forward, dx, dw), kw)
        return forward(x, w, sig, **kw)
    return call


_experts_kernels = experts_differentiable(
    _forward_experts, emt_matmul_experts_dx, emt_matmul_experts_dw)
# the plain versions on any device, with the same VJP (the card's plain
# training path for MoE stacks)
plain_experts_differentiable = experts_differentiable(
    plain_experts, plain_experts_dx, plain_experts_dw)


def emt_matmul_experts(x: torch.Tensor, w: torch.Tensor, sig: torch.Tensor,
                       *, device: DeviceModel, seed: int = 0,
                       plane: int = 0):
    """A stack of E experts' noisy products: x (E, M, K) @ noisy(w (E, K,
    N)) -> (y (E, M, N) float32, sum |w~|, max |w~|), the noise of expert
    e's element (k, n) hashed at row e * K + k, col n (the folded (E * K,
    N) draw), and the two statistics of the noisy stack as float32 scalar
    tensors.  x of any strides; w n-major (stride 1 along N).
    Differentiable in x, w and sig (the max excepted): on the CPU the
    plain version under torch's autograd; on the card the kernel, whose
    gradient runs the experts' K3-dx and K3-dw."""
    kw = dict(device=device, seed=seed, plane=plane)
    if _on_cpu("emt_matmul_experts", x):
        return plain_experts(x, w, sig, **kw)
    return _experts_kernels(x, w, sig, **kw)


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
_forward_tc.launches = 0
emt_matmul_experts.launches = 0
emt_matmul_dx.launches = 0
emt_matmul_dw.launches = 0
emt_matmul_experts_dx.launches = 0
emt_matmul_experts_dw.launches = 0
