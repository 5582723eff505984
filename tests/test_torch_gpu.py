"""The port's CUDA kernels against their plain versions on the card, at
small shapes (and K3's experts entry at moonshot-v1-16b-a3b's full expert
stacks), and the shrunk engines on the card (gemma3-1b analog and on the
mixed placement; seamless-m4t-medium through the legacy prefill and the
cross-attention kernel; moonshot's MoE stack on the mixed placement; the
recurrent stacks, xlstm-350m and jamba-v0.1-52b, with K3 at their
projections' shapes and the experts entry at jamba's widths).  Marked
``gpu``: the fixture skips them where torch sees no CUDA device; on a
machine with an H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 1e-5 relative (float32 sum order; the attention kernels K1,
K2 and K4 against their plain versions in float64); pools after the fused
write (and the read-only kernel's, unchanged), the noisy weight itself
(x = I) and two calls of the split kernels (K1, K2, K3, K4, K5) on the same
inputs bit for bit.  The experts entry's statistics: the max of |w~|
exact, the sum within rtol 1e-6 (the kernel sums in float64, the plain
version in float32).
"""
import numpy as np
import pytest
import torch

from cuda_launches import launched
from repro_torch.core import noise
from repro_torch.core.device import DeviceModel, four_state_device
from repro_torch.kernels import emt_bitserial as k5
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as k1
from repro_torch.kernels import paged_attention as k4
from repro_torch.kernels import paged_prefill as k2
from repro_torch.kernels.ref import NEG_INF

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# (M, K, N, transposed): every GEMV row template (1-4, 8, 16) and the
# tensor-core kernel (M > 16: the verify step's 20, one row tile at 64 and
# 128, two at 129, a training step's 1,024, the CNN's K = 27 at 4,096
# rows); K a multiple of neither the K chunk, the 32-row k-tile nor the
# split; both weight layouts; ragged N (row strides that allow 16-, 8- and
# 4-byte loads, and 1, 2 or 129 columns past a 128-column tile); most
# cases split K (the plan's split count is printed on failure); a MoE
# router's 64 columns (half a GEMV CTA's 128) at decode and chunk rows.
K3_CASES = [(4, 96, 200, False), (64, 256, 130, False), (3, 64, 300, True),
            (1, 1000, 260, False), (2, 555, 1001, False),
            (4, 1000, 262, True), (6, 4100, 64, True),
            (16, 777, 514, False), (16, 300, 200, True),
            (17, 1000, 130, False), (64, 1000, 300, True),
            (4, 2048, 64, False), (64, 2048, 64, False),
            (20, 1000, 130, False), (20, 300, 200, True),
            (128, 512, 256, False), (128, 256, 385, True),
            (129, 300, 257, False), (129, 512, 130, True),
            (1024, 1152, 1024, False), (1024, 1152, 1000, True),
            (4096, 27, 64, False), (200, 77, 129, False),
            (64, 333, 257, False), (129, 333, 300, True)]
# cases whose weight is built so that its noisy values lie at or just below
# powers of two (rna to TF32 would round them up: the three-piece split
# must still return them bit for bit on x = I)
K3_BELOW_POW2 = {(64, 333, 257, False), (129, 333, 300, True)}


def _below_pow2(cuda, K, N, rho, dev, g):
    """A (K, N) weight whose noisy value fl(w * f) is within an ulp of
    s (2 - j 2^-23) 2^e (j in 1..4, e in -8..8, s a random sign): w = that
    over the element's factor f (fluctuate of ones)."""
    f = noise.fluctuate(torch.ones((K, N), device=cuda), rho, dev,
                        noise.NoiseConfig(), seed=99, plane=1234)
    j = torch.randint(1, 5, (K, N), generator=g, device=cuda).double()
    e = torch.randint(-8, 9, (K, N), generator=g, device=cuda).double()
    sign = torch.randint(0, 2, (K, N), generator=g, device=cuda) * 2.0 - 1
    t = sign * (2 - j * 2.0 ** -23) * torch.pow(2.0, e)
    return (t / f.double()).float()


@pytest.mark.parametrize("M,K,N,transposed", K3_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k3_matches_plain_and_noise_bit_exact(cuda, M, K, N, transposed, dev):
    """Within 1e-5 of the plain version; two calls bit-identical (the split
    sum is ordered); rows of I give the noisy weight's rows bit for bit on
    the path M selects, and I itself (the tensor-core path) the whole of
    it; M > 16 launches the tensor-core kernel (emt_matmul_tc), M <= 16
    the GEMV."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda)
    rho = torch.tensor(3.5, device=cuda)
    if (M, K, N, transposed) in K3_BELOW_POW2:
        w = _below_pow2(cuda, K, N, rho, dev, g)
        w = w.T.contiguous().T if transposed else w
    else:
        w = torch.randn((N, K) if transposed else (K, N), generator=g,
                        device=cuda)
        w = w.T if transposed else w
    sig = dev.sigma_rel(rho)
    p = k3.plan(M, N, K, torch.cuda.get_device_properties(cuda)
                .multi_processor_count, not transposed)
    kw = dict(device=dev, seed=99, plane=1234)
    before = (k3.emt_matmul.launches, k3._forward_tc.launches)
    y = k3.emt_matmul(x, w, sig, **kw)
    assert k3.emt_matmul.launches == before[0] + 1
    assert k3._forward_tc.launches == before[1] + (M > k3.GEMV_MAX_M)
    want = "emt_matmul_tc" if M > k3.GEMV_MAX_M else "emt_matmul_gemv"
    names = launched(lambda: k3.emt_matmul(x, w, sig, **kw), want)
    assert any(want in n for n in names), names
    assert not any("emt_experts_tc" in n for n in names), names
    assert _rel(y, k3.plain(x, w, sig, **kw)) <= 1e-5, p
    assert torch.equal(y, k3.emt_matmul(x, w, sig, **kw)), p
    ref = noise.fluctuate(w, rho, dev, noise.NoiseConfig(), seed=99,
                          plane=1234)
    rows = torch.randperm(K, generator=g, device=cuda)[:M]
    eye = torch.eye(K, device=cuda)
    assert torch.equal(k3.emt_matmul(eye[rows], w, sig, **kw), ref[rows]), p
    assert torch.equal(k3.emt_matmul(eye, w, sig, **kw), ref)


# (E, M, K, N, strided x) for K3's experts entry: moonshot-v1-16b-a3b's 64
# experts at its decode and chunk rows (M = 4 and 8 on the GEMV templates,
# 20 on the tensor-core kernel, 1 the smallest template), wg/wu's (D, F) =
# (2048, 1408) and wd's (1408, 2048); small ragged stacks with x a strided
# view (rows not 16-byte aligned).  The GEMV's ring at every row template
# (1-4, 8, 16), K not a multiple of its 16-row stage, N not a multiple of
# 128 or of 4 (weight rows 16-, 8- or 4-byte aligned: its 16-, 8- and
# 4-byte copies), slabs split or not.  The tensor-core kernel above 16
# rows at 17, 24, 40, 64, 65, 70, 128 and 130 rows: wgmma's N a multiple of
# 8 above M, one and two 64-row tiles a CTA and a third row tile in the
# grid; odd N (4-byte weight copies), strided x and K not a multiple of
# the 32-deep k-tile.
EXPERT_CASES = [(64, 4, 2048, 1408, False), (64, 8, 2048, 1408, False),
                (64, 20, 2048, 1408, False), (64, 4, 1408, 2048, False),
                (64, 8, 1408, 2048, False), (64, 20, 1408, 2048, False),
                (64, 1, 2048, 1408, False), (3, 5, 100, 130, True),
                (2, 70, 300, 66, True), (5, 16, 777, 514, True),
                (4, 2, 200, 131, False), (3, 3, 1000, 130, False),
                (2, 16, 1000, 260, True), (6, 8, 40, 4100, False),
                (1, 4, 333, 9, True), (3, 17, 300, 130, False),
                (4, 24, 1000, 260, False), (2, 40, 777, 514, True),
                (2, 64, 256, 130, False), (3, 65, 200, 131, False),
                (2, 128, 1000, 260, False), (2, 130, 333, 129, True)]


@pytest.mark.parametrize("E,M,K,N,strided", EXPERT_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k3_experts_matches_plain(cuda, E, M, K, N, strided, dev):
    """Within 1e-5 of the plain version (fluctuate of the folded (E * K, N)
    stack, then bmm); the statistics max exact and sum within rtol 1e-6;
    one launch a call; two calls bit-identical; rows of I give each
    expert's noisy rows bit for bit (expert e hashed at rows e * K + k);
    above 16 rows the experts' tensor-core kernel (emt_experts_tc) runs,
    not K3's (emt_matmul_tc)."""
    g = torch.Generator(device=cuda).manual_seed(E + M + K + N)
    if strided:
        x = torch.randn((E, M, K + 3), generator=g, device=cuda)[..., :K]
    else:
        x = torch.randn((E, M, K), generator=g, device=cuda)
    w = torch.randn((E, K, N), generator=g, device=cuda)
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = k3.plan(M, N, K, sms, True, experts=E)
    kw = dict(device=dev, seed=99, plane=1234)
    before = k3.emt_matmul_experts.launches
    y, s, m = k3.emt_matmul_experts(x, w, sig, **kw)
    assert k3.emt_matmul_experts.launches == before + 1
    yp, sp, mp = k3.plain_experts(x, w, sig, **kw)
    assert _rel(y, yp) <= 1e-5, p
    assert float(m) == float(mp), p
    assert abs(float(s) - float(sp)) <= 1e-6 * float(sp), (float(s),
                                                           float(sp), p)
    y2, s2, m2 = k3.emt_matmul_experts(x, w, sig, **kw)
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(m, m2)
    want = "emt_experts_tc" if M > k3.GEMV_MAX_M else "emt_matmul_gemv"
    names = launched(lambda: k3.emt_matmul_experts(x, w, sig, **kw), want)
    assert any(want in n for n in names), names
    assert not any("emt_matmul_tc" in n for n in names), names
    rows = torch.randint(0, K, (E, M), generator=g, device=cuda)
    eye = torch.eye(K, device=cuda)[rows]
    wn = noise.fluctuate(w.reshape(E * K, N), torch.tensor(3.5, device=cuda),
                         dev, noise.NoiseConfig(), seed=99,
                         plane=1234).reshape(E, K, N)
    want = torch.gather(wn, 1, rows[..., None].expand(E, M, N))
    assert torch.equal(k3.emt_matmul_experts(eye, w, sig, **kw)[0], want), p


@pytest.mark.parametrize("M,K,N", [(4, 96, 200), (1, 1000, 260),
                                   (16, 777, 514), (64, 256, 130),
                                   (17, 1000, 130)])
def test_k3_experts_row_base_zero_is_k3(cuda, M, K, N):
    """A stack of one expert (row base 0) is plain K3 on its weight, bit
    for bit, on the GEMV (M <= 16); above 16 rows, where the experts'
    tensor-core kernel and K3's (both four TF32 products on a three-piece
    weight) sum in different orders and split K differently, within 1e-5,
    and bit for bit on rows of I (both the noisy weight itself); the
    gradient through the stack of one expert (row base 0) runs the experts'
    K3-dx and K3-dw, one launch each, and equals K3-dx's and K3-dw's on
    its weight (the sum |w~|'s cotangent, 0 here, adds signed zeros)."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((1, M, K), generator=g, device=cuda)
    w = torch.randn((1, K, N), generator=g, device=cuda)
    dev = DeviceModel()
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    kw = dict(device=dev, seed=7, plane=77)
    y, _, _ = k3.emt_matmul_experts(x, w, sig, **kw)
    y1 = k3.emt_matmul(x[0], w[0], sig, **kw)
    if M <= k3.GEMV_MAX_M:
        assert torch.equal(y[0], y1)
    else:
        assert _rel(y[0], y1) <= 1e-5
        eye = torch.eye(K, device=cuda)[:M]
        ye = k3.emt_matmul_experts(eye[None], w, sig, **kw)[0]
        assert torch.equal(ye[0], k3.emt_matmul(eye, w[0], sig, **kw))
    xg = x.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    sg = sig.clone().requires_grad_(True)
    y, _, _ = k3.emt_matmul_experts(xg, wg, sg, **kw)
    c = torch.randn(y.shape, generator=g, device=cuda)
    counters = (k3.emt_matmul_experts_dx, k3.emt_matmul_experts_dw,
                k3.emt_matmul_dx, k3.emt_matmul_dw)
    before = [k.launches for k in counters]
    (y * c).sum().backward()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 0, 0]
    dx = k3.emt_matmul_dx(c[0], w[0], sig, **kw)
    dw, dsig = k3.emt_matmul_dw(x[0], c[0], w[0], sig, **kw)
    assert torch.equal(xg.grad[0], dx) and torch.equal(wg.grad[0], dw)
    assert torch.equal(sg.grad, dsig.reshape(sg.shape))
    assert torch.equal(k3.emt_matmul_experts_dx(c, w, sig, **kw)[0], dx)
    dwe, dse = k3.emt_matmul_experts_dw(x, c, w, sig, **kw)
    assert torch.equal(dwe[0], dw) and torch.equal(dse, dsig)


# (E, M, K, N, strided) for the experts' K3-dx and K3-dw: three or four
# experts at M = 5 and 20 (a moonshot decode and a jamba chunk's expert
# rows) and 17 and 130 (row tiles past 128); ragged K and N at the 128 x 128
# tile's and the 32-deep k-tile's edges, the CNN-like K = 27; `strided`:
# x column-major in each expert, g's experts interleaved (row stride E * N)
# and w with padded rows (row stride N + 3: 4-byte copies).
K3_EXPERTS_BWD_CASES = [(3, 5, 130, 200, False), (3, 20, 300, 1001, True),
                        (3, 20, 27, 64, False), (4, 17, 1000, 130, True),
                        (3, 130, 129, 257, False)]


def _experts_bwd_inputs(cuda, E, M, K, N, strided, integer=False):
    """x (E, M, K), g (E, M, N), w (E, K, N) n-major and gs from a seed;
    with `integer`, x, g and gs integers (x^T g + gs exact in float32 and
    in 3xTF32 alike)."""
    g_ = torch.Generator(device=cuda).manual_seed(E + M + K + N)

    def draw(*shape):
        if integer:
            return torch.randint(-4, 5, shape, generator=g_,
                                 device=cuda).float()
        return torch.randn(shape, generator=g_, device=cuda)
    if strided:
        x = draw(E, K, M).transpose(1, 2)
        g = draw(M, E, N).transpose(0, 1)
        w = torch.randn((E, K, N + 3), generator=g_, device=cuda)[..., :N]
    else:
        x, g = draw(E, M, K), draw(E, M, N)
        w = torch.randn((E, K, N), generator=g_, device=cuda)
    # exact zeros in w: sgn(w~) is +1 there
    w[:, :2, :5] = 0.0
    gs = torch.tensor(3.0 if integer else 0.37, device=cuda)
    return x, g, w, gs


@pytest.mark.parametrize("E,M,K,N,strided", K3_EXPERTS_BWD_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k3_experts_backward_matches_plain(cuda, E, M, K, N, strided, dev):
    """The experts' K3-dx and K3-dw (one launch each, expert e hashed at
    rows e * K + k) within 1e-5 of their plain versions in float64 (dx, dw
    with the sum |w~| term gs * sgn(w~), dsigma); on integer x, g and gs dw
    bit for bit against the float32 plain pass; two calls bit-identical;
    and autograd through emt_matmul_experts gives them."""
    x, g, w, gs = _experts_bwd_inputs(cuda, E, M, K, N, strided)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = (f"dx {k3.plan_dx(M, K, N, sms, experts=E)}, "
             f"dw {k3.plan_dw(M, K, N, sms, experts=E)}")
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    kw = dict(device=dev, seed=99, plane=1234)
    before = (k3.emt_matmul_experts_dx.launches,
              k3.emt_matmul_experts_dw.launches)
    dx = k3.emt_matmul_experts_dx(g, w, sig, **kw)
    dw, dsig = k3.emt_matmul_experts_dw(x, g, w, sig, gs, **kw)
    assert (k3.emt_matmul_experts_dx.launches,
            k3.emt_matmul_experts_dw.launches) == (before[0] + 1,
                                                   before[1] + 1)
    dx64 = k3.plain_experts_dx(g.double(), w, sig, **kw)
    dw64, dsig64 = k3.plain_experts_dw(x.double(), g.double(), w, sig, gs,
                                       **kw)
    assert _rel(dx.double(), dx64) <= 1e-5, plans
    assert _rel(dw.double(), dw64) <= 1e-5, plans
    terms = (dw64.abs() * w.double().abs()).sum().item()
    assert abs(dsig.item() - dsig64.item()) <= 1e-5 * terms, plans
    assert torch.equal(dx, k3.emt_matmul_experts_dx(g, w, sig, **kw))
    dw2, dsig2 = k3.emt_matmul_experts_dw(x, g, w, sig, gs, **kw)
    assert torch.equal(dw, dw2) and torch.equal(dsig, dsig2)
    xi, gi, _, gsi = _experts_bwd_inputs(cuda, E, M, K, N, strided, True)
    dwi, _ = k3.emt_matmul_experts_dw(xi, gi, w, sig, gsi, **kw)
    pdwi, _ = k3.plain_experts_dw(xi, gi, w, sig, gsi, **kw)
    assert torch.equal(dwi, pdwi), plans
    # autograd: the product's cotangent g and the sum's 0.37
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    sr = sig.clone().requires_grad_(True)
    y, s, m = k3.emt_matmul_experts(xr, wr, sr, **kw)
    assert not m.requires_grad
    ((y * g).sum() + gs * s).backward()
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw)
    assert torch.equal(sr.grad, dsig.reshape(sr.shape))


def test_k3_experts_one_expert_at_64_rows_is_k3_tc(cuda):
    """A stack of one expert at M = 64 (one full row tile of the experts'
    tensor-core kernel, its weight through a tensor map: N a multiple of
    4) against K3's tensor-core forward (emt_matmul_tc) on the same
    weight: the same four TF32 products on the same three-piece weight and
    two-piece x, summed in another order, within 1e-6."""
    M, K, N = 64, 1000, 512
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((1, M, K), generator=g, device=cuda)
    w = torch.randn((1, K, N), generator=g, device=cuda)
    dev = DeviceModel()
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    kw = dict(device=dev, seed=7, plane=77)
    names = launched(lambda: k3.emt_matmul_experts(x, w, sig, **kw),
                     "emt_experts_tc")
    assert any("emt_experts_tc" in n for n in names), names
    before = k3._forward_tc.launches
    y1 = k3.emt_matmul(x[0], w[0], sig, **kw)
    assert k3._forward_tc.launches == before + 1
    y, _, _ = k3.emt_matmul_experts(x, w, sig, **kw)
    assert _rel(y[0], y1) <= 1e-6


# (M, K, N, transposed) for K3's backward: the 3xTF32 template in both
# weight layouts (the tied unembed's transpose); ragged M, K and N, below,
# at and past the 128 x 128 tile's edges and the 32-deep k-tile's, rows not
# 16-byte aligned (the 4-byte loads); the CNN's K = 27 as dx's width and
# dw's row count; a reduction of one row, of 10, and of N = 64 (8
# k-steps); dx split along N (few output tiles over a long N) and dw along
# M (few output tiles over a long M): K3_BWD_SPLIT names which.
K3_BWD_CASES = [(64, 96, 200, False), (100, 27, 64, False),
                (33, 130, 1001, True), (17, 40, 3000, False),
                (8, 300, 4100, True), (1, 64, 96, False), (70, 256, 10, False),
                (129, 129, 257, False), (255, 127, 384, True),
                (128, 256, 128, False), (130, 200, 5000, True),
                (4096, 27, 64, False), (3000, 130, 200, True),
                (2049, 576, 64, False)]
# case: (dx splits > 1, dw splits > 1) at the H100's 132 SMs (most other
# cases split too; (70, 256, 10) leaves dx unsplit)
K3_BWD_SPLIT = {(17, 40, 3000, False): (True, False),
                (130, 200, 5000, True): (True, False),
                (4096, 27, 64, False): (False, True),
                (3000, 130, 200, True): (True, True),
                (2049, 576, 64, False): (False, True)}


def _k3_bwd_inputs(cuda, M, K, N, transposed, integer=False):
    """x (M, K), g (M, N) and w (K, N) (w the transpose of an (N, K)
    tensor if `transposed`) from a seed; with `integer`, x and g integers
    in [-4, 4], so that x^T g is exact in float32 and in 3xTF32 alike."""
    g_ = torch.Generator(device=cuda).manual_seed(M + K + N)
    if integer:
        x = torch.randint(-4, 5, (M, K), generator=g_, device=cuda).float()
        g = torch.randint(-4, 5, (M, N), generator=g_, device=cuda).float()
    else:
        x = torch.randn((M, K), generator=g_, device=cuda)
        g = torch.randn((M, N), generator=g_, device=cuda)
    w = torch.randn((N, K) if transposed else (K, N), generator=g_,
                    device=cuda)
    return x, g, w.T if transposed else w


@pytest.mark.parametrize("M,K,N,transposed", K3_BWD_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k3_backward_matches_plain(cuda, M, K, N, transposed, dev):
    """K3-dx and K3-dw within 1e-5 of their plain versions in float64 (dx,
    dw, dsigma); on integer x and g in [-4, 4] (x^T g exact in either
    precision and any order) dw bit for bit against the float32 plain
    pass; two calls bit-identical; one launch each; the split counts
    K3_BWD_SPLIT names; and autograd through emt_matmul gives them."""
    x, g, w = _k3_bwd_inputs(cuda, M, K, N, transposed)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pdx, pdw = k3.plan_dx(M, K, N, sms), k3.plan_dw(M, K, N, sms)
    plans = f"dx {pdx}, dw {pdw}"
    if sms == 132 and (M, K, N, transposed) in K3_BWD_SPLIT:
        assert K3_BWD_SPLIT[M, K, N, transposed] == (
            pdx.splits > 1, pdw.splits > 1), plans
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    kw = dict(device=dev, seed=99, plane=1234)
    before = (k3.emt_matmul_dx.launches, k3.emt_matmul_dw.launches)
    dx = k3.emt_matmul_dx(g, w, sig, **kw)
    dw, dsig = k3.emt_matmul_dw(x, g, w, sig, **kw)
    assert (k3.emt_matmul_dx.launches, k3.emt_matmul_dw.launches) == (
        before[0] + 1, before[1] + 1)
    dx64 = k3.plain_dx(g.double(), w, sig, **kw)
    dw64, dsig64 = k3.plain_dw(x.double(), g.double(), w, sig, **kw)
    assert _rel(dx.double(), dx64) <= 1e-5, plans
    assert _rel(dw.double(), dw64) <= 1e-5, plans
    assert abs(dsig.item() - dsig64.item()) <= (
        1e-5 * dw64.abs().sum().item()), plans
    assert torch.equal(dx, k3.emt_matmul_dx(g, w, sig, **kw))
    dw2, dsig2 = k3.emt_matmul_dw(x, g, w, sig, **kw)
    assert torch.equal(dw, dw2) and torch.equal(dsig, dsig2)
    xi, gi, _ = _k3_bwd_inputs(cuda, M, K, N, transposed, integer=True)
    dwi, _ = k3.emt_matmul_dw(xi, gi, w, sig, **kw)
    pdwi, _ = k3.plain_dw(xi, gi, w, sig, **kw)
    assert torch.equal(dwi, pdwi), plans
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    sr = sig.clone().requires_grad_(True)
    (k3.emt_matmul(xr, wr, sr, **kw) * g).sum().backward()
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw)
    assert torch.equal(sr.grad, dsig.reshape(sr.shape))


def test_train_step_on_card_launches_k3_and_its_backward(cuda):
    """One train step of the 2-layer gemma3 smoke stack (analog) on the
    card: one K3, K3-dx and K3-dw launch per projection (14 + the unembed),
    and the loss and every gradient leaf within 1e-4 of the plain path on
    the card at a 24-bit DAC (no level sits at a rounding tie there)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.placement import map_corners
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops as kops
    from repro_torch.train.step import init_state, make_grad_fn
    from repro_torch.train.optimizer import Optimizer, OptimizerConfig
    cfg = get_config("gemma3-1b", smoke=True).replace(num_layers=2)
    cfg = cfg.replace(emt=map_corners(cfg.emt, lambda e: e.replace(
        quant=dataclasses.replace(e.quant, a_bits=24))))
    state = init_state(cfg, Optimizer(OptimizerConfig()), 0, device=cuda)
    batch = SyntheticLM(cfg.vocab_size, 16, 2, device=cuda).batch_at(0)
    grad_fn = make_grad_fn(cfg, 1e-6)
    counters = (k3.emt_matmul, k3.emt_matmul_dx, k3.emt_matmul_dw)
    before = [c.launches for c in counters]
    loss, _, grads = grad_fn(state["params"], batch, 0)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [15] * 3
    orig = kops._emt_matmul
    kops._emt_matmul = k3.plain_differentiable
    try:
        ploss, _, pgrads = grad_fn(state["params"], batch, 0)
    finally:
        kops._emt_matmul = orig
    assert abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item())
    from repro_torch.utils.pytrees import flatten_with_paths
    for (path, a), (_, b) in zip(flatten_with_paths(grads),
                                 flatten_with_paths(pgrads)):
        assert torch.isfinite(a).all(), path
        assert _rel(a, b) <= 1e-4, path


@pytest.mark.parametrize("arch,placement", [
    ("moonshot-v1-16b-a3b", "mixed"), ("xlstm-350m", None),
    ("jamba-v0.1-52b", "mixed")])
def test_moe_and_recurrent_train_step_on_card(cuda, arch, placement):
    """One gradient step of the MoE and recurrent smoke stacks (2 layers;
    jamba's mamba + MLP, then mamba + MoE) on the card at a 24-bit DAC
    (the bit-serial MLPs' read noise off): the
    experts' K3-dx and K3-dw once per expert projection, K3-dx and K3-dw
    beside K3 on the other crossbars; the loss and every gradient leaf
    finite and within 1e-4 of the plain path on the card (K3, its experts
    entry and K5 through their plain versions with the same VJPs)."""
    import dataclasses

    from repro_torch.core.placement import LayerRule, map_corners
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.serve.spec import build_config
    from repro_torch.train.optimizer import Optimizer, OptimizerConfig
    from repro_torch.train.step import init_state, make_grad_fn
    from repro_torch.utils.pytrees import flatten_with_paths
    cfg = build_config(arch, smoke=True, placement=placement,
                       model_overrides={"num_layers": 2})
    cfg = cfg.replace(dtype=torch.float32, emt=map_corners(
        cfg.emt, lambda e: e.replace(quant=dataclasses.replace(
            e.quant, a_bits=24))))
    if placement:
        # the bit-serial MLPs read without noise: a bit-serial read is not
        # continuous in its level (jamba's layer-0 MLP gradients moved by
        # 1.2e-4 with it on); the experts on that corner read in analog
        # and keep theirs
        cfg = cfg.replace(emt=dataclasses.replace(cfg.emt, rules=tuple(
            LayerRule(r.pattern, r.emt.replace(device=dataclasses.replace(
                r.emt.device, amplitude=0.0)))
            if r.pattern == "*/mlp/*" else r for r in cfg.emt.rules)))
    state = init_state(cfg, Optimizer(OptimizerConfig()), 0, device=cuda)
    batch = SyntheticLM(cfg.vocab_size, 12, 2, device=cuda).batch_at(0)
    grad_fn = make_grad_fn(cfg, 1e-6)
    counters = (k3.emt_matmul_experts, k3.emt_matmul_experts_dx,
                k3.emt_matmul_experts_dw, k3.emt_matmul_dx, k3.emt_matmul_dw)
    before = [c.launches for c in counters]
    loss, _, grads = grad_fn(state["params"], batch, 0)
    torch.cuda.synchronize()
    got = [c.launches - b for c, b in zip(counters, before)]
    assert got[0] == got[1] == got[2], got
    assert (got[0] > 0) == bool(cfg.num_experts), got
    assert got[3] > 0 and got[4] > 0, got
    names = ("_emt_matmul", "_emt_matmul_experts", "_emt_bitserial")
    orig = {n: getattr(ops, n) for n in names}
    ops._emt_matmul = k3.plain_differentiable
    ops._emt_matmul_experts = k3.plain_experts_differentiable
    ops._emt_bitserial = k5.plain_differentiable
    try:
        ploss, _, pgrads = grad_fn(state["params"], batch, 0)
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)
    assert abs(loss.item() - ploss.item()) <= 1e-4 * abs(ploss.item())
    for (path, a), (_, b) in zip(flatten_with_paths(grads),
                                 flatten_with_paths(pgrads)):
        assert torch.isfinite(a).all(), path
        assert _rel(a, b) <= 1e-4, path


# (M, K, N, transposed): every GEMV row template (1-4, 8, 16) and the
# tensor-core kernel (M > 16: 17 and 64 in one 64-row tile, 65, 130 and 300
# in two to five; the CNN's first stage at K = 27 (2,048 of its 32,768
# rows) and its head, 32 x 256 @ 256 x 10); both weight layouts; ragged N
# (N = 10 and 64: one 128-column CTA, its second warpgroup past N); K not
# a multiple of the 32-row k-tile, split into slabs (1024 with N = 130,
# 1000, 777, 1500 and 256 on the tensor cores, 4100 on the GEMV path).
K5_CASES = [(4, 96, 200, False), (64, 1024, 130, False), (3, 64, 300, True),
            (1, 1000, 260, False), (2, 555, 1001, False),
            (4, 1000, 262, True), (8, 4100, 130, False), (8, 700, 96, True),
            (16, 777, 514, False), (16, 300, 200, True),
            (17, 1000, 130, False), (64, 1000, 300, True),
            (65, 1000, 130, False), (130, 777, 200, True),
            (300, 1500, 260, False), (2048, 27, 64, False),
            (32, 256, 10, False)]


@pytest.mark.parametrize("M,K,N,transposed", K5_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k5_matches_plain_and_planes_bit_exact(cuda, M, K, N, transposed,
                                               dev):
    """Within 1e-5 of the plain version; two calls bit-identical (the split
    sum is ordered).  The levels hold an all-zero row (exact zeros out), a
    row whose high planes are zero and a band of K zero in every row.
    Levels 2^p on rows of the identity (the path M
    selects) and on the identity itself (the tiled path) return 2^p times
    plane p's noisy weight, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    xq = torch.round(torch.randn((M, K), generator=g, device=cuda) * 40)
    xq = xq.clamp(-127, 127)
    xq[:, K // 3:K // 2] = 0.0
    if M > 1:
        xq[0] = 0.0
        xq[1] = xq[1].clamp(-15, 15)
    w = torch.randn((N, K) if transposed else (K, N), generator=g,
                    device=cuda)
    w = w.T if transposed else w
    rho = torch.tensor(3.5, device=cuda)
    sig = dev.sigma_rel(rho)
    p = k5.plan(M, N, K, torch.cuda.get_device_properties(cuda)
                .multi_processor_count, not transposed)
    kw = dict(device=dev, bits=7, seed=99, base_plane=1234)
    before = k5.emt_bitserial.launches
    y = k5.emt_bitserial(xq, w, sig, **kw)
    assert k5.emt_bitserial.launches == before + 1
    assert _rel(y, k5.plain(xq, w, sig, **kw)) <= 1e-5, p
    assert torch.equal(y, k5.emt_bitserial(xq, w, sig, **kw)), p
    if M > 1:
        assert (y[0] == 0).all()
    eye = torch.eye(K, device=cuda)
    rows = torch.randperm(K, generator=g, device=cuda)[:M]
    for pl in range(7):
        ref = noise.fluctuate(w, rho, dev, noise.NoiseConfig(), seed=99,
                              plane=1234 + pl) * 2.0 ** pl
        wn = k5.emt_bitserial(eye[rows] * 2.0 ** pl, w, sig, **kw)
        assert torch.equal(wn, ref[rows]), (pl, p)
        assert torch.equal(k5.emt_bitserial(eye * 2.0 ** pl, w, sig, **kw),
                           ref), pl


@pytest.mark.parametrize("M", [64, 200])
@pytest.mark.parametrize("case", ["strided", "k_major_levels", "planes23"])
def test_k5_tensor_cores_strided_levels_and_23_planes(cuda, case, M):
    """The tensor-core kernel (M = 64, one 64-row tile, and 200, two CTAs
    of two row tiles; K = 1000, not a multiple of its 32-row k-tile,
    split) on levels that are a strided view (every second
    column of a wider tensor, or the transpose of a (K, M) tensor: no
    16-byte loads) and on 23 planes (the smoke's 24-bit DAC: levels up to
    2^23 - 1, so one k-tile mixes terms of 2^22 and 2^0): within 1e-5 of
    the plain version, two calls bit-identical, and 2^p x I bit-exact
    with plane p's noisy weight."""
    K, N = 1000, 300
    dev = DeviceModel()
    bits = 23 if case == "planes23" else 7
    g = torch.Generator(device=cuda).manual_seed(7)
    top = 2.0 ** bits - 1
    scale = 2.0 ** (bits - 2)
    if case == "strided":
        wide = torch.randn((M, 2 * K), generator=g, device=cuda) * scale
        xq = torch.round(wide).clamp(-top, top)[:, ::2]
    elif case == "k_major_levels":
        tall = torch.randn((K, M), generator=g, device=cuda) * scale
        xq = torch.round(tall).clamp(-top, top).T
    else:
        xq = torch.round(torch.randn((M, K), generator=g, device=cuda)
                         * scale).clamp(-top, top)
    w = torch.randn((K, N), generator=g, device=cuda)
    rho = torch.tensor(3.5, device=cuda)
    sig = dev.sigma_rel(rho)
    p = k5.plan(M, N, K, torch.cuda.get_device_properties(cuda)
                .multi_processor_count, True, bits)
    assert p.splits > 1
    kw = dict(device=dev, bits=bits, seed=5, base_plane=77)
    y = k5.emt_bitserial(xq, w, sig, **kw)
    assert _rel(y, k5.plain(xq, w, sig, **kw)) <= 1e-5, (case, p)
    assert torch.equal(y, k5.emt_bitserial(xq, w, sig, **kw)), case
    eye = torch.eye(K, device=cuda)
    for pl in sorted({0, bits // 2, bits - 1}):
        ref = noise.fluctuate(w, rho, dev, noise.NoiseConfig(), seed=5,
                              plane=77 + pl) * 2.0 ** pl
        assert torch.equal(k5.emt_bitserial(eye * 2.0 ** pl, w, sig, **kw),
                           ref), (case, pl)


def _bits_equal(a, b):
    """The same float32 bits (NaN payloads included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k1_matches_plain_and_pools_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, KV, G, hd, bs, T = 3, 2, 4, 64, 8, 5
    nb = B * T + 1
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    kp[nb] = vp[nb] = 0.0
    table = torch.randperm(nb, generator=g, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    wpos = torch.tensor([3, 17, 30], device=cuda)
    mask = torch.where(torch.arange(T * bs - 3, device=cuda)[None, :]
                       <= wpos[:, None], 0.0, NEG_INF)
    mask[1] = NEG_INF
    active = torch.tensor([True, False, True], device=cuda)
    kn = torch.randn((B, KV, hd), generator=g, device=cuda)
    vn = torch.randn((B, KV, hd), generator=g, device=cuda)
    # the plain version in float64 (float32 on the CPU of the machine that
    # holds the H100 is not reproducible across processes: PERF.md, ROADMAP
    # Queue 3); its pools, written in float64, hold the same values
    kpc, vpc = kp.cpu().double(), vp.cpu().double()
    out, _, _ = ops.paged_attention_decode(q, kp, vp, table, mask, kn, vn,
                                           wpos, active, softcap=30.0)
    ref, _, _ = ops.paged_attention_decode(
        q.cpu().double(), kpc, vpc, table.cpu(), mask.cpu().double(),
        kn.cpu().double(), vn.cpu().double(), wpos.cpu(), active.cpu(),
        softcap=30.0)
    torch.cuda.synchronize()
    assert _rel(out.cpu().double(), ref) <= 1e-5
    assert (out[1] == 0).all()
    assert torch.equal(kp.cpu().double(), kpc)
    assert torch.equal(vp.cpu().double(), vpc)


@pytest.mark.parametrize("KV,G,hd", [(16, 1, 64), (1, 4, 256)])
def test_k4_matches_plain_and_only_reads(cuda, KV, G, hd):
    """Rows of encoder length 0 (exact zeros), 1, a partial last block and
    the whole view; the mask is shorter than the view (the wrapper pads
    it).  The plain version runs in float64."""
    g = torch.Generator(device=cuda).manual_seed(KV + G)
    B, bs, T = 4, 16, 3
    nb = B * T + 1
    L = T * bs - 5
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    kp[nb] = vp[nb] = 0.0
    table = torch.randperm(nb, generator=g, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    table[1, 1:] = nb
    lens = torch.tensor([0, 1, 21, L], device=cuda)
    mask = torch.where(torch.arange(L, device=cuda)[None, :] < lens[:, None],
                       0.0, NEG_INF)
    kp0, vp0 = kp.clone(), vp.clone()
    before = k4.paged_attention.launches
    out = ops.paged_attention(q, kp, vp, table, mask)
    assert k4.paged_attention.launches == before + 1
    ref = ops.paged_attention(q.cpu().double(), kp.cpu().double(),
                              vp.cpu().double(), table.cpu(),
                              mask.cpu().double())
    torch.cuda.synchronize()
    assert _rel(out.cpu().double(), ref) <= 1e-5
    assert (out[0] == 0).all()
    assert torch.equal(kp, kp0) and torch.equal(vp, vp0)


# (KV, G, hd, softcap, bs): gemma3-1b's decode attention and seamless-m4t-
# medium's self and cross attention (block 16, batch 4), then a head size
# that rules out 16-byte copies with an odd block, and 8 query heads with
# blocks walked in two chunks; then the query groups of llama3-405b (16 x
# 128, 8 outputs a thread), llama4-scout (5, no power of two),
# deepseek-67b and qwen2-vl-72b (8 x 128) and gemma2-9b (2 x 256) over 8
# kv heads, softcap 50; T from 1 to 128 blocks gives every cluster size
# the planner picks (1, 2, 4, 8).
ATTN_SHAPES = [(1, 4, 256, 0.0, 16), (16, 1, 64, 30.0, 16),
               (2, 3, 98, 0.0, 5), (1, 8, 256, 20.0, 32),
               (8, 16, 128, 50.0, 16), (8, 5, 128, 50.0, 16),
               (8, 8, 128, 50.0, 16), (8, 2, 256, 50.0, 16)]


@pytest.mark.parametrize("KV,G,hd,softcap,bs", ATTN_SHAPES)
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16, 128])
@pytest.mark.parametrize("write", [True, False], ids=["k1", "k4"])
def test_k1_k4_cluster_walk(cuda, KV, G, hd, softcap, bs, T, write):
    """The walk split over a cluster, against the float64 plain version at
    1e-5.  Row 0 sees every position up to a write in its last block; row 1
    the same with its second block fully masked between visible ones (for
    T >= 2 one of the two writes lands in a block that a rank other than 0
    walks); row 2 nothing (exact zeros, its write still
    lands); row 3 one block and a bit, with no write.  Blocks that only
    masked positions cover hold NaN: the kernel neither loads nor computes
    them, so it returns the same bits as on clean pools.  K1's pools end
    bit-identical to the plain write's; K4's are untouched.  Two calls give
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(T + KV + G + write)
    B = 4
    L = T * bs
    nb = B * T + 1
    S = k1.kv_splits(B, KV, G, hd, T, torch.cuda.get_device_properties(cuda)
                     .multi_processor_count)
    q = torch.randn((B, KV, G, hd), generator=gen, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=gen, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=gen, device=cuda)
    kp[nb] = vp[nb] = 0.0
    table = torch.randperm(nb, generator=gen, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    wpos = torch.tensor([L - 3, L - 1, min(L - 1, 5), min(L - 1, bs + 2)],
                        device=cuda)
    pos = torch.arange(L, device=cuda)[None, :]
    mask = torch.where(pos <= wpos[:, None], 0.0, NEG_INF)
    if T >= 3:
        mask[1, bs:2 * bs] = NEG_INF
    mask[2] = NEG_INF
    kn = torch.randn((B, KV, hd), generator=gen, device=cuda)
    vn = torch.randn((B, KV, hd), generator=gen, device=cuda)
    active = torch.tensor([True, True, True, False], device=cuda)
    # NaN in every block no row sees (the plain version gets zeros there)
    kpz, vpz = kp.clone(), vp.clone()
    seen = (mask.reshape(B, T, bs) > NEG_INF / 2).any(-1)
    for b in range(B):
        for t in range(T):
            if not seen[b, t]:
                blk = int(table[b, t])
                kp[blk] = vp[blk] = float("nan")
                kpz[blk] = vpz[blk] = 0.0
    kpn, vpn = kp.clone(), vp.clone()
    args64 = (q.cpu().double(), kpz.cpu().double(), vpz.cpu().double(),
              table.cpu(), mask.cpu().double())
    if write:
        outs = [ops.paged_attention_decode(q, kp, vp, table, mask, kn, vn,
                                           wpos, active,
                                           softcap=softcap)[0]
                for _ in range(2)]
        clean = ops.paged_attention_decode(q, kpz, vpz, table, mask, kn, vn,
                                           wpos, active, softcap=softcap)[0]
        ref = ops.paged_attention_decode(
            *args64, kn.cpu().double(), vn.cpu().double(), wpos.cpu(),
            active.cpu(), softcap=softcap)[0]
        plain_k, plain_v = kpn.cpu(), vpn.cpu()
        ops.paged_attention_decode(q.cpu(), plain_k, plain_v, table.cpu(),
                                   mask.cpu(), kn.cpu(), vn.cpu(),
                                   wpos.cpu(), active.cpu(), softcap=softcap)
        assert _bits_equal(kp.cpu(), plain_k) and _bits_equal(vp.cpu(),
                                                              plain_v)
    else:
        outs = [ops.paged_attention(q, kp, vp, table, mask, softcap=softcap)
                for _ in range(2)]
        clean = ops.paged_attention(q, kpz, vpz, table, mask,
                                    softcap=softcap)
        ref = ops.paged_attention(*args64, softcap=softcap)
        assert _bits_equal(kp, kpn) and _bits_equal(vp, vpn)
    torch.cuda.synchronize()
    assert _rel(outs[0].cpu().double(), ref) <= 1e-5, S
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], clean), S
    assert (outs[0][2] == 0).all(), S


def test_k1_k4_cluster_sizes(cuda):
    """The cases above run every cluster size the planner picks."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sizes = {k1.kv_splits(4, KV, G, hd, T, sms)
             for KV, G, hd, *_ in ATTN_SHAPES[:2]
             for T in (1, 2, 3, 4, 8, 16, 128)}
    assert sizes == {1, 2, 4, 8}


@pytest.mark.parametrize("bs,G,C,hd,softcap,alias",
                         [(16, 4, 16, 256, 0.0, False),
                          (4, 3, 5, 256, 0.0, False),
                          (16, 4, 16, 64, 30.0, False),
                          (8, 2, 7, 64, 0.0, False),
                          (5, 1, 9, 98, 20.0, False),
                          (16, 2, 3, 256, 0.0, False),
                          (32, 1, 2, 256, 0.0, False),
                          (16, 4, 16, 256, 0.0, True),
                          (4, 3, 5, 64, 0.0, True),
                          (16, 16, 16, 128, 50.0, False),
                          (16, 5, 16, 128, 50.0, False)])
def test_k2_matches_plain(cuda, bs, G, C, hd, softcap, alias):
    """Rows from position 0, one token at a block's last position, a chunk
    ending at the view's end, and a padded row (qpos -1: exact zeros).  The
    blocks past each row's qlast that no row sees hold NaN: the kernel must
    neither load nor compute them (the plain version gets zeros there;
    masked, they add exact zeros).  With `alias` the table draws blocks
    with repeats, so rows (and a row's own positions) share physical
    blocks.  The cases split each row tile's walk over 1, 2, 4 and 8 CTAs;
    two calls are bit-identical (the merge runs in rank order)."""
    g = torch.Generator(device=cuda).manual_seed(bs + G + C + hd + alias)
    B, KV, T = 4, 2, 6
    nb = B * T + 1
    q = torch.randn((B, C, KV * G, hd), generator=g, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    if alias:
        table = torch.randint(0, nb, (B, T), generator=g, device=cuda)
    else:
        table = torch.randperm(nb, generator=g, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    start = torch.tensor([0, bs - 1, T * bs - C, 0], device=cuda)
    ntok = torch.tensor([C, 1, C, C], device=cuda)
    j = torch.arange(C, device=cuda)[None, :]
    qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
    qpos[3] = -1
    qlast = qpos.amax(1)
    seen = {int(table[b, t]) for b in range(B) for t in range(T)
            if t * bs <= qlast[b]}
    kpz, vpz = kp.clone(), vp.clone()
    for b in range(B):
        for t in range(T):
            blk = int(table[b, t])
            if t * bs > qlast[b] and blk not in seen:
                kp[blk] = vp[blk] = float("nan")
                kpz[blk] = vpz[blk] = 0.0
    before = k2.paged_prefill.launches
    y = ops.paged_prefill(q, kp, vp, table, qpos, softcap=softcap)
    assert k2.paged_prefill.launches == before + 1
    # the plain version in float64: in float32 on the CPU of the machine
    # that holds the H100, two calls of it differ in some processes by more
    # than the 1e-5 checked here (PERF.md, open questions)
    ref = ops.paged_prefill(q.cpu().double(), kpz.cpu().double(),
                            vpz.cpu().double(), table.cpu(), qpos.cpu(),
                            softcap=softcap)
    assert _rel(y.cpu().double(), ref) <= 1e-5
    assert (y[3] == 0).all()
    assert torch.equal(y, ops.paged_prefill(q, kp, vp, table, qpos,
                                            softcap=softcap))


def test_engine_on_card_launches_every_kernel(cuda):
    _serve_on_card(None)


def test_mixed_engine_on_card_launches_every_kernel(cuda):
    """The mixed placement adds the bit-serial kernel (MLPs on RRAM)."""
    _serve_on_card("mixed")


def test_moe_engine_on_card_launches_every_kernel(cuda):
    """moonshot-v1-16b-a3b smoke on the mixed placement: K1, K2, K3 (the
    attention, the routers on SRAM, the unembed) and K3's experts entry
    (three launches a MoE layer); no K5 (the experts read in analog)."""
    k5_before = k5.emt_bitserial.launches
    _serve_on_card("mixed", "moonshot-v1-16b-a3b")
    assert k5.emt_bitserial.launches == k5_before


def test_seamless_engine_on_card_launches_its_kernels(cuda):
    """The enc-dec path: K1 (decoder self-attention), K4 (cross attention)
    and K3; no chunked prefill, so no K2."""
    k2_before = k2.paged_prefill.launches
    _serve_on_card(None, "seamless-m4t-medium")
    assert k2.paged_prefill.launches == k2_before


def _serve_on_card(placement, arch="gemma3-1b"):
    from repro_torch.models import lm
    from repro_torch.serve.engine import GenRequest, ServingEngine
    from repro_torch.serve.spec import build_config
    cfg = build_config(arch, smoke=True, all_global=True, a_per_row=True,
                       placement=placement,
                       model_overrides={"num_layers": 2})
    params = lm.init_model_params(cfg, 0)
    eng = ServingEngine(cfg, params, batch_size=2, max_len=32, paged=True,
                        block_size=8, prefill_chunk=8, fresh_noise=False)
    counters = (k1.paged_attention_decode, k3.emt_matmul)
    counters += ((k4.paged_attention,) if cfg.is_encdec
                 else (k2.paged_prefill,))
    if cfg.num_experts:
        counters += (k3.emt_matmul_experts,)
    elif placement == "mixed":
        counters += (k5.emt_bitserial,)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(0)
    res = eng.serve([GenRequest(prompt=rng.integers(0, 512, n)
                                .astype(np.int32), max_new=4)
                     for n in (5, 12, 9)], stagger=1)
    assert [len(r.tokens) for r in res] == [4, 4, 4]
    assert all(c.launches > b for c, b in zip(counters, before))
    assert eng.energy_conserved(res)


# -- the recurrent stacks (xlstm-350m, jamba-v0.1-52b) ------------------------
# (M, K, N) of K3 at the recurrent stacks' projections, at a decode step
# (M = 4, the GEMV) and an admission (the tensor-core kernel): the mLSTM
# gates' one output a head (N = 4, far below every tile width), mamba's
# x_proj (8,192 -> dt_rank 256 + 2 x 16) and dt_proj (K = 256), the sLSTM
# up projection (1,024 -> 2 x 1,408), the mLSTM up projection
RECURRENT_K3 = [(4, 2048, 4), (64, 2048, 4), (4, 8192, 288),
                (128, 8192, 288), (4, 256, 8192), (128, 256, 8192),
                (4, 1024, 2816), (64, 1024, 2816), (32, 1024, 4096)]


@pytest.mark.parametrize("M,K,N", RECURRENT_K3)
def test_k3_at_the_recurrent_shapes_on_card(cuda, M, K, N):
    """Within 1e-5 of the plain version, one launch, two calls bit-identical
    and rows of I the noisy weight's rows bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda)
    w = torch.randn((K, N), generator=g, device=cuda)
    dev, rho = DeviceModel(), torch.tensor(3.5, device=cuda)
    sig = dev.sigma_rel(rho)
    kw = dict(device=dev, seed=99, plane=1234)
    before = k3.emt_matmul.launches
    y = k3.emt_matmul(x, w, sig, **kw)
    assert k3.emt_matmul.launches == before + 1
    assert _rel(y, k3.plain(x, w, sig, **kw)) <= 1e-5
    assert torch.equal(y, k3.emt_matmul(x, w, sig, **kw))
    ref = noise.fluctuate(w, rho, dev, noise.NoiseConfig(), seed=99,
                          plane=1234)
    rows = torch.randperm(K, generator=g, device=cuda)[:M]
    eye = torch.eye(K, device=cuda)[rows]
    assert torch.equal(k3.emt_matmul(eye, w, sig, **kw), ref[rows])


@pytest.mark.parametrize("M", [4, 128])
def test_dt_proj_with_bias_on_card(cuda, M):
    """mamba's dt_proj (K = 256 -> 8,192, with a bias) through emt_dense on
    the card (K3, then the bias) against the same layer on K3's plain
    version, and its energy equal."""
    from repro_torch.configs.common import emt_preset
    from repro_torch.core.emt_linear import dense_specs, emt_dense
    from repro_torch.nn.param import init_params
    emt = emt_preset("analog")
    params = init_params(dense_specs(256, 8192, emt, bias=True), 3, cuda)
    params["b"] = torch.randn(8192, device=cuda)
    x = torch.randn((2, M // 2, 256), device=cuda)
    tag = "dec/layer_000/mamba/dt"
    y, a = emt_dense(params, x, emt, tag=tag, seed=5)
    orig = ops._emt_matmul
    ops._emt_matmul = k3.plain
    try:
        yp, ap = emt_dense(params, x, emt, tag=tag, seed=5)
    finally:
        ops._emt_matmul = orig
    assert y.shape == (2, M // 2, 8192)
    assert _rel(y, yp) <= 1e-5
    assert float(a["energy_pj"]) == float(ap["energy_pj"])


@pytest.mark.parametrize("M,K,N", [(20, 4096, 14336), (20, 14336, 4096),
                                   (4, 4096, 14336), (4, 14336, 4096)])
def test_k3_experts_at_jamba_widths_on_card(cuda, M, K, N):
    """K3's experts entry at jamba's 16 experts of 14,336: at a 128-token
    admission's capacity (M = 20, the tensor-core kernel) and a decode step's
    (M = 4, the GEMV): within 1e-5 of the plain version, the noisy stack's
    max |w~| exact and sum within rtol 1e-6, two calls bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((16, M, K), generator=g, device=cuda)
    w = torch.randn((16, K, N), generator=g, device=cuda) * 0.02
    dev = DeviceModel()
    sig = dev.sigma_rel(torch.tensor(3.5, device=cuda))
    kw = dict(device=dev, seed=99, plane=1234)
    y, s, m = k3.emt_matmul_experts(x, w, sig, **kw)
    yp, sp, mp = k3.plain_experts(x, w, sig, **kw)
    assert _rel(y, yp) <= 1e-5
    assert float(m) == float(mp)
    assert abs(float(s) - float(sp)) <= 1e-6 * float(sp)
    del yp
    y2, s2, m2 = k3.emt_matmul_experts(x, w, sig, **kw)
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(m, m2)
    want = "emt_experts_tc" if M > k3.GEMV_MAX_M else "emt_matmul_gemv"
    names = launched(lambda: k3.emt_matmul_experts(x, w, sig, **kw), want)
    assert any(want in n for n in names), names


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_recurrent_engine_on_card_launches_its_kernels(cuda, arch):
    """The smoke stacks (jamba's cut to 4 layers) served on the card
    through the legacy prefill: xlstm K3 alone; jamba (mixed, paged) K1,
    K3, the experts entry and K5; neither K2 nor K4."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import GenRequest, ServingEngine
    from repro_torch.serve.spec import build_config
    cfg = build_config(arch, smoke=True, a_per_row=True,
                       placement="mixed" if arch == "jamba-v0.1-52b" else None,
                       model_overrides={"num_layers": 4})
    params = lm.init_model_params(cfg, 0)
    eng = ServingEngine(cfg, params, batch_size=3, max_len=32, seed=7,
                        block_size=8, paged=True, fresh_noise=False)
    on = [k3.emt_matmul]
    off = [k2.paged_prefill, k1.paged_attention]
    jamba = [k1.paged_attention_decode, k3.emt_matmul_experts,
             k5.emt_bitserial]
    (on if arch == "jamba-v0.1-52b" else off).extend(jamba)
    before = {c: c.launches for c in on + off}
    rng = np.random.default_rng(0)
    res = eng.serve([GenRequest(prompt=rng.integers(0, 512, n)
                                .astype(np.int32), max_new=4)
                     for n in (5, 12, 9)], stagger=1)
    assert [len(r.tokens) for r in res] == [4, 4, 4]
    assert eng.paged == (arch == "jamba-v0.1-52b") and not eng.chunked
    assert all(c.launches > before[c] for c in on)
    assert all(c.launches == before[c] for c in off)
