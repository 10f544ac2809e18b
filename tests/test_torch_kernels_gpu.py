"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on
a machine with the card and no JAX, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_gpu.py

Tolerances: relu_maxpool bit-exact, NaN where the plain version has
NaN (max is exact), its backward bit-exact against the plain backward
(autograd of the plain forward: the same tap chosen, the same f32 sum
of at most 4 windows in the same order, rounded once), also at strip
and column edges and under other plans; roi_align within
1e-5 * max|F| in float32 (float32 sums in another order), and in
bfloat16 within one bfloat16 ulp of the plain version (computed in
float32 and cast once), or 1e-5 * max|F| where that is larger, the same
bits on a second launch and under every launch plan; its
feature gradient within 1e-5 * (the plain gradient of |g|) at each
cell (the float32 sum-order bound of a cell that many boxes touch),
plus one bfloat16 ulp in bfloat16, and the same bits on a second
launch; the bottleneck block within
1e-5 * max|y| of the plain version in float32 (float32 sums in another
order) and in bfloat16, at each element, within one bfloat16 ulp plus
1e-3 * max|y| (t1 and t2 each rounded once: a sum-order difference can
flip one of those roundings, which the next product carries into y as
about ulp(t2) * |w3|), also with b1 = 3, where a t1 halo holding
relu(b1) instead of 0 would move every border pixel, and at partial
tiles into a NaN-filled output, the same bits on a second launch; the
stem conv within one
bfloat16 ulp of the plain version (the same 147 float32 products in
another order, one rounding), plus 1e-5 * (|x| conv |w| + |shift|), the
float32 sum-order bound, which exceeds a bfloat16 ulp of an output
close to 0; its gradient within 1e-5 of the largest
value (plus one bfloat16 ulp in bfloat16) of autograd of the plain conv.
The int8 convolution (KQ1) and the int8 ROIAlign (KQ2: its matrices
built from the boxes, then both contractions) bit-exact against their
plain versions (integer sums, the same float32 operations in the same
order), into a NaN-filled or otherwise filled output, at odd shapes
(M and O not multiples of the tile, C past a k step, zero-area, outside,
tiny and whole-image boxes); the tiny int8 model on the card against the CPU by
matched detections (a stem output an ulp apart can move an int8
rounding by a step: scores within 5e-3). The serving program split over
two cards gives the one-card program's bits on each half of the
batch. The full-float32 products of
the grounding head (``ops/matmul.py``)
within 1e-5 of float64 with cuBLAS's TF32 allowed; the tiny LSM step on
the card against the CPU at the tolerances its docstring states.
"""
import math

import numpy as np
import pytest
import torch

from locov_torch.ops import kernel_lib
from locov_torch.ops import roi_align as roi_mod
from locov_torch.ops import bottleneck_block as block_mod
from locov_torch.ops import int8_conv as iq
from locov_torch.ops.bottleneck_block import (bottleneck_block,
                                              bottleneck_block_cuda,
                                              bottleneck_block_plain)
from locov_torch.ops.relu_maxpool import (relu_maxpool,
                                          relu_maxpool_bwd_cuda,
                                          relu_maxpool_bwd_plain,
                                          relu_maxpool_cuda,
                                          relu_maxpool_plain)
from locov_torch.ops.roi_align import (roi_align_batched,
                                       roi_align_bwd_cuda,
                                       roi_align_bwd_plain, roi_align_cuda,
                                       roi_align_fused)
from locov_torch.ops.stem_conv_bn import (_conv, stem_conv_bn,
                                          stem_conv_bn_cuda,
                                          stem_conv_bn_plain)
from locov_torch.tools.bench_block import make_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _same_bits(got, want):
    """Equal bit for bit, with NaN in the same places (NaN payloads
    aside)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(got.view(ints[got.dtype])[~nan],
                       want.view(ints[want.dtype])[~nan])


def _ties_with_nan(gen, shape):
    """Heavy ties with NaNs and negative zeros sprinkled in."""
    x = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
    u = torch.rand(shape, generator=gen, device="cuda")
    x[u < 0.02] = float("nan")
    x[(u >= 0.02) & (u < 0.12)] = -0.0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 20, 64), (1, 15, 17, 64),
                                   (2, 9, 9, 5), (1, 1, 3, 8)])
def test_relu_maxpool_bit_exact(cuda, dtype, shape):
    for x in (torch.randn(shape, generator=cuda, device="cuda"),
              torch.randint(-2, 3, shape, generator=cuda,
                            device="cuda").float(),
              _ties_with_nan(cuda, shape)):
        x = x.to(dtype)
        before = kernel_lib.LAUNCHES["relu_maxpool"]
        got = relu_maxpool(x)
        assert kernel_lib.LAUNCHES["relu_maxpool"] == before + 1
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.is_contiguous()
        assert _same_bits(got, relu_maxpool_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 20, 64), (1, 15, 17, 64),
                                   (2, 9, 9, 5), (1, 1, 3, 8)])
def test_relu_maxpool_backward_bit_exact(cuda, dtype, shape):
    oshape = (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, shape[3])
    for x in (torch.randn(shape, generator=cuda, device="cuda"),
              _ties_with_nan(cuda, shape)):
        x = x.to(dtype).requires_grad_(True)
        dy = torch.randn(oshape, generator=cuda, device="cuda").to(dtype)
        before = kernel_lib.LAUNCHES["relu_maxpool_bwd"]
        relu_maxpool(x).backward(dy)  # the autograd Function's backward
        assert kernel_lib.LAUNCHES["relu_maxpool_bwd"] == before + 1
        want = relu_maxpool_bwd_plain(x.detach(), dy)
        torch.cuda.synchronize()
        assert _same_bits(x.grad, want)
        assert _same_bits(relu_maxpool_bwd_cuda(x.detach(), dy), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((1, 37, 67, 24), 0),
                                          ((2, 35, 129, 64), 0),
                                          ((1, 19, 71, 128), 0),
                                          ((1, 21, 9, 5), 0),
                                          ((1, 17, 13, 64), 1)])
def test_relu_maxpool_backward_at_tile_edges(cuda, dtype, shape, offset):
    """H and W odd and not multiples of a block's strip (8 window rows)
    or of its window columns (15 at 16 vectors a pixel, 31 at 8, 63 at
    4); C 24, 64, 128 (two lane groups in f32), 5 and a misaligned x (the
    scalar variant); ties with NaN and -0. Bit-exact against the plain
    backward, and the same bits on two launches and under other plans
    (1 and 3 window rows a block), each into a NaN-filled dx."""
    from locov_torch.ops.relu_maxpool import _launch_bwd
    oshape = (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, shape[3])
    flat = torch.empty(math.prod(shape) + offset, device="cuda", dtype=dtype)
    x = flat[offset:].view(shape)
    x.copy_(_ties_with_nan(cuda, shape))
    dy = torch.randn(oshape, generator=cuda, device="cuda").to(dtype)
    want = relu_maxpool_bwd_plain(x, dy)
    got = _launch_bwd(x, dy, fill=math.nan)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    for rows in (None, 1, 3):
        assert _same_bits(_launch_bwd(x, dy, rows, math.nan), got)


def test_relu_maxpool_rejects_bad_inputs(cuda):
    x = torch.randn(1, 8, 8, 4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        relu_maxpool_cuda(x.permute(0, 2, 1, 3))
    with pytest.raises(TypeError):
        relu_maxpool_cuda(x.half())


def _boxes(gen, b, n, img_h, img_w):
    u = torch.rand((b, n, 4), generator=gen, device="cuda")
    lo = u[..., :2] * torch.tensor([img_w, img_h], device="cuda") - 40
    wh = u[..., 2:] * 400 + 1
    special = torch.tensor([[0, 0, img_w, img_h], [50, 40, 50, 90],
                            [80, 60, 70, 50], [-3000, -50, 3000, 120],
                            [img_w + 20, img_h + 30, img_w + 90,
                             img_h + 99]], dtype=torch.float32,
                           device="cuda").expand(b, -1, -1)
    return torch.cat([special, torch.cat([lo, lo + wh], -1)], 1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sr,c,h,pooled,offset", [
    (0, 256, 25, 14, 0), (2, 256, 25, 14, 0), (0, 12, 25, 14, 0),
    (1, 64, 25, 14, 0), (8, 64, 25, 14, 0),
    # pooled 7 and 32 (the kernel's largest: 512 threads a block)
    (0, 64, 25, 7, 0), (2, 64, 25, 32, 0),
    # feature heights 7 and 1
    (0, 256, 7, 14, 0), (2, 64, 1, 14, 0),
    # features one element past a 16-byte boundary: one channel a thread
    (0, 256, 25, 14, 1)])
def test_roi_align_matches_plain(cuda, dtype, sr, c, h, pooled, offset):
    shape = (2, h, 42, c)
    f = torch.randn((math.prod(shape) + offset,), generator=cuda,
                    device="cuda") * 3
    f = f.to(dtype)[offset:].view(shape)
    assert (f.data_ptr() % 16 == 0) == (offset == 0)
    # boxes hugging the right and bottom edges, and one wider than the
    # image, after the special and random ones
    hug = torch.tensor([[672 - 30.0, h * 16 - 20.0, 672, h * 16],
                        [-500.0, 0.0, 672 + 500.0, h * 16]],
                       device="cuda").expand(2, -1, -1)
    bx = torch.cat([_boxes(cuda, 2, 40, h * 16, 672), hug], 1).contiguous()
    before = kernel_lib.LAUNCHES["roi_align_fused"]
    got = roi_align_fused(f, bx, 1 / 16, pooled, sr)
    assert kernel_lib.LAUNCHES["roi_align_fused"] == before + 1
    plain = roi_align_batched(f, bx, 1 / 16, pooled, sr).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 47, pooled, pooled, c)
    fmax = f.float().abs().max().item()
    err = (got.float() - plain).abs()
    if dtype == torch.float32:
        tol = torch.full_like(err, 1e-5 * fmax)
    else:  # one bf16 ulp at the larger magnitude, 1e-5 * max|F| floor
        _, e = torch.frexp(torch.maximum(plain.abs(), got.float().abs()))
        tol = torch.clamp(torch.exp2((e - 8).float()), min=1e-5 * fmax)
    assert bool((err <= tol).all()), err.max().item()
    assert bool((got[:, -2:].float().abs().amax((2, 3, 4)) > 0).all())
    # a box wholly outside the image; in adaptive mode also the
    # degenerate boxes (zero width, inverted), which have no samples
    assert bool((got[:, 4] == 0).all())
    if sr == 0:
        assert bool((got[:, 1:3] == 0).all())
    # the sum order is fixed: another launch, and launches under other
    # plans (channel tiles, channels a thread, output rows a block), give
    # the same bits
    assert _same_bits(roi_align_cuda(f, bx, 1 / 16, pooled, sr), got)
    plan = roi_mod._fwd_plan(h, 42, c, dtype, pooled, roi_mod._align(f))
    vec, tile = plan["vec"], plan["channel_tile"]
    half = roi_mod._vec(c, dtype, roi_mod._align(f) >= 16, 16)
    for d, v, rows in ((2, vec, 1), (4, vec, 3), (8, vec, 2), (1, half, 7),
                       (2, half, 4), (1, 1, 1), (1, vec, pooled)):
        step = math.lcm(8, v)  # a tile: whole vectors, a multiple of 8
        t = max(step, tile // d // step * step)
        other = roi_mod._fwd_launch_plan(h, 42, t, v, pooled, rows)
        assert _same_bits(roi_mod._launch_fwd(f, bx, 1 / 16, pooled, sr,
                                              other, math.nan), got), \
            (t, v, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sr,c,h,offset", [
    (0, 256, 25, 0), (2, 256, 25, 0), (0, 12, 25, 0), (1, 64, 25, 0),
    # heights that leave a part band (the plan's bands are 2 or 4 rows)
    (0, 256, 7, 0), (2, 64, 1, 0),
    # g one element past a 16-byte boundary: one channel a thread
    (0, 256, 7, 1)])
def test_roi_align_backward_matches_plain(cuda, dtype, sr, c, h, offset):
    f = (torch.randn((2, h, 42, c), generator=cuda, device="cuda") * 3)
    f = f.to(dtype).requires_grad_(True)
    bx = _boxes(cuda, 2, 40, h * 16, 672)
    shape = (2, 45, 14, 14, c)
    g = torch.randn((math.prod(shape) + offset,), generator=cuda,
                    device="cuda").to(dtype)[offset:].view(shape)
    assert (g.data_ptr() % 16 == 0) == (offset == 0)
    before = kernel_lib.LAUNCHES["roi_align_bwd"]
    roi_align_fused(f, bx, 1 / 16, 14, sr).backward(g)
    assert kernel_lib.LAUNCHES["roi_align_bwd"] == before + 1
    got = f.grad.float()
    plain = roi_align_bwd_plain(g, bx, 1 / 16, h, 42, 14, sr).float()
    bound = roi_align_bwd_plain(g.abs(), bx, 1 / 16, h, 42, 14, sr).float()
    torch.cuda.synchronize()
    tol = 1e-5 * bound
    if dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(plain.abs(), got.abs()))
        tol = tol + torch.exp2((e - 8).float())
    assert bool(((got - plain).abs() <= tol).all())
    # the sum order is fixed: another launch gives the same bits
    assert _same_bits(roi_align_bwd_cuda(g, bx, 1 / 16, h, 42, 14, sr),
                      f.grad)
    # boxes wholly outside, and in adaptive mode the degenerate ones,
    # contribute exactly 0
    zero = [1, 2, 4] if sr == 0 else [4]
    alone = roi_align_bwd_cuda(g[:, zero].contiguous(),
                               bx[:, zero].contiguous(), 1 / 16, h, 42, 14,
                               sr)
    assert bool((alone == 0).all())


def test_roi_align_rejects_bad_inputs(cuda):
    f = torch.randn(1, 8, 8, 16, device="cuda")
    bx = torch.zeros(1, 3, 4, device="cuda")
    with pytest.raises(TypeError):
        roi_align_cuda(f, bx.double(), 1 / 16)
    with pytest.raises(ValueError):
        roi_align_cuda(f, bx, 1 / 16, pooled=64)
    with pytest.raises(ValueError):
        roi_align_cuda(f, bx.cpu(), 1 / 16)


def _assert_block_close(got, want):
    """float32: 1e-5 * max|y|; bfloat16: one ulp plus 1e-3 * max|y| at
    each element (see the module docstring)."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    ymax = want.abs().max().item()
    err = (got - want).abs()
    tol = 1e-5 * ymax
    if bf16:
        tol = _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-3 * ymax
    assert bool((err <= tol).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,m", [((2, 20, 24, 256), 64),
                                     ((1, 13, 19, 128), 64),
                                     ((2, 1, 37, 128), 64),
                                     ((1, 9, 7, 512), 128)])
def test_bottleneck_block_matches_plain(cuda, dtype, shape, m):
    args = make_inputs(cuda, shape, m, dtype)
    before = kernel_lib.LAUNCHES["bottleneck_block"]
    got = bottleneck_block(*args)
    assert kernel_lib.LAUNCHES["bottleneck_block"] == before + 1
    want = bottleneck_block_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == shape
    _assert_block_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,m", [
    ((1, 1, 7, 64), 64),       # one row, W below a tile
    ((2, 2, 17, 128), 64),     # W one past a tile
    ((1, 9, 17, 512), 128),    # H one past a tile, C 512
    ((1, 9, 17, 512), 64),
    ((2, 2, 7, 128), 128),
    ((1, 9, 16, 64), 128),
    ((3, 40, 96, 64), 64),     # 90 tiles
    ((2, 72, 128, 64), 64),    # 144 tiles: more than the card has blocks
    ((2, 72, 128, 128), 128)])
def test_bottleneck_block_edges(cuda, dtype, shape, m):
    """Partial tiles in both directions, C 64 to 512, M 64 and 128, and
    more tiles than the persistent grid has blocks: each launch writes
    into a NaN-filled output, matches the plain version, and a second
    launch gives the same bits."""
    args = make_inputs(cuda, shape, m, dtype)
    got = block_mod._launch(*args, fill=math.nan)
    again = block_mod._launch(*args, fill=math.nan)
    want = bottleneck_block_plain(*args)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert _same_bits(got, again)
    _assert_block_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,m", [((2, 6, 9, 128), 64),
                                     ((1, 1, 5, 128), 64),
                                     ((1, 10, 20, 128), 128)])
def test_bottleneck_block_zero_pads_t1(cuda, dtype, shape, m):
    """b1 = 3: relu(b1) in t1's halo would move every border pixel."""
    x, w1, b1, *rest = make_inputs(cuda, shape, m, dtype)
    args = (x, w1, torch.full_like(b1, 3.0), *rest)
    got = bottleneck_block_cuda(*args)
    want = bottleneck_block_plain(*args)
    torch.cuda.synchronize()
    _assert_block_close(got, want)


def test_bottleneck_block_refusals(cuda):
    args = make_inputs(cuda, (1, 4, 4, 128), 64, torch.bfloat16)
    with pytest.raises(ValueError, match="M in"):
        bottleneck_block_cuda(*make_inputs(cuda, (1, 4, 4, 128), 32,
                                             torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 64"):
        bottleneck_block_cuda(*make_inputs(cuda, (1, 4, 4, 96), 64,
                                             torch.bfloat16))
    with pytest.raises(TypeError):
        bottleneck_block_cuda(args[0].half(), *args[1:])
    with pytest.raises(RuntimeError, match="no gradient"):
        bottleneck_block(args[0].requires_grad_(True), *args[1:])


def _bf16_ulp(mag):
    _, e = torch.frexp(mag)
    return torch.exp2((e - 8).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f", [((2, 64, 86, 3), 64),
                                     ((1, 38, 70, 3), 64),
                                     ((1, 16, 20, 3), 32),
                                     ((1, 18, 34, 3), 128)])
def test_stem_conv_bn_matches_plain(cuda, dtype, shape, f):
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = torch.randn((7, 7, 3, f), generator=cuda, device="cuda") * 0.1
    shift = torch.randn((f,), generator=cuda, device="cuda")
    before = kernel_lib.LAUNCHES["stem_conv_bn"]
    got = stem_conv_bn(x, w, shift)
    assert kernel_lib.LAUNCHES["stem_conv_bn"] == before + 1
    want = stem_conv_bn_plain(x, w, shift).float()
    bf = torch.bfloat16
    sum_order = 1e-5 * (_conv(x.to(bf).float().abs(), w.to(bf).float().abs())
                        + shift.abs())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, f)
    err = (got.float() - want).abs()
    assert bool((err <= _bf16_ulp(torch.maximum(
        want.abs(), got.float().abs())) + sum_order).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f", [((1, 30, 62, 3), 32),
                                     ((2, 46, 94, 3), 64),
                                     ((1, 22, 50, 3), 128)])
def test_stem_conv_bn_partial_tiles(cuda, dtype, shape, f):
    """Outputs that leave partial 8 x 16 tiles in both directions: within
    tolerance of the plain version, every output written (NaN-filled
    first), and the same bits on two launches."""
    from locov_torch.ops.stem_conv_bn import _launch
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    w = torch.randn((7, 7, 3, f), generator=cuda, device="cuda") * 0.1
    shift = torch.randn((f,), generator=cuda, device="cuda")
    got = _launch(x, w, shift, math.nan)
    again = _launch(x, w, shift, math.nan)
    want = stem_conv_bn_plain(x, w, shift).float()
    bf = torch.bfloat16
    sum_order = 1e-5 * (_conv(x.to(bf).float().abs(), w.to(bf).float().abs())
                        + shift.abs())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    err = (got.float() - want).abs()
    assert bool((err <= _bf16_ulp(torch.maximum(
        want.abs(), got.float().abs())) + sum_order).all()), err.max().item()


def test_stem_conv_bn_refusals(cuda):
    x = torch.randn((1, 8, 8, 3), generator=cuda, device="cuda")
    w = torch.randn((7, 7, 3, 48), generator=cuda, device="cuda")
    with pytest.raises(ValueError, match="F in"):
        stem_conv_bn_cuda(x, w, torch.zeros(48, device="cuda"))
    with pytest.raises(TypeError):
        stem_conv_bn_cuda(x.half(), w[..., :32], torch.zeros(32,
                                                               device="cuda"))
    with pytest.raises(ValueError, match="even"):
        stem_conv_bn_cuda(x[:, :7].contiguous(), w[..., :32],
                          torch.zeros(32, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_conv_bn_backward_is_the_conv_vjp(cuda, dtype):
    x = torch.randn((2, 64, 86, 3), generator=cuda, device="cuda").to(dtype)
    w = torch.randn((7, 7, 3, 64), generator=cuda, device="cuda") * 0.1
    shift = torch.randn((64,), generator=cuda, device="cuda")
    g = torch.randn((2, 32, 43, 64), generator=cuda,
                    device="cuda").to(torch.bfloat16)
    xs, ws, ss = (v.detach().requires_grad_(True) for v in (x, w, shift))
    stem_conv_bn(xs, ws, ss).backward(g)
    # autograd of the plain conv at the un-rounded x and w.to(x.dtype)
    xr, wr = (v.detach().requires_grad_(True) for v in (x, w))
    y = torch.nn.functional.conv2d(
        xr.permute(0, 3, 1, 2), wr.to(dtype).permute(3, 2, 0, 1), stride=2,
        padding=3).permute(0, 2, 3, 1)
    y.backward(g.to(dtype))
    torch.cuda.synchronize()
    for got, want in ((xs.grad, xr.grad), (ws.grad, wr.grad),
                      (ss.grad, g.float().sum((0, 1, 2)))):
        assert got.dtype == want.dtype
        got, want = got.float(), want.float()
        tol = 1e-5 * want.abs().max()
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
        assert bool(((got - want).abs() <= tol).all())


# the epilogue variants: (residual, int8 output, float output)
CONV_INT8_VARIANTS = {"plain": (False, False, True),
                      "residual": (True, False, True),
                      "quant": (True, True, True),
                      "quant_only": (False, True, False)}


def conv_int8_variant(gen, xq, wq, scale, shift, stride, pad, relu,
                      variant):
    """The extra operands of an epilogue ``variant`` (a residual of the
    output's shape, an amax at 0.7 of the plain output's max-abs, so
    that values saturate), and the plain version's outputs for them:
    (residual, amax, float_out, want_out, want_q)."""
    has_res, has_q, float_out = CONV_INT8_VARIANTS[variant]
    y = iq.conv_int8_plain(xq, wq, scale, shift, stride, pad, relu)
    res = (torch.randn(y.shape, generator=gen, device="cuda") * 4).to(
        shift.dtype) if has_res else None
    amax = (y.float().abs().max() * 0.7).reshape(()) if has_q else None
    if not has_q:
        return res, None, True, iq.conv_int8_plain(
            xq, wq, scale, shift, stride, pad, relu, res), None
    out, q = iq.conv_int8_op_plain(xq, wq, scale, shift, stride, pad, relu,
                                   res, amax, float_out)
    return res, amax, float_out, (out if float_out else None), q


def _misaligned(t):
    """A copy of ``t`` whose address is one element past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,o,k,stride", [
    ((2, 14, 14, 1024), 512, 1, 2), ((2, 7, 7, 512), 512, 3, 1),
    ((3, 9, 11, 48), 200, 3, 2), ((1, 13, 17, 64), 72, 1, 1),
    ((2, 25, 42, 256), 1024, 1, 1), ((1, 5, 3, 16), 8, 3, 1),
    ((2, 6, 5, 32), 20, 1, 1), ((2, 12, 10, 64), 64, 3, 1),
    ((2, 10, 20, 128), 136, 3, 1), ((1, 9, 13, 128), 64, 1, 2),
    ((2, 16, 16, 8), 24, 3, 1), ((2, 9, 7, 12), 32, 1, 2),
    ((1, 5, 6, 6), 16, 3, 1)])
def test_conv_int8_bit_exact(cuda, dtype, shape, o, k, stride):
    """Each epilogue variant (a residual; the int8 copy with and without
    the float output) into NaN-filled outputs (-128 in the int8 one) has
    the plain version's bits, and the same bits on a second launch, also
    from misaligned operands (copied by ``kernel_operands``). C 8 and 12
    are padded with zero channels to 16. The shapes reach each of the
    kernel's A modes: the 2-D TMA box (1x1 / 1), the 4-D spatial boxes
    (C a multiple of 128: 3x3 / 1 on 7 x 7 images and on ragged 16 x 8
    blocks, 1x1 / 2) and the cp.async gather (the rest). Each call
    counts one launch under ``LAUNCHES["conv_int8"]``."""
    xq = torch.randint(-127, 128, shape, generator=cuda,
                       device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (o, k, k, shape[3]), generator=cuda,
                       device="cuda").to(torch.int8)
    scale = torch.rand(o, generator=cuda, device="cuda") * 1e-3
    shift = (torch.randn(o, generator=cuda, device="cuda") * 5).to(dtype)
    pad = (k - 1) // 2
    for relu in (False, True):
        for variant in CONV_INT8_VARIANTS:
            res, amax, float_out, want, want_q = conv_int8_variant(
                cuda, xq, wq, scale, shift, stride, pad, relu, variant)
            operands = [(xq, wq, res)]
            if variant == "residual":
                operands.append((_misaligned(xq), _misaligned(wq),
                                 _misaligned(res)))
            for x8, w8, r in operands:
                got, q = iq._launch(x8, w8, scale, shift, stride, pad, relu,
                                    r, amax, float_out, fill=math.nan)
                assert (got is None) == (want is None)
                assert want is None or _same_bits(got, want), variant
                assert (q is None) == (want_q is None)
                assert want_q is None or torch.equal(q, want_q), variant
                again = iq._launch(x8, w8, scale, shift, stride, pad, relu,
                                   r, amax, float_out)
                assert want is None or _same_bits(again[0], got)
                assert want_q is None or torch.equal(again[1], q)
    before = dict(kernel_lib.LAUNCHES)
    iq.conv_int8_cuda(xq, wq, scale, shift, stride, pad, True)
    iq.conv_int8_cuda(xq, wq, scale, shift, stride, pad, True, None,
                      torch.ones((), device="cuda"), False)
    after = dict(kernel_lib.LAUNCHES)
    assert after["conv_int8"] == before["conv_int8"] + 2
    assert all(after[k] == before[k] for k in after if k != "conv_int8")


def test_conv_int8_rejects_bad_inputs(cuda):
    xq = torch.zeros((1, 4, 4, 6), dtype=torch.int8, device="cuda")
    wq = torch.zeros((8, 1, 1, 6), dtype=torch.int8, device="cuda")
    one = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="kh, kw, C"):
        iq.conv_int8_cuda(xq, wq[:, :, :, :4].contiguous(), one, one, 1, 0,
                          False)
    with pytest.raises(ValueError, match="no output asked for"):
        iq.conv_int8_cuda(xq, wq, one, one, 1, 0, False, float_out=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        iq.conv_int8_cuda(xq.cpu(), wq, one, one, 1, 0, False)


def _int8_roi_same(f, bx, sr, pooled, pool_share=0.6):
    """KQ2 (``locov::roi_align_int8`` on the card) against its plain
    version on the same inputs (the pooled tensor's max-abs
    ``pool_share`` of the features'), into an output filled with 77 and
    again through the counted wrapper: the same bits. Returns the
    output."""
    fa = f.abs().amax()
    fq, kyq, kxq, sx, rescale, s_pool = roi_mod.int8_operands(
        f, bx, 1 / 16, fa, fa * pool_share, pooled, sr)
    ratio = (iq._scale_of(fa) / s_pool).reshape(1)
    want = roi_mod.roi_align_int8_plain(fq, kyq, kxq, sx, rescale)
    got = roi_mod._launch_int8(fq, bx, ratio, 1 / 16, pooled, sr, fill=77)
    assert torch.equal(got, want)
    before = kernel_lib.LAUNCHES["roi_align_int8"]
    again = roi_mod.roi_align_int8_cuda(fq, bx, ratio, 1 / 16, pooled, sr)
    assert torch.equal(again, want)
    assert kernel_lib.LAUNCHES["roi_align_int8"] == before + 1
    assert torch.equal(torch.ops.locov.roi_align_int8(fq, bx, ratio, 1 / 16,
                                                      pooled, sr), want)
    return got


@pytest.mark.parametrize("sr,pooled,c,h,w,n", [
    (0, 14, 1024, 50, 84, 100), (2, 7, 16, 24, 28, 25),
    (0, 14, 64, 84, 50, 40), (0, 16, 4, 7, 9, 9),
    (0, 14, 1024, 120, 76, 20)])
def test_roi_align_int8_bit_exact(cuda, sr, pooled, c, h, w, n):
    f = torch.randn((2, h, w, c), generator=cuda, device="cuda") * 3
    bx = _boxes(cuda, 2, n, h * 16, w * 16)
    bx[0, 3] = 10.0  # zero-area
    bx[1, 2] = torch.tensor([-90.0, -40.0, -20.0, -5.0], device="cuda")
    got = _int8_roi_same(f, bx, sr, pooled)
    assert (got[1, 2] == 0).all() and (got.abs() > 60).any()
    if sr == 0:
        assert (got[0, 3] == 0).all()


@pytest.mark.parametrize("kind", ["tiny", "whole_image"])
def test_roi_align_int8_bit_exact_tiny_and_whole_image(cuda, kind):
    """Tiny boxes (bins under one cell: many bins share a feature row)
    and boxes covering the whole image and more (the adaptive grid capped
    at 8 samples, every column in a span), at the static path's feature
    size."""
    h, w = 50, 84
    f = torch.randn((2, h, w, 256), generator=cuda, device="cuda") * 3
    u = torch.rand((2, 64, 4), generator=cuda, device="cuda")
    size = torch.tensor([w * 16.0, h * 16.0], device="cuda")
    if kind == "tiny":
        lo = u[..., :2] * (size - 150)
        bx = torch.cat([lo, lo + 2 + u[..., 2:] * 148], -1)
    else:
        bx = torch.cat([-u[..., :2] * size, size * (1 + u[..., 2:])], -1)
        bx[:, 0] = torch.tensor([0.0, 0.0, w * 16.0, h * 16.0])
    got = _int8_roi_same(f, bx.contiguous(), 0, 14)
    assert (got.abs() > 30).any()


def test_roi_align_int8_bit_exact_wide_ratio(cuda):
    """A pooled max-abs 1/300 of the features' (a scale ratio of 300):
    most outputs saturate at +-127, the same bits."""
    f = torch.randn((2, 50, 84, 64), generator=cuda, device="cuda") * 3
    got = _int8_roi_same(f, _boxes(cuda, 2, 40, 800, 1344), 0, 14,
                         1 / 300)
    assert (got.abs() == 127).float().mean() > 0.5


def _matched(cpu, gpu, score_tol, box_tol):
    """The share of the CPU's detections that the card's match (the same
    class, every box coordinate within ``box_tol``, the score within
    ``score_tol``)."""
    (cb, cs, cc, cm), (gb, gs, gc, gm) = cpu, gpu
    hit = total = 0
    for i in range(cm.shape[0]):
        for j in torch.nonzero(cm[i]).flatten().tolist():
            total += 1
            near = gm[i] & (gc[i] == cc[i, j]) & \
                ((gb[i] - cb[i, j]).abs().amax(-1) <= box_tol) & \
                ((gs[i] - cs[i, j]).abs() <= score_tol)
            hit += bool(near.any())
    return hit / max(total, 1)


@pytest.mark.parametrize("scheme,roialign", [("dynamic", True),
                                             ("static", True),
                                             ("static", False)])
def test_tiny_int8_model_cuda_matches_cpu(cuda, scheme, roialign):
    """The tiny float32 model in the int8 mode on the card (KQ1, KQ2 and
    K2 launched) against the CPU (the plain versions): calibrated on
    each device from the same weights, the detections matched one to
    one within 5e-3 in score and 0.05 px."""
    from locov_torch.config import get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch, to_torch)
    from locov_torch.utils.weights import seeded_init_
    from torch_parity import tiny_cfg
    cfg = tiny_cfg(get_cfg, **{"MODEL.PIXEL_STD": [57.375, 57.12, 58.395],
                               "TPU.INT8_EVAL": True,
                               "TPU.INT8_SCHEME": scheme,
                               "TPU.INT8_ROIALIGN": roialign})
    rng = np.random.RandomState(0)
    batch = DetectionBatch(images=ImageBatch(
        image=(rng.rand(2, 64, 64, 3) * 255).astype(np.float32),
        hw=np.array([[64, 64], [48, 56]], np.int32),
        orig_hw=np.array([[128, 128], [96, 112]], np.int32)))
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    out = {}
    before = dict(kernel_lib.LAUNCHES)
    for dev in ("cpu", "cuda"):
        m = seeded_init_(build_meta_arch(cfg, device="cpu"), 0)
        with torch.no_grad():
            m.rpn_head.anchor_deltas.weight.zero_()
        m.to(dev)
        b, c = to_torch(batch, dev), torch.from_numpy(ce).to(dev)
        if scheme == "static":
            m.calibrate_int8(b, c)
        out[dev] = [x.cpu() for x in m.inference(b, c)]
    assert kernel_lib.LAUNCHES["conv_int8"] > before["conv_int8"]
    if scheme == "static" and roialign:
        assert kernel_lib.LAUNCHES["roi_align_int8"] > \
            before["roi_align_int8"]
    assert int(out["cpu"][3].sum()) >= 10
    assert _matched(out["cpu"], out["cuda"], 5e-3, 0.05) == 1.0


def test_tiny_model_cuda_matches_cpu(cuda):
    from locov_torch.config import get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch, to_torch)
    from locov_torch.utils.weights import seeded_init_
    from torch_parity import tiny_cfg
    cfg = tiny_cfg(get_cfg, **{"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]})
    rng = np.random.RandomState(0)
    batch = DetectionBatch(images=ImageBatch(
        image=(rng.rand(2, 64, 64, 3) * 255).astype(np.float32),
        hw=np.array([[64, 64], [48, 56]], np.int32),
        orig_hw=np.array([[128, 128], [96, 112]], np.int32)))
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    out = {}
    for dev in ("cpu", "cuda"):
        m = seeded_init_(build_meta_arch(cfg, device="cpu"), 0)
        with torch.no_grad():
            m.rpn_head.anchor_deltas.weight.zero_()
        m.to(dev)
        out[dev] = [x.cpu() for x in
                    m.inference(to_torch(batch, dev),
                                torch.from_numpy(ce).to(dev))]
    (cb, cs, cc, cm), (gb, gs, gc, gm) = out["cpu"], out["cuda"]
    assert torch.equal(cm, gm) and cm.sum() > 0
    assert torch.equal(cc[cm], gc[cm])
    assert (cs - gs).abs().max() <= 1e-5
    assert (cb[cm] - gb[cm]).abs().max() <= 1e-3


def test_tiny_f32_model_on_the_card_at_pytorch_tf32_defaults():
    """The port's float32 convolutions turn cuDNN's TF32 off themselves:
    with the process's flags at PyTorch's defaults (cuDNN may use TF32,
    matmuls may not), the tiny float32 model on the card matches the CPU
    at chip_smoke.small_reference's tolerance (the same mask and
    classes, boxes within 1e-3 px, scores within 1e-5). No ``cuda``
    fixture: it sets the flags for the whole process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from locov_torch.config import get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch, to_torch)
    from locov_torch.utils.weights import seeded_init_
    from torch_parity import tiny_cfg
    cfg = tiny_cfg(get_cfg, **{"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]})
    rng = np.random.RandomState(1)
    batch = DetectionBatch(images=ImageBatch(
        image=(rng.rand(2, 64, 64, 3) * 255).astype(np.float32),
        hw=np.array([[64, 64], [48, 56]], np.int32),
        orig_hw=np.array([[128, 128], [96, 112]], np.int32)))
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            m = seeded_init_(build_meta_arch(cfg, device="cpu"), 1)
            with torch.no_grad():
                m.rpn_head.anchor_deltas.weight.zero_()
            m.to(dev)
            out[dev] = [x.cpu() for x in
                        m.inference(to_torch(batch, dev),
                                    torch.from_numpy(ce).to(dev))]
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (cb, cs, cc, cm), (gb, gs, gc, gm) = out["cpu"], out["cuda"]
    assert torch.equal(cm, gm) and cm.sum() > 0
    assert torch.equal(cc[cm], gc[cm])
    assert (cs - gs).abs().max() <= 1e-5
    assert (cb[cm] - gb[cm]).abs().max() <= 1e-3


def test_serving_split_over_two_cards_equals_one_card(cuda, tmp_path):
    """The tiny model exported on the card at batch 2, and at batch 4
    over two cards: the two-card program, which runs one copy on each of
    ``cuda:0`` and ``cuda:1``, gives on a batch the bits of the one-card
    program on each half, and refuses the one-card batch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from locov_torch.config import get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.serving import export_inference, load_exported
    from locov_torch.utils.weights import seeded_init_
    from torch_parity import tiny_cfg
    cfg = tiny_cfg(get_cfg, **{"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]})
    m = seeded_init_(build_meta_arch(cfg, device="cpu"), 0)
    with torch.no_grad():
        m.rpn_head.anchor_deltas.weight.zero_()
    m.to("cuda")
    rng = np.random.RandomState(0)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    ce = torch.from_numpy(ce).cuda()
    export_inference(m, ce, str(tmp_path / "one"), batch=2, height=64,
                     width=64)
    export_inference(m, ce, str(tmp_path / "two"), batch=4, height=64,
                     width=64, n_devices=2)
    img = torch.from_numpy((rng.rand(4, 64, 64, 3) * 255).astype(
        np.float32)).cuda()
    hw = torch.tensor([[64, 64], [48, 56], [56, 64], [64, 40]],
                      dtype=torch.int32, device="cuda")
    ohw = hw * 2
    call1, v1, ce1 = load_exported(str(tmp_path / "one"))
    call2, v2, ce2 = load_exported(str(tmp_path / "two"))
    count = kernel_lib.LAUNCHES["roi_align_fused"]
    halves = [call1(v1, img[i:i + 2], hw[i:i + 2], ohw[i:i + 2], ce1)
              for i in (0, 2)]
    one = kernel_lib.LAUNCHES["roi_align_fused"] - count
    got = call2(v2, img, hw, ohw, ce2)
    assert kernel_lib.LAUNCHES["roi_align_fused"] - count == 2 * one > 0
    assert got["mask"].sum() > 0
    for k, x in got.items():
        assert x.device == torch.device("cuda:0")
        assert torch.equal(x, torch.cat([h[k] for h in halves])), k
    with pytest.raises(ValueError):
        call2(v2, img[:2], hw[:2], ohw[:2], ce2)


def test_highest_precision_products_ignore_the_tf32_flag(cuda):
    """``ops/matmul.py:matmul_f32`` (the grounding head's similarity and
    the tied ``v2l_projection``, ``Precision.HIGHEST`` in JAX) stays in
    full float32, forward and backward, with cuBLAS's TF32 allowed in
    the process, and restores the flag: within 1e-5 of the float64
    product, where TF32 (10 mantissa bits) is about 1e-3 off."""
    from locov_torch.ops.matmul import matmul_f32
    a = torch.randn(256, 768, generator=cuda, device="cuda")
    b = torch.randn(768, 512, generator=cuda, device="cuda")
    g = torch.randn(256, 512, generator=cuda, device="cuda")
    want = a.double() @ b.double()
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        got = matmul_f32(ar, br)
        got.backward(g)
        tf32 = a @ b
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    scale = want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= 1e-5 * scale
    assert (tf32.double() - want).abs().max().item() > 1e-4 * scale
    da = g.double() @ b.double().t()
    db = a.double().t() @ g.double()
    assert (ar.grad.double() - da).abs().max() <= 1e-5 * da.abs().max()
    assert (br.grad.double() - db).abs().max() <= 1e-5 * db.abs().max()


def test_tiny_lsm_step_on_the_card():
    """One training step of the tiny float32 DistillProposalMMSSRCNN
    (tests/torch_parity.py:TINY_LSM, FREEZE_AT 0) on the card, through
    the kernels, against the CPU, through the plain versions, with
    every draw pinned, the RPN tamed and the process's TF32 flags at
    PyTorch's defaults: the loss dict and outputs within 1e-4 * max(1,
    |value|); every parameter's SGD update within 1e-3 of the largest
    CPU update of its tensor (float32 sums in another order through the
    trunk and the joint encoder) plus 1e-6 times the learning rate (the
    float32 rounding of order-1 loss terms whose gradients cancel: at
    random init the matching losses sit at their uniform value, and the
    pooler's update is such a residue), or, for the shift-invariant key and
    ``bi_seq_relationship`` biases (a gradient that is 0 but for
    rounding), below 1e-6 on both; every kernel of the path launched.
    No ``cuda`` fixture: it leaves the flags as PyTorch has them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from locov_torch.config import config_path, get_cfg
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import make_train_step
    from locov_torch.structures.batches import (DetectionBatch, GtBatch,
                                                ImageBatch, TextBatch)
    from locov_torch.utils.weights import seeded_init_
    from torch_parity import lsm_batch, tiny_lsm_arrays, tiny_lsm_cfg
    cfg = tiny_lsm_cfg(get_cfg, config_path, **{"SOLVER.BASE_LR": 0.01,
                                                "SOLVER.WARMUP_ITERS": 0})
    rng = np.random.RandomState(2)
    arrays = tiny_lsm_arrays(rng)
    u = {"rpn": rng.rand(2, 2, 6 * 8 * 15).astype(np.float32),
         "roi": rng.rand(2, 2, 24 + 3).astype(np.float32),
         "grid_drop": rng.rand(2, 12).astype(np.float32),
         "box_drop": rng.rand(2, 12).astype(np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        m = seeded_init_(build_meta_arch(cfg, device="cpu"), 2)
        with torch.no_grad():
            m.rpn_head.anchor_deltas.weight.zero_()
        m.to(dev)
        start = {k: v.detach().clone() for k, v in m.named_parameters()}
        step = make_train_step(m, *build_optimizer(cfg, m))
        batch = lsm_batch(arrays, ImageBatch, GtBatch, TextBatch,
                          DetectionBatch,
                          lambda a: torch.from_numpy(a).to(dev))
        uniforms = {k: (tuple(torch.from_numpy(a).to(dev) for a in v)
                        if v.ndim == 3 else torch.from_numpy(v).to(dev))
                    for k, v in u.items()}
        kernel_lib.reset_launches()
        metrics = step(batch, torch.from_numpy(arrays["class_emb"]).to(dev),
                       None, uniforms)
        launched = dict(kernel_lib.LAUNCHES)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: (p.detach() - start[k]).cpu()
                     for k, p in m.named_parameters()})
    (cm, cu), (gm, gu) = out["cpu"], out["cuda"]
    assert set(cm) == set(gm) and len(cm) == 19 + 14 + 1
    for k, v in cm.items():
        assert abs(gm[k] - v) <= 1e-4 * max(1.0, abs(v)), k
    zero_by_shift = ("attention_self.key.bias", "bi_seq_relationship.bias")
    floor = 1e-6 * cfg.SOLVER.BASE_LR
    for k, v in cu.items():
        if k.endswith(zero_by_shift):
            assert max(v.abs().max(), gu[k].abs().max()) <= 1e-6, k
            continue
        assert (gu[k] - v).abs().max() <= 1e-3 * v.abs().max() + floor, k
    for name in ("relu_maxpool", "relu_maxpool_bwd", "roi_align_fused",
                 "roi_align_bwd"):
        assert launched[name] > 0, name


def _op_cases(gen):
    """Each ``locov::`` op with CUDA inputs at small shapes, beside the
    plain function it must equal, the kernel its CUDA implementation
    launches, and the tolerance: relu_maxpool and its backward bit-exact
    (float32); ROIAlign and its backward in float32 within 1e-5 * max|F|
    and 1e-5 * (the plain backward of |g|) at each cell; the stem conv
    within one bfloat16 ulp plus 1e-5 * (|x| conv |w| + |shift|); the
    block within 1e-5 * max|y| (float32); the int8 conv and the int8
    ROIAlign core bit-exact; the NMS keep mask equal to the
    CPU's."""
    from locov_torch.ops import nms as nms_mod
    x = torch.randn((2, 15, 17, 64), generator=gen, device="cuda")
    dy = torch.randn((2, 8, 9, 64), generator=gen, device="cuda")
    f = torch.randn((2, 25, 42, 64), generator=gen, device="cuda")
    bx = _boxes(gen, 2, 20, 400, 672)
    g = torch.randn((2, 25, 14, 14, 64), generator=gen, device="cuda")
    sx = torch.randn((2, 64, 86, 3), generator=gen, device="cuda")
    sw = torch.randn((7, 7, 3, 64), generator=gen, device="cuda") * 0.1
    ssh = torch.randn((64,), generator=gen, device="cuda")
    block = make_inputs(gen, (2, 20, 24, 256), 64, torch.float32)
    nb = _boxes(gen, 2, 600, 400, 672)
    ns = torch.rand((2, 605), generator=gen, device="cuda")
    nv = torch.rand((2, 605), generator=gen, device="cuda") > 0.1
    nc = torch.randint(0, 3, (2, 605), generator=gen, device="cuda")
    xq = torch.randint(-127, 128, (2, 9, 11, 64), generator=gen,
                       device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (40, 3, 3, 64), generator=gen,
                       device="cuda").to(torch.int8)
    qs = torch.rand(40, generator=gen, device="cuda") * 1e-3
    qh = torch.randn(40, generator=gen, device="cuda").to(torch.bfloat16)
    qr = torch.randn((2, 5, 6, 40), generator=gen,
                     device="cuda").to(torch.bfloat16)
    qa = torch.tensor(0.05, device="cuda")
    fa = f.abs().amax()
    return {
        "relu_maxpool": ((x,), relu_maxpool_plain, "relu_maxpool"),
        "relu_maxpool_bwd": ((x, dy), relu_maxpool_bwd_plain,
                             "relu_maxpool_bwd"),
        "roi_align": ((f, bx, 1 / 16, 14, 0), roi_align_batched,
                      "roi_align_fused"),
        "roi_align_bwd": ((g, bx, 1 / 16, 25, 42, 14, 0),
                          roi_align_bwd_plain, "roi_align_bwd"),
        "stem_conv_bn": ((sx, sw, ssh), stem_conv_bn_plain,
                         "stem_conv_bn"),
        "bottleneck_block": (block, bottleneck_block_plain,
                             "bottleneck_block"),
        "conv_int8": ((xq, wq, qs, qh, 2, 1, True), iq.conv_int8_op_plain,
                      "conv_int8"),
        "conv_int8_fused": ((xq, wq, qs, qh, 2, 1, True, qr, qa, True),
                            iq.conv_int8_op_plain, "conv_int8"),
        "roi_align_int8": ((roi_mod.int8_operands(f, bx, 1 / 16, fa,
                                                  fa * 0.5, 14, 0)[0], bx,
                            (iq._scale_of(fa) / iq._scale_of(fa * 0.5)
                             ).reshape(1), 1 / 16, 14, 0),
                           roi_mod.roi_align_int8_boxes_plain,
                           "roi_align_int8"),
        "nms_mask": ((nb, ns, nv, 0.5, 100, nc),
                     lambda *a: nms_mod.nms_mask_batched(
                         *(t.cpu() if torch.is_tensor(t) else t
                           for t in a)), None),
    }


@pytest.mark.parametrize("name", ["relu_maxpool", "relu_maxpool_bwd",
                                  "roi_align", "roi_align_bwd",
                                  "stem_conv_bn", "bottleneck_block",
                                  "conv_int8", "conv_int8_fused",
                                  "roi_align_int8",
                                  "nms_mask"])
def test_locov_ops_on_the_card(cuda, name):
    """Each ``torch.ops.locov`` op on CUDA tensors: ``opcheck`` (its fake
    implementation, registered autograd and schema against the real
    kernel), one kernel launch a call, and its output against the plain
    version at the tolerances of ``_op_cases``."""
    args, plain, kernel = _op_cases(cuda)[name]
    # conv_int8_fused: the conv op with a residual and an int8 output
    op = getattr(torch.ops.locov, name.replace("_fused", ""))
    grad_args = args
    if name in ("relu_maxpool", "roi_align", "stem_conv_bn"):
        grad_args = (args[0].clone().requires_grad_(True),) + args[1:]
    torch.library.opcheck(op.default, grad_args)
    before = dict(kernel_lib.LAUNCHES)
    got = op(*args)
    torch.cuda.synchronize()
    if kernel is not None:
        assert kernel_lib.LAUNCHES[kernel] == before[kernel] + 1
    want = plain(*args)
    if name == "nms_mask":
        assert torch.equal(got.cpu(), want)
        assert int(want.sum()) > 0
        return
    if name.startswith("conv_int8"):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    if name == "roi_align_int8":
        assert torch.equal(got, want)
        return
    got, want = got.float(), want.float()
    if name.startswith("relu_maxpool"):
        assert _same_bits(got, want)
    elif name == "roi_align":
        assert bool(((got - want).abs() <=
                     1e-5 * args[0].abs().max()).all())
    elif name == "roi_align_bwd":
        bound = 1e-5 * roi_align_bwd_plain(args[0].abs(), *args[1:])
        assert bool(((got - want).abs() <= bound + 1e-12).all())
    elif name == "stem_conv_bn":
        x, w, shift = args
        mag = _conv(x.to(torch.bfloat16).float().abs(),
                    w.to(torch.bfloat16).float().abs()) + shift.abs()
        tol = _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-5 * mag
        assert bool(((got - want).abs() <= tol).all())
    else:
        assert bool(((got - want).abs() <= 1e-5 * want.abs().max()).all())


# ------------------------------------------------------------------ KA1
def _attention_inputs(gen, n, nh, hd, l, raw, caption=None):
    """qkv [n, l, 3 nh hd] bf16 N(0, 1) (scores of order 1) and the bias
    [n, 1, 1, l]: a valid prefix of each pair's caption slots (the first
    ``caption`` tokens, 8 to ``caption`` of them valid) and of its other
    tokens, as the raw 0/1 mask or (1 - m) * min."""
    qkv = torch.randn((n, l, 3 * nh * hd), generator=gen,
                      device="cuda").to(torch.bfloat16)
    cap = caption or 0
    ar = torch.arange(l, device="cuda")[None]
    lc = torch.randint(min(8, cap), cap + 1, (n, 1), generator=gen,
                       device="cuda")
    lr = torch.randint((l - cap) // 2, l - cap + 1, (n, 1), generator=gen,
                       device="cuda")
    m = torch.where(ar < cap, ar < lc, ar - cap < lr).float()[:, None, None]
    bias = m if raw else (1.0 - m) * torch.finfo(torch.float32).min
    return qkv, bias


def _attention_magnitudes(qkv, bias, u, nh, p, dout):
    """The sizes of the terms each output sums, in float32: |pd| . |v|
    for the context; for dq and dk the logits' gradient terms |p dp| + p
    sum|p dp| (over sqrt(hd)) times |k| and |q|; |pd|^T . |dO| for dv.
    Packed as the outputs are."""
    n, l, h3 = qkv.shape
    hsz = h3 // 3
    hd = hsz // nh
    q, k, v = (x.float().reshape(n, l, nh, hd).transpose(1, 2)
               for x in qkv.split(hsz, -1))
    s = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd) + bias, -1)
    scale = 1.0 if u is None else torch.where(
        u < 1 - p, torch.full_like(u, 1 / (1 - p)), torch.zeros_like(u))
    do = dout.float().reshape(n, l, nh, hd).transpose(1, 2)
    sdp = (s * (do @ v.transpose(-1, -2)) * scale).abs()
    t = (sdp + s * sdp.sum(-1, keepdim=True)) / math.sqrt(hd)
    pd = (s * scale).abs()
    del s, sdp

    def back(x):
        return x.transpose(1, 2).reshape(n, l, hsz)
    return back(pd @ v.abs()), torch.cat(
        [back(t @ k.abs()), back(t.transpose(-1, -2) @ q.abs()),
         back(pd.transpose(-1, -2) @ do.abs())], -1)


@pytest.mark.parametrize("dropout", [True, False], ids=["dropout", "eval"])
@pytest.mark.parametrize("raw", [True, False], ids=["raw_mask", "min_mask"])
@pytest.mark.parametrize("shape", [(128, 8, 96, 170, 70),
                                   (8, 12, 64, 512, None),
                                   (5, 3, 64, 37, 9)],
                         ids=["cell", "bert512", "odd"])
def test_pair_attention_matches_plain(cuda, shape, raw, dropout):
    """KA1 (``ops/pair_attention.py``, forward and backward) against the
    plain chain on the same qkv, bias and uniforms: the cell's chunk (128
    pairs, 8 heads of 96, 70 caption slots + 100 regions), the full BERT
    (12 heads of 64, L 512) and an odd L. The rounding points are the
    same, so the two differ by float32 summation order only: the
    context within one bf16 ulp of the plain float32 context (its
    bf16 rounding may flip) plus 1e-5 * |pd| . |v| (sum order); dv the
    same against |pd|^T . |dO|; dq and dk within one ulp plus 2^-7 of
    the terms they sum (a sum-order difference in the softmax's sums may
    flip the bf16 roundings of the logit's gradient and of its
    1 / sqrt(hd) product, one ulp each); at least 99% of each equal to
    the plain one in bf16 (a flip needs a float32 sum within a few
    float32 ulps of a bf16 rounding boundary). Two launches give the
    same bits, one launch each way a call."""
    from locov_torch.ops import pair_attention as pa
    n, nh, hd, l, cap = shape
    p = 0.1
    qkv, bias = _attention_inputs(cuda, n, nh, hd, l, raw, cap)
    u = torch.rand((n, nh, l, l), generator=cuda,
                   device="cuda") if dropout else None
    dout = torch.randn((n, l, nh * hd), generator=cuda,
                       device="cuda").to(torch.bfloat16)
    torch.full((n, l, 3 * nh * hd), math.nan, dtype=torch.bfloat16,
               device="cuda")  # freed: the outputs may reuse NaN memory
    before = dict(kernel_lib.LAUNCHES)
    x = qkv.clone().requires_grad_(True)
    got = pa._PairAttention.apply(x, bias.reshape(n, l), u, nh, p)
    got.backward(dout)
    assert kernel_lib.LAUNCHES["pair_attention"] == \
        before["pair_attention"] + 1
    assert kernel_lib.LAUNCHES["pair_attention_bwd"] == \
        before["pair_attention_bwd"] + 1
    again, saved = pa.pair_attention_cuda(qkv, bias.reshape(n, l), u, nh, p)
    dagain = pa.pair_attention_bwd_cuda(qkv, bias.reshape(n, l), saved,
                                        dout, nh, p)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert torch.equal(x.grad.view(torch.int16), dagain.view(torch.int16))

    y = qkv.clone().requires_grad_(True)
    want = pa.pair_attention_plain(y, bias, nh, p, u)
    want.backward(dout.float())
    mag_ctx, mag_grad = _attention_magnitudes(qkv, bias, u, nh, p, dout)
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    g = got.float()
    err = (g - want).abs()
    tol = _bf16_ulp(torch.maximum(g.abs(), want.abs())) + 1e-5 * mag_ctx
    assert bool((err <= tol).all()), (err - tol).max().item()
    same = (got == want.to(torch.bfloat16)).float().mean().item()
    assert same >= 0.99, same
    dg, dw = x.grad.float(), y.grad.float()
    err = (dg - dw).abs()
    ulp = _bf16_ulp(torch.maximum(dg.abs(), dw.abs()))
    h = nh * hd
    for name, sl, rel, share in (("dq", slice(0, h), 2 ** -7, 0.99),
                                 ("dk", slice(h, 2 * h), 2 ** -7, 0.99),
                                 ("dv", slice(2 * h, 3 * h), 1e-5, 0.99)):
        e, t = err[..., sl], ulp[..., sl] + rel * mag_grad[..., sl]
        assert bool((e <= t).all()), (name, (e - t).max().item())
        same = (dg[..., sl] == dw[..., sl]).float().mean().item()
        assert same >= share, (name, same)


def test_pairwise_chunk_matches_unchunked_under_grad_on_the_card(cuda):
    """The port's twin of tests/test_transformer_head.py's test of the
    same name, on the card in bfloat16 through KA1: the TransformerHead
    (2 layers, 2 heads of 64, 4 x 4 pairs, dropout 0 as there) with
    ``pairwise_chunk`` 4 (4 chunks under ``bert.remat``, each forward
    run again in the backward) against one pass: the loss within 1e-3
    and each gradient within 2^-6 of its tensor's largest value (bf16
    dense products whose cuBLAS kernel may change with the chunk's row
    count: one bf16 ulp, 2^-8, at a rounding, carried through two
    layers). KA1 launched 2 x 4 x 2 times forward and 2 x 4 backward
    chunked, 2 and 2 in one pass."""
    from locov_torch.models.bert import BertConfig
    from locov_torch.models.mmss.transformer_head import (
        TransformerHead, TransformerHeadConfig)
    from locov_torch.structures.batches import (CaptionFeatures,
                                                RegionFeatures)
    from locov_torch.utils.weights import seeded_init_
    b, r, w, d, vocab = 4, 6, 8, 128, 60
    bert = BertConfig(vocab_size=vocab, hidden_size=d, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, dtype=torch.bfloat16)

    def normal(*s):
        return torch.randn(s, generator=cuda, device="cuda")
    ids = torch.randint(5, vocab, (b, w), generator=cuda, device="cuda")
    caption = CaptionFeatures(
        input_ids=ids, attention_mask=torch.ones_like(ids),
        special_tokens_mask=torch.zeros_like(ids), target_ids=ids,
        mlm_mask=(torch.rand(b, w, generator=cuda, device="cuda")
                  < 0.3).int(), encoded_tokens=normal(b, w, d),
        input_embeddings=normal(b, w, d))
    feats = normal(b, r, 32)
    regions = RegionFeatures(features=feats,
                             mask=torch.ones(b, r, device="cuda"),
                             loc=torch.rand(b, r, 2, generator=cuda,
                                            device="cuda"))
    word = normal(vocab, d)
    outs = {}
    for chunk in (0, 4):
        tcfg = TransformerHeadConfig(bert=bert, mmm_loss="cross_entropy",
                                     return_dist=True, pairwise_chunk=chunk)
        head = seeded_init_(TransformerHead(tcfg, v_dim=32, l_dim=d), 0)
        head = head.cuda()
        f = feats.clone().requires_grad_(True)
        before = dict(kernel_lib.LAUNCHES)
        _, losses, _ = head(regions._replace(features=f), caption, word,
                            deterministic=False)
        loss = sum(losses.values())
        loss.backward()
        torch.cuda.synchronize()
        outs[chunk] = (loss.item(), f.grad.clone(),
                       {k: p.grad.clone() for k, p in
                        head.named_parameters() if p.grad is not None},
                       {k: kernel_lib.LAUNCHES[k] - before[k] for k in
                        ("pair_attention", "pair_attention_bwd")})
    (l0, g0, p0, n0), (l4, g4, p4, n4) = outs[0], outs[4]
    assert n0 == {"pair_attention": 2, "pair_attention_bwd": 2}
    assert n4 == {"pair_attention": 16, "pair_attention_bwd": 8}
    assert abs(l4 - l0) <= 1e-3 * max(1.0, abs(l0))
    assert set(p0) == set(p4)
    for k, a, c in [("features", g0, g4)] + [(k, p0[k], p4[k]) for k in p0]:
        assert (c - a).abs().max() <= 2 ** -6 * a.abs().max() + 1e-12, k


def test_joint_encoder_routes_through_the_kernel(cuda):
    """One pass of the global scope's joint encoder at the LSM cell's
    shapes (``tools/bench_pairwise.py:build``: 32 x 32 pairs, chunk 128,
    70 tokens + 100 regions, dropout live): 8 chunks x 6 layers forward
    and again in the remat recompute, 96 KA1 forward launches and 48
    backward; the same encoder in float32 launches none."""
    from locov_torch.models.bert import BertConfig, BertSelfAttention
    from locov_torch.tools.bench_pairwise import build
    head, image, caption, word = build(32, 128, 100, 70, "cuda")
    before = dict(kernel_lib.LAUNCHES)
    _, losses, _ = head(image, caption, word, deterministic=False,
                        generator=cuda)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    got = {k: kernel_lib.LAUNCHES[k] - before[k]
           for k in ("pair_attention", "pair_attention_bwd")}
    assert got == {"pair_attention": 96, "pair_attention_bwd": 48}
    del head, image, caption, word, losses
    att = BertSelfAttention(BertConfig(hidden_size=192,
                                       num_attention_heads=2)).cuda()
    before = dict(kernel_lib.LAUNCHES)
    y = att(torch.randn(2, 9, 192, generator=cuda, device="cuda"),
            torch.zeros(2, 1, 1, 9, device="cuda"), False, cuda)
    assert y.dtype == torch.float32
    assert kernel_lib.LAUNCHES == before


# ------------------------------------------------------------------ KA2
@pytest.mark.parametrize("n,grid", [(200, (14, 14)), (8, (64, 64)),
                                    (3, (5, 9)), (4, (19, 23)), (2, (5, 64))],
                         ids=["windows", "global", "oblong", "ragged",
                              "ragged64"])
def test_rel_attention_matches_plain(cuda, n, grid):
    """KA2 against ``rel_attention_plain`` on the same bfloat16 qkv and
    float32 position tables (the plain route builds the bias terms with
    ``rel_pos_terms``, the kernel from q and the tables), at ViTDet-B's
    windowed (200 windows of 14 x 14) and global (8 maps of 64 x 64)
    shapes, 12 heads of 64, an oblong window, a 19 x 23 grid (kh != kw,
    L = 437 a multiple of no tile, a ragged last key and query tile) and a
    5 x 64 grid (the 64-wide path with half its last key tile past L).
    The bias terms' standard deviation is about 1.2, the scaled q . k's
    about 2.3.
    Tolerance: 2^-8 (|plain| + max|v|) at each element, twice the
    bfloat16 rounding the kernel adds: the context's own rounding (2^-9
    |ctx|) and each probability's rounding to bfloat16 for the product
    with v, which moves the context by at most 2^-9 max|v|. The same
    bits on a second launch."""
    from locov_torch.ops.rel_attention import (rel_attention,
                                               rel_attention_cuda,
                                               rel_attention_plain)
    kh, kw = grid
    l, nh, hd = kh * kw, 12, 64
    qkv = torch.randn(n, l, 3 * nh * hd, generator=cuda, device="cuda")
    qkv = (qkv * 1.5).to(torch.bfloat16)
    rh = torch.randn(2 * kh - 1, hd, generator=cuda, device="cuda") * 0.1
    rw = torch.randn(2 * kw - 1, hd, generator=cuda, device="cuda") * 0.1
    before = dict(kernel_lib.LAUNCHES)
    got = rel_attention(qkv, rh, rw, nh, grid)
    assert kernel_lib.LAUNCHES["rel_attention"] == \
        before["rel_attention"] + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, l, nh * hd)
    vmax = float(qkv[..., 2 * nh * hd:].float().abs().max())
    step = max(1, 4096 * 4096 // (l * l))
    for i in range(0, n, step):
        want = rel_attention_plain(qkv[i:i + step].float(), rh, rw, nh,
                                   grid)
        err = (got[i:i + step].float() - want).abs()
        assert bool((err <= 2 ** -8 * (want.abs() + vmax)).all()), \
            float(err.max())
    assert _same_bits(rel_attention_cuda(qkv, rh, rw, nh, grid), got)


def test_vit_blocks_never_build_the_bias_terms_on_the_card(cuda,
                                                           monkeypatch):
    """A windowed and a global ``models/vit.py:Block`` of ViTDet-B's
    width on a 64 x 64 map, bfloat16 on the card: ``rel_pos_terms``
    (patched to raise on a CUDA tensor) is never called, and each block
    is exactly one KA2 launch."""
    from locov_torch.models import vit as vit_mod
    from locov_torch.ops import rel_attention as ra
    plain_terms = ra.rel_pos_terms

    def cpu_only(q, *args):
        if q.is_cuda:
            raise AssertionError("rel_pos_terms called on the card")
        return plain_terms(q, *args)
    monkeypatch.setattr(ra, "rel_pos_terms", cpu_only)
    x = torch.randn(1, 64, 64, 768, generator=cuda, device="cuda")
    for window in (14, 0):
        block = vit_mod.Block(768, 12, 4.0, window, 64, torch.bfloat16,
                              "ViTDetRCNN").cuda()
        before = kernel_lib.LAUNCHES["rel_attention"]
        with torch.no_grad():
            y = block(x)
        torch.cuda.synchronize()
        assert kernel_lib.LAUNCHES["rel_attention"] == before + 1
        assert y.shape == x.shape and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_levels_matches_each_level(cuda, dtype):
    """K2 across levels in one launch: each box's output the same bits as
    the single-map kernel on its own level, and within the plain
    version's tolerance (as for K2) of ``roi_align_levels_plain``."""
    from locov_torch.ops.roi_align import (roi_align_levels,
                                           roi_align_levels_plain)
    sides, b, n, c = (96, 48, 24, 12), 2, 300, 256
    feats = [torch.randn(b, s, s, c, generator=cuda, device="cuda")
             .to(dtype) for s in sides]
    xy = torch.rand(b, n, 2, generator=cuda, device="cuda") * 380
    wh = torch.rand(b, n, 2, generator=cuda, device="cuda") ** 2 * 380 + 1
    boxes = torch.cat([xy, xy + wh], -1)
    levels = torch.randint(0, 4, (b, n), generator=cuda, device="cuda",
                           dtype=torch.int32)
    scales = [0.25, 0.125, 0.0625, 0.03125]
    before = dict(kernel_lib.LAUNCHES)
    got = roi_align_levels(feats, boxes, levels, scales, 7, 0)
    assert kernel_lib.LAUNCHES["roi_align_levels"] == \
        before["roi_align_levels"] + 1
    assert kernel_lib.LAUNCHES["roi_align_fused"] == before["roi_align_fused"]
    for lvl in range(4):
        one = roi_align_cuda(feats[lvl], boxes, scales[lvl], 7, 0)
        sel = levels == lvl
        assert _same_bits(got[sel], one[sel])
    want = roi_align_levels_plain([f.float() for f in feats], boxes, levels,
                                  scales, 7, 0)
    fmax = max(float(f.float().abs().max()) for f in feats)
    tol = 1e-5 * fmax
    if dtype == torch.bfloat16:
        tol = torch.maximum(torch.full_like(want, tol),
                            want.abs() * 2 ** -7)
    assert bool(((got.float() - want).abs() <= tol).all())


def test_vitdet_inference_launches_and_memory(cuda):
    """One ``ViTDetRCNN.inference`` call at the published widths on 8
    images of 1024 x 1024 (seeded weights): each of the 12 blocks' attention
    is one KA2 launch, the pooling one launch across P2-P5, and no
    [8, 12, 4096, 4096] float32 score tensor (6.4 GB) is ever held: the
    call's peak stays under it."""
    from locov_torch.config import config_path, get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.structures import batches as types
    from locov_torch.utils.weights import seeded_init_
    cfg = get_cfg()
    cfg.merge_from_file(config_path("vitdet_b_stt.yaml"))
    model = seeded_init_(build_meta_arch(cfg, device="cuda"), 0).eval()
    img = np.zeros((8, 1024, 1024, 3), np.float32)
    img[:, :768] = np.random.default_rng(0).integers(0, 256, (8, 768, 1024,
                                                              3))
    batch = types.to_torch(types.DetectionBatch(images=types.ImageBatch(
        image=img, hw=np.tile(np.array([[768, 1024]], np.int32), (8, 1)),
        orig_hw=np.tile(np.array([[480, 640]], np.int32), (8, 1)))), "cuda")
    emb = torch.randn(66, 768, generator=cuda, device="cuda") * 4
    model.inference(batch, emb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(kernel_lib.LAUNCHES)
    dets = model.inference(batch, emb)
    torch.cuda.synchronize()
    got = {k: kernel_lib.LAUNCHES[k] - before[k] for k in before}
    assert got["rel_attention"] == 12 and got["roi_align_levels"] == 1
    assert got["roi_align_fused"] == 0
    assert torch.cuda.max_memory_allocated() - base < 8 * 12 * 4096 ** 2 * 4
    assert dets.boxes.shape == (8, 100, 4)
