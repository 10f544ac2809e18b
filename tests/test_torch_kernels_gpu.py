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
The serving program split over two cards gives the one-card
program's bits on each half of the batch. The full-float32 products of
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
    block within 1e-5 * max|y| (float32); the NMS keep mask equal to the
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
        "nms_mask": ((nb, ns, nv, 0.5, 100, nc),
                     lambda *a: nms_mod.nms_mask_batched(
                         *(t.cpu() if torch.is_tensor(t) else t
                           for t in a)), None),
    }


@pytest.mark.parametrize("name", ["relu_maxpool", "relu_maxpool_bwd",
                                  "roi_align", "roi_align_bwd",
                                  "stem_conv_bn", "bottleneck_block",
                                  "nms_mask"])
def test_locov_ops_on_the_card(cuda, name):
    """Each ``torch.ops.locov`` op on CUDA tensors: ``opcheck`` (its fake
    implementation, registered autograd and schema against the real
    kernel), one kernel launch a call, and its output against the plain
    version at the tolerances of ``_op_cases``."""
    args, plain, kernel = _op_cases(cuda)[name]
    op = getattr(torch.ops.locov, name)
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
