"""PyTorch port vs JAX: the int8 serving mode's operators on the CPU.

The quantizers, ``conv_int8`` (``locov::conv_int8``, whose CPU
implementation is the plain version of the CUDA kernel KQ1) and the int8
ROIAlign (``locov::roi_align_int8``, KQ2's plain version) on the same
numpy inputs as ``locov_tpu/ops/int8_conv.py`` and
``locov_tpu/ops/roi_align.py``. Both packages compute the int8 values and
int32 sums exactly, so those are held bit for bit. The float epilogues
are the same float32 operations in the same order, so the outputs are
held bit for bit too (float32 and bfloat16: equal bits were seen in
both). The whole int8 ROIAlign builds its interpolation matrices in
float32 in each package, which differ by up to 1e-7
(``test_torch_roi_align.py``); a row step that flips there can carry
through both contractions, so it is held within 2 int8 steps of JAX's
(the share of elements that differ and the largest difference are
reported)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import int8_conv as jq
from locov_tpu.ops import roi_align as jra
from locov_torch.ops import int8_conv as tq
from locov_torch.ops import roi_align as tra
from test_int8 import _np_conv_int8
from torch_parity import n, t

CASES = [(1, 1), (3, 1), (1, 2), (3, 2)]


def _bits(x):
    """The bits of a float32 or bfloat16 array (torch or numpy)."""
    if isinstance(x, torch.Tensor):
        return n(x.view({4: torch.int32, 2: torch.int16}[x.element_size()]))
    x = np.asarray(x)
    return x.view({4: np.int32, 2: np.int16}[x.dtype.itemsize])


def test_quantize_per_tensor_ties_and_zeros():
    # amax 127 -> scale 1: every value is an exact tie or integer
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -3.5, 126.5, 3.0,
                  -127.0], np.float32)
    q, s = tq.quantize_per_tensor(t(x))
    qj, sj = jq.quantize_per_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(n(q), np.asarray(qj))
    assert n(q).tolist() == [127, 0, 2, 2, 0, -2, -4, 126, 3, -127]
    assert _bits(s) == _bits(sj)
    # seeded tensors, and the static quantizer at a clipping amax
    rng = np.random.RandomState(0)
    for shape in ((3, 5, 7, 8), (64,)):
        x = rng.randn(*shape).astype(np.float32) * 3
        q, s = tq.quantize_per_tensor(t(x))
        qj, sj = jq.quantize_per_tensor(jnp.asarray(x))
        np.testing.assert_array_equal(n(q), np.asarray(qj))
        assert _bits(s) == _bits(sj)
        amax = np.float32(np.abs(x).max() * 0.6)
        q, s = tq.quantize_per_tensor_static(t(x), t(amax))
        qj, sj = jq.quantize_per_tensor_static(jnp.asarray(x),
                                               jnp.asarray(amax))
        np.testing.assert_array_equal(n(q), np.asarray(qj))
        assert _bits(s) == _bits(sj)
        assert (np.abs(n(q)) == 127).any()
    # zero-safe (as test_quantizers_zero_safe)
    q, s = tq.quantize_per_tensor(torch.zeros(2, 3))
    assert (n(q) == 0).all() and np.isfinite(n(s)) and n(s) > 0
    qw, sw = tq.quantize_weight_per_channel(torch.zeros(4, 3, 1, 1))
    assert (n(qw) == 0).all() and np.isfinite(n(sw)).all()


def test_quantize_weight_per_channel_matches_jax():
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 3, 6, 5) * rng.rand(5) ** 2).astype(np.float32)
    w[..., 2] = 0.0  # a zero output channel
    w[0, 0, 0, 4] = 0.5 * np.abs(w[..., 4]).max()  # not a tie by itself
    q, s = tq.quantize_weight_per_channel(t(w.transpose(3, 2, 0, 1)))
    qj, sj = jq.quantize_weight_per_channel(jnp.asarray(w))
    np.testing.assert_array_equal(n(q), np.asarray(qj).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(_bits(s), _bits(sj))
    assert (n(q)[2] == 0).all() and n(s)[2] == np.float32(1e-12)


def test_static_equals_dynamic_with_true_amax():
    rng = np.random.RandomState(2)
    x = t(rng.randn(2, 8, 8, 16).astype(np.float32))
    w = t(rng.randn(4, 16, 3, 3).astype(np.float32))
    dyn = tq.conv_int8(x, w, 1, 1)
    sta = tq.conv_int8(x, w, 1, 1, amax=x.abs().amax())
    assert torch.equal(dyn, sta)


def _inputs(seed, k, c=16, o=24):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 9, 11, c).astype(np.float32)
    w = (rng.randn(k, k, c, o) * rng.rand(o)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["dynamic", "static", "quantized"])
@pytest.mark.parametrize("k,stride", CASES)
def test_conv_int8_matches_jax(k, stride, scheme, dtype):
    """The int8 input and the int32 sums equal JAX's; the output has
    JAX's bits (float32 and bfloat16 alike)."""
    x, w = _inputs(k * 10 + stride, k)
    pad = (k - 1) // 2
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, xt = jnp.asarray(x).astype(jdt), t(x).to(tdt)
    wt = t(w.transpose(3, 2, 0, 1))
    amax = np.float32(np.abs(x).max() * 0.8)
    kw = {}
    if scheme == "static":
        kw = dict(amax=amax)
        qj, sj = jq.quantize_per_tensor_static(xj, jnp.asarray(amax))
        qt, st = tq.quantize_per_tensor_static(xt, t(amax))
    else:
        qj, sj = jq.quantize_per_tensor(xj)
        qt, st = tq.quantize_per_tensor(xt)
    np.testing.assert_array_equal(n(qt), np.asarray(qj))
    assert _bits(st) == _bits(sj)
    wqj, _ = jq.quantize_weight_per_channel(jnp.asarray(w))
    acc_j = np.asarray(jq._int8_conv_core(qj, wqj, stride, pad))
    wqt, _ = tq.quantize_weight_per_channel(wt)
    acc_t = tq.conv_int8_acc(qt, wqt.permute(0, 2, 3, 1), stride, pad)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(n(acc_t), acc_j)

    if scheme == "quantized":
        want = jq.conv_int8(jq.QuantizedTensor(qj, sj), jnp.asarray(w),
                            stride, pad, out_dtype=jdt)
        got = tq.conv_int8(tq.QuantizedTensor(qt, st), wt, stride, pad,
                           out_dtype=tdt)
    else:
        want = jq.conv_int8(xj, jnp.asarray(w), stride, pad,
                            amax=(jnp.asarray(amax) if kw else None))
        got = tq.conv_int8(xt, wt, stride, pad,
                           amax=(t(amax) if kw else None))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k,stride", CASES)
def test_conv_int8_matches_numpy_scheme(k, stride):
    """test_int8.py's numpy reference of the scheme (rtol = atol =
    1e-6, as test_conv_int8_exact_vs_numpy)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 10, 6).astype(np.float32)
    w = rng.randn(k, k, 6, 12).astype(np.float32)
    pad = (k - 1) // 2
    got = tq.conv_int8(t(x), t(w.transpose(3, 2, 0, 1)), stride, pad)
    np.testing.assert_allclose(n(got), _np_conv_int8(x, w, stride, pad),
                               rtol=1e-6, atol=1e-6)


def test_conv_int8_close_to_f32():
    """Within JAX's 2% of the float conv (test_conv_int8_close_to_f32)."""
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(2, 14, 14, 32)).astype(np.float32)
    w = (rng.randn(3, 3, 32, 16) * rng.rand(16) ** 2).astype(np.float32)
    wt = t(w.transpose(3, 2, 0, 1))
    got = n(tq.conv_int8(t(x), wt, 1, 1))
    want = n(torch.nn.functional.conv2d(
        t(x).permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1))
    assert np.abs(got - want).mean() / np.abs(want).mean() < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_int8_epilogue(dtype):
    """Shift and relu in the op's epilogue: the output rounded once to
    the dtype, the shift added in that dtype, then relu, as
    ``models/resnet.py`` adds them after the JAX function."""
    x, w = _inputs(5, 3)
    rng = np.random.RandomState(6)
    shift = t(rng.randn(24).astype(np.float32)).to(dtype)
    wt = t(w.transpose(3, 2, 0, 1))
    got = tq.conv_int8(t(x).to(dtype), wt, 2, 1, shift=shift, relu=True)
    want = torch.relu(tq.conv_int8(t(x).to(dtype), wt, 2, 1) + shift)
    assert torch.equal(got, want) and (got == 0).any() and (got > 0).any()
    op = torch.ops.locov.conv_int8
    xq, sx = tq.quantize_per_tensor(t(x))
    wq, sw = tq.quantize_weight_per_channel(wt)
    args = (xq, wq.permute(0, 2, 3, 1).contiguous(), sx * sw, shift, 2, 1,
            True)
    torch.library.opcheck(op, args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake, fake_q = op(*(mode.from_tensor(a)
                            if isinstance(a, torch.Tensor) else a
                            for a in args))
    assert fake.shape == got.shape and fake.dtype == dtype
    assert tuple(fake_q.shape) == (0,) and fake_q.dtype == torch.int8


# (case, kernel size, residual, float output, amax / max|y|): conv1 and
# conv2 write only int8 (relu, no residual); conv3 adds the shortcut and
# writes the block output and its int8 copy, or only the copy; amax 0
# takes the 1e-12 floor; a small amax saturates
FUSED = [("conv1", 1, False, False, 0.7), ("conv2", 3, False, False, 0.9),
         ("conv3", 1, True, True, 0.7), ("conv3_int8", 1, True, False, 0.8),
         ("zero_amax", 1, True, True, 0.0),
         ("saturating", 3, False, True, 0.05)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,k,residual,float_out,factor", FUSED)
def test_conv_int8_fused_epilogue(case, k, residual, float_out, factor,
                                  dtype):
    """``locov::conv_int8`` with the residual and the next conv's
    quantize in its epilogue, on the CPU, bit for bit against the
    composition it replaces (``conv_int8`` with the shift, ``+
    residual``, relu, ``quantize_per_tensor_static``) and against JAX's
    ``quantize_per_tensor_static(relu(conv_int8(...) + shift + sc))``,
    eagerly; ``opcheck`` and the fake's shapes."""
    x, w = _inputs(40 + k, k)
    rng = np.random.RandomState(41)
    pad = (k - 1) // 2
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xt, wt = t(x).to(tdt), t(w.transpose(3, 2, 0, 1))
    shift = rng.randn(24).astype(np.float32)
    sc = (rng.randn(2, 9, 11, 24) * 2).astype(np.float32)
    y = tq.conv_int8(xt, wt, 1, pad, shift=t(shift).to(tdt))
    if residual:
        y = y + t(sc).to(tdt)
    y = torch.relu(y)
    amax = np.float32(float(y.float().abs().max()) * factor)
    q_want, s_want = tq.quantize_per_tensor_static(y, t(amax))
    out, got = tq.conv_int8(xt, wt, 1, pad, shift=t(shift).to(tdt),
                            relu=True,
                            residual=t(sc).to(tdt) if residual else None,
                            out_amax=t(amax), float_out=float_out)
    assert isinstance(got, tq.QuantizedTensor) and got.q.dtype == torch.int8
    assert torch.equal(got.q, q_want) and _bits(got.scale) == _bits(s_want)
    if float_out:
        np.testing.assert_array_equal(_bits(out), _bits(y))
    else:
        assert out is None

    jy = jq.conv_int8(jnp.asarray(x).astype(jdt), jnp.asarray(w), 1, pad)
    jy = jy + jnp.asarray(shift).astype(jdt)
    if residual:
        jy = jy + jnp.asarray(sc).astype(jdt)
    jy = jnp.maximum(jy, 0)
    qj, sj = jq.quantize_per_tensor_static(jy, jnp.asarray(amax))
    np.testing.assert_array_equal(n(got.q), np.asarray(qj))
    assert _bits(got.scale) == _bits(sj)
    np.testing.assert_array_equal(_bits(y), _bits(jy))
    if case == "zero_amax":
        assert float(got.scale) == np.float32(1e-12)
        assert set(np.unique(np.abs(n(got.q)))) <= {0, 127}
    if case == "saturating":
        assert (np.abs(n(got.q)) == 127).mean() > 0.1

    xq, sx = tq.quantize_per_tensor(xt)
    wq, sw = tq.quantize_weight_per_channel(wt)
    args = (xq, wq.permute(0, 2, 3, 1).contiguous(), sx * sw,
            t(shift).to(tdt), 1, pad, True,
            t(sc).to(tdt) if residual else None, t(amax), float_out)
    op = torch.ops.locov.conv_int8
    torch.library.opcheck(op.default, args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fo, fq = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                      else a for a in args))
    assert tuple(fq.shape) == tuple(got.q.shape) and fq.dtype == torch.int8
    assert tuple(fo.shape) == (tuple(y.shape) if float_out else (0,))
    assert fo.dtype == tdt


def _int8_at(rng, shape, offset):
    """Seeded int8 values of ``shape`` in a view ``offset`` bytes into a
    fresh buffer."""
    size = int(np.prod(shape))
    buf = torch.empty(size + offset, dtype=torch.int8)[offset:]
    return buf.view(shape).copy_(torch.from_numpy(
        rng.randint(-127, 128, size=shape).astype(np.int8)))


@pytest.mark.parametrize("c,offset", [(8, 0), (12, 0), (6, 3), (16, 0),
                                      (48, 0), (16, 1)])
def test_kernel_operands_pad_and_align(c, offset):
    """The operands the int8 conv kernel is handed (``kernel_operands``):
    C padded with zero channels to a multiple of 16, and any operand not
    16-byte aligned copied; the plain output of the padded operands has
    the bits of the original ones (zeros leave the int32 sums exact).
    Operands the kernel takes as they are pass through uncopied."""
    rng = np.random.RandomState(c + offset)
    xq = _int8_at(rng, (2, 5, 6, c), offset)
    wq = _int8_at(rng, (20, 3, 3, c), offset)
    res = torch.from_numpy(rng.randn(2, 5, 6, 20).astype(np.float32))
    if offset:
        res = torch.empty(res.numel() + 1)[1:].view(res.shape).copy_(res)
    px, pw, pr = tq.kernel_operands(xq, wq, res)
    cp = px.shape[3]
    assert cp % 16 == 0 and c <= cp < c + 16 and pw.shape[3] == cp
    for a in (px, pw, pr):
        assert a.data_ptr() % 16 == 0 and a.is_contiguous()
    assert torch.equal(px[..., :c], xq) and not px[..., c:].any()
    assert torch.equal(pw[..., :c], wq) and not pw[..., c:].any()
    assert torch.equal(pr, res)
    if c % 16 == 0 and offset == 0:
        assert px is xq and pw is wq and pr is res
    scale = torch.from_numpy(rng.rand(20).astype(np.float32) * 1e-3)
    shift = torch.from_numpy(rng.randn(20).astype(np.float32))
    want = tq.conv_int8_plain(xq, wq, scale, shift, 1, 1, True, res)
    got = tq.conv_int8_plain(px, pw, scale, shift, 1, 1, True, pr)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------------------- ROIAlign
def _roi_inputs(seed, c=16):
    rng = np.random.RandomState(seed)
    feat = (rng.randn(2, 24, 28, c) * 3.0).astype(np.float32)
    boxes = (rng.rand(2, 25, 4) * 80).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.rand(2, 25, 2) * 60 + 2
    boxes[0, 3] = [10.0, 10.0, 10.0, 10.0]  # degenerate (zero-size)
    boxes[1, 5] = [-30.0, -20.0, -5.0, -2.0]  # outside the image
    return feat, boxes


@pytest.mark.parametrize("sampling_ratio,chunk", [(0, 200), (2, 200),
                                                  (0, 8), (2, 16)])
def test_roi_align_int8_core_matches_jax(sampling_ratio, chunk):
    """The integer core fed JAX's own int8 matrices, row scales and
    quantized features returns JAX's int8 output bit for bit, whatever
    its box chunk (the port's plain core takes other chunks too); the op,
    which builds its matrices from the boxes, does too on JAX's quantized
    features (the matrices are JAX's at these ratios:
    ``test_roi_align_int8_matrices_match_jax``)."""
    feat, boxes = _roi_inputs(sampling_ratio * 10 + chunk)
    amax_in = np.float32(np.abs(feat).max() * 0.9)
    amax_pool = np.float32(np.abs(feat).max() * 0.5)
    want, s_pool = jra.roi_align_batched_int8(
        jnp.asarray(feat), jnp.asarray(boxes), 0.25, jnp.asarray(amax_in),
        jnp.asarray(amax_pool), pooled=7, sampling_ratio=sampling_ratio,
        chunk=chunk)
    ky, kx = jra._build_kernels(jnp.asarray(boxes), 0.25, 24, 28, 7,
                                sampling_ratio)
    kyq, sy = jra._quantize_rows(ky)
    kxq, sx = jra._quantize_rows(kx)
    fq, s_f = jq.quantize_per_tensor_static(jnp.asarray(feat),
                                            jnp.asarray(amax_in))
    ratio = t(np.asarray(s_f)) / t(np.asarray(s_pool))
    rescale = ratio * t(np.asarray(sy))
    for pc in (chunk, 3):
        got = tra.roi_align_int8_plain(t(np.asarray(fq)), t(np.asarray(kyq)),
                                       t(np.asarray(kxq)), t(np.asarray(sx)),
                                       rescale, chunk=pc)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(n(got), np.asarray(want))
    got = torch.ops.locov.roi_align_int8(
        t(np.asarray(fq)), t(boxes), ratio.reshape(1), 0.25, 7,
        sampling_ratio)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert (np.abs(np.asarray(want)) > 50).any()


# sampling ratio -> the largest number of row scales (sx and the rescale)
# that differ from JAX's, by at most two float32 ulps, over the four seeds
MATRIX_CASES = {0: 0, 2: 0, 3: 86}


@pytest.mark.parametrize("sampling_ratio", sorted(MATRIX_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_roi_align_int8_matrices_match_jax(sampling_ratio, seed):
    """The int8 path's own builder (``int8_matrices``: each bin's samples
    added in ascending order, as the kernel adds them) against JAX's
    ``_quantize_rows(_build_kernels(...))``: the same int8 matrices. The
    row scales are JAX's bits under adaptive sampling and at a fixed ratio
    of 2; at a fixed ratio of 3 JAX averages the samples' sum (divides it
    by 3) where the port weighs each sample by 1/3 (the float kernels'
    tap code), which moves some row maxima, so their scales, by up to two
    ulps; no int8 weight moved."""
    _, boxes = _roi_inputs(seed)
    ky, kx = jra._build_kernels(jnp.asarray(boxes), 0.25, 24, 28, 7,
                                sampling_ratio)
    kyq, sy = jra._quantize_rows(ky)
    kxq, sx = jra._quantize_rows(kx)
    ratio = torch.tensor([0.7])
    tkyq, tkxq, tsx, trs = tra.int8_matrices(t(boxes), ratio, 0.25, 24, 28,
                                             7, sampling_ratio)
    np.testing.assert_array_equal(n(tkyq), np.asarray(kyq))
    np.testing.assert_array_equal(n(tkxq), np.asarray(kxq))
    want_rs = n(ratio.reshape(()) * t(np.asarray(sy)))
    moved = 0
    for got, want in ((n(tsx), np.asarray(sx)), (n(trs), want_rs)):
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
        moved += int((got != want).sum())
    assert moved <= MATRIX_CASES[sampling_ratio]


@pytest.mark.parametrize("sampling_ratio", [0, 2, 3])
def test_roi_align_int8_op_is_operands_then_core(sampling_ratio):
    """``locov::roi_align_int8`` on the CPU is ``int8_operands`` followed by
    the integer core ``roi_align_int8_plain``, bit for bit."""
    feat, boxes = _roi_inputs(21 + sampling_ratio)
    ft, bt = t(feat), t(boxes)
    amax_in, amax_pool = ft.abs().amax(), ft.abs().amax() * 0.5
    fq, kyq, kxq, sx, rescale, s_pool = tra.int8_operands(
        ft, bt, 0.25, amax_in, amax_pool, 7, sampling_ratio)
    want = tra.roi_align_int8_plain(fq, kyq, kxq, sx, rescale)
    ratio = (tq._scale_of(amax_in) / s_pool).reshape(1)
    got = torch.ops.locov.roi_align_int8(fq, bt, ratio, 0.25, 7,
                                         sampling_ratio)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    q, scale = tra.roi_align_batched_int8(ft, bt, 0.25, amax_in, amax_pool,
                                          7, sampling_ratio)
    assert torch.equal(q, want) and torch.equal(scale, s_pool)
    assert (want.abs() > 50).any()


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_roi_align_int8_and_quant_within_two_steps_of_jax(sampling_ratio,
                                                          capsys):
    feat, boxes = _roi_inputs(7 + sampling_ratio)
    fj, bj = jnp.asarray(feat), jnp.asarray(boxes)
    pooled_f = np.asarray(jra.roi_align_batched(
        fj, bj, 0.25, pooled=7, sampling_ratio=sampling_ratio))
    amax_in = np.float32(np.abs(feat).max())
    amax_pool = np.float32(np.abs(pooled_f).max())
    for name, want, got in (
            ("int8", jra.roi_align_batched_int8(
                fj, bj, 0.25, jnp.asarray(amax_in), jnp.asarray(amax_pool),
                pooled=7, sampling_ratio=sampling_ratio),
             tra.roi_align_batched_int8(
                 t(feat), t(boxes), 0.25, t(amax_in), t(amax_pool),
                 pooled=7, sampling_ratio=sampling_ratio)),
            ("quant", jra.roi_align_batched_quant(
                fj, bj, 0.25, jnp.asarray(amax_pool), pooled=7,
                sampling_ratio=sampling_ratio),
             tra.roi_align_batched_quant(
                 t(feat), t(boxes), 0.25, t(amax_pool), pooled=7,
                 sampling_ratio=sampling_ratio))):
        assert _bits(got[1]) == _bits(want[1])
        d = np.abs(n(got[0]).astype(np.int32) -
                   np.asarray(want[0]).astype(np.int32))
        with capsys.disabled():
            print(f"\n{name} sr {sampling_ratio}: {np.mean(d > 0):.2e} of "
                  f"elements differ from JAX's, by at most {d.max()}")
        assert d.max() <= 2


@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_roi_align_int8_within_budget_of_quant(sampling_ratio):
    """The port's int8 op against its own float-then-quantize op, at
    JAX's analytic budget (tests/test_roi_align.py): <= 3.5 steps of the
    larger scale, mean <= 0.5; the degenerate box gives zeros under
    adaptive sampling, and the op's fake gives its shape."""
    feat, boxes = _roi_inputs(11 + sampling_ratio)
    ft, bt = t(feat), t(boxes)
    pooled_f = tra.roi_align_batched(ft, bt, 0.25, 7, sampling_ratio)
    amax_in, amax_pool = ft.abs().amax(), pooled_f.abs().amax()
    q_ref, s_ref = tra.roi_align_batched_quant(ft, bt, 0.25, amax_pool, 7,
                                               sampling_ratio)
    q8, s8 = tra.roi_align_batched_int8(ft, bt, 0.25, amax_in, amax_pool, 7,
                                        sampling_ratio)
    assert q8.dtype == torch.int8 and q8.shape == q_ref.shape
    assert torch.equal(s8, s_ref)
    step = max(float(amax_in), float(amax_pool)) / 127.0
    diff = np.abs(n(q8).astype(np.float32) * float(s8) -
                  n(q_ref).astype(np.float32) * float(s_ref))
    assert diff.max() <= 3.5 * step + 1e-6
    assert diff.mean() <= 0.5 * step
    if sampling_ratio == 0:
        assert (n(q8)[0, 3] == 0).all()
    assert (n(q8)[1, 5] == 0).all()  # outside the image
    fq = tra.int8_operands(ft, bt, 0.25, amax_in, amax_pool, 7,
                           sampling_ratio)[0]
    ratio = (tq._scale_of(amax_in) / tq._scale_of(amax_pool)).reshape(1)
    args = (fq, bt, ratio, 0.25, 7, sampling_ratio)
    torch.library.opcheck(torch.ops.locov.roi_align_int8, args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.locov.roi_align_int8(
            *(mode.from_tensor(a) for a in args[:3]), *args[3:])
    assert fake.shape == q8.shape and fake.dtype == torch.int8


def test_int8_plans_match_the_kernel_sources():
    """The int8 ROIAlign wrapper's shared-memory count, bins, builder warp
    and argument types are the CUDA source's (its C entry refuses a
    launch whose shared memory differs; the wrapper refuses features that
    would exceed a block's); the conv wrapper's argument types are those
    of the conv kernel's C entry."""
    import ctypes
    import re
    from locov_torch.ops import kernel_lib

    def c_entry_kinds(src, name):
        params = re.search(r'extern "C" int %s\((.*?)\)' % name, src,
                           re.S).group(1).split(",")
        kinds = [{"int": ctypes.c_int, "float": ctypes.c_float}.get(
            p.split()[0], ctypes.c_void_p) for p in params]
        assert all("*" in p for p, k in zip(params, kinds)
                   if k is ctypes.c_void_p)
        return kinds

    with open(f"{kernel_lib.CSRC}/roi_align_int8.cu") as f:
        src = f.read()

    def body(sig):
        return " ".join(re.search(re.escape(sig) +
                                  r"\s*\{\s*return (.*?);\s*\}",
                                  src, re.S).group(1).split())
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
              for k in ("PMAX", "MAX_THREADS")}
    assert consts["PMAX"] == tra._INT8_PMAX
    assert consts["MAX_THREADS"] == max(tra._INT8_THREADS)
    env = dict(consts, round_up=lambda x, m: -(-x // m) * m)
    ops = body("inline int ops_bytes(int h, int w)")
    env["ops_bytes"] = lambda h, w: eval(ops, dict(env, h=h, w=w))
    smem = body("static int smem_bytes(int h, int w, int vec, int threads)")
    for h, w in ((50, 84), (84, 50), (250, 7), (1, 1), (7, 9)):
        for vec in (16, 8, 4):
            for tc in tra._INT8_THREADS:
                want = eval(smem, dict(env, h=h, w=w, vec=vec, threads=tc))
                assert tra._int8_smem(h, w, vec, tc) == want
    assert c_entry_kinds(src, "roi_align_int8_fwd") == \
        kernel_lib.argtypes("roi_align_int8_fwd")
    plan = tra._int8_plan(50, 84, 1024)
    assert plan["vec"] == 16 and plan["threads"] == 128
    assert plan["blocks_per_sm"] == 2  # 52 tq rows of 16 channels a thread
    assert tra._int8_plan(84, 50, 1024)["blocks_per_sm"] == 1
    assert tra._int8_plan(50, 84, 1024, align=8)["vec"] == 8
    assert tra._int8_plan(7, 9, 4)["threads"] == 32
    with pytest.raises(ValueError, match="pooled <= 16"):
        tra._int8_plan(50, 84, 1024, pooled=17)
    with open(f"{kernel_lib.CSRC}/conv_int8.cu") as f:
        src = f.read()
    assert c_entry_kinds(src, "conv_int8_fwd") == \
        kernel_lib.argtypes("conv_int8_fwd")
    assert "conv_int8" in kernel_lib.KERNELS
    assert "roi_align_int8" in kernel_lib.KERNELS


def test_kq2_ablations_apply_to_the_source(tmp_path, monkeypatch):
    """tools/ablate_roi_int8.py's copies of KQ2's source: a change or cut
    whose text the source holds once is applied in a copy under the build
    directory, one whose text it does not hold gives no copy (the tool
    leaves it out); its plans are launch plans the C entry takes."""
    from locov_torch.ops import kernel_lib
    from locov_torch.tools import ablate_roi_int8 as ab
    monkeypatch.setattr(kernel_lib, "BUILD_DIR",
                        str(tmp_path / "build" / "kernels"))
    with open(f"{kernel_lib.CSRC}/{ab.SRC}") as f:
        source = f.read()
    combined = {"phase_a+phase_b": ab.CUTS["phase_a"] + ab.CUTS["phase_b"]}
    for name, subs in {**ab.CHANGES, **ab.CUTS, **combined}.items():
        src = ab.write_variant(name, subs)
        if all(source.count(old) == 1 for old, _ in subs):
            assert src.startswith(str(tmp_path))
            with open(src) as f:
                text = f.read()
            assert all(new in text for _, new in subs)
        else:
            assert src is None
    line = "constexpr int PMAX = 16;"
    assert source.count(line) == 1
    src = ab.write_variant("pmax", [(line, "constexpr int PMAX = 15;")])
    with open(src) as f:
        assert "constexpr int PMAX = 15;" in f.read()
    assert ab.write_variant("absent", [("no such text", "")]) is None
    assert not (tmp_path / "build" / "ablate_roi_int8" / "absent").exists()
    for spec in ("128x16", "64x16", "128x8", "64x8"):
        plan = ab.plan_of(spec, 50, 84)
        threads, vec = (int(v) for v in spec.split("x"))
        assert plan["threads"] == threads
        assert plan["smem_bytes"] == tra._int8_smem(50, 84, vec, threads)
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    assert ab.plan_of("128x16", 50, 84) == tra._int8_plan(50, 84, 1024)


@pytest.mark.parametrize("h,w,c,align,want", [
    (108, 76, 1024, 16, (16, 128)), (109, 76, 1024, 16, (8, 128)),
    (120, 76, 1024, 16, (8, 128)), (250, 167, 1024, 16, (4, 128)),
    (500, 300, 1024, 16, (4, 64)), (120, 76, 1024, 8, (8, 128)),
    (1200, 76, 64, 16, (4, 32))])
def test_int8_plan_fits_tall_features(h, w, c, align, want):
    """Each thread holds h x vec bytes of tq rows: for tall features
    (TTA's sizes: h 114 at a 1824-pixel side) the plan halves the
    channels a thread, then the threads, until a block's shared memory
    holds them (neither twice the channels nor twice the threads would
    fit), and raises where nothing fits."""
    plan = tra._int8_plan(h, w, c, align=align)
    vec, threads = want
    assert (plan["vec"], plan["threads"]) == want
    assert plan["smem_bytes"] == tra._int8_smem(h, w, vec, threads)
    assert plan["smem_bytes"] <= tra._SMEM_MAX
    if 2 * vec <= min(16, align) and c % (2 * vec) == 0:
        assert tra._int8_smem(h, w, 2 * vec, threads) > tra._SMEM_MAX
    if 2 * threads <= max(tra._INT8_THREADS):
        assert tra._int8_smem(h, w, vec, 2 * threads) > tra._SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tra._int8_plan(2000, w, c, align=align)
