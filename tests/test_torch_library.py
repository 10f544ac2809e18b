"""The port's ``locov::`` custom ops (``torch.library``) on the CPU.

Every kernel of the port and the NMS are custom ops, so that
``torch.export`` traces the models through them (``locov_torch/
serving.py``). Here, with CPU tensors (the CPU implementation of each is
its plain version): ``torch.library.opcheck`` (schema, fake
implementation against the real one, registered autograd, no aliasing)
on each op; each op's output and gradient bit-equal to the plain
function's and to the autograd Function each op replaced (an autograd
Function over the same plain forward and backward, as it ran on the
CPU); the NMS op's keep mask equal to JAX's; and the ops' fake
implementations giving the shapes and dtypes a trace needs. On the card
the same ops run the kernels: ``tests/test_torch_kernels_gpu.py``.

Also the kernel table of ``ops/kernel_lib.py`` held to the text of the
CUDA sources (no ``nvcc`` needed), and its launch function against a
fake library.
"""
import contextlib
import ctypes
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import nms as jnms
from locov_torch.ops import bottleneck_block as block_mod
from locov_torch.ops import kernel_lib
from locov_torch.ops import nms as tnms
from locov_torch.ops import relu_maxpool as pool_mod
from locov_torch.ops import roi_align as roi_mod
from locov_torch.ops import stem_conv_bn as stem_mod
from torch_parity import n, t

OPS = ("relu_maxpool", "relu_maxpool_bwd", "roi_align", "roi_align_bwd",
       "stem_conv_bn", "bottleneck_block", "nms_mask")


def _ties(gen, shape):
    """Values in -2..2 with NaNs and negative zeros among them."""
    x = torch.randint(-2, 3, shape, generator=gen).float()
    u = torch.rand(shape, generator=gen)
    x[u < 0.05] = float("nan")
    x[(u >= 0.05) & (u < 0.15)] = -0.0
    return x


def _bits(a, b):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


class _OldReluMaxPool(torch.autograd.Function):
    """The autograd Function the op replaced, as it ran on the CPU: the
    plain forward, and the plain backward by autograd of it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pool_mod.relu_maxpool_plain(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (dx,) = torch.autograd.grad(pool_mod.relu_maxpool_plain(xr),
                                        xr, dy)
        return torch.where(x > 0, dx, torch.zeros_like(dx))


class _OldRoIAlign(torch.autograd.Function):
    """The autograd Function the op replaced, as it ran on the CPU."""

    @staticmethod
    def forward(ctx, features, boxes, scale, pooled, sr):
        ctx.save_for_backward(boxes)
        ctx.args = (scale, features.shape[1], features.shape[2], pooled,
                    sr)
        return roi_mod.roi_align_batched(features, boxes, scale, pooled, sr)

    @staticmethod
    def backward(ctx, g):
        (boxes,) = ctx.saved_tensors
        return (roi_mod.roi_align_bwd_plain(g.contiguous(), boxes,
                                            *ctx.args),
                None, None, None, None)


class _OldStemConvBN(torch.autograd.Function):
    """The autograd Function the op replaced, as it ran on the CPU."""

    @staticmethod
    def forward(ctx, x, w, shift):
        ctx.save_for_backward(x, w)
        ctx.shift_dtype = shift.dtype
        return stem_mod.stem_conv_bn_plain(x, w, shift)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, dshift = stem_mod.stem_conv_bn_bwd_plain(x, w, g)
        return dx, dw, dshift.to(ctx.shift_dtype)


def _roi_inputs(gen, dtype=torch.float32):
    f = torch.randn((2, 9, 13, 6), generator=gen).to(dtype)
    lo = torch.rand((2, 5, 2), generator=gen) * 100
    wh = torch.rand((2, 5, 2), generator=gen) * 80 + 1
    return f, torch.cat([lo, lo + wh], -1)


def _nms_inputs(rng, b=2, n_=40):
    xy = rng.rand(b, n_, 2).astype(np.float32) * 50
    wh = rng.rand(b, n_, 2).astype(np.float32) * 30 + 1
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.rand(b, n_).astype(np.float32)
    valid = rng.rand(b, n_) > 0.1
    classes = rng.randint(0, 3, (b, n_)).astype(np.int32)
    return boxes, scores, valid, classes


def _block_inputs(gen, c=16, m=8):
    def r(*s):
        return torch.randn(s, generator=gen) * 0.2
    return (r(2, 5, 6, c), r(c, m), r(m), r(3, 3, m, m), r(m), r(m, c),
            r(c))


def test_every_kernel_and_the_nms_are_locov_ops():
    for name in OPS:
        assert hasattr(torch.ops.locov, name), name
    for mod, old in ((pool_mod, "_ReluMaxPool"), (roi_mod, "_RoIAlign"),
                     (stem_mod, "_StemConvBN")):
        assert not hasattr(mod, old)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_maxpool_op(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 7, 9, 4), generator=gen).to(dtype)
    torch.library.opcheck(torch.ops.locov.relu_maxpool.default,
                          (x.clone().requires_grad_(True),))
    torch.library.opcheck(torch.ops.locov.relu_maxpool_bwd.default,
                          (x, torch.randn((2, 4, 5, 4), generator=gen
                                          ).to(dtype)))
    for x in (_ties(gen, (2, 9, 11, 5)).to(dtype),
              torch.randn((1, 8, 8, 3), generator=gen).to(dtype)):
        dy = torch.randn((x.shape[0], (x.shape[1] + 1) // 2,
                          (x.shape[2] + 1) // 2, x.shape[3]),
                         generator=gen).to(dtype)
        xa, xb = x.clone().requires_grad_(True), \
            x.clone().requires_grad_(True)
        ya, yb = pool_mod.relu_maxpool(xa), _OldReluMaxPool.apply(xb)
        assert _bits(torch.nan_to_num(ya), torch.nan_to_num(yb))
        assert torch.equal(torch.isnan(ya), torch.isnan(yb))
        assert _bits(torch.nan_to_num(ya.detach()), torch.nan_to_num(
            pool_mod.relu_maxpool_plain(x)))
        ya.backward(dy)
        yb.backward(dy)
        assert _bits(xa.grad, xb.grad)
        assert _bits(xa.grad, pool_mod.relu_maxpool_bwd_plain(x, dy))


@pytest.mark.parametrize("sr", [0, 2])
def test_roi_align_op(sr):
    gen = torch.Generator().manual_seed(1)
    f, boxes = _roi_inputs(gen)
    torch.library.opcheck(torch.ops.locov.roi_align.default,
                          (f.clone().requires_grad_(True), boxes, 0.125, 4,
                           sr))
    g = torch.randn((2, 5, 4, 4, 6), generator=gen)
    torch.library.opcheck(torch.ops.locov.roi_align_bwd.default,
                          (g, boxes, 0.125, 9, 13, 4, sr))
    fa, fb = f.clone().requires_grad_(True), f.clone().requires_grad_(True)
    ya = roi_mod.roi_align_fused(fa, boxes, 0.125, 4, sr)
    yb = _OldRoIAlign.apply(fb, boxes, 0.125, 4, sr)
    assert _bits(ya, yb)
    assert _bits(ya.detach(), roi_mod.roi_align_batched(f, boxes, 0.125, 4,
                                                        sr))
    ya.backward(g)
    yb.backward(g)
    assert _bits(fa.grad, fb.grad)
    assert _bits(fa.grad, roi_mod.roi_align_bwd_plain(g, boxes, 0.125, 9,
                                                      13, 4, sr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_conv_bn_op(dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 12, 10, 3), generator=gen).to(dtype)
    w = torch.randn((7, 7, 3, 32), generator=gen) * 0.1
    shift = torch.randn((32,), generator=gen)
    args = [a.clone().requires_grad_(True) for a in (x, w, shift)]
    torch.library.opcheck(torch.ops.locov.stem_conv_bn.default, args)
    new = [a.clone().requires_grad_(True) for a in (x, w, shift)]
    old = [a.clone().requires_grad_(True) for a in (x, w, shift)]
    ya, yb = stem_mod.stem_conv_bn(*new), _OldStemConvBN.apply(*old)
    assert _bits(ya, yb)
    assert _bits(ya.detach(), stem_mod.stem_conv_bn_plain(x, w, shift))
    g = torch.randn(ya.shape, generator=gen).to(ya.dtype)
    ya.backward(g)
    yb.backward(g)
    for a, b in zip(new, old):
        assert _bits(a.grad, b.grad)


def test_bottleneck_block_op():
    gen = torch.Generator().manual_seed(3)
    args = _block_inputs(gen)
    torch.library.opcheck(torch.ops.locov.bottleneck_block.default, args)
    assert _bits(block_mod.bottleneck_block(*args),
                 block_mod.bottleneck_block_plain(*args))
    with pytest.raises(RuntimeError, match="no gradient"):
        block_mod.bottleneck_block(args[0].requires_grad_(True),
                                   *args[1:])


@pytest.mark.parametrize("stop_after,per_class", [(0, False), (0, True),
                                                  (8, False), (8, True)])
def test_nms_op_matches_jax(stop_after, per_class):
    boxes, scores, valid, classes = _nms_inputs(np.random.RandomState(4),
                                                n_=600)
    cls = t(classes) if per_class else None
    torch.library.opcheck(torch.ops.locov.nms_mask.default,
                          (t(boxes), t(scores), t(valid), 0.5, stop_after,
                           cls))
    got = n(tnms.nms_mask_batched(t(boxes), t(scores), t(valid), 0.5,
                                  stop_after=stop_after, classes=cls))
    want = n(jnms.nms_mask_batched(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5,
        stop_after=stop_after,
        classes=jnp.asarray(classes) if per_class else None))
    np.testing.assert_array_equal(got, want)


def test_fake_implementations_give_shapes_and_dtypes():
    """Under fake tensors (what ``torch.export`` traces with) each op
    returns its output's shape and dtype, K2's [B, N, P, P, C] in the
    features' dtype, and runs no kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = dict(kernel_lib.LAUNCHES)
    gen = torch.Generator().manual_seed(5)
    f, boxes = _roi_inputs(gen, torch.bfloat16)
    x = torch.randn((2, 7, 9, 4), generator=gen)
    nb, ns, nv, nc = (t(a) for a in _nms_inputs(np.random.RandomState(6)))
    block = _block_inputs(gen)
    sx = torch.randn((1, 8, 6, 3), generator=gen)
    sw, ssh = torch.randn((7, 7, 3, 64), generator=gen), torch.zeros(64)
    with FakeTensorMode() as mode:
        fk = [mode.from_tensor(a) for a in (f, boxes, x, nb, ns, nv, nc,
                                            sx, sw, ssh)]
        fblock = [mode.from_tensor(a) for a in block]
        got = {
            "roi_align": torch.ops.locov.roi_align(fk[0], fk[1], 0.25, 14,
                                                   0),
            "roi_align_bwd": torch.ops.locov.roi_align_bwd(
                torch.empty((2, 5, 14, 14, 6), dtype=torch.bfloat16),
                fk[1], 0.25, 9, 13, 14, 0),
            "relu_maxpool": torch.ops.locov.relu_maxpool(fk[2]),
            "relu_maxpool_bwd": torch.ops.locov.relu_maxpool_bwd(
                fk[2], torch.empty((2, 4, 5, 4))),
            "nms_mask": torch.ops.locov.nms_mask(fk[3], fk[4], fk[5], 0.5,
                                                 10, fk[6]),
            "stem_conv_bn": torch.ops.locov.stem_conv_bn(*fk[7:]),
            "bottleneck_block": torch.ops.locov.bottleneck_block(*fblock),
        }
    want = {"roi_align": ((2, 5, 14, 14, 6), torch.bfloat16),
            "roi_align_bwd": ((2, 9, 13, 6), torch.bfloat16),
            "relu_maxpool": ((2, 4, 5, 4), torch.float32),
            "relu_maxpool_bwd": ((2, 7, 9, 4), torch.float32),
            "nms_mask": ((2, 40), torch.bool),
            "stem_conv_bn": ((1, 4, 3, 64), torch.bfloat16),
            "bottleneck_block": ((2, 5, 6, 16), torch.float32)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == want
    assert kernel_lib.LAUNCHES == before


SOURCES = sorted(f[:-3] for f in os.listdir(kernel_lib.CSRC)
                 if f.endswith(".cu"))
_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float}


def _read_source(name):
    with open(os.path.join(kernel_lib.CSRC, name)) as f:
        return f.read()


def _c_entries(src):
    """{symbol: its parameters' ctypes kinds} of the ``extern "C"``
    functions of a source."""
    out = {}
    for sym, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        params = [" ".join(p.split()) for p in params.split(",")]
        out[sym] = [ctypes.c_void_p if "*" in p else _KINDS[p.split()[0]]
                    for p in params]
    return out


def _global_functions(src):
    """The names of a source's ``__global__`` functions: the first name
    after the keyword that opens a parameter list, launch bounds and
    ``sizeof`` aside."""
    names = []
    for m in re.finditer(r"__global__\b", src):
        for call in re.finditer(r"(\w+)\s*\(", src[m.end():]):
            if call.group(1) not in ("__launch_bounds__", "sizeof"):
                names.append(call.group(1))
                break
    return names


@pytest.mark.parametrize("source", SOURCES)
def test_kernel_table_holds_each_source(source):
    """Each ``csrc/*.cu`` is the source of some entries of the table, and
    its C entries (with their parameters, the stream last) and its
    ``__global__`` functions are exactly those entries'."""
    src = _read_source(source + ".cu")
    keys = [k for k, v in kernel_lib.TABLE.items() if v.source == source]
    assert keys, f"{source}.cu is in no entry of kernel_lib.TABLE"
    entries = _c_entries(src)
    assert sorted(entries) == sorted(
        sym for k in keys for sym in kernel_lib.TABLE[k].entries)
    for sym, kinds in entries.items():
        assert kernel_lib.argtypes(sym) == kinds, sym
        assert kinds[-1] is ctypes.c_void_p, sym
    assert sorted(_global_functions(src)) == sorted(
        fn for k in keys for fn in kernel_lib.TABLE[k].device)


def test_kernel_table_is_the_one_list():
    """``KERNELS``, ``LAUNCHES`` and ``DEVICE_FUNCTIONS`` are the table's;
    the headers hold no C entry and no kernel."""
    assert sorted(kernel_lib.KERNELS) == SOURCES
    assert list(kernel_lib.LAUNCHES) == list(kernel_lib.TABLE)
    assert sorted(kernel_lib.DEVICE_FUNCTIONS) == sorted(
        fn for v in kernel_lib.TABLE.values() for fn in v.device)
    assert len(set(kernel_lib.DEVICE_FUNCTIONS)) == \
        len(kernel_lib.DEVICE_FUNCTIONS)
    for header in os.listdir(kernel_lib.CSRC):
        if header.endswith(".cuh"):
            src = _read_source(header)
            assert not _c_entries(src) and not _global_functions(src), header
    saved = dict(kernel_lib.LAUNCHES)
    try:
        kernel_lib.LAUNCHES["conv_int8"] += 3
        kernel_lib.reset_launches()
        assert kernel_lib.LAUNCHES == dict.fromkeys(kernel_lib.TABLE, 0)
    finally:
        kernel_lib.LAUNCHES.update(saved)


class _FakeEntry:
    """A C entry of a fake library: records its calls, returns ``err``."""

    def __init__(self, err):
        self.argtypes = self.restype = None
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.mark.parametrize("symbol", sorted(
    sym for v in kernel_lib.TABLE.values() for sym in v.entries))
def test_launch_binds_from_the_table_and_checks(symbol, monkeypatch):
    """``launch`` binds the entry once with the table's types (an int
    result), calls it on the device with that device's stream last, and
    raises with the kernel's launch key when it returns an error; with
    ``lib`` it calls that library's entry instead."""
    key = next(k for k, v in kernel_lib.TABLE.items() if symbol in v.entries)
    entry, other = _FakeEntry(0), _FakeEntry(0)
    monkeypatch.setitem(kernel_lib._LIBS, kernel_lib.TABLE[key].source,
                        types.SimpleNamespace(**{symbol: entry}))
    devices = []

    def on_device(device):
        devices.append(device)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.cuda, "device", on_device)
    monkeypatch.setattr(kernel_lib, "stream_ptr",
                        lambda device: 1000 + device.index)
    dev = torch.device("cuda", 3)
    args = tuple(range(len(kernel_lib.argtypes(symbol)) - 1))
    kernel_lib.launch(symbol, dev, *args)
    assert entry.argtypes == kernel_lib.argtypes(symbol)
    assert entry.restype is ctypes.c_int
    entry.argtypes = bound = list(entry.argtypes)
    kernel_lib.launch(symbol, dev, *args)
    assert entry.argtypes is bound  # set once
    assert entry.calls == [args + (1003,)] * 2 and devices == [dev] * 2
    kernel_lib.launch(symbol, dev, *args,
                      lib=types.SimpleNamespace(**{symbol: other}))
    assert other.calls == [args + (1003,)] and len(entry.calls) == 2
    assert other.argtypes == kernel_lib.argtypes(symbol)
    entry.err = 700
    with pytest.raises(RuntimeError,
                       match=f"^{key}: CUDA kernel launch failed with "
                             f"cudaError 700$"):
        kernel_lib.launch(symbol, dev, *args)
