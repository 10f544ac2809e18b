"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on
a machine with the card and no JAX, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_gpu.py

Tolerances: relu_maxpool bit-exact, NaN where the plain version has
NaN (max is exact); roi_align within
1e-5 * max|F| in float32 (float32 sums in another order), and in
bfloat16 within one bfloat16 ulp of the plain version (computed in
float32 and cast once), or 1e-5 * max|F| where that is larger.
"""
import numpy as np
import pytest
import torch

from locov_torch.ops import kernel_lib
from locov_torch.ops.relu_maxpool import (relu_maxpool, relu_maxpool_cuda,
                                          relu_maxpool_plain)
from locov_torch.ops.roi_align import (roi_align_batched, roi_align_cuda,
                                       roi_align_fused)

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
@pytest.mark.parametrize("sr,c", [(0, 256), (2, 256), (0, 12), (1, 64)])
def test_roi_align_matches_plain(cuda, dtype, sr, c):
    f = torch.randn((2, 25, 42, c), generator=cuda, device="cuda") * 3
    f = f.to(dtype)
    bx = _boxes(cuda, 2, 40, 400, 672)
    before = kernel_lib.LAUNCHES["roi_align_fused"]
    got = roi_align_fused(f, bx, 1 / 16, 14, sr)
    assert kernel_lib.LAUNCHES["roi_align_fused"] == before + 1
    plain = roi_align_batched(f, bx, 1 / 16, 14, sr).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 45, 14, 14, c)
    fmax = f.float().abs().max().item()
    err = (got.float() - plain).abs()
    if dtype == torch.float32:
        tol = torch.full_like(err, 1e-5 * fmax)
    else:  # one bf16 ulp at the larger magnitude, 1e-5 * max|F| floor
        _, e = torch.frexp(torch.maximum(plain.abs(), got.float().abs()))
        tol = torch.clamp(torch.exp2((e - 8).float()), min=1e-5 * fmax)
    assert bool((err <= tol).all()), err.max().item()
    # a box wholly outside the image; in adaptive mode also the
    # degenerate boxes (zero width, inverted), which have no samples
    assert bool((got[:, 4] == 0).all())
    if sr == 0:
        assert bool((got[:, 1:3] == 0).all())


def test_roi_align_rejects_bad_inputs(cuda):
    f = torch.randn(1, 8, 8, 16, device="cuda")
    bx = torch.zeros(1, 3, 4, device="cuda")
    with pytest.raises(TypeError):
        roi_align_cuda(f, bx.double(), 1 / 16)
    with pytest.raises(ValueError):
        roi_align_cuda(f, bx, 1 / 16, pooled=64)
    with pytest.raises(ValueError):
        roi_align_cuda(f, bx.cpu(), 1 / 16)


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
