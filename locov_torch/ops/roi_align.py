"""Inference ROIAlignV2: the plain separable form and the CUDA kernel.

Counterpart of ``locov_tpu/ops/roi_align.py`` (``roi_align_batched``)
and ``locov_tpu/ops/pallas_roi_align.py`` (``roi_align_pallas_fused``).
Bilinear sampling is separable, so the plain version builds per-box
1-D interpolation matrices Ky [P, H] and Kx [P, W] (sampling-point hat
weights, averaged over the sampling grid) and computes
``crop[n] = Ky[n] @ F @ Kx[n]^T`` per channel. Numerics follow
ROIAlignV2 (aligned=True, half-pixel offset) with torchvision's border
rules: samples outside [-1, dim] contribute zero, in-range samples
clamp to [0, dim-1]. ``roi_align_fused`` launches the gather-form CUDA
kernel ``csrc/roi_align.cu`` on CUDA tensors and runs the plain version
on CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_lib

# Static cap on the adaptive per-bin sampling grid (d2 uses
# ceil(roi_size / pooled) samples per bin with no cap; at stride 16 /
# pooled 14 the cap of 8 is exact for any ROI up to 1792 image pixels a
# side). Same value as the JAX package; the CUDA kernel's SR_MAX.
ADAPTIVE_SR_MAX = 8
# the CUDA kernel's shared-memory sample tables hold this many bins
_POOLED_MAX = 32
# boxes per step of the plain version: bounds its [B, chunk, P, H, C]
# float32 intermediate
_CHUNK = 200

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d, correctly rounded on every device. (On CUDA, PyTorch
    divides by a Python scalar as a multiply by its reciprocal, which is
    an ulp off: 84 / 14 gave 6.0000005, and the adaptive grid took
    ceil() = 7 samples where the JAX package takes 6.)"""
    return x / torch.full_like(x, d)


def _interp_matrix(coords: torch.Tensor, dim: int,
                   sample_weights: torch.Tensor = None) -> torch.Tensor:
    """Averaged bilinear hat weights for sample coordinates.

    coords: [N, P, S] continuous positions along one axis. Returns
    [N, P, dim] weights averaged over the S samples per bin, or, with
    ``sample_weights`` [N, P, S], combined by that weighted sum."""
    outside = (coords < -1.0) | (coords > dim)
    c = coords.clamp(0.0, dim - 1.0)
    low = torch.floor(c)
    frac = c - low
    # when low == dim-1, high collapses onto low (weight 1 there)
    high = torch.clamp(low + 1.0, max=dim - 1.0)
    zero = torch.zeros_like(frac)
    w_low = torch.where(outside, zero, 1.0 - frac)
    w_high = torch.where(outside, zero, frac)

    grid = torch.arange(dim, dtype=coords.dtype, device=coords.device)
    w = w_low[..., None] * (low[..., None] == grid) + \
        w_high[..., None] * (high[..., None] == grid)
    if sample_weights is None:
        return _div(w.sum(dim=2), coords.shape[2])  # mean over samples
    return (w * sample_weights[..., None]).sum(dim=2)


def _sample_coords(lo: torch.Tensor, size: torch.Tensor, pooled: int,
                   ratio: int) -> torch.Tensor:
    """Sample positions lo + (p + (s + 0.5) / ratio) * bin_size for bin
    p and sample s. lo, size: [N] -> [N, P, S]."""
    bin_size = _div(size, pooled)
    p = torch.arange(pooled, dtype=lo.dtype, device=lo.device)[None, :,
                                                               None]
    s = _div(torch.arange(ratio, dtype=lo.dtype, device=lo.device)[None,
                                                                   None]
             + 0.5, ratio)
    return lo[:, None, None] + (p + s) * bin_size[:, None, None]


def _adaptive_coords(lo: torch.Tensor, size: torch.Tensor, pooled: int,
                     sr_max: int = ADAPTIVE_SR_MAX):
    """d2 adaptive sampling (POOLER_SAMPLING_RATIO = 0): a per-box grid
    of ceil(roi_size / pooled) samples per bin and axis, as a static
    [N, P, sr_max] slot array with zero weight on unused slots.
    Degenerate (size <= 0) boxes get no samples -> zero output.

    Returns (coords [N, P, S], sample_weights [N, P, S])."""
    dt, dev = lo.dtype, lo.device
    bin_size = _div(size, pooled)
    sr = torch.clamp(torch.ceil(bin_size), 0.0, float(sr_max))
    srn = torch.clamp(sr, min=1.0)[:, None]
    s_idx = torch.arange(sr_max, dtype=dt, device=dev)[None, :]
    pos = (s_idx + 0.5) / srn
    p = torch.arange(pooled, dtype=dt, device=dev)[None, :, None]
    coords = lo[:, None, None] + (p + pos[:, None, :]) * \
        bin_size[:, None, None]
    weight = torch.where(s_idx < sr[:, None], 1.0 / srn,
                         torch.zeros_like(srn))
    return coords, weight[:, None, :].expand(coords.shape)


def _build_kernels(boxes: torch.Tensor, spatial_scale: float, h: int,
                   w: int, pooled: int, sampling_ratio: int):
    """Per-box interpolation matrices ky [B, N, P, H], kx [B, N, P, W]
    in f32 (fixed or adaptive sampling)."""
    b, n = boxes.shape[:2]
    # aligned=True (ROIAlignV2): half-pixel correction, no size clamping
    x0 = boxes[..., 0] * spatial_scale - 0.5
    y0 = boxes[..., 1] * spatial_scale - 0.5
    bw = boxes[..., 2] * spatial_scale - 0.5 - x0
    bh = boxes[..., 3] * spatial_scale - 0.5 - y0
    x0, y0, bw, bh = (v.reshape(b * n) for v in (x0, y0, bw, bh))
    if sampling_ratio > 0:
        sr = int(sampling_ratio)
        ky = _interp_matrix(_sample_coords(y0, bh, pooled, sr), h)
        kx = _interp_matrix(_sample_coords(x0, bw, pooled, sr), w)
    else:
        cy, wy = _adaptive_coords(y0, bh, pooled)
        cx, wx = _adaptive_coords(x0, bw, pooled)
        ky = _interp_matrix(cy, h, wy)
        kx = _interp_matrix(cx, w, wx)
    return ky.reshape(b, n, pooled, h), kx.reshape(b, n, pooled, w)


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor,
                      spatial_scale: float, pooled: int = 14,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """Plain ROIAlign: features [B, H, W, C], boxes [B, N, 4] ->
    [B, N, pooled, pooled, C] in features' dtype. Computed in f32 (the
    interpolation matrices and both contractions) and cast once; boxes
    are taken ``_CHUNK`` at a time."""
    b, h, w, c = features.shape
    n = boxes.shape[1]
    ky, kx = _build_kernels(boxes.float(), spatial_scale, h, w, pooled,
                            sampling_ratio)
    f = features.float()
    outs = []
    for s in range(0, n, _CHUNK):
        # contract W first: the [B, n, Q, H, C] intermediate is smaller
        # than [B, n, P, W, C] on landscape images
        t = torch.einsum("bnqw,bhwc->bnqhc", kx[:, s:s + _CHUNK], f)
        outs.append(torch.einsum("bnqhc,bnph->bnpqc", t,
                                 ky[:, s:s + _CHUNK]))
    out = torch.cat(outs, dim=1) if outs else \
        f.new_zeros((b, 0, pooled, pooled, c))
    return out.to(features.dtype)


def _lib():
    lib = kernel_lib.load("roi_align")
    fn = lib.roi_align_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def roi_align_cuda(features: torch.Tensor, boxes: torch.Tensor,
                   spatial_scale: float, pooled: int = 14,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """The CUDA kernel. features: contiguous NHWC float32/bfloat16;
    boxes: contiguous [B, N, 4] float32, on the same device."""
    kernel_lib.check_cuda_tensor(features, "roi_align features", _DTYPES)
    kernel_lib.check_cuda_tensor(boxes, "roi_align boxes",
                                 {torch.float32})
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[2] != 4 \
            or boxes.shape[0] != features.shape[0]:
        raise ValueError(f"roi_align: features {tuple(features.shape)} / "
                         f"boxes {tuple(boxes.shape)}")
    if boxes.device != features.device:
        raise ValueError("roi_align: features and boxes on two devices")
    if not 1 <= pooled <= _POOLED_MAX or \
            sampling_ratio > ADAPTIVE_SR_MAX:
        raise ValueError(f"roi_align: pooled {pooled} (<= {_POOLED_MAX})"
                         f", sampling_ratio {sampling_ratio} "
                         f"(<= {ADAPTIVE_SR_MAX})")
    b, h, w, c = features.shape
    n = boxes.shape[1]
    out = torch.empty((b, n, pooled, pooled, c), dtype=features.dtype,
                      device=features.device)
    if out.numel() == 0:
        return out
    vec = 16 // features.element_size()
    if c % vec or features.data_ptr() % 16:
        vec = 1
    fn = _lib()
    with torch.cuda.device(features.device):
        err = fn(features.data_ptr(), boxes.data_ptr(), out.data_ptr(), b,
                 h, w, c, n, pooled, int(sampling_ratio),
                 float(spatial_scale), _DTYPES[features.dtype], vec,
                 kernel_lib.stream_ptr(features.device))
    kernel_lib.check_launch(err, "roi_align_fused")
    kernel_lib.LAUNCHES["roi_align_fused"] += 1
    return out


def roi_align_fused(features: torch.Tensor, boxes: torch.Tensor,
                    spatial_scale: float, pooled: int = 14,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """Inference ROIAlign, features [B, H, W, C], boxes [B, N, 4] ->
    [B, N, P, P, C] in features' dtype: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if features.is_cuda:
        return roi_align_cuda(features, boxes, spatial_scale, pooled,
                              sampling_ratio)
    if features.device.type != "cpu":
        raise ValueError(f"roi_align: unsupported device {features.device}")
    return roi_align_batched(features, boxes, spatial_scale, pooled,
                             sampling_ratio)
