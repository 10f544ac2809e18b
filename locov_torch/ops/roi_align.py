"""ROIAlignV2 with its feature gradient: the plain separable form and
the CUDA kernels.

Counterpart of ``locov_tpu/ops/roi_align.py`` (``roi_align_batched``
and its custom VJP) and ``locov_tpu/ops/pallas_roi_align.py``
(``roi_align_pallas_fused``, and ``roi_align_pallas`` with its backward).
Bilinear sampling is separable, so the plain version builds per-box
1-D interpolation matrices Ky [P, H] and Kx [P, W] (sampling-point hat
weights, averaged over the sampling grid) and computes
``crop[n] = Ky[n] @ F @ Kx[n]^T`` per channel, and the feature gradient
``dF = sum_n Ky[n]^T @ g[n] @ Kx[n]``; the boxes get no gradient.
Numerics follow ROIAlignV2 (aligned=True, half-pixel offset) with
torchvision's border rules: samples outside [-1, dim] contribute zero,
in-range samples clamp to [0, dim-1]. ``roi_align_fused`` calls the
``torch.library`` custom op ``locov::roi_align``, whose registered
backward is the op ``locov::roi_align_bwd``: on CUDA tensors the forward
launches the separable forward kernel and the backward the scatter-free
gradient kernel of ``csrc/roi_align.cu``, each under a launch plan
(``_fwd_plan``, ``_bwd_plan``), and nothing else; on CPU tensors both
directions run the plain version. Their fake implementations give the
output's shape and dtype, so that ``torch.export`` traces through them.

Across the levels of a feature pyramid (ViTDet's P2-P5),
``roi_align_levels`` calls the op ``locov::roi_align_levels``: each box
pooled once, from the map of its level only. On CUDA tensors it is one
launch of the forward kernel's multi-level entry (the same block body as
``locov::roi_align``, each block taking its box's level's map, height,
width and scale; the shared memory of the largest level); on CPU tensors
``roi_align_levels_plain`` (every box pooled on every level by
``roi_align_batched``, its own level's output kept). Inference only.

The static int8 serving mode adds ``roi_align_batched_quant`` (the float
op, then a static int8 quantize of its output) and
``roi_align_batched_int8`` (``locov_tpu/ops/roi_align.py:
roi_align_batched_int8``): the features quantized per tensor by a
calibrated max-abs, then the op ``locov::roi_align_int8`` on the int8
features, the boxes and the ratio of the two scales: the interpolation
matrices quantized per row, and both contractions in int8 with int32
sums. On CUDA tensors the op launches the kernel of
``csrc/roi_align_int8.cu``, which builds the matrices itself; on CPU
tensors it runs the plain ``int8_matrices`` (the samples added in the
kernel's order) and ``roi_align_int8_plain``. Inference only, no
gradient.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from . import kernel_lib
from .int8_conv import _scale_of, quantize_per_tensor_static

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
# shared memory a block may take on this card (227 KB); the backward
# kernel's launch plan (see ``_bwd_plan``): what two blocks on one SM
# may each take (228 KB less 1 KB reserved a block), threads a block
_SMEM_MAX = 232448
_BWD_SMEM_TWO = 233472 // 2 - 1024
_BWD_THREADS = 256
_BWD_ROWS = (4, 2, 1)
# the forward kernel's launch plan (see ``_fwd_plan``): channel vectors
# a tile, output rows a block, threads a block at most, and the bytes a
# thread loads at once (the fastest timed on the H100: 32-byte vectors
# and two rows a block)
_FWD_TILE_VECS = 128
_FWD_ROWS = 2
_FWD_MAX_THREADS = 256
_FWD_VEC_BYTES = 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the levels one launch of the multi-level forward takes
# (csrc/roi_align.cu: MAX_LEVELS)
_MAX_LEVELS = 4


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


def _box_extents(boxes: torch.Tensor, spatial_scale: float):
    """(x0, y0, width, height) [B * N] of boxes [B, N, 4] in feature
    coordinates: aligned=True (ROIAlignV2), half-pixel correction, no
    size clamping."""
    x0 = boxes[..., 0] * spatial_scale - 0.5
    y0 = boxes[..., 1] * spatial_scale - 0.5
    bw = boxes[..., 2] * spatial_scale - 0.5 - x0
    bh = boxes[..., 3] * spatial_scale - 0.5 - y0
    return tuple(v.reshape(-1) for v in (x0, y0, bw, bh))


def _build_kernels(boxes: torch.Tensor, spatial_scale: float, h: int,
                   w: int, pooled: int, sampling_ratio: int):
    """Per-box interpolation matrices ky [B, N, P, H], kx [B, N, P, W]
    in f32 (fixed or adaptive sampling)."""
    b, n = boxes.shape[:2]
    x0, y0, bw, bh = _box_extents(boxes, spatial_scale)
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


def roi_align_bwd_plain(g: torch.Tensor, boxes: torch.Tensor,
                        spatial_scale: float, h: int, w: int,
                        pooled: int = 14,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """Plain feature gradient of ``roi_align_batched``: g [B, N, P, P,
    C] -> dF [B, H, W, C] = sum_n Ky[n]^T g[n] Kx[n], in f32 (the
    interpolation matrices and both contractions), cast once to g's
    dtype; boxes are taken ``_CHUNK`` at a time (the JAX package's
    ``ops/roi_align.py:_roi_align_bwd``)."""
    b, n = boxes.shape[:2]
    ky, kx = _build_kernels(boxes.float(), spatial_scale, h, w, pooled,
                            sampling_ratio)
    gf = g.float()
    df = gf.new_zeros((b, h, w, g.shape[-1]))
    for s in range(0, n, _CHUNK):
        # contract the small pooled axis P first
        v = torch.einsum("bnph,bnpqc->bnhqc", ky[:, s:s + _CHUNK],
                         gf[:, s:s + _CHUNK])
        df += torch.einsum("bnhqc,bnqw->bhwc", v, kx[:, s:s + _CHUNK])
    return df.to(g.dtype)


def _check_args(features_or_g, boxes, pooled, sampling_ratio, what):
    kernel_lib.check_cuda_tensor(features_or_g, what, _DTYPES)
    kernel_lib.check_cuda_tensor(boxes, "roi_align boxes",
                                 {torch.float32})
    if boxes.dim() != 3 or boxes.shape[2] != 4 or \
            boxes.shape[0] != features_or_g.shape[0]:
        raise ValueError(f"roi_align: {what} {tuple(features_or_g.shape)}"
                         f" / boxes {tuple(boxes.shape)}")
    if boxes.device != features_or_g.device:
        raise ValueError(f"roi_align: {what} and boxes on two devices")
    if not 1 <= pooled <= _POOLED_MAX or \
            sampling_ratio > ADAPTIVE_SR_MAX:
        raise ValueError(f"roi_align: pooled {pooled} (<= {_POOLED_MAX})"
                         f", sampling_ratio {sampling_ratio} "
                         f"(<= {ADAPTIVE_SR_MAX})")


def _vec(c: int, dtype: torch.dtype, aligned: bool = True,
         nbytes: int = 16) -> int:
    """Channels a kernel thread takes: ``nbytes`` bytes' worth where the
    channel count is a multiple of it and the tensor is so aligned, else
    1."""
    vec = nbytes * 8 // torch.finfo(dtype).bits
    return vec if aligned and c % vec == 0 else 1


def _align(t: torch.Tensor) -> int:
    """The largest power of two, up to 32, that divides t's address."""
    ptr = t.data_ptr()
    return min(32, ptr & -ptr) if ptr else 32


def _fwd_smem(h: int, w: int, rows: int, pooled: int) -> int:
    """Dynamic shared memory of the forward kernel, counted as
    ``fwd_smem_bytes`` of ``csrc/roi_align.cu`` counts it: two ints for
    each x bin and each of the block's rows (the cells each weighs on),
    the box's Kx [pooled, w] and its rows' Ky [rows, h]."""
    return 4 * (pooled * w + rows * h + 2 * (pooled + rows))


def _fwd_launch_plan(h: int, w: int, tile: int, vec: int,
                     pooled: int = 14, rows: int = _FWD_ROWS) -> dict:
    """The forward kernel's plan for a channel tile and ``rows`` output
    rows a block: one thread a channel vector of the tile, rounded up to
    whole warps, at most ``_FWD_MAX_THREADS`` (which then loop over the
    tile), each walking the rows."""
    threads = min(_FWD_MAX_THREADS, -(-(tile // vec) // 32) * 32)
    rows = min(rows, pooled)
    return {"channel_tile": tile, "rows": rows, "threads": threads,
            "vec": vec, "smem_bytes": _fwd_smem(h, w, rows, pooled)}


def _fwd_plan(h: int, w: int, c: int, dtype: torch.dtype,
              pooled: int = 14, align: int = 32) -> dict:
    """Launch plan of the forward kernel for features [*, h, w, c] of
    ``dtype`` whose address is a multiple of ``align`` bytes: the
    channels a thread takes (``_FWD_VEC_BYTES``' worth, else 16 bytes'
    worth where c and the address allow, else 1), the channel
    tile (128 channel vectors, one a thread, no more than c needs), the
    output rows a block (``_FWD_ROWS``), the threads and the dynamic
    shared memory (the box's Kx over the image's columns, its rows' Ky).
    Raises where that does not fit a block."""
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align: dtype {dtype} not in {_DTYPES}")
    vec = 1
    for nbytes in (32, 16):
        if nbytes <= min(align, _FWD_VEC_BYTES):
            vec = _vec(c, dtype, True, nbytes)
            if vec > 1:
                break
    tile = min(_FWD_TILE_VECS * vec, -(-c // 8) * 8)
    tile = -(-tile // vec) * vec
    plan = _fwd_launch_plan(h, w, tile, vec, pooled)
    if plan["smem_bytes"] > _SMEM_MAX:
        raise ValueError(f"roi_align: features {h} x {w} need more shared "
                         f"memory than a block has")
    return plan


def _launch_fwd(features: torch.Tensor, boxes: torch.Tensor,
                spatial_scale: float, pooled: int, sampling_ratio: int,
                plan: dict, fill: float = None) -> torch.Tensor:
    """The forward kernel's C entry under ``plan`` (its ``vec`` must suit
    the features); no launch count. ``fill``: a value the output holds
    before the launch (checks that every element is written)."""
    b, h, w, c = features.shape
    n = boxes.shape[1]
    out = torch.empty((b, n, pooled, pooled, c), dtype=features.dtype,
                      device=features.device)
    if fill is not None:
        out.fill_(fill)
    if out.numel() == 0:
        return out
    kernel_lib.launch(
        "roi_align_fwd", features.device, features.data_ptr(),
        boxes.data_ptr(), out.data_ptr(), b, h, w, c, n, pooled,
        int(sampling_ratio), float(spatial_scale), _DTYPES[features.dtype],
        plan["vec"], plan["channel_tile"], plan["rows"], plan["threads"],
        plan["smem_bytes"])
    return out


def roi_align_cuda(features: torch.Tensor, boxes: torch.Tensor,
                   spatial_scale: float, pooled: int = 14,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """The forward kernel. features: contiguous NHWC float32/bfloat16;
    boxes: contiguous [B, N, 4] float32, on the same device."""
    _check_args(features, boxes, pooled, sampling_ratio,
                "roi_align features")
    if features.dim() != 4:
        raise ValueError(f"roi_align: features {tuple(features.shape)}")
    _, h, w, c = features.shape
    plan = _fwd_plan(h, w, c, features.dtype, pooled, _align(features))
    out = _launch_fwd(features, boxes, spatial_scale, pooled,
                      sampling_ratio, plan)
    if out.numel():
        kernel_lib.LAUNCHES["roi_align_fused"] += 1
    return out


def _bwd_smem(rows: int, w: int, tile: int, pooled: int) -> int:
    """Dynamic shared memory of the backward kernel, counted as
    ``bwd_smem_bytes`` of ``csrc/roi_align.cu`` counts it: the f32
    accumulator [rows, w, tile], the Ky-contracted cotangent [rows,
    pooled, tile], the box's Kx [pooled, w], and two boxes' taps (y and
    x taps, Ky [pooled, rows], a summary)."""
    taps = 2 * 16 * pooled * ADAPTIVE_SR_MAX + 4 * pooled * (1 + rows) + 32
    return 4 * (rows * w * tile + rows * pooled * tile + pooled * w) + \
        2 * taps


def _bwd_plan(h: int, w: int, c: int, dtype: torch.dtype,
              pooled: int = 14) -> dict:
    """Launch plan of the backward kernel for features [*, h, w, c] of
    ``dtype``: the band rows R (feature rows a block accumulates), the
    channel tile, the threads a block and the dynamic shared memory it
    takes. The tile is 16 channel vectors (128 bf16 or 64 f32
    channels), so that at pooled 14 each of the 224 contracting threads
    takes one (bin column, channel vector); R is the widest band (4, 2
    or 1 rows, no more than the image has) with which two blocks share
    an SM, else the widest that fits a block alone. On the H100 at [8,
    512, 14, 14, 1024] -> [8, 50, 84, 1024] this took f32 R 4 x 64
    channels and bf16 R 2 x 128, the fastest of the plans timed. Raises
    where even one row does not fit."""
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align_bwd: dtype {dtype} not in {_DTYPES}")
    vec = 16 * 8 // torch.finfo(dtype).bits  # channels in 16 bytes
    vec = vec if c % vec == 0 else 1
    tile = min(16 * vec, -(-c // 8) * 8)
    for limit in (_BWD_SMEM_TWO, _SMEM_MAX):
        for rows in _BWD_ROWS:
            smem = _bwd_smem(rows, w, tile, pooled)
            if (rows <= h or rows == 1) and smem <= limit:
                return {"band_rows": rows, "channel_tile": tile,
                        "threads": _BWD_THREADS, "smem_bytes": smem}
    raise ValueError(f"roi_align_bwd: feature width {w} needs more "
                     f"shared memory than a block has")


def roi_align_bwd_cuda(g: torch.Tensor, boxes: torch.Tensor,
                       spatial_scale: float, h: int, w: int,
                       pooled: int = 14,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """The backward kernel: g [B, N, P, P, C] contiguous float32/
    bfloat16, boxes as for the forward -> dF [B, H, W, C] in g's
    dtype."""
    _check_args(g, boxes, pooled, sampling_ratio, "roi_align_bwd g")
    b, n = boxes.shape[:2]
    c = g.shape[-1]
    if tuple(g.shape) != (b, n, pooled, pooled, c):
        raise ValueError(f"roi_align_bwd: g {tuple(g.shape)} for boxes "
                         f"{tuple(boxes.shape)}, pooled {pooled}")
    plan = _bwd_plan(h, w, c, g.dtype, pooled)
    df = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    if df.numel() == 0:
        return df
    if n == 0:
        return df.zero_()
    vec = _vec(c, g.dtype, g.data_ptr() % 16 == 0)
    kernel_lib.launch(
        "roi_align_bwd", g.device, g.data_ptr(), boxes.data_ptr(),
        df.data_ptr(), b, h, w, c, n, pooled, int(sampling_ratio),
        float(spatial_scale), _DTYPES[g.dtype], vec, plan["band_rows"],
        plan["channel_tile"], plan["smem_bytes"])
    kernel_lib.LAUNCHES["roi_align_bwd"] += 1
    return df


@torch.library.custom_op("locov::roi_align", mutates_args=(),
                         device_types="cpu")
def _roi_align_op(features: torch.Tensor, boxes: torch.Tensor,
                  spatial_scale: float, pooled: int,
                  sampling_ratio: int) -> torch.Tensor:
    return roi_align_batched(features, boxes, spatial_scale, pooled,
                             sampling_ratio)


@_roi_align_op.register_kernel("cuda")
def _(features, boxes, spatial_scale, pooled, sampling_ratio):
    return roi_align_cuda(features, boxes, spatial_scale, pooled,
                          sampling_ratio)


@_roi_align_op.register_fake
def _(features, boxes, spatial_scale, pooled, sampling_ratio):
    b, n = boxes.shape[:2]
    return features.new_empty((b, n, pooled, pooled, features.shape[-1]))


@torch.library.custom_op("locov::roi_align_bwd", mutates_args=(),
                         device_types="cpu")
def _roi_align_bwd_op(g: torch.Tensor, boxes: torch.Tensor,
                      spatial_scale: float, h: int, w: int, pooled: int,
                      sampling_ratio: int) -> torch.Tensor:
    return roi_align_bwd_plain(g, boxes, spatial_scale, h, w, pooled,
                               sampling_ratio)


@_roi_align_bwd_op.register_kernel("cuda")
def _(g, boxes, spatial_scale, h, w, pooled, sampling_ratio):
    return roi_align_bwd_cuda(g.contiguous(), boxes, spatial_scale, h, w,
                              pooled, sampling_ratio)


@_roi_align_bwd_op.register_fake
def _(g, boxes, spatial_scale, h, w, pooled, sampling_ratio):
    return g.new_empty((g.shape[0], h, w, g.shape[-1]))


def _setup(ctx, inputs, output):
    features, boxes, spatial_scale, pooled, sampling_ratio = inputs
    ctx.save_for_backward(boxes)
    ctx.args = (spatial_scale, features.shape[1], features.shape[2],
                pooled, sampling_ratio)


def _backward(ctx, g):
    """The feature gradient; the boxes get none."""
    (boxes,) = ctx.saved_tensors
    return (torch.ops.locov.roi_align_bwd(g, boxes, *ctx.args), None, None,
            None, None)


_roi_align_op.register_autograd(_backward, setup_context=_setup)


def roi_align_fused(features: torch.Tensor, boxes: torch.Tensor,
                    spatial_scale: float, pooled: int = 14,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign, features [B, H, W, C], boxes [B, N, 4] -> [B, N, P, P,
    C] in features' dtype, differentiable in the features
    (``locov::roi_align``): the kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    return torch.ops.locov.roi_align(features, boxes, float(spatial_scale),
                                     int(pooled), int(sampling_ratio))


# ---------------------------------------------------------------- levels
def roi_align_levels_plain(features: List[torch.Tensor], boxes: torch.Tensor,
                           levels: torch.Tensor, scales: List[float],
                           pooled: int = 7,
                           sampling_ratio: int = 0) -> torch.Tensor:
    """Plain ROIAlign across the levels of a pyramid: features[l] [B,
    H_l, W_l, C], boxes [B, N, 4], levels [B, N] (each box's level, 0 ..
    L - 1), scales[l] level l's 1 / stride -> [B, N, pooled, pooled, C],
    each box's output that of ``roi_align_batched`` on its own level
    (every box pooled on every level, the level's kept)."""
    out = None
    for lvl, (f, scale) in enumerate(zip(features, scales)):
        o = roi_align_batched(f, boxes, scale, pooled, sampling_ratio)
        out = o if out is None else torch.where(
            (levels == lvl)[..., None, None, None], o, out)
    return out


def roi_align_levels_cuda(features: List[torch.Tensor], boxes: torch.Tensor,
                          levels: torch.Tensor, scales: List[float],
                          pooled: int = 7,
                          sampling_ratio: int = 0) -> torch.Tensor:
    """K2 across levels: one launch of ``roi_align_levels_fwd``, each box
    pooled once, from its level's map only, under the forward's plan
    (``_fwd_plan``) with the shared memory of the widest level.
    features: contiguous NHWC maps of one dtype, batch and width; boxes
    [B, N, 4] float32 and levels [B, N] int32, contiguous, on their
    device."""
    if not 1 <= len(features) <= _MAX_LEVELS or \
            len(scales) != len(features):
        raise ValueError(f"roi_align_levels: {len(features)} levels and "
                         f"{len(scales)} scales; 1 to {_MAX_LEVELS}")
    for f in features:
        _check_args(f, boxes, pooled, sampling_ratio,
                    "roi_align_levels features")
        if f.dim() != 4 or f.dtype != features[0].dtype or \
                f.shape[0] != features[0].shape[0] or \
                f.shape[3] != features[0].shape[3]:
            raise ValueError(f"roi_align_levels: features "
                             f"{[tuple(x.shape) for x in features]}")
    kernel_lib.check_cuda_tensor(levels, "roi_align_levels levels",
                                 {torch.int32})
    b, n = boxes.shape[:2]
    if tuple(levels.shape) != (b, n) or levels.device != boxes.device:
        raise ValueError(f"roi_align_levels: levels {tuple(levels.shape)} "
                         f"for boxes {tuple(boxes.shape)}")
    c, dtype = features[0].shape[3], features[0].dtype
    plan = _fwd_plan(max(f.shape[1] for f in features),
                     max(f.shape[2] for f in features), c, dtype, pooled,
                     min(_align(f) for f in features))
    smem = max(_fwd_smem(f.shape[1], f.shape[2], plan["rows"], pooled)
               for f in features)
    out = torch.empty((b, n, pooled, pooled, c), dtype=dtype,
                      device=boxes.device)
    if out.numel() == 0:
        return out
    nl = len(features)
    ptrs = (ctypes.c_longlong * nl)(*(f.data_ptr() for f in features))
    hs = (ctypes.c_int * nl)(*(f.shape[1] for f in features))
    ws = (ctypes.c_int * nl)(*(f.shape[2] for f in features))
    sc = (ctypes.c_float * nl)(*(float(x) for x in scales))
    kernel_lib.launch(
        "roi_align_levels_fwd", boxes.device, ctypes.addressof(ptrs),
        ctypes.addressof(hs), ctypes.addressof(ws), ctypes.addressof(sc),
        nl, boxes.data_ptr(), levels.data_ptr(), out.data_ptr(), b, c, n,
        pooled, int(sampling_ratio), _DTYPES[dtype], plan["vec"],
        plan["channel_tile"], plan["rows"], plan["threads"], smem)
    kernel_lib.LAUNCHES["roi_align_levels"] += 1
    return out


@torch.library.custom_op("locov::roi_align_levels", mutates_args=(),
                         device_types="cpu")
def _roi_align_levels_op(features: List[torch.Tensor], boxes: torch.Tensor,
                         levels: torch.Tensor, scales: List[float],
                         pooled: int, sampling_ratio: int) -> torch.Tensor:
    return roi_align_levels_plain(features, boxes, levels, scales, pooled,
                                  sampling_ratio)


@_roi_align_levels_op.register_kernel("cuda")
def _(features, boxes, levels, scales, pooled, sampling_ratio):
    return roi_align_levels_cuda([f.contiguous() for f in features],
                                 boxes.contiguous(), levels.contiguous(),
                                 scales, pooled, sampling_ratio)


@_roi_align_levels_op.register_fake
def _(features, boxes, levels, scales, pooled, sampling_ratio):
    b, n = boxes.shape[:2]
    return features[0].new_empty((b, n, pooled, pooled,
                                  features[0].shape[-1]))


def roi_align_levels(features: List[torch.Tensor], boxes: torch.Tensor,
                     levels: torch.Tensor, scales: List[float],
                     pooled: int = 7,
                     sampling_ratio: int = 0) -> torch.Tensor:
    """ROIAlign across pyramid levels (``locov::roi_align_levels``):
    each box pooled from its level's map, features[l] [B, H_l, W_l, C],
    boxes [B, N, 4], levels [B, N] -> [B, N, pooled, pooled, C] in the
    features' dtype. The kernel for CUDA tensors, the plain version for
    CPU tensors; inference only."""
    return torch.ops.locov.roi_align_levels(
        list(features), boxes.float(), levels.to(torch.int32),
        [float(x) for x in scales], int(pooled), int(sampling_ratio))


# ------------------------------------------------------------------ int8
# bins a side the int8 kernel takes (csrc/roi_align_int8.cu: PMAX)
_INT8_PMAX = 16
# the threads an int8 kernel block may take, the most first
# (csrc/roi_align_int8.cu: MAX_THREADS)
_INT8_THREADS = (128, 64, 32)


def _int8_axis(lo: torch.Tensor, size: torch.Tensor, pooled: int,
               sampling_ratio: int, dim: int) -> torch.Tensor:
    """One axis's interpolation matrix [N, P, dim] (float32) for the int8
    path, in the int8 kernel's order of operations (``csrc/roi_taps.cuh``:
    ``bin_taps``, ``tap_weight``): each sample's two hat weights times its
    sample weight, the samples added in ascending order from zeros. (The
    float path's ``_interp_matrix`` sums the slots with ``sum(dim=2)``,
    whose order on CUDA is not ascending, and divides a fixed grid's sum
    by its size: an ulp apart, which flips int8 steps.)"""
    dt, dev = lo.dtype, lo.device
    bin_size = _div(size, pooled)
    if sampling_ratio > 0:
        slots = int(sampling_ratio)
        srn = torch.full_like(bin_size, float(slots))
        count = srn
    else:
        slots = ADAPTIVE_SR_MAX
        count = torch.clamp(torch.ceil(bin_size), 0.0, float(slots))
        srn = torch.clamp(count, min=1.0)
    s = torch.arange(slots, dtype=dt, device=dev)[None, :]
    pos = (s + 0.5) / srn[:, None]                                 # [N, S]
    sw = torch.where(s < count[:, None], torch.ones_like(srn)[:, None] /
                     srn[:, None], torch.zeros_like(pos))          # [N, S]
    p = torch.arange(pooled, dtype=dt, device=dev)[None, :, None]
    coords = lo[:, None, None] + (p + pos[:, None, :]) * \
        bin_size[:, None, None]                                    # [N, P, S]
    outside = (coords < -1.0) | (coords > dim)
    c = coords.clamp(0.0, dim - 1.0)
    low = torch.floor(c)
    frac = c - low
    high = torch.clamp(low + 1.0, max=dim - 1.0)
    zero = torch.zeros_like(frac)
    w_low = torch.where(outside, zero, (1.0 - frac) * sw[:, None, :])
    w_high = torch.where(outside, zero, frac * sw[:, None, :])
    grid = torch.arange(dim, dtype=dt, device=dev)
    k = torch.zeros(coords.shape[:2] + (dim,), dtype=dt, device=dev)
    for j in range(slots):
        k = k + w_low[..., j, None] * (low[..., j, None] == grid)
        k = k + w_high[..., j, None] * (high[..., j, None] == grid)
    return k


def _quantize_rows(k: torch.Tensor):
    """Symmetric per-row int8 quantization of interpolation matrices
    [B, N, P, dim] (rows are small, ~2 / sr at most, so a row scale keeps
    the weights' resolution). Returns (q int8, scale [B, N, P])."""
    scale = torch.clamp(_div(k.abs().amax(dim=-1), 127.0), min=1e-12)
    q = torch.clamp(torch.round(k / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def roi_align_batched_quant(features: torch.Tensor, boxes: torch.Tensor,
                            spatial_scale: float, amax: torch.Tensor,
                            pooled: int = 14, sampling_ratio: int = 2):
    """ROIAlign emitting int8 for the static int8 scheme: the float op
    (``roi_align_fused``), then its output quantized by the calibrated
    max-abs ``amax`` of the pooled tensor. Returns (q [B, N, P, P, C]
    int8, scale float32): ``quantize_per_tensor_static(roi_align(...),
    amax)``, as the JAX function computes it."""
    out = roi_align_fused(features, boxes, spatial_scale, pooled,
                          sampling_ratio)
    return quantize_per_tensor_static(out, amax)


def int8_matrices(boxes: torch.Tensor, ratio: torch.Tensor,
                  spatial_scale: float, h: int, w: int, pooled: int,
                  sampling_ratio: int):
    """The int8 core's matrices from the boxes [B, N, 4], in plain
    PyTorch: (kyq [B, N, P, H], kxq [B, N, P, W] int8, sx [B, N, P], the
    rescale ratio * sy [B, N, P]); ``ratio`` = s_f / s_pool, one
    element. As ``_build_kernels`` then ``_quantize_rows``, with each
    axis built by ``_int8_axis``."""
    b, n = boxes.shape[:2]
    x0, y0, bw, bh = _box_extents(boxes.float(), spatial_scale)
    ky = _int8_axis(y0, bh, pooled, sampling_ratio, h)
    kx = _int8_axis(x0, bw, pooled, sampling_ratio, w)
    kyq, sy = _quantize_rows(ky.reshape(b, n, pooled, h))
    kxq, sx = _quantize_rows(kx.reshape(b, n, pooled, w))
    return kyq, kxq, sx, ratio.reshape(()) * sy


def int8_operands(features: torch.Tensor, boxes: torch.Tensor,
                  spatial_scale: float, amax_in: torch.Tensor,
                  amax_pool: torch.Tensor, pooled: int = 14,
                  sampling_ratio: int = 0):
    """The integer core's operands, in the JAX function's order of
    operations: (fq, kyq, kxq, sx, rescale, s_pool). The interpolation
    matrices quantized per row (``int8_matrices``), the features per
    tensor by ``amax_in`` (s_f = amax_in / 127), and rescale = (s_f /
    s_pool) * sy with s_pool = amax_pool / 127 (each at least 1e-12)."""
    _, h, w, _ = features.shape
    s_f, s_pool = _scale_of(amax_in), _scale_of(amax_pool)
    fq, _ = quantize_per_tensor_static(features, amax_in)
    kyq, kxq, sx, rescale = int8_matrices(boxes, s_f / s_pool, spatial_scale,
                                          h, w, pooled, sampling_ratio)
    return fq, kyq, kxq, sx, rescale, s_pool


def roi_align_int8_plain(fq, kyq, kxq, sx, rescale,
                         chunk: int = _CHUNK) -> torch.Tensor:
    """The integer core of ``roi_align_batched_int8`` in plain PyTorch:
    fq int8 [B, H, W, C], kyq int8 [B, N, P, H], kxq int8 [B, N, P, W],
    the row scales sx [B, N, P] of kxq and the rescale [B, N, P] ->
    int8 [B, N, P, P, C]. The einsums run in float64 on integers (exact:
    every partial sum is an integer below 2^53), boxes ``chunk`` at a
    time; t and r convert to float32 exactly (below 2^24)."""
    b, n, p, _ = kyq.shape
    c = fq.shape[-1]
    f = fq.double()
    outs = []
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        t = torch.einsum("bnqw,bhwc->bnqhc", kxq[:, sl].double(), f)
        tq = torch.clamp(torch.round(t.float() * sx[:, sl, :, None, None]),
                         -127.0, 127.0)
        del t
        r = torch.einsum("bnqhc,bnph->bnpqc", tq.double(),
                         kyq[:, sl].double())
        del tq
        outs.append(torch.clamp(
            torch.round(r.float() * rescale[:, sl, :, None, None]),
            -127.0, 127.0).to(torch.int8))
    if not outs:
        return fq.new_zeros((b, 0, p, p, c))
    return torch.cat(outs, dim=1)


def roi_align_int8_boxes_plain(fq, boxes, ratio, spatial_scale: float,
                               pooled: int = 14,
                               sampling_ratio: int = 0) -> torch.Tensor:
    """The op ``locov::roi_align_int8`` in plain PyTorch: the matrices
    (``int8_matrices``), then the integer core (``roi_align_int8_plain``)."""
    _, h, w, _ = fq.shape
    return roi_align_int8_plain(fq, *int8_matrices(
        boxes, ratio, spatial_scale, h, w, pooled, sampling_ratio))


def _int8_smem(h: int, w: int, vec: int, threads: int) -> int:
    """Dynamic shared memory of an int8 kernel block, counted as
    ``smem_bytes`` of ``csrc/roi_align_int8.cu`` counts it: the box's
    operands (its matrices' rows of w and h bytes rounded up to 4, for 16
    bins, rounded up to 16 bytes; six words a bin and four more), and the
    tq rows (h rounded up to 4) of ``vec`` channels for each of the
    ``threads``."""
    r4 = lambda x: -(-x // 4) * 4  # noqa: E731
    ops = -(-_INT8_PMAX * (r4(w) + r4(h)) // 16) * 16 + \
        4 * (6 * _INT8_PMAX + 4)
    return ops + threads * r4(h) * vec


def _int8_plan(h: int, w: int, c: int, pooled: int = 14,
               align: int = 16) -> dict:
    """Launch plan of the int8 kernel (one block a box) for int8 features
    [*, h, w, c] whose address is a multiple of ``align`` bytes: the
    channels a thread takes (16 where c and the address allow it, else
    8, else 4), the threads a block (the most of ``_INT8_THREADS``, no
    more than the (bin column, channel vector) items need), the blocks
    an SM its shared memory leaves (2 or 1) and that shared memory. Each
    thread holds h x vec bytes of tq rows, so for tall features the
    channels a thread halve, then the threads, until a block's shared
    memory holds them (at h 120, 128 x 8 ran 9% faster than 64 x 16:
    chip_smoke.py's tall case). Raises where none fits."""
    if pooled > _INT8_PMAX or c % 4 or align % 4:
        raise ValueError(f"roi_align_int8: the kernel takes pooled <= "
                         f"{_INT8_PMAX} and 4-byte aligned features of C a "
                         f"multiple of 4, got pooled {pooled}, C {c}")
    vecs = [v for v in (16, 8, 4) if c % v == 0 and align % v == 0]
    need = -(-pooled * (c // vecs[0]) // 32) * 32
    for threads in (t for t in _INT8_THREADS if t <= max(need, 32)):
        for vec in vecs:
            smem = _int8_smem(h, w, vec, threads)
            if smem <= _SMEM_MAX:
                per_sm = 2 if smem <= _BWD_SMEM_TWO else 1
                return {"vec": vec, "threads": threads,
                        "blocks_per_sm": per_sm, "smem_bytes": smem}
    raise ValueError(f"roi_align_int8: features {h} x {w} need more "
                     f"shared memory than a block has")


def _check_int8_args(fq, boxes, ratio) -> None:
    if fq.dim() != 4 or boxes.dim() != 3 or boxes.shape[2] != 4 or \
            boxes.shape[0] != fq.shape[0] or ratio.numel() != 1:
        raise ValueError(f"roi_align_int8: fq {tuple(fq.shape)}, boxes "
                         f"{tuple(boxes.shape)}, ratio {tuple(ratio.shape)}")


def _launch_int8(fq, boxes, ratio, spatial_scale: float, pooled: int,
                 sampling_ratio: int, plan: dict = None,
                 fill: int = None) -> torch.Tensor:
    """One launch of the int8 kernel under ``plan`` (by default
    ``_int8_plan``'s), no launch count. ``fill``: a value the output
    holds before the launch."""
    for t, what, dts in ((fq, "fq", {torch.int8}),
                         (boxes, "boxes", {torch.float32}),
                         (ratio, "ratio", {torch.float32})):
        kernel_lib.check_cuda_tensor(t, f"roi_align_int8 {what}", dts)
    _check_int8_args(fq, boxes, ratio)
    if len({t.device for t in (fq, boxes, ratio)}) != 1:
        raise ValueError("roi_align_int8: tensors on several devices")
    if not 1 <= pooled or sampling_ratio > ADAPTIVE_SR_MAX:
        raise ValueError(f"roi_align_int8: pooled {pooled}, sampling_ratio "
                         f"{sampling_ratio} (<= {ADAPTIVE_SR_MAX})")
    b, h, w, c = fq.shape
    n = boxes.shape[1]
    if plan is None:
        plan = _int8_plan(h, w, c, pooled, _align(fq))
    out = torch.empty((b, n, pooled, pooled, c), dtype=torch.int8,
                      device=fq.device)
    if fill is not None:
        out.fill_(fill)
    if out.numel() == 0:
        return out
    kernel_lib.launch(
        "roi_align_int8_fwd", fq.device, fq.data_ptr(), boxes.data_ptr(),
        ratio.data_ptr(), out.data_ptr(), b, h, w, c, n, pooled,
        int(sampling_ratio), float(spatial_scale), plan["vec"],
        plan["threads"], plan["smem_bytes"])
    return out


def roi_align_int8_cuda(fq, boxes, ratio, spatial_scale: float,
                        pooled: int = 14,
                        sampling_ratio: int = 0) -> torch.Tensor:
    """The int8 kernel: contiguous CUDA tensors fq int8 [B, H, W, C] (C a
    multiple of 4), boxes float32 [B, N, 4], ratio float32 (one
    element); pooled at most 16."""
    out = _launch_int8(fq, boxes, ratio, spatial_scale, pooled,
                       sampling_ratio)
    if out.numel():
        kernel_lib.LAUNCHES["roi_align_int8"] += 1
    return out


@torch.library.custom_op("locov::roi_align_int8", mutates_args=(),
                         device_types="cpu")
def _roi_align_int8_op(fq: torch.Tensor, boxes: torch.Tensor,
                       ratio: torch.Tensor, spatial_scale: float,
                       pooled: int, sampling_ratio: int) -> torch.Tensor:
    _check_int8_args(fq, boxes, ratio)
    return roi_align_int8_boxes_plain(fq, boxes, ratio, spatial_scale, pooled,
                                      sampling_ratio)


@_roi_align_int8_op.register_kernel("cuda")
def _(fq, boxes, ratio, spatial_scale, pooled, sampling_ratio):
    return roi_align_int8_cuda(fq.contiguous(), boxes.contiguous(),
                               ratio.contiguous(), spatial_scale, pooled,
                               sampling_ratio)


@_roi_align_int8_op.register_fake
def _(fq, boxes, ratio, spatial_scale, pooled, sampling_ratio):
    _check_int8_args(fq, boxes, ratio)
    b, n = boxes.shape[:2]
    return fq.new_empty((b, n, pooled, pooled, fq.shape[-1]))


def roi_align_batched_int8(features: torch.Tensor, boxes: torch.Tensor,
                           spatial_scale: float, amax_in: torch.Tensor,
                           amax_pool: torch.Tensor, pooled: int = 14,
                           sampling_ratio: int = 0):
    """Full-int8 ROIAlign (static int8 serving): both separable
    contractions int8 x int8 -> int32, the intermediate requantized to
    the features' scale by the row scales of Kx (rows are convex
    weights, so no other statistic is needed), the output rescaled to
    the pooled tensor's calibrated scale. The features are quantized
    here (plain); the op ``locov::roi_align_int8`` builds the matrices
    from the boxes and contracts. Returns (q [B, N, P, P, C] int8, scale
    float32), a drop-in for ``roi_align_batched_quant``."""
    s_f, s_pool = _scale_of(amax_in), _scale_of(amax_pool)
    fq, _ = quantize_per_tensor_static(features, amax_in)
    q = torch.ops.locov.roi_align_int8(
        fq.contiguous(), boxes.float().contiguous(), (s_f / s_pool).reshape(1),
        float(spatial_scale), int(pooled), int(sampling_ratio))
    return q, s_pool
