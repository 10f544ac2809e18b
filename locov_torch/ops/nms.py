"""Exact greedy NMS on padded batches, in plain PyTorch ops.

Counterpart of ``locov_tpu/ops/nms.py``, with the same algorithm and
the same keep sets: sort by score (stable), then decide the boxes one
tile at a time. Each tile is first suppressed by the survivors of
earlier tiles (one [B, T, *] IoU block), then resolved internally by
the fixed-point iteration ``alive <- init & ~overlaps(alive)``, which
converges to the greedy solution in at most T sweeps. Everything stays
on the device; the host reads one flag per convergence check and, on
the ``stop_after`` path, one per tile.

Per-class suppression masks the suppression matrices by class equality
instead of offsetting coordinates by class (torchvision's trick loses
float32 precision at offset scale and breaks on negative coordinates).

``nms_mask_batched`` is the ``torch.library`` custom op
``locov::nms_mask``, the same PyTorch code on every device: its host
reads would stop ``torch.export``'s trace, and its fake implementation
(a bool [B, N]) lets the trace pass over it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.trace import wait

# sweeps of the in-tile fixed point between two convergence checks
_SWEEPS_PER_CHECK = 4


def _pick_tile(stop_after: int) -> int:
    """Tile size of the suppression sweep: big tiles for deep top-k
    targets (fewer trips), small ones otherwise (the survivor buffer is
    padded to stop_after + tile). Same rule as the JAX package."""
    return 512 if stop_after >= 2000 else 256


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis with ``jax.lax.top_k``'s tie order:
    among equal values the lower index comes first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _pairwise_iou_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, 4] x [B, N, 4] -> [B, M, N] IoU."""
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    union = area_a[:, :, None] + area_b[:, None, :] - inter
    return torch.where(inter > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def _pad_axis1(x: torch.Tensor, multiple: int, value) -> torch.Tensor:
    rem = (-x.shape[1]) % multiple
    if rem == 0:
        return x
    pad = x.new_full((x.shape[0], rem) + tuple(x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


def _self_suppress(iou_self: torch.Tensor, init_alive: torch.Tensor,
                   iou_threshold: float, same_class) -> torch.Tensor:
    """Greedy keep set inside one score-sorted tile. iou_self [B, T, T],
    init_alive [B, T] (boxes not yet suppressed from outside)."""
    t = iou_self.shape[1]
    earlier = torch.ones(t, t, dtype=torch.bool,
                         device=iou_self.device).triu(1)  # [j, k]: j < k
    sup_mat = (iou_self > iou_threshold) & earlier & same_class

    def sweep(alive):
        return init_alive & ~(sup_mat & alive[:, :, None]).any(dim=1)

    alive = sweep(init_alive)
    for _ in range(0, t + 1, _SWEEPS_PER_CHECK):
        nxt = alive
        for _ in range(_SWEEPS_PER_CHECK):
            nxt = sweep(nxt)
        # sweep(fixpoint) == fixpoint, so extra sweeps are harmless
        with wait("nms_converge"):
            same = torch.equal(nxt, alive)
        if same:
            break
        alive = nxt
    return alive


@torch.library.custom_op("locov::nms_mask", mutates_args=())
def nms_mask_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     stop_after: int = 0,
                     classes: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Greedy NMS keep-mask over padded boxes, batched.

    boxes [B, N, 4] XYXY; scores [B, N]; valid [B, N] bool; classes
    [B, N] int (optional: suppression only acts within a class).
    Returns keep [B, N] bool in the ORIGINAL order.

    stop_after > 0 (exact for top-k consumers, as in the JAX package):
    the sweep stops once every row has ``stop_after`` survivors among
    the decided boxes, and later boxes are reported suppressed; with
    more than two tiles, each tile is checked against a compacted
    buffer of the alive earlier boxes (capacity stop_after + one tile)
    instead of all earlier boxes. A row that overflows the buffer may
    mis-decide boxes after its ``stop_after``-th survivor only.
    """
    tile = _pick_tile(stop_after)
    bsz, n = scores.shape
    dev = boxes.device
    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    order = torch.sort(-masked, dim=1, stable=True).indices
    boxes_p = _pad_axis1(
        torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
        tile, 0.0)
    active = _pad_axis1(torch.gather(valid, 1, order), tile, False)
    cls_p = None if classes is None else _pad_axis1(
        torch.gather(classes, 1, order), tile, -1)
    n_pad = boxes_p.shape[1]
    num_tiles = n_pad // tile

    def tile_classes(start):
        if cls_p is None:
            return None, True
        tc = cls_p[:, start:start + tile]
        return tc, tc[:, :, None] == tc[:, None, :]

    if stop_after > 0 and num_tiles > 2:
        cap = min(-(-(stop_after + tile) // tile) * tile, n_pad)
        slot = torch.arange(cap, device=dev)
        # one spare slot takes the writes of boxes that do not fit
        surv = boxes_p.new_zeros(bsz, cap + 1, 4)
        scls = torch.zeros(bsz, cap + 1, dtype=torch.long, device=dev)
        cnt = torch.zeros(bsz, dtype=torch.long, device=dev)
        i = 0
        while i < num_tiles:
            full = (cnt >= stop_after).all()
            with wait("nms_tile"):
                done = bool(full)
            if done:
                break
            start = i * tile
            tb = boxes_p[:, start:start + tile]
            hit = (_pairwise_iou_b(tb, surv[:, :cap]) > iou_threshold) & \
                (slot[None, None, :] < cnt[:, None, None])
            tc, self_ok = tile_classes(start)
            if tc is not None:
                # buffered classes are stored +1: empty slots never match
                hit &= (tc[:, :, None] + 1) == scls[:, None, :cap]
            alive = _self_suppress(
                _pairwise_iou_b(tb, tb),
                active[:, start:start + tile] & ~hit.any(dim=2),
                iou_threshold, self_ok)
            alive_i = alive.long()
            csum = torch.cumsum(alive_i, dim=1)
            dst = cnt[:, None] + csum - alive_i
            dst = torch.where(alive & (dst < cap), dst,
                              torch.full_like(dst, cap))
            surv.scatter_(1, dst[..., None].expand(-1, -1, 4), tb)
            if tc is not None:
                scls.scatter_(1, dst, tc.long() + 1)
            cnt = (cnt + csum[:, -1]).clamp(max=cap)
            active[:, start:start + tile] = alive
            i += 1
        # everything past the stop point is reported suppressed
        active &= torch.arange(n_pad, device=dev)[None, :] < i * tile
    else:
        pos = torch.arange(n_pad, device=dev)
        for i in range(num_tiles):
            start = i * tile
            tb = boxes_p[:, start:start + tile]
            tc, self_ok = tile_classes(start)
            cross = (_pairwise_iou_b(tb, boxes_p) > iou_threshold) & \
                (pos < start)[None, None, :] & active[:, None, :]
            if tc is not None:
                cross &= tc[:, :, None] == cls_p[:, None, :]
            active[:, start:start + tile] = _self_suppress(
                _pairwise_iou_b(tb, tb),
                active[:, start:start + tile] & ~cross.any(dim=2),
                iou_threshold, self_ok)
    keep = torch.zeros(bsz, n, dtype=torch.bool, device=dev)
    return keep.scatter_(1, order, active[:, :n])


@nms_mask_batched.register_fake
def _(boxes, scores, valid, iou_threshold, stop_after=0, classes=None):
    return torch.empty_like(valid)


def nms_topk_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS returning the top-``max_out`` surviving indices per
    row: (idx [B, max_out] int32, keep_valid [B, max_out] bool)."""
    keep = nms_mask_batched(boxes, scores, valid, iou_threshold,
                            stop_after=max_out)
    neg_inf = torch.finfo(scores.dtype).min
    kept = torch.where(keep, scores, torch.full_like(scores, neg_inf))
    top, idx = top_k(kept, max_out)
    return idx.to(torch.int32), top > neg_inf


def batched_nms_mask_batched(boxes, scores, classes, valid,
                             iou_threshold: float,
                             stop_after: int = 0) -> torch.Tensor:
    """Per-class NMS, batched: suppression acts only within a class
    (class-equality masking, see ``nms_mask_batched``)."""
    return nms_mask_batched(boxes, scores, valid, iou_threshold,
                            stop_after=stop_after, classes=classes)
