"""Whether what the timed path produced is correct: the plain reference
(``reference/``, float32 with TF32 off) run over the same inputs from the
same seeded weights once the window has closed and the program's state
is freed, and each compared number held to its limit
(``benchmark/limits/<cell>.json``).

Training (``train``): the reference follows the program's first steps,
each on the same batch, sampler draws and dropout generator, with the
program's proposals (the NMS keeps a different set on a rounding of the
objectness), and the selection of those proposals is checked on its
own:

- ``loss_gap``: each step's total loss, |program - reference| over
  |reference|, the worst step;
- ``grad_gap``: the first gradient as SGD took it (from its momentum
  after one step), per trained leaf the gap of the program's norm from
  the reference's over the larger of the reference's norm of that leaf
  and of the median leaf, the worst leaf;
- ``update_gap``: the same of the parameters' change after the first
  steps.

Both over the leaves whose reference gradient is at least a thousandth
of the median leaf's: a leaf the loss reaches only through a shift
that the loss ignores (the matching score's bias, under the softmax over
the B x B costs; an attention key's bias) has a gradient of rounding
alone, and the program's bfloat16 rounding of it reads up to a tenth of
the median leaf's norm, swinging from seed to seed (``PERF.md``).
- ``proposals_differ``: elements of the program's proposals that the
  reference's ``select_proposals`` of the program's own RPN outputs
  does not reproduce bit for bit.

Inference (``infer``): a sample of the window's calls, drawn from the
seed; the reference's detector from the program's proposals, in float32
and in the configuration's own dtype (bfloat16: the plain computation
at the precision the configuration states). The program's errors from
float32 are read in units of the plain bfloat16 computation's, on the
same seed, so that the seed's weights, which set how far any bfloat16
computation lands from float32, fall out:

- ``rpn_mse_ratio``: the mean square of the program's RPN objectness
  less float32's, over that of the plain bfloat16 objectness;
- ``proposals_differ``: as in training;
- ``det_mse_ratio``: the same ratio for the detections: per detection,
  the gap between the log-odds of its score and of float32's
  probability of its class at the proposal whose refined box it is (IoU
  at least ``match_iou``; none there: the gap to probability 0), and
  per float32 top-``judge_top`` detection an image, the log-odds by
  which it exceeds the best detection of its class that overlaps it
  (IoU at least ``cover_iou``): detections left out.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from . import build
from .reference import steps as ref_steps


def proposals_differ(ref_select, rpn_cfg, captured: List[dict]) -> int:
    """Elements of each captured ``select_proposals`` output that the
    reference's selection of the same inputs does not give bit for
    bit."""
    bad = 0
    for c in captured:
        want = ref_select(c["anchors"], c["logits"], c["deltas"], c["hw"],
                          rpn_cfg, c["training"])
        got = c["out"]
        for g, w in zip(got, want):
            g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
            if g.dtype.is_floating_point:
                g, w = g.float().view(torch.int32), w.float().view(
                    torch.int32)
            bad += int((g != w).sum())
    return bad


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Per leaf |prog - ref| / max(ref, the median leaf's ref)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def moved(ref) -> set:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return {k for k, v in g.items() if v >= 1e-3 * med}


def train_notes(rec, ref, n: int = 4) -> Dict[str, list]:
    """The leaves with the widest gaps, for standard error."""
    out = {}
    for name, gaps in (
            ("grad", leaf_gaps(rec["grad_norms"], ref["grad_norms"],
                               keep=moved(ref))),
            ("update", leaf_gaps(rec["update_norms"], ref["update_norms"],
                                 keep=moved(ref)))):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out[name] = [[k, round(v, 6)] for k, v in top]
    out["losses"] = [rec["losses"], ref["losses"]]
    return out


def _batch(types, arrays: dict, device):
    return types.to_torch(types.DetectionBatch(
        images=types.ImageBatch(**arrays["images"]),
        gt=types.GtBatch(**arrays["gt"]) if "gt" in arrays else None,
        text=types.TextBatch(**arrays["text"]) if "text" in arrays
        else None), device)


def reference_model(run, dtype: str = "float32"):
    from .reference.locov_ref.models import build_meta_arch
    cfg = build.reference_cfg(run.config, dtype)
    model = build_meta_arch(cfg, device=run.device)
    model.load_state_dict(build.make_weights(
        model, run.seed, run.device, run.config["trained_scale"]))
    return cfg, model


def reference_train(run, rec) -> Dict[str, object]:
    """The reference's first steps (losses, first gradient norms,
    change norms) from the program's proposals, and the selection's
    check."""
    import importlib
    from .reference.locov_ref.engine.solver import build_optimizer
    from .reference.locov_ref.structures import batches as types
    cfg, model = reference_model(run)
    module = importlib.import_module(type(model).__module__)
    optimizer, scheduler = build_optimizer(cfg, model)
    trained = {n: q for n, q in model.named_parameters() if q.requires_grad}
    p0 = {n: q.detach().clone() for n, q in trained.items()}
    traffic = rec["shapes"]["traffic"]
    class_emb = torch.from_numpy(traffic.class_emb).to(run.device)
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    out = {"proposals_differ": proposals_differ(
        module.select_proposals, model.rpn_cfg, rec["proposals"])}
    losses = []
    from .loops import first_gradients
    with ref_steps.no_tf32(), ref_steps.forced_proposals(
            module, [c["out"] for c in rec["proposals"]]):
        for k, s in enumerate(rec["steps"]):
            batch = _batch(types, traffic.request(k)[1], run.device)
            losses.append(float(ref_steps.train_step(
                model, optimizer, scheduler, batch, class_emb, gen,
                s["uniforms"])))
            if k == 0:
                out["grad_norms"] = first_gradients(optimizer, trained, p0)
    out["losses"] = losses
    out["update_norms"] = {n: float((q.detach() - p0[n]).norm())
                           for n, q in trained.items()}
    return out


def train_numbers(rec, ref) -> Dict[str, float]:
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(rec["losses"], ref["losses"])),
        "grad_gap": worst_leaf(rec["grad_norms"], ref["grad_norms"],
                               keep=moved(ref)),
        "update_gap": worst_leaf(rec["update_norms"], ref["update_norms"],
                                 keep=moved(ref)),
        "proposals_differ": float(ref["proposals_differ"]),
    }


def log_odds(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(LOG_ODDS_EPS, 1 - LOG_ODDS_EPS)
    return torch.log(p) - torch.log1p(-p)


LOG_ODDS_EPS = 1e-6


def judge_detections(dets, ref, match_iou: float, cover_iou: float,
                     judge_top: int) -> Dict[str, list]:
    """One call's program detections (host) against the reference's
    ``detect`` output: per program detection the log-odds gap of its
    score from the reference's probability of its class at the proposal
    whose refined box it is (the smallest over the proposals at IoU
    ``match_iou`` or more; none there: against probability 0), and per
    reference top-``judge_top`` detection an image the score by which it
    exceeds the best program detection of its class that overlaps it
    (IoU ``cover_iou`` or more)."""
    from .reference.locov_ref.structures.boxes import pairwise_iou
    dev = ref["probs"].device
    boxes, scores = dets.boxes.to(dev).float(), dets.scores.to(dev).float()
    classes, mask = dets.classes.to(dev).long(), dets.mask.to(dev)
    gaps, missed, covers = [], [], []
    for i in range(boxes.shape[0]):
        m = mask[i]
        b, s, c = boxes[i][m], scores[i][m], classes[i][m]
        if b.shape[0]:
            iou = pairwise_iou(b, ref["boxes"][i])            # [D, N]
            iou = torch.where(ref["valid"][i][None], iou,
                              torch.zeros_like(iou))
            p = ref["probs"][i][:, c].t()                    # [D, N]
            gap = (log_odds(p) - log_odds(s)[:, None]).abs()
            gap = torch.where(iou >= match_iou, gap,
                              torch.full_like(gap, float("inf")))
            best = gap.min(dim=1).values
            none = (log_odds(s) - log_odds(torch.zeros_like(s))).abs()
            gaps.append(torch.where(torch.isinf(best), none, best))
        rm = ref["det_mask"][i]
        rb, rs = ref["det_boxes"][i][rm], ref["det_scores"][i][rm]
        rc = ref["det_classes"][i][rm].long()
        top = torch.argsort(rs, descending=True)[:judge_top]
        rb, rs, rc = rb[top], rs[top], rc[top]
        if rb.shape[0]:
            cover = torch.zeros_like(rs)
            if b.shape[0]:
                iou = pairwise_iou(rb, b)                    # [R, D]
                ok = (iou >= cover_iou) & (rc[:, None] == c[None])
                cover = torch.where(ok, s[None].expand_as(iou),
                                    torch.zeros_like(iou)).max(dim=1).values
            missed.append((rs - cover).clamp(min=0))
            covers.append(cover.clamp(max=1.0))
    return {"gaps": gaps, "missed": missed, "cover": covers}


def _judged(dets, ref, p) -> Dict[str, torch.Tensor]:
    j = judge_detections(dets, ref, p["match_iou"], p["cover_iou"],
                         p["judge_top"])
    empty = torch.zeros(0, device=ref["probs"].device)
    return {k: torch.cat(v) if v else empty for k, v in j.items()}


def _as_detections(ref):
    """The reference's detections as the program's ``Detections`` hold
    them."""
    from .reference.locov_ref.structures.batches import Detections
    return Detections(boxes=ref["det_boxes"], scores=ref["det_scores"],
                      classes=ref["det_classes"], mask=ref["det_mask"])


def infer_numbers(run, rec, notes=None) -> Dict[str, float]:
    """The reference's detector on each sampled call, from the
    program's proposals, in float32 and in the configuration's own
    dtype (the plain computation at the precision the configuration
    states). The program's errors from float32 are read in units of the
    plain computation's: ``rpn_mse_ratio``, the mean square of the
    program's RPN objectness less float32's over that of the plain
    bfloat16 objectness; ``det_mse_ratio``, the same of the detections'
    log-odds gaps and of the missed top detections' log-odds
    (``judge_detections``); absolute readings go to ``notes``."""
    import importlib
    from .reference.locov_ref.structures import batches as types
    p = run.traffic
    _, model = reference_model(run)
    _, low = reference_model(run, run.config["dtype"])
    model.eval()
    low.eval()
    module = importlib.import_module(type(model).__module__)
    class_emb = torch.from_numpy(
        rec["shapes"]["traffic"].class_emb).to(run.device)
    differ = 0
    sq = {"rpn": 0.0, "rpn_low": 0.0, "det": [], "det_low": []}
    widest = {"rpn": 0.0, "det_gap": 0.0, "det_missed": 0.0}
    absolute = {"rpn": [], "gaps": [], "missed": []}
    with ref_steps.no_tf32():
        for s in rec["sample"]:
            (cap,) = s["proposals"]
            differ += proposals_differ(module.select_proposals,
                                       model.rpn_cfg, [cap])
            batch = _batch(types, s["arrays"], run.device)
            ref = ref_steps.detect(model, batch, class_emb, cap["out"])
            ref_low = ref_steps.detect(low, batch, class_emb, cap["out"])
            lr = ref["logits"]
            d = cap["logits"].float() - lr
            d_low = ref_low["logits"].float() - lr
            sq["rpn"] += float(d.pow(2).sum())
            sq["rpn_low"] += float(d_low.pow(2).sum())
            absolute["rpn"].append(float(d.pow(2).mean() / lr.var()))
            widest["rpn"] = max(widest["rpn"],
                                float(d.abs().max() / lr.std()))
            for key, dets in (("det", s["dets"]),
                              ("det_low", _as_detections(ref_low))):
                j = _judged(dets, ref, p)
                missed = (log_odds(j["missed"] + j["cover"])
                          - log_odds(j["cover"])).clamp(min=0)
                sq[key].append(torch.cat([j["gaps"], missed]))
                if key == "det":
                    absolute["gaps"].append(j["gaps"])
                    absolute["missed"].append(j["missed"])
    det, det_low = torch.cat(sq["det"]), torch.cat(sq["det_low"])
    gaps, missed = torch.cat(absolute["gaps"]), torch.cat(absolute["missed"])
    if notes is not None:
        notes.update(
            rpn_rms=statistics.mean(absolute["rpn"]) ** 0.5,
            rpn_widest=widest["rpn"], det_logit_rms=_rms(gaps),
            det_logit_widest=_widest(gaps),
            det_missed_mean=float(missed.mean()) if missed.numel() else 0.0,
            det_missed_widest=_widest(missed), det_rms=_rms(det),
            det_rms_low=_rms(det_low),
            detections=int(gaps.numel()), judged=int(missed.numel()))
    return {"rpn_mse_ratio": _ratio(sq["rpn"], sq["rpn_low"]),
            "proposals_differ": float(differ),
            "det_mse_ratio": _ratio(_rms(det) ** 2, _rms(det_low) ** 2)}


def _rms(x: torch.Tensor) -> float:
    return float(x.pow(2).mean().sqrt()) if x.numel() else 0.0


def _widest(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _ratio(prog: float, low: float) -> float:
    """The program's mean square over the plain computation's; where
    both are 0 (a seed whose weights leave no detection above the
    threshold, on either side), they agree: 1."""
    if prog == 0.0 and low == 0.0:
        return 1.0
    return prog / max(low, 1e-30)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
