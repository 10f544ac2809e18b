"""What the benchmark reads of the two cells it has stays as it was
before the stage tables, the reference's extensions and meta-
architectures, the detector's check and the weights' laws were made
open to new files (on the CPU):

- the stage tables merged from ``benchmark/stages/`` equal the literals
  that ``trace.py`` and ``spans.py`` held, and a stage given two buckets
  raises;
- on the tiny cells (``tiny.py``), the reference's
  ``detect_from_proposals`` equals bit for bit a copy of the former
  ``reference/steps.py:detect`` (the inference cell's model),
  ``build.make_weights`` a copy of the former one (both cells, both
  sides), and a run's compared numbers (with a fault planted, so that
  they are not all 0) those of a run with both copies in place.
"""
import json
from typing import Dict

import pytest
import torch

from benchmark import build, spans, trace
from benchmark.control import half_step
from benchmark.reference import steps as ref_steps
from benchmark.tests.test_bench_faults import altered_step
from benchmark.tests.tiny import CELLS, cpu_run, tiny_cell
from benchmark.traffic.detection import Traffic

SUBSYSTEMS = (
    ("backbone", ("backbone",)),
    ("res5", ("roi_features", "grid_features")),
    ("rpn+nms", ("rpn_head", "rpn_losses", "select_proposals",
                 "fast_rcnn_inference")),
    ("mmss_heads", ("grid_mmss", "box_mmss", "fused_mmss", "distill")),
    ("language", ("language",)),
    ("optimizer", ("optimizer",)),
    ("boxes/match", ("label_and_sample", "predict", "roi_heads_losses")),
    ("backward (unattributed)", ("backward",)),
)
STAGE_PREFIXES = ("OvrRCNN.", "DistillProposalMMSSRCNN.", "MMSSGridModel.",
                  "train_step.", "eval.")
BACKWARD_BUCKETS = (
    ("trunk", ("backbone",)),
    ("res5", ("roi_features", "grid_features")),
    ("mmss", ("grid_mmss", "box_mmss", "fused_mmss", "distill")),
    ("language", ("language",)),
    ("rpn", ("rpn_head", "rpn_losses")),
    ("boxes", ("label_and_sample", "predict", "box_regions")),
)


@torch.no_grad()
def parent_make_weights(model: torch.nn.Module, seed: int, device,
                        trained_scale: bool) -> Dict[str, torch.Tensor]:
    """The former ``build.make_weights``. The model's state dict from ``seed``, with the laws of the
    port's seeded initialisation: trunk convs He-normal over fan-out
    truncated at 2 sigma, the RPN's convs N(0, 0.01), plain linear layers
    N(0, 0.01) (``bbox_pred`` N(0, 0.001)), the BERT layers with an
    ``init_std`` N(0, init_std), other Dense layers LeCun-normal
    truncated, the embedding tables N(0, initializer_range); biases 0,
    LayerNorm and FrozenBN the identity. ``trained_scale``: the stem
    conv / 57 and every bottleneck's last FrozenBN scale 0.2, the scale
    of trained weights. The RPN's objectness filter is drawn once and
    shared by every anchor type: with a filter of its own, each type
    takes a random offset, the types with the largest fill the top-k, and
    the NMS's work, which depends on how much those anchors overlap,
    changes threefold from seed to seed. All normal draws come from one
    ``randn`` and all truncated ones from one ``trunc_normal_`` on the
    device, in ``state_dict`` order. Raises where a leaf has no law."""
    laws: Dict[str, tuple] = {}
    for name, mod in model.named_modules():
        kind = type(mod).__name__
        pre = name + "." if name else ""
        if kind == "FrozenBatchNorm":
            for leaf, val in (("weight", 1.0), ("bias", 0.0),
                              ("running_mean", 0.0), ("running_var", 1.0)):
                laws[pre + leaf] = ("const", val)
        elif isinstance(mod, torch.nn.LayerNorm):
            laws[pre + "weight"] = ("const", 1.0)
            laws[pre + "bias"] = ("const", 0.0)
        elif kind == "BertEmbeddings":
            for leaf in ("word_embeddings", "position_embeddings",
                         "token_type_embeddings"):
                laws[pre + leaf] = ("normal", mod.cfg.initializer_range)
        elif kind == "BertLMHead":
            laws[pre + "decoder_bias"] = ("const", 0.0)
        elif isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            shape = tuple(mod.weight.shape)
            leaf = name.rsplit(".", 1)[-1]
            if kind == "Dense":
                law = ("trunc", shape[1] ** -0.5) if mod.init_std is None \
                    else ("normal", mod.init_std)
            elif isinstance(mod, torch.nn.Linear):
                law = ("normal", 0.001 if leaf == "bbox_pred" else 0.01)
            elif ".rpn_head." in f".{name}.":
                law = ("normal", 0.01)
            else:
                law = ("trunc", (2.0 / (shape[0] * shape[2] *
                                        shape[3])) ** 0.5)
            laws[pre + "weight"] = law
            if mod.bias is not None:
                laws[pre + "bias"] = ("const", 0.0)
    state = model.state_dict()
    for k in state:  # the static int8 scheme's max-abs, calibrated later
        if k.endswith(("_amax.amax", "pooled_amax", "roialign_amax")):
            laws[k] = ("const", 0.0)
    missing = [k for k in state if k not in laws]
    if missing:
        raise ValueError(f"no initial law for {missing[:5]}")
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for law in ("normal", "trunc"):
        keys = [k for k in state if laws[k][0] == law]
        total = sum(state[k].numel() for k in keys)
        flat = torch.empty(total, device=device)
        if law == "normal":
            flat.normal_(generator=gen)
        else:
            torch.nn.init.trunc_normal_(flat, std=1.0, a=-2.0, b=2.0,
                                        generator=gen)
        off = 0
        for k in keys:
            n = state[k].numel()
            std = laws[k][1] / (build.TRUNC if law == "trunc" else 1.0)
            out[k] = (flat[off:off + n] * std).view(state[k].shape)
            off += n
    for k in state:
        if laws[k][0] == "const":
            out[k] = torch.full(state[k].shape, laws[k][1],
                                dtype=state[k].dtype, device=device)
    # one objectness filter for every anchor type: a seeded filter a type
    # gives each type a random offset, one type then fills the top-k and
    # the NMS's work swings with the seed
    key = "rpn_head.objectness_logits.weight"
    if key in out:
        out[key] = out[key][:1].expand_as(out[key]).clone()
    if trained_scale:
        out["backbone.stem.conv1.weight"] = \
            out["backbone.stem.conv1.weight"] / 57.0
        for name, mod in model.named_modules():
            if type(mod).__name__ == "BottleneckBlock":
                key = f"{name}.conv3_norm.weight"
                out[key] = torch.full_like(out[key], 0.2)
    return {k: out[k] for k in state}


@torch.inference_mode()
def parent_detect(model, batch, class_emb,
                  proposals) -> Dict[str, torch.Tensor]:
    """The former ``reference/steps.py:detect``. The detector from the given proposals: the reference's RPN
    logits, each proposal's class probabilities and refined box in the
    original image's frame, and the detections
    (``fast_rcnn_inference_batched``), as ``OvrRCNN._inference`` computes
    them."""
    from benchmark.reference.locov_ref.models.box_predictor import \
        fast_rcnn_inference_batched
    from benchmark.reference.locov_ref.structures import boxes as box_ops
    images = batch.images
    x = model.preprocess(images)
    features = model.backbone(x)["res4"]
    _, logits, _ = model.run_rpn(features)
    feats = model.roi_heads.roi_features(features, proposals.boxes)
    scores, deltas = model.roi_heads.predict(feats.float(),
                                             class_emb.float())
    dets = fast_rcnn_inference_batched(scores, deltas, proposals.boxes,
                                       proposals.mask, images.hw,
                                       model.pcfg)
    scale = images.orig_hw.float() / images.hw.float()

    def to_orig(b):
        b = box_ops.scale(b, scale[:, None, 1], scale[:, None, 0])
        return box_ops.clip(b, (images.orig_hw[:, 0:1],
                                images.orig_hw[:, 1:2]))
    boxes = box_ops.apply_deltas(deltas, proposals.boxes,
                                 model.pcfg.bbox_reg_weights)
    boxes = box_ops.clip(boxes, (images.hw[:, 0:1], images.hw[:, 1:2]))
    return {"logits": logits, "probs": torch.softmax(scores, -1)[..., :-1],
            "boxes": to_orig(boxes), "valid": proposals.mask,
            "det_boxes": to_orig(dets.boxes), "det_scores": dets.scores,
            "det_classes": dets.classes, "det_mask": dets.mask}


def test_the_stage_tables_are_the_former_literals():
    assert trace.SUBSYSTEMS == SUBSYSTEMS
    assert trace.STAGE_PREFIXES == STAGE_PREFIXES
    assert spans.BACKWARD_BUCKETS == BACKWARD_BUCKETS
    assert trace.BUCKET_OF_STAGE == {s: b for b, st in SUBSYSTEMS
                                     for s in st}
    assert spans.BUCKET_OF_STAGE == {s: b for b, st in BACKWARD_BUCKETS
                                     for s in st}


def _write(d, name, table):
    (d / name).write_text(json.dumps(table))


def test_a_family_file_adds_its_prefix_and_stages(tmp_path):
    _write(tmp_path, "a.json", {"prefixes": ["A.", "step."],
                                "forward": {"x": ["s", "t"]}})
    _write(tmp_path, "b.json", {"prefixes": ["B.", "step."],
                                "forward": {"x": ["t", "u"], "y": ["v"]},
                                "backward": {"z": ["v"]}})
    (tmp_path / "notes.txt").write_text("not a table")
    t = trace.stage_tables(str(tmp_path))
    assert t["prefixes"] == ("A.", "step.", "B.")
    assert t["forward"] == (("x", ("s", "t", "u")), ("y", ("v",)))
    assert t["backward"] == (("z", ("v",)),)


def test_a_stage_in_two_buckets_raises(tmp_path):
    _write(tmp_path, "a.json", {"forward": {"x": ["s"]}})
    _write(tmp_path, "b.json", {"forward": {"y": ["s"]}})
    with pytest.raises(ValueError, match=r"'x' in a\.json, 'y' in b\.json"):
        trace.stage_tables(str(tmp_path))
    # one stage may take different buckets on the two sides
    _write(tmp_path, "b.json", {"backward": {"y": ["s"]}})
    assert trace.stage_tables(str(tmp_path))["backward"] == (("y", ("s",)),)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 13])
def test_detect_from_proposals_is_the_former_detect(seed):
    """The inference cell's model (the LSM cell's has no detector of its
    own: its box predictor takes the MMSS heads' projection, and no check
    calls ``detect`` on it)."""
    import importlib
    from benchmark.check import _batch
    from benchmark.reference.locov_ref.models import build_meta_arch
    from benchmark.reference.locov_ref.structures import batches as types
    c = tiny_cell("stt_infer_b8")
    model = build_meta_arch(build.reference_cfg(c["config"]), device="cpu")
    model.load_state_dict(build.make_weights(model, seed, "cpu", True))
    model.eval()
    module = importlib.import_module(type(model).__module__)
    traffic = Traffic(c["traffic"], seed)
    class_emb = torch.from_numpy(traffic.class_emb)
    for i in range(3):  # a bucket each
        batch = _batch(types, traffic.request(i)[1], "cpu")
        with torch.inference_mode():
            anchors, logits, deltas = model.run_rpn(
                model.backbone(model.preprocess(batch.images))["res4"])
            proposals = module.select_proposals(
                anchors, logits, deltas, batch.images.hw, model.rpn_cfg)
        got = ref_steps.detect(model, batch, class_emb, proposals)
        want = parent_detect(model, batch, class_emb, proposals)
        assert list(got) == list(want)
        assert int(want["det_mask"].sum()) > 0
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("side", ["program", "reference"])
def test_make_weights_is_the_former_one(cell, side):
    from benchmark.reference.locov_ref.models import \
        build_meta_arch as build_reference
    from locov_torch.models import build_meta_arch
    conf = tiny_cell(cell)["config"]
    model = build_meta_arch(build.program_cfg(conf), device="cpu") \
        if side == "program" else \
        build_reference(build.reference_cfg(conf), device="cpu")
    got = build.make_weights(model, 2 ** 31 + 9, "cpu", True)
    want = parent_make_weights(model, 2 ** 31 + 9, "cpu", True)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


FAULTS = {"lsm_global_b32": half_step, "stt_infer_b8": altered_step}


@pytest.mark.parametrize("cell", CELLS)
def test_the_compared_numbers_are_the_former_ones(cell, monkeypatch):
    """A fault planted, so that the numbers read something."""
    got = cpu_run(cell, seed=2 ** 31 + 21, wrap_step=FAULTS[cell])
    monkeypatch.setattr(ref_steps, "detect", parent_detect)
    monkeypatch.setattr(build, "make_weights", parent_make_weights)
    want = cpu_run(cell, seed=2 ** 31 + 21, wrap_step=FAULTS[cell])
    assert got["checked"] == want["checked"]
    assert got["correct"] is want["correct"] is False
