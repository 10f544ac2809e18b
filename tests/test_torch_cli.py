"""The port's CLI, ``python -m locov_torch.train_ovnet`` (the twin of
train_ovnet.py), driven in the process with ``--device cpu`` through
both LocOV stages on a micro-COCO tree at the parity tests' narrow
widths, as the JAX package's tests/test_cli.py and test_integration.py
drive theirs:

1. LSM from configs/coco_lsm.yaml: three steps, a checkpoint each
   (pruned to the last two), the loss-and-detection evaluation of
   ``coco_captions_val``;
2. the same command with ``--resume`` and more steps: it starts at the
   saved iteration plus 1;
3. STT from configs/coco_stt.yaml with ``MODEL.WEIGHTS`` the LSM's
   ``model_final``: the import report of the hand-off, two steps, the
   evaluation;
4. ``--eval-only`` of the STT checkpoint with ``TEST.EXPECTED_RESULTS``:
   the same AP as the end of stage 3.

Also: ``config.yaml`` in OUTPUT_DIR, two ranks on the CPU
(``--num-gpus 2 --device cpu``), the raises on what is not ported, and
no fallback to the CPU when no GPU is present.
"""
import json
import os

import numpy as np
import pytest
import torch

from locov_torch import train_ovnet
from locov_torch.data.synthetic import make_micro_coco
from test_torch_eval_helpers import fresh_catalogs
from torch_parity import two_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
          "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
          "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
          "MODEL.PIXEL_STD", "[57.375, 57.12, 58.395]",
          "MODEL.ROI_BOX_HEAD.EMB_DIM", "16",
          "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
          "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
          "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
          "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
          "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
          "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "96",
          "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
          "TPU.IMAGE_BUCKETS", "((96, 96),)", "TPU.MAX_GT_BOXES", "16",
          "TPU.MAX_PRECOMPUTED_PROPOSALS", "8", "TPU.TEXT_MAX_LEN", "12",
          "TPU.COMPUTE_DTYPE", "float32",
          "TEST.DETECTIONS_PER_IMAGE", "8", "TEST.IMS_PER_BATCH", "4",
          "SOLVER.IMS_PER_BATCH", "4", "SOLVER.BASE_LR", "0.0001",
          "SOLVER.WARMUP_ITERS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
          "SOLVER.LOG_PERIOD", "1", "TEST.EVAL_PERIOD", "0",
          "DATALOADER.NUM_WORKERS", "0", "SEED", "7"]
BERT = ["vocab_size", "200", "hidden_size", "16", "num_hidden_layers", "2",
        "num_attention_heads", "2", "intermediate_size", "32",
        "max_position_embeddings", "16"]
LSM = (["MODEL.WEIGHTS", "", "MODEL.ROI_HEADS.NUM_CLASSES", "3",
        "MODEL.MMSS_HEAD.SPATIAL_DROPOUT", "6"]
       + [f"{node}.BERT_CONFIG.{BERT[i]}" if j == 0 else BERT[i + 1]
          for node in ("MODEL.LANGUAGE_BACKBONE",
                       "MODEL.MMSS_HEAD.TRANSFORMER")
          for i in range(0, len(BERT), 2) for j in (0, 1)])


def run(flags, opts):
    """``main`` of ``train_ovnet`` on ``flags`` then the ``KEY VALUE``
    overrides ``opts`` (argparse takes the flags before the overrides)."""
    fresh_catalogs()
    args = train_ovnet.default_argument_parser().parse_args(
        list(flags) + list(opts))
    return train_ovnet.main(args)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_micro"))
    make_micro_coco(root)
    common = NARROW + ["DATASETS.ROOT", root]
    lsm_out = os.path.join(root, "lsm")
    lsm_flags = ["--config-file", os.path.join(REPO, "configs",
                                               "coco_lsm.yaml"),
                 "--device", "cpu"]
    lsm_opts = common + LSM + ["OUTPUT_DIR", lsm_out]
    lsm = run(lsm_flags, lsm_opts + ["SOLVER.MAX_ITER", "3"])
    lsm_dir = next(os.path.join(root, d) for d in os.listdir(root)
                   if d.startswith("lsm-"))
    rows = [json.loads(ln) for ln in open(os.path.join(lsm_dir,
                                                       "metrics.json"))]
    files = sorted(os.listdir(lsm_dir))
    resumed = run(lsm_flags + ["--resume"],
                  lsm_opts + ["SOLVER.MAX_ITER", "4"])
    rows2 = [json.loads(ln) for ln in open(os.path.join(lsm_dir,
                                                        "metrics.json"))]
    stt_flags = ["--config-file", os.path.join(REPO, "configs",
                                               "coco_stt.yaml"),
                 "--device", "cpu"]
    stt_opts = common + [
        "DATASETS.TEST", "('coco_zeroshot_val',)",
        "TEST.EVAL_INIT", "False", "SOLVER.MAX_ITER", "2",
        "MODEL.ROI_HEADS.NUM_CLASSES", "3",
        "OUTPUT_DIR", os.path.join(root, "stt")]
    stt = run(stt_flags, stt_opts + [
        "MODEL.WEIGHTS", os.path.join(lsm_dir, "model_final")])
    stt_dir = next(os.path.join(root, d) for d in os.listdir(root)
                   if d.startswith("stt-"))
    report = json.load(open(os.path.join(stt_dir, "import_report.json")))
    yield dict(root=root, lsm=lsm, lsm_dir=lsm_dir, rows=rows, files=files,
               resumed=resumed, rows2=rows2, stt=stt, stt_dir=stt_dir,
               stt_flags=stt_flags, stt_opts=stt_opts, report=report)
    fresh_catalogs()


def test_lsm_stage_trains_checkpoints_and_evaluates(stages):
    assert stages["files"] == sorted(
        ["config.yaml", "last_checkpoint", "metrics.csv", "metrics.json",
         "model_0000001", "model_0000002", "model_final"]
        + [f for f in stages["files"] if f.startswith("events.out")])
    assert open(os.path.join(stages["lsm_dir"],
                             "config.yaml")).read().startswith("CUDNN")
    rows = stages["rows"]
    assert [r["iteration"] for r in rows] == list(range(3))
    assert all(v == v and abs(v) < float("inf")
               for r in rows for k, v in r.items() if "loss" in k)
    res = stages["lsm"]["coco_captions_val"]
    for k in ("Total Loss", "CE_loss (Align Words, Choose Caption)",
              "Masked Language Modeling Loss", "AP50", "AP"):
        assert k in res, k


def test_lsm_resume_starts_after_the_saved_iteration(stages):
    rows = stages["rows2"][len(stages["rows"]):]
    assert [r["iteration"] for r in rows] == [3]
    assert "Total Loss" in stages["resumed"]["coco_captions_val"]
    assert open(os.path.join(stages["lsm_dir"],
                             "last_checkpoint")).read() == "model_0000003"


def test_stt_stage_takes_the_lsm_weights(stages):
    rep = stages["report"]
    assert rep["weights"].endswith("model_final")
    assert rep["mismatched"] == []
    assert "roi_heads.res5.0.conv1.weight" in rep["loaded"]
    assert "roi_heads.box_predictor.emb_pred.weight" in rep["loaded"]
    assert any(k.startswith("mmss_heads.") for k in rep["unused_src"])
    res = stages["stt"]["coco_zeroshot_val"]
    assert {"AP", "AP50"} <= set(res)


def test_eval_only_with_expected_results(stages, capsys):
    ap50 = stages["stt"]["coco_zeroshot_val"]["AP50"]
    res = run(stages["stt_flags"] + ["--eval-only"], stages["stt_opts"] + [
        "MODEL.WEIGHTS", os.path.join(stages["stt_dir"], "model_final"),
        "TEST.EXPECTED_RESULTS",
        f"[['coco_zeroshot_val', 'AP50', {ap50!r}, 1e-9]]"])
    assert res["coco_zeroshot_val"]["AP50"] == ap50
    assert "OK: coco_zeroshot_val/AP50" in capsys.readouterr().out


def test_cli_raises_on_what_is_not_ported(stages):
    """int8 serving (item 9) raises. Test-time augmentation (item 8),
    which raised here before, evaluates: ``--eval-only`` with
    TEST.AUG.ENABLED at the test size and its flip, two passes merged
    (tests/test_torch_tta.py holds TTA to JAX's); several ranks, which
    raised here before too, run in ``test_two_ranks_on_the_cpu``."""
    with pytest.raises(NotImplementedError, match="item 9"):
        run(stages["stt_flags"], stages["stt_opts"] + ["TPU.INT8_EVAL",
                                                       "True"])
    res = run(stages["stt_flags"] + ["--eval-only"], stages["stt_opts"] + [
        "MODEL.WEIGHTS", os.path.join(stages["stt_dir"], "model_final"),
        "TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(64,)",
        "TEST.AUG.MAX_SIZE", "96", "TEST.AUG.FLIP", "True"])
    got = res["coco_zeroshot_val"]
    assert got["tta_passes"] == 2
    assert got["tta_merged"] <= got["tta_detections"]
    assert all(np.isfinite(got[k]) for k in ("AP", "AP50"))


def test_two_ranks_on_the_cpu(stages):
    """``--num-gpus 2 --device cpu``: two spawned gloo ranks train the
    STT stage for two steps and evaluate; rank 0 alone writes
    ``config.yaml``, the checkpoints (the best-metric one too) and one
    ``metrics.json`` row an iteration. ``--dist-url auto`` is for one
    machine only."""
    out = os.path.join(stages["root"], "two_ranks")
    opts = stages["stt_opts"] + ["OUTPUT_DIR", out,
                                 "MODEL.WEIGHTS", "", "SOLVER.MAX_ITER", "2"]
    assert run(stages["stt_flags"] + ["--num-gpus", "2"], opts) is None
    out_dir = next(os.path.join(stages["root"], d)
                   for d in os.listdir(stages["root"])
                   if d.startswith("two_ranks-"))
    files = sorted(f for f in os.listdir(out_dir)
                   if not f.startswith("events.out"))
    assert files == ["config.yaml", "last_checkpoint", "metrics.csv",
                     "metrics.json", "model_0000000", "model_0000001",
                     "model_best", "model_best.json", "model_final"]
    rows = [json.loads(ln) for ln in open(os.path.join(out_dir,
                                                       "metrics.json"))]
    assert [r["iteration"] for r in rows] == [0, 1]
    assert all(v == v and abs(v) < float("inf")
               for r in rows for k, v in r.items() if "loss" in k)
    final = torch.load(os.path.join(out_dir, "model_final"),
                       weights_only=True)
    assert final["iteration"] == 1
    with pytest.raises(ValueError, match="auto needs --num-machines 1"):
        run(stages["stt_flags"] + ["--num-gpus", "2", "--num-machines",
                                   "2"], opts)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cli_needs_the_card_unless_told_cpu(stages):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(stages["stt_flags"][:2], stages["stt_opts"] + [
            "OUTPUT_DIR", os.path.join(stages["root"], "nogpu")])
