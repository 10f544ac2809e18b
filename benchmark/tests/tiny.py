"""Tiny forms of the benchmark's cells for the CPU tests: the cells'
files with the widths, sizes and counts cut so that a whole run (the
program's loop, the trace reading and the reference's check) takes
seconds on the CPU."""
from __future__ import annotations

import copy

import torch

from benchmark import build

CELLS = ("lsm_global_b32", "stt_infer_b8")
TINY_MODEL = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
    "MODEL.PIXEL_STD": [57.375, 57.12, 58.395],
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 12,
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 48,
    "MODEL.RPN.POST_NMS_TOPK_TRAIN": 24,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 48,
    "MODEL.RPN.POST_NMS_TOPK_TEST": 16,
    "MODEL.MMSS_HEAD.SPATIAL_DROPOUT": 8,
    "MODEL.ROI_BOX_HEAD.EMB_DIM": 16,
    "TEST.DETECTIONS_PER_IMAGE": 8,
}
TINY_BERT = {"vocab_size": 50, "hidden_size": 16, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 32,
             "max_position_embeddings": 16, "hidden_dropout_prob": 0.1,
             "attention_probs_dropout_prob": 0.1}
BUCKETS = {
    "landscape": {"padded": [64, 96], "valid": [64, 85], "orig": [48, 64]},
    "portrait": {"padded": [96, 64], "valid": [85, 64], "orig": [64, 48]},
    "square": {"padded": [64, 64], "valid": [64, 64], "orig": [64, 64]},
}


def tiny_cell(name: str) -> dict:
    """The cell ``name`` as ``build.load_cell`` reads it, cut to tiny
    sizes, with the float32 program (the plain versions on the CPU): its
    readings from the float32 reference are 0, and so are the plain
    computation's at its own dtype."""
    cell = copy.deepcopy(build.load_cell(name))
    conf, p = cell["config"], cell["traffic"]
    settings = dict(conf["settings"])
    settings.update(TINY_MODEL)
    settings["TPU.COMPUTE_DTYPE"] = "float32"
    for node in ("MODEL.LANGUAGE_BACKBONE.BERT_CONFIG",
                 "MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG"):
        for k, v in TINY_BERT.items():
            settings[f"{node}.{k}"] = v
    if p["loop"] == "train":
        settings["TPU.PAIRWISE_CHUNK"] = 2
    conf["settings"] = settings
    conf["dtype"] = "float32"  # the dtype the tiny program runs in
    p.update(batch=2, buckets=copy.deepcopy(BUCKETS), pool=1,
             block={"landscape": 3, "portrait": 1, "square": 1})
    p["class_emb"] = dict(p["class_emb"], dim=16, std=0.5)
    if p["loop"] == "train":
        p.update(trace_steps=2)
        p["gt"] = dict(p["gt"], boxes=6, side=[8, 40])
        p["text"] = {"slots": 8, "words": [2, 5], "ids": [5, 50],
                     "mlm": 0.15}
        p["class_emb"]["std"] = 0.1
    else:
        p.update(class_emb={"rows": 6, "dim": 16, "std": 3.0},
                 warm_calls=1, sample_calls=2, sample_from=3,
                 trace_calls=3)
    return cell


def cpu_run(name: str, seed: int = 3, seconds: float = 0.5,
            trace: bool = False, wrap_step=None, cell=None):
    """One run of the tiny cell on the CPU through ``run.run_cell``."""
    import time
    from benchmark.run import Run, run_cell
    run = Run(cell or tiny_cell(name), seed, seconds, trace,
              torch.device("cpu"), wrap_step=wrap_step)
    return run_cell(run, t_start=time.perf_counter())
