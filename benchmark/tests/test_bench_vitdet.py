"""The ``vitdet_b_infer_b8`` cell's own files, at a CPU test's size.

The cell (``BENCHMARK.json``: configuration ``vitdet_b``, traffic
``vitdet_infer_b8``, its workload, limits, work module, stage table and
metric readers) is loaded by name and cut to the tiny ViTDet of
``tests/test_torch_vitdet.py`` (width 64, 4 heads, one global block,
windows of 4 on a 10 x 10 grid, three pyramid levels; 160 x 160
canvases, 2 images a call), the program in float32. A process of its own
runs it through ``run_cell`` with ``--trace 0`` and ``--trace 1``, and
joins one traced window: the new stage ranges land in their buckets.
Also: the files this configuration brought to ``benchmark/`` are all
new, none of the benchmark's earlier files edited.
"""
import json
import os
import subprocess
import sys

import pytest

from benchmark import build

SEED = 2 ** 31 + 29
TINY = {
    "MODEL.VIT.EMBED_DIM": 64, "MODEL.VIT.DEPTH": 4,
    "MODEL.VIT.NUM_HEADS": 4, "MODEL.VIT.WINDOW_SIZE": 4,
    "MODEL.VIT.WINDOW_BLOCK_INDEXES": [0, 2, 3],
    "MODEL.VIT.PRETRAIN_IMG_SIZE": 64,
    "MODEL.SIMPLE_FPN.SCALE_FACTORS": [2.0, 1.0],
    "MODEL.SIMPLE_FPN.OUT_CHANNELS": 32,
    "MODEL.SIMPLE_FPN.SQUARE_PAD": 160,
    "MODEL.ANCHOR_GENERATOR.SIZES": [[32], [64], [128]],
    "MODEL.RPN.IN_FEATURES": ["p3", "p4", "p5"],
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 100, "MODEL.RPN.POST_NMS_TOPK_TEST": 60,
    "MODEL.ROI_HEADS.IN_FEATURES": ["p3", "p4"],
    "MODEL.ROI_BOX_HEAD.EMB_DIM": 16,
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 4,
    "MODEL.ROI_BOX_HEAD.NUM_CONV": 2, "MODEL.ROI_BOX_HEAD.CONV_DIM": 32,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64, "TEST.DETECTIONS_PER_IMAGE": 20,
}
BUCKETS = {
    "landscape": {"padded": [160, 160], "valid": [120, 160],
                  "orig": [90, 120]},
    "portrait": {"padded": [160, 160], "valid": [160, 120],
                 "orig": [120, 90]},
    "square": {"padded": [160, 160], "valid": [160, 160],
               "orig": [120, 120]},
}

DRIVE = f"""
import json, time
import torch
from benchmark import build
from benchmark.loops import LOOPS, trace_dir
from benchmark.run import Run, run_cell, trace_context
cell = build.load_cell("vitdet_b_infer_b8")
cell["config"]["settings"] = dict(cell["config"]["settings"],
                                  **{TINY!r}, **{{"TPU.COMPUTE_DTYPE":
                                                   "float32"}})
cell["traffic"] = dict(cell["traffic"], batch=2, buckets={BUCKETS!r},
                       block={{"landscape": 3, "portrait": 1, "square": 1}},
                       pool=1, warm_calls=1, sample_calls=2, sample_from=3,
                       trace_calls=3,
                       class_emb={{"rows": 7, "dim": 16, "std": 3.0}})
cpu = torch.device("cpu")
out = {{}}
for t in (0, 1):
    res = run_cell(Run(cell, {SEED}, 0.5, bool(t), cpu),
                   t_start=time.perf_counter())
    out[str(t)] = {{k: res[k] for k in ("correct", "metrics", "checked")}}
run = Run(cell, {SEED}, 0.5, True, cpu)
run.trace_dir = trace_dir()
ctx = trace_context(run, LOOPS["infer"](run))
out["buckets"] = {{k: v["host_s"] for k, v in ctx["buckets"].items()}}
out["work"] = {{k: ctx[k] for k in ("flops", "roi_bytes")}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tiny():
    env = dict(os.environ, PYTHONPATH=build.ROOT)
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=build.ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_tiny_cell_is_correct(tiny, trace):
    res = tiny[trace]
    assert res["correct"] is True
    checked = res["checked"]
    assert list(checked) == ["rpn_mse_ratio", "proposals_differ",
                             "det_mse_ratio"]
    assert checked["proposals_differ"]["value"] == 0
    # the float32 program against the plain bfloat16 computation
    assert checked["rpn_mse_ratio"]["value"] < 1e-3
    assert checked["det_mse_ratio"]["value"] < 1e-3


def test_the_end_to_end_metrics(tiny):
    e2e = tiny["0"]["metrics"]
    assert set(e2e) == {"infer_img_per_s", "peak_mem_gib", "setup_s"}
    assert e2e["infer_img_per_s"]["value"] > 0


def test_the_new_stages_are_joined(tiny):
    """Each new stage range lands in its bucket (host time on the CPU,
    which has no device rows), nested ones apart from ``backbone``."""
    b = tiny["buckets"]
    for bucket in ("window_attn", "global_attn", "pyramid", "box_head",
                   "backbone", "rpn+nms", "res5"):
        assert b.get(bucket, 0.0) > 0, bucket
    metrics = tiny["1"]["metrics"]
    assert metrics["rpn_nms_host_ms.vitdet"]["value"] > 0
    # device metrics read nothing on the CPU and are left out
    assert "rel_attention_roofline.vitdet" not in metrics
    assert "window_attn_ms.vitdet" not in metrics
    assert tiny["work"]["flops"] > 0 and tiny["work"]["roi_bytes"] > 0


def _git(*args) -> str:
    return subprocess.run(["git", *args], cwd=build.ROOT, check=True,
                          capture_output=True, text=True).stdout


def test_the_configuration_only_added_files_to_the_benchmark():
    """``git diff --name-status`` of ``benchmark/`` across the commit that
    brought this configuration (or, before it is committed, of the
    working tree against ``HEAD``) names added files only."""
    if not os.path.isdir(os.path.join(build.ROOT, ".git")):
        pytest.skip("no git history in this checkout")
    me = "benchmark/tests/test_bench_vitdet.py"
    added = _git("log", "--diff-filter=A", "--format=%H", "-n", "1", "--",
                 me).strip()
    if added:
        diff = _git("diff", "--name-status", f"{added}^", added, "--",
                    "benchmark/")
    else:
        diff = _git("diff", "--name-status", "HEAD", "--", "benchmark/")
    changes = [line.split("\t") for line in diff.splitlines() if line]
    assert all(kind == "A" for kind, *_ in changes), changes
    names = {path for _, path in changes}
    if added:
        assert me in names


def test_the_attention_roofline_reads_its_cell_only():
    """``rel_attention_roofline`` reads a window whose model FLOPs are
    ``vitdet_b_infer_b8``'s (KA2's least time over the two attention
    buckets' device time), and nothing where the FLOPs are another
    cell's or the buckets hold no device time."""
    from benchmark.metrics import rel_attention_roofline as reader
    from benchmark.work.peaks import BF16_FLOPS, HBM_BYTES
    from benchmark.work.vitdet_infer import request_work
    cell = build.load_cell(reader.CELL)
    work = request_work(build.reference_cfg(cell["config"]),
                        cell["traffic"]["class_emb"]["rows"],
                        cell["traffic"]["batch"], (1024, 1024))
    ctx = {"buckets": {"window_attn": {"device_s": 0.004},
                       "global_attn": {"device_s": 0.01}},
           "requests": 2, "flops": 2 * work["flops"]}
    least = 2 * max(work["attn_flops"] / BF16_FLOPS,
                    work["attn_bytes"] / HBM_BYTES)
    assert reader.read(ctx) == pytest.approx(100 * least / 0.014)
    assert reader.read(dict(ctx, flops=2.01 * work["flops"])) is None
    assert reader.read(dict(ctx, buckets={})) is None
