"""The readings that set the limits of ``correct``: each compared number
of a cell on several seeds, for the program as the window runs it, for
the control (the reference in a lower precision in the program's place)
and for planted faults, several seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3
                                 --mode program|control|half [--seconds 2]

``program``: the program's own set-up steps (training) or a short window
(inference), checked as a run checks them. ``control``: training, the
plain reference computed with its products in fp8 (``reference/fp8.py``)
in the program's place; inference, the program's own int8 path where the
configuration gives one (its ``control_settings``; ``stt``: the static
scheme with the int8 ROIAlign, calibrated in set-up), else the plain
reference's detector with its products in fp8 in the program's place,
on the calls a run samples. ``half``: the
program's step given half of each batch, its losses the mean over the
rest. Prints one JSON line a seed. Not run by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from . import build, check
from .loops import captured, first_gradients, sampled_calls, sync
from .reference import steps as ref_steps
from .reference.fp8 import Fp8Products
from .run import Run, cache_env
from .traffic.detection import Traffic, draw_shapes, draws


def halve(x):
    """The first half of a batch: every tensor of a (nested) NamedTuple,
    dict or tuple cut along dim 0."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: halve(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(halve(v) for v in x))
    if isinstance(x, tuple):
        return tuple(halve(v) for v in x)
    return x[:x.shape[0] // 2]


def half_step(step):
    """A training step that leaves half of the batch out."""
    def s(batch, class_emb, generator, uniforms=None):
        return step(halve(batch), class_emb, generator, halve(uniforms))
    return s


def control_train(run) -> dict:
    """The first steps as ``loops.train`` runs them, with the plain
    reference's products in fp8 (``reference/fp8.py``; the
    configuration's own dtype otherwise) in the program's place."""
    from .reference.locov_ref.engine.solver import build_optimizer
    from .reference.locov_ref.models import build_meta_arch
    from .reference.locov_ref.structures import batches as types
    dev, p = run.device, run.traffic
    cfg = build.reference_cfg(run.config, run.config["dtype"])
    model = build_meta_arch(cfg, device=dev)
    model.load_state_dict(build.make_weights(
        model, run.seed, dev, run.config["trained_scale"]))
    module = importlib.import_module(type(model).__module__)
    optimizer, scheduler = build_optimizer(cfg, model)
    traffic = Traffic(p, run.seed)
    class_emb = torch.from_numpy(traffic.class_emb).to(dev)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    ugen = torch.Generator(device=dev).manual_seed(traffic.draw_seed)
    b, n_gt = p["batch"], p["gt"]["boxes"]
    trained = {n: q for n, q in model.named_parameters() if q.requires_grad}
    p0 = {n: q.detach().clone() for n, q in trained.items()}
    rec = {"steps": [], "losses": [], "proposals": []}
    with captured(module, "select_proposals", rec["proposals"]), \
            Fp8Products():
        for k in range(p["check_steps"]):
            bucket, arrays = traffic.request(k)
            u = draws(draw_shapes(cfg, b, *traffic.padded(bucket), n_gt),
                      b, ugen, dev)
            batch = check._batch(types, arrays, dev)
            loss = ref_steps.train_step(model, optimizer, scheduler, batch,
                                        class_emb, gen, u)
            rec["steps"].append({"bucket": bucket, "uniforms": u})
            rec["losses"].append(float(loss))
            if k == 0:
                rec["grad_norms"] = first_gradients(optimizer, trained, p0)
    sync(dev)
    rec["update_norms"] = {n: float((q.detach() - p0[n]).norm())
                           for n, q in trained.items()}
    rec["shapes"] = {"batch": b, "cfg": cfg, "traffic": traffic}
    run.free = [model, optimizer, scheduler]
    return rec


def control_infer(run) -> dict:
    """The calls that ``loops.infer`` samples, each answered by the plain
    reference's detector (``inference``) with its products in fp8
    (``reference/fp8.py``; the configuration's own dtype otherwise) in
    the program's place, its proposals and the RPN outputs they came
    from captured as the program's are: the inference control of a
    configuration with no int8 path of its own."""
    from .reference.locov_ref.models import build_meta_arch
    from .reference.locov_ref.structures import batches as types
    dev, p = run.device, run.traffic
    cfg = build.reference_cfg(run.config, run.config["dtype"])
    model = build_meta_arch(cfg, device=dev)
    model.load_state_dict(build.make_weights(
        model, run.seed, dev, run.config["trained_scale"]))
    model.eval()
    module = importlib.import_module(type(model).__module__)
    traffic = Traffic(p, run.seed)
    class_emb = torch.from_numpy(traffic.class_emb).to(dev)
    rec = {"sample": []}
    with Fp8Products():
        for i in sampled_calls(p, run.seed, run.trace):
            bucket, arrays = traffic.request(i)
            props = []
            with captured(module, "select_proposals", props):
                dets = model.inference(check._batch(types, arrays, dev),
                                       class_emb)
            rec["sample"].append({
                "bucket": bucket, "arrays": arrays, "proposals": props,
                "dets": type(dets)(*(t.cpu() for t in dets))})
    sync(dev)
    rec["shapes"] = {"batch": p["batch"], "cfg": cfg, "traffic": traffic}
    run.free = [model]
    return rec


def readings(run, mode: str) -> dict:
    from .loops import LOOPS
    if run.traffic["loop"] == "train":
        rec = control_train(run) if mode == "control" else \
            LOOPS["train"](run)
    elif mode == "control" and not run.config.get("control_settings"):
        rec = control_infer(run)
    else:
        rec = LOOPS["infer"](run)
    run.free.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if run.traffic["loop"] == "train":
        ref = check.reference_train(run, rec)
        return dict(check.train_numbers(rec, ref),
                    notes=check.train_notes(rec, ref))
    notes = {}
    return dict(check.infer_numbers(run, rec, notes), notes=notes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control", "half"),
                    default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cache_env()
    cell = build.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell, seed, args.seconds if cell["traffic"]["loop"] ==
                  "infer" else 0.0, False, device,
                  control=args.mode == "control" and
                  cell["traffic"]["loop"] == "infer",
                  wrap_step=half_step if args.mode == "half" else None)
        try:
            numbers = readings(run, args.mode)
        except Exception as e:  # noqa: BLE001 -- a crash is a reading
            numbers = {"error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
