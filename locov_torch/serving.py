"""Serving export: the detection inference step as a program that a
later process runs without the model's Python code.

Counterpart of ``locov_tpu/serving.py``, which serializes the jitted
inference function with ``jax.export``. Here the program is
``torch.export``'s: the inference body traced to an ``ExportedProgram``
of ATen ops and the port's ``locov::`` custom ops (the hand-written
kernels K1 and K2, the NMS), saved with ``torch.export.save``. A
consumer needs PyTorch and the op registrations of ``locov_torch.ops``
(``import locov_torch.serving`` brings them), never ``locov_torch.
models``.

Artifact layout written by :func:`export_inference`:

    <out>/inference.pt2           torch.export.save of the program
    <out>/inference.graph.txt     the program's graph, readable text
    <out>/params/variables        the port's Checkpointer: the
                                  variables and class_emb
    <out>/signature.json          input/output shapes + dtypes

The program takes the weights first, then plain tensors, as JAX's
does: ``(variables, image [B,H,W,3] f32, hw [B,2] i32, orig_hw [B,2]
i32, class_emb [C+1,D] f32)``, with ``variables`` the serving module's
state dict, and returns a dict of ``boxes [B,K,4]`` (in original-image
coordinates), ``scores [B,K]``, ``classes [B,K] i32`` and ``mask [B,K]
bool``. It holds no weights itself: ``params/`` is their one copy.
``load_exported`` returns ``call(variables, image, hw, orig_hw,
class_emb)``. Image preprocessing (PIXEL_MEAN/STD, BGR order, bucket
padding) happens inside the model's own preprocess, as in training and
evaluation.

The program runs on the device it was exported on (``platforms`` in
``signature.json``): factory calls in the graph record a literal
device. With ``n_devices`` N, JAX's mesh of N chips, the program is
exported at batch B / N and the loaded ``call`` splits the batch over N
devices, runs one copy of the program on each (moved there with
``torch.export.passes.move_to_device_pass``) and concatenates the
outputs; a batch of another size raises. ``TPU.INT8_EVAL`` is not
ported (ROADMAP queue 1, item 9): the export tool
(``tools/export_serving.py``) raises on it.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

# the locov:: op registrations the program calls
from .ops import bottleneck_block, nms, relu_maxpool, roi_align  # noqa: F401
from .ops import stem_conv_bn  # noqa: F401
from .structures.batches import DetectionBatch, ImageBatch
from .utils.checkpoint import Checkpointer

PROGRAM = "inference.pt2"
GRAPH = "inference.graph.txt"
OUTPUTS = ("boxes", "scores", "classes", "mask")


def load_class_embeddings(path: str) -> Tuple[list, torch.Tensor]:
    """Read a class-name->vector JSON (``tools/coco_bert_embeddings.py``
    output) into ``(names, mtx)`` with the framework's row convention:
    row i = names[i] (sorted), and the LAST row is the zero background
    embedding (the classifier's scores are [.., K+1] with K =
    background). ``mtx`` is a float32 CPU tensor."""
    with open(path) as f:
        emb = json.load(f)
    names = sorted(emb)
    dim = len(emb[names[0]])
    mtx = np.zeros((len(names) + 1, dim), np.float32)
    for i, k in enumerate(names):
        mtx[i] = np.asarray(emb[k], np.float32)
    return names, torch.from_numpy(mtx)


class ServeModule(torch.nn.Module):
    """``model.inference`` as a module of plain tensors, for
    ``torch.export``: it runs the inference body under ``no_grad``
    (``OvrRCNN.inference``'s ``inference_mode`` decorator is left out: a
    trace under it gives inference tensors that ``torch.export`` does
    not take) and returns the detections as a dict, classes as int32."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        infer = type(model).inference
        self._body = getattr(infer, "__wrapped__", infer)

    def forward(self, image: torch.Tensor, hw: torch.Tensor,
                orig_hw: torch.Tensor, class_emb: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        batch = DetectionBatch(images=ImageBatch(image=image, hw=hw,
                                                 orig_hw=orig_hw))
        with torch.no_grad():
            dets = self._body(self.model, batch, class_emb)
        return {"boxes": dets.boxes, "scores": dets.scores,
                "classes": dets.classes.to(torch.int32),
                "mask": dets.mask}


def make_serve_fn(model: torch.nn.Module) -> ServeModule:
    """The serving module of ``model`` (JAX's ``make_serve_fn``; the
    module holds its weights)."""
    return ServeModule(model)


def _sig(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).split(".")[1]}


def _global(sig: dict, n: int) -> dict:
    return {**sig, "shape": [sig["shape"][0] * n] + sig["shape"][1:]}


class _WeightsAsInputs(torch.nn.Module):
    """``serve`` with its weights as the program's first input, JAX's
    calling convention: ``forward(variables, image, hw, orig_hw,
    class_emb)`` runs ``serve`` on ``variables`` (its state dict's keys)
    with ``torch.func.functional_call``. ``serve`` is held outside the
    module's children, so that the exported program keeps no copy of the
    weights: ``params/`` is their only copy."""

    def __init__(self, serve: ServeModule):
        super().__init__()
        self._serve = (serve,)

    def forward(self, variables, image, hw, orig_hw, class_emb):
        return torch.func.functional_call(
            self._serve[0], variables, (image, hw, orig_hw, class_emb))


def export_inference(model: torch.nn.Module, class_emb: torch.Tensor,
                     out_dir: str, batch: int, height: int, width: int,
                     n_devices: int = 1) -> str:
    """Export ``model.inference`` at static serving shapes, on the
    device that holds the model (``platforms`` in ``signature.json``).

    Returns the path of the saved program, which takes the weights as
    its first input. With ``n_devices`` N > 1 the program is exported at
    batch ``batch / N`` for N devices of the model's kind, each running
    one copy on its share of the batch (``signature.json`` records the
    global shapes, ``nr_devices`` N and a one-axis ``data`` mesh);
    ``batch`` must divide by N."""
    if n_devices < 1 or batch % n_devices:
        raise ValueError(f"serving batch {batch} must divide by the "
                         f"device count {n_devices}")
    serve = make_serve_fn(model).eval()
    variables = dict(serve.state_dict())
    dev = next(model.parameters()).device
    local = batch // n_devices
    hw = torch.tensor([[height, width]] * local, dtype=torch.int32,
                      device=dev)
    args = (torch.zeros((local, height, width, 3), dtype=torch.float32,
                        device=dev), hw, hw.clone(),
            class_emb.to(dev, torch.float32))
    program = torch.export.export(_WeightsAsInputs(serve),
                                  (variables,) + args, strict=False)
    program.example_inputs = None  # the weights and zero images

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, PROGRAM)
    torch.export.save(program, path)
    with open(os.path.join(out_dir, GRAPH), "w") as f:
        f.write(program.graph_module.print_readable(print_output=False))
    Checkpointer(os.path.join(out_dir, "params"), use_async=False
                 ).save_named("variables", {"variables": variables,
                                            "class_emb": args[3]})

    names = ("image", "hw", "orig_hw")
    sig = {
        "inputs": {**{k: _global(_sig(a), n_devices)
                      for k, a in zip(names, args)},
                   "class_emb": _sig(args[3])},
        "outputs": {k: _global(_sig(v), n_devices)
                    for k, v in zip(OUTPUTS, _output_metas(program))},
        "platforms": [dev.type],
        "nr_devices": n_devices,
        "mesh": (None if n_devices == 1 else
                 {"axis_names": ["data"], "shape": [n_devices]}),
    }
    with open(os.path.join(out_dir, "signature.json"), "w") as f:
        json.dump(sig, f, indent=2)
    return path


def _output_metas(program) -> list:
    """The fake tensors of the program's outputs, in ``OUTPUTS`` order."""
    node = program.graph_module.graph.find_nodes(op="output")[0]
    return [a.meta["val"] for a in node.args[0]]


@contextlib.contextmanager
def _full_float32():
    """TF32 off for cuDNN and cuBLAS while the program runs: the port's
    float32 convolutions and products turn it off for their own calls
    (``ops/conv.py``, ``ops/matmul.py``), a flag that the exported graph
    does not keep. bfloat16 ops are unaffected. The flags are restored
    on exit."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p


def load_exported(out_dir: str) -> Tuple[Callable, Dict[str, torch.Tensor],
                                         torch.Tensor]:
    """Reload a serving artifact: ``(call, variables, class_emb)``, with
    ``call(variables, image, hw, orig_hw, class_emb)`` returning the
    output dict. Running it does NOT import the model's Python code.

    The copies run on the device the artifact was exported on, or on
    ``cuda:0`` .. ``cuda:N-1`` for a CUDA artifact of ``nr_devices`` N;
    ``variables`` and ``class_emb`` are loaded onto the first. Each
    device keeps one copy of the variables last called with (kept until
    a call passes other tensors, or changes one in place). Inputs of
    other shapes than the signature's raise."""
    with open(os.path.join(out_dir, "signature.json")) as f:
        sig = json.load(f)
    n = sig["nr_devices"]
    kind = sig["platforms"][0]
    devices = [torch.device(d) for d in
               ([kind] * n if kind == "cpu" else
                [f"cuda:{i}" for i in range(n)])]
    path = os.path.join(out_dir, PROGRAM)
    modules = [move_to_device_pass(torch.export.load(path), d).module()
               for d in devices]
    state = Checkpointer(os.path.join(out_dir, "params"), use_async=False
                         ).load("variables")
    variables = {k: v.to(devices[0]) for k, v in state["variables"].items()}
    class_emb = state["class_emb"].to(devices[0])
    placed = {}

    def on_devices(variables):
        """``variables`` on each device, copied once for each new set."""
        key = [(k, id(v), v._version) for k, v in variables.items()]
        if placed.get("key") != key:
            placed.update(key=key, source=list(variables.values()),
                          copies=[{k: v.to(d) for k, v in variables.items()}
                                  for d in devices])
        return placed["copies"]

    def call(variables, image, hw, orig_hw, class_emb):
        for k, x in (("image", image), ("hw", hw), ("orig_hw", orig_hw)):
            if list(x.shape) != sig["inputs"][k]["shape"]:
                raise ValueError(f"{k} has shape {list(x.shape)}, the "
                                 f"artifact takes {sig['inputs'][k]['shape']}")
        chunks = zip(*(x.chunk(n) for x in (image, hw, orig_hw)))
        outs = []
        with _full_float32():
            for module, d, ws, (im, h, o) in zip(
                    modules, devices, on_devices(variables), chunks):
                outs.append(module(ws, im.to(d), h.to(d), o.to(d),
                                   class_emb.to(d)))
        if n == 1:
            return outs[0]
        return {k: torch.cat([o[k].to(devices[0]) for o in outs])
                for k in OUTPUTS}

    return call, variables, class_emb
