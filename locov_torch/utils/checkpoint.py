"""Checkpoints of the port: torch save/restore, best-metric tracking,
stage transfer via key-rename fan-out, and torch/Caffe2 weight import.

Counterpart of ``locov_tpu/utils/checkpoint.py`` (itself the
reference's ``WSOGCheckpointer``, ``ovr/utils/checkpoint.py:15-234``,
and fvcore's DetectionCheckpointer):

- periodic checkpoints with ``max_to_keep`` pruning and a
  ``last_checkpoint`` pointer file (d2 PeriodicCheckpointer behavior),
  written by ``torch.save``: one file a checkpoint, named as JAX names
  its directories (``model_0000007``, ``model_final``, no suffix, so
  that ``load_weights_standalone`` never takes one for a d2 ``.pth``);
- best-model save keyed on a metric with a JSON sidecar recording the
  metric name/value (checkpoint.py:186-234);
- load with a rename fan-out map (one source key populating several
  destination keys) for the LSM->STT stage hand-off (res5 <->
  roi_heads.res5, v2l_projection -> emb_pred; trainer.py:308-326);
- import of torch checkpoints (the published LocOV.pth / lsm_coco.pth,
  HF BERT weights) and Caffe2 ResNets. The converters are JAX's, as
  they are: they emit flat Flax names (``a/b/kernel``, HWIO convs,
  [in, out] dense kernels), and ``utils/weights.py:from_flax`` maps
  those to the port's ``state_dict``, the one seam between the names.
  The rename map is kept in Flax names too; ``torch_rename_map`` gives
  it in ``state_dict`` names (``/`` -> ``.``).
"""
from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


# --------------------------------------------------------------- flat tree
def flatten_params(tree, prefix=()) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, prefix + (str(k),)))
    else:
        out["/".join(prefix)] = tree
    return out


def unflatten_params(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def merge_over_template(template: Dict[str, Any],
                        restored: Dict[str, Any]) -> Dict[str, Any]:
    """A restored ``state_dict`` over the model's own (``template``):
    every key ``restored`` has wins; keys the model declares but the
    checkpoint lacks keep their init values (JAX's rule, for state the
    model gained after the checkpoint was written); keys only in
    ``restored`` are carried through unchanged."""
    missing = sorted(set(template) - set(restored))
    if missing:
        logger.info("%d keys missing from the checkpoint keep their init "
                    "values (e.g. %s)", len(missing), missing[0])
    return {**template, **restored}


# ------------------------------------------------------------- checkpointer
def _to_host(obj):
    """A copy of ``obj`` (nested dicts, lists, tuples of tensors and
    plain values) with every tensor on the CPU in memory of its own:
    CUDA tensors through pinned buffers, copied on the current stream
    and waited for once."""
    waits = []

    def rec(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                waits.append(x.device)
                return host
            return x.clone()
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rec(v) for v in x)
        return x
    out = rec(obj)
    for dev in set(waits):
        torch.cuda.synchronize(dev)
    return out


def _atomic_write(path: str, write) -> None:
    """``write(tmp)``, then rename ``tmp`` to ``path``: a crash leaves
    no partial file under the final name."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class Checkpointer:
    """``torch.save``-backed checkpoint manager with d2-style
    conventions.

    Saves are ASYNCHRONOUS by default (``use_async=True``, the config's
    ``TPU.ASYNC_CHECKPOINT``): the state is copied device->host on the
    caller's thread, so the next step may change the parameters in
    place, and the file is written on a background thread. The
    bookkeeping that must only see *committed* checkpoints (the
    ``last_checkpoint`` pointer file and ``max_to_keep`` pruning) is
    deferred to the commit barrier ``wait``: at most one save is in
    flight, and every reader (``load``/``has_checkpoint``/
    ``last_checkpoint``) and the next save call ``wait()`` first. Every
    file is written under a temporary name and renamed into place, so a
    crash mid-save leaves the pointer at the previous complete
    checkpoint and no partial file under a final name.
    ``saves`` records each written checkpoint: its name, the seconds on
    the caller's thread (``caller_s``: the device->host copy) and in all
    (``total_s``), and the file's bytes.
    """

    def __init__(self, output_dir: str, max_to_keep: int = 2,
                 use_async: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._async = use_async
        self._pending: Optional[Tuple[str, bool]] = None  # (name, ptr?)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.max_to_keep = max_to_keep
        self.saves: List[Dict[str, Any]] = []

    # -- naming ---------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    # -- async barrier ----------------------------------------------------
    def wait(self):
        """Block until the in-flight save (if any) is committed, then
        run its deferred bookkeeping (pointer file + pruning)."""
        if self._pending is None:
            return
        name, update_pointer = self._pending
        self._pending = None
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint {name} was not written") \
                from err
        if update_pointer:
            self._write_pointer(name)

    def _write_pointer(self, name: str):
        def write(tmp):
            with open(tmp, "w") as f:
                f.write(name)
        _atomic_write(self._path("last_checkpoint"), write)
        self._prune()

    def _write(self, name: str, host: dict, t0: float, caller_s: float):
        path = self._path(name)
        try:
            _atomic_write(path, lambda tmp: torch.save(host, tmp))
            self.saves.append({"name": name, "caller_s": caller_s,
                               "total_s": time.perf_counter() - t0,
                               "bytes": os.path.getsize(path)})
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def _dispatch(self, name: str, state: dict, update_pointer: bool):
        self.wait()  # at most one save in flight
        t0 = time.perf_counter()
        host = _to_host(state)
        caller_s = time.perf_counter() - t0
        if self._async:
            self._thread = threading.Thread(
                target=self._write, args=(name, host, t0, caller_s),
                name="checkpoint-write", daemon=True)
            self._thread.start()
            self._pending = (name, update_pointer)
        else:
            self._write(name, host, t0, time.perf_counter() - t0)
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if update_pointer:
                self._write_pointer(name)

    def save(self, name: str, state: dict) -> str:
        self._dispatch(name, state, update_pointer=True)
        return self._path(name)

    def _prune(self):
        pat = re.compile(r"^model_(\d+)$")
        ckpts = sorted(
            (int(m.group(1)), n) for n in os.listdir(self.output_dir)
            if (m := pat.match(n)))
        while len(ckpts) > self.max_to_keep:
            _, name = ckpts.pop(0)
            os.remove(self._path(name))

    def save_periodic(self, iteration: int, state: dict) -> str:
        return self.save(f"model_{iteration:07d}", state)

    def save_best(self, iteration: int, state: dict, metric_name: str,
                  metric_value: float) -> str:
        path = self.save_named("model_best", state)
        # The JSON sidecar is resume metadata: it must never be visible
        # before the checkpoint it describes is committed (an async save
        # is still in flight here). Best-saves happen at eval time, so
        # blocking on the commit barrier costs nothing per step.
        self.wait()
        with open(self._path("model_best.json"), "w") as f:
            json.dump({"iteration": iteration, "metric": metric_name,
                       "value": metric_value}, f)
        return path

    def save_named(self, name: str, state: dict) -> str:
        self._dispatch(name, state, update_pointer=False)
        return self._path(name)

    def load(self, name_or_path: str) -> dict:
        self.wait()
        path = name_or_path if os.path.isabs(name_or_path) \
            else self._path(name_or_path)
        return torch.load(path, map_location="cpu", weights_only=True)

    def has_checkpoint(self) -> bool:
        self.wait()
        return os.path.exists(self._path("last_checkpoint"))

    def last_checkpoint(self) -> Optional[str]:
        self.wait()
        try:
            with open(self._path("last_checkpoint")) as f:
                return f.read().strip()
        except FileNotFoundError:
            return None

    def resume_iteration(self, name: str) -> int:
        """Parse the iteration from a checkpoint name, incl. model_best
        via its JSON sidecar (trainer.py:343-363)."""
        m = re.match(r"model_(\d+)$", name)
        if m:
            return int(m.group(1)) + 1
        if name == "model_best" and os.path.exists(
                self._path("model_best.json")):
            with open(self._path("model_best.json")) as f:
                return json.load(f)["iteration"] + 1
        if name == "model_final":
            return -1
        return 0


# ------------------------------------------------------- rename-map loading
class ImportReport(list):
    """Result report of a rename-map weight import.

    Behaves as the list of dst keys left untouched (``missing``) for
    backward compatibility; additionally carries the full surface the
    day-1 parity runbook asserts on (README "Eval-only runbook"):
    ``loaded`` dst keys that received a value, ``mismatched``
    (dst_key, src_shape, dst_shape) skipped on shape, ``unused_src``
    source keys that matched no destination."""

    def __init__(self, missing, loaded, mismatched, unused_src):
        super().__init__(missing)
        self.missing = list(missing)
        self.loaded = loaded
        self.mismatched = mismatched
        self.unused_src = unused_src

    def summary(self) -> str:
        return (f"loaded {len(self.loaded)}, missing "
                f"{len(self.missing)}, shape-mismatched "
                f"{len(self.mismatched)}, unused source keys "
                f"{len(self.unused_src)}")

    def asdict(self, weights: str) -> dict:
        """The ``import_report.json`` record of an import of
        ``weights``."""
        return {"weights": weights, "loaded": self.loaded,
                "missing": self.missing,
                "mismatched": [list(m) for m in self.mismatched],
                "unused_src": self.unused_src}


def _cast_like(sv, dv):
    """``sv`` in ``dv``'s dtype, in storage of its own: a tensor where
    ``dv`` is one (so that two destinations of one source never share
    memory), else a numpy array."""
    if isinstance(dv, torch.Tensor):
        return torch.as_tensor(sv).to(dtype=dv.dtype, copy=True)
    if hasattr(dv, "dtype"):
        return np.asarray(sv).astype(dv.dtype)
    return sv


def load_with_rename_map(flat_src: Dict[str, Any],
                         flat_dst: Dict[str, Any],
                         rename_map: Dict[str, List[str]],
                         strict_shapes: bool = True
                         ) -> Tuple[Dict[str, Any], ImportReport]:
    """Copy src params into dst, fanning out renamed keys.

    rename_map maps a source PREFIX to a list of destination PREFIXES
    (one-to-many, reference checkpoint.py:81-97). The values are numpy
    arrays (Flax names) or tensors (a ``state_dict``); each copied value
    takes the destination's dtype and memory of its own. Returns (new
    flat dst, ImportReport); the report doubles as the legacy list of
    dst keys left untouched."""
    out = dict(flat_dst)
    loaded = set()
    mismatched = []
    used_src = set()
    for sk, sv in flat_src.items():
        targets = [sk]
        for src_prefix, dst_prefixes in rename_map.items():
            if sk.startswith(src_prefix):
                targets = [d + sk[len(src_prefix):] for d in dst_prefixes]
                break
        for tk in targets:
            if tk in out:
                if tuple(out[tk].shape) == tuple(sv.shape):
                    out[tk] = _cast_like(sv, out[tk])
                    loaded.add(tk)
                    used_src.add(sk)
                elif strict_shapes:
                    mismatched.append((tk, tuple(sv.shape),
                                       tuple(out[tk].shape)))
                    print(f"[checkpoint] shape mismatch for {tk}: "
                          f"{tuple(sv.shape)} vs {tuple(out[tk].shape)}; "
                          f"skipped")
    missing = [k for k in out if k not in loaded]
    unused = sorted(set(flat_src) - used_src)
    return out, ImportReport(missing, sorted(loaded), mismatched, unused)


# --------------------------------------------------------------- torch import
def _t(x):
    return np.ascontiguousarray(x)


def torch_to_flax_leaf(torch_key: str, value: np.ndarray,
                       flax_key: str) -> np.ndarray:
    """Layout conversion by destination leaf kind: conv kernels
    OIHW->HWIO, dense kernels [out,in]->[in,out]."""
    v = np.asarray(value)
    if flax_key.endswith("/kernel"):
        if v.ndim == 4:
            return _t(v.transpose(2, 3, 1, 0))
        if v.ndim == 2:
            return _t(v.T)
    return _t(v)


# HF BERT parameter names (relative prefix) -> our flax BertModel paths.
# Covers both a bare bert-base-uncased checkpoint ("bert.encoder...."
# or "encoder....") and the reference LSM checkpoint's
# language_backbone.body.bert_model.* embedding (transf_models.py:24).
_BERT_LAYER_RULES = [
    (r"attention\.self\.query\.(weight|bias)$",
     "attention_self/query/{0}"),
    (r"attention\.self\.key\.(weight|bias)$", "attention_self/key/{0}"),
    (r"attention\.self\.value\.(weight|bias)$",
     "attention_self/value/{0}"),
    (r"attention\.output\.dense\.(weight|bias)$",
     "attention_output/{0}"),
    (r"attention\.output\.LayerNorm\.(weight|bias)$",
     "attention_norm/{0}"),
    (r"intermediate\.dense\.(weight|bias)$", "intermediate/{0}"),
    (r"output\.dense\.(weight|bias)$", "output/{0}"),
    (r"output\.LayerNorm\.(weight|bias)$", "output_norm/{0}"),
]

_BERT_EMB_RULES = [
    (r"word_embeddings\.weight$", "embeddings/word_embeddings"),
    (r"position_embeddings\.weight$", "embeddings/position_embeddings"),
    (r"token_type_embeddings\.weight$",
     "embeddings/token_type_embeddings"),
    (r"LayerNorm\.(weight|bias)$", "embeddings/norm/{0}"),
]


def convert_bert_state_dict(state: Dict[str, np.ndarray],
                            dest_prefix: str = "") -> Dict[str, np.ndarray]:
    """Convert HF BERT names to our flax BertModel naming. dest_prefix
    scopes the output (e.g. 'language_backbone/bert_model/'). The
    embedding matrices stay untransposed; LayerNorm weight -> scale;
    dense weights transpose [out,in] -> [in,out]."""
    out = {}
    leaf_map = {"weight": "kernel", "bias": "bias"}
    for tk, tv in state.items():
        tv = np.asarray(tv)
        # strip common wrappers
        name = re.sub(r"^(bert\.|bert_model\.|cls\.|module\.)", "", tk)
        name = re.sub(r"^(language_backbone\.body\.bert_model\.)", "",
                      name)
        m = re.match(r"^embeddings\.(.+)$", name)
        if m:
            for pat, template in _BERT_EMB_RULES:
                mm = re.match(pat, m.group(1))
                if mm:
                    fk = template
                    if mm.groups():
                        leaf = "scale" if mm.group(1) == "weight" \
                            else "bias"
                        fk = template.replace("{0}", leaf)
                    out[dest_prefix + fk] = _t(tv)  # no transpose
                    break
            continue
        m = re.match(r"^encoder\.layer\.(\d+)\.(.+)$", name)
        if m:
            layer, rest = m.group(1), m.group(2)
            for pat, template in _BERT_LAYER_RULES:
                mm = re.match(pat, rest)
                if mm:
                    leaf = leaf_map[mm.group(1)]
                    if "norm" in template:
                        leaf = "scale" if mm.group(1) == "weight" \
                            else "bias"
                    fk = (f"encoder/layer_{layer}/"
                          + template.replace("{0}", leaf))
                    v = _t(tv.T) if leaf == "kernel" else _t(tv)
                    out[dest_prefix + fk] = v
                    break
            continue
        if re.match(r"^pooler\.dense\.(weight|bias)$", name):
            leaf = "kernel" if name.endswith("weight") else "bias"
            v = _t(tv.T) if leaf == "kernel" else _t(tv)
            out[dest_prefix + "pooler/dense/" + leaf] = v
    return out


# LSM-checkpoint extras: mmss-head modules (reference naming from
# mmss_heads.py / transformer_head.py) -> our tree. The v2l_projection
# maps to the shared tied projection.
_LSM_EXTRA_RULES = [
    (r"^mmss_heads\.GroundingHead\.v2l_projection\.(weight|bias)$",
     "mmss_heads/v2l_projection/{0}"),
    (r"^mmss_heads\.TransformerHead\.v2l_projection\.(weight|bias)$",
     "mmss_heads/transformer_head/v2l_projection/{0}"),
    (r"^mmss_heads\.TransformerHead\.visual_emb\.image_embeddings"
     r"\.(weight|bias)$",
     "mmss_heads/transformer_head/visual_emb/image_embeddings/{0}"),
    (r"^mmss_heads\.TransformerHead\.visual_emb"
     r"\.image_location_embeddings\.(weight|bias)$",
     "mmss_heads/transformer_head/visual_emb/"
     "image_location_embeddings/{0}"),
    (r"^mmss_heads\.TransformerHead\.visual_emb\.LayerNorm"
     r"\.(weight|bias)$",
     "mmss_heads/transformer_head/visual_emb/norm/{0}"),
    (r"^mmss_heads\.TransformerHead\.pooler\.dense\.(weight|bias)$",
     "mmss_heads/transformer_head/pooler/dense/{0}"),
    (r"^mmss_heads\.TransformerHead\.heads\.bi_seq_relationship"
     r"\.(weight|bias)$",
     "mmss_heads/transformer_head/bi_seq_relationship/{0}"),
    (r"^mmss_heads\.TransformerHead\.heads\.predictions\.transform"
     r"\.dense\.(weight|bias)$",
     "mmss_heads/transformer_head/predictions/transform/dense/{0}"),
    (r"^mmss_heads\.TransformerHead\.heads\.predictions\.transform"
     r"\.LayerNorm\.(weight|bias)$",
     "mmss_heads/transformer_head/predictions/transform/norm/{0}"),
    (r"^mmss_heads\.TransformerHead\.heads\.predictions\.bias$",
     "mmss_heads/transformer_head/predictions/decoder_bias"),
]


def convert_lsm_extras(state: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Convert the reference LSM checkpoint's mmss-head + transformer-
    encoder weights. The 6-layer multimodal encoder lives at
    mmss_heads.TransformerHead.encoder.layer.N.* in torch."""
    out = {}
    for tk, tv in state.items():
        tv = np.asarray(tv)
        for pat, template in _LSM_EXTRA_RULES:
            m = re.match(pat, tk)
            if m:
                fk = template
                if m.groups():
                    leaf = m.group(1)
                    is_norm = "/norm/" in fk or fk.endswith("norm/{0}")
                    if leaf == "weight":
                        leaf2 = "scale" if is_norm else "kernel"
                    else:
                        leaf2 = "bias"
                    fk = fk.replace("{0}", leaf2)
                    v = _t(tv.T) if leaf2 == "kernel" and tv.ndim == 2 \
                        else _t(tv)
                else:
                    v = _t(tv)
                out[fk] = v
                break
        else:
            m = re.match(
                r"^mmss_heads\.TransformerHead\.encoder\.(layer\..+)$",
                tk)
            if m:
                out.update(convert_bert_state_dict(
                    {"encoder." + m.group(1): tv},
                    dest_prefix="mmss_heads/transformer_head/"))
    return out


# name-mapping rules: (regex on torch name) -> flax path template
_D2_RULES = [
    # backbone
    (r"^backbone\.stem\.conv1\.weight$", "backbone/stem/conv1/kernel"),
    (r"^backbone\.stem\.conv1\.norm\.(\w+)$",
     "backbone/stem/conv1_norm/{0}"),
    (r"^backbone\.(res\d)\.(\d+)\.conv(\d)\.weight$",
     "backbone/{0}/{1}/conv{2}/kernel"),
    (r"^backbone\.(res\d)\.(\d+)\.conv(\d)\.norm\.(\w+)$",
     "backbone/{0}/{1}/conv{2}_norm/{3}"),
    (r"^backbone\.(res\d)\.(\d+)\.shortcut\.weight$",
     "backbone/{0}/{1}/shortcut/kernel"),
    (r"^backbone\.(res\d)\.(\d+)\.shortcut\.norm\.(\w+)$",
     "backbone/{0}/{1}/shortcut_norm/{2}"),
    # RPN
    (r"^proposal_generator\.rpn_head\.conv\.(weight|bias)$",
     "rpn_head/conv/{0}"),
    (r"^proposal_generator\.rpn_head\.objectness_logits\.(weight|bias)$",
     "rpn_head/objectness_logits/{0}"),
    (r"^proposal_generator\.rpn_head\.anchor_deltas\.(weight|bias)$",
     "rpn_head/anchor_deltas/{0}"),
    # ROI res5 head
    (r"^roi_heads\.res5\.(\d+)\.conv(\d)\.weight$",
     "roi_heads/res5/{0}/conv{1}/kernel"),
    (r"^roi_heads\.res5\.(\d+)\.conv(\d)\.norm\.(\w+)$",
     "roi_heads/res5/{0}/conv{1}_norm/{2}"),
    (r"^roi_heads\.res5\.(\d+)\.shortcut\.weight$",
     "roi_heads/res5/{0}/shortcut/kernel"),
    (r"^roi_heads\.res5\.(\d+)\.shortcut\.norm\.(\w+)$",
     "roi_heads/res5/{0}/shortcut_norm/{1}"),
    # box predictor
    (r"^roi_heads\.box_predictor\.bbox_pred\.(weight|bias)$",
     "roi_heads/box_predictor/bbox_pred/{0}"),
    (r"^roi_heads\.box_predictor\.emb_pred\.(weight|bias)$",
     "roi_heads/box_predictor/emb_pred/{0}"),
]

_TORCH_TO_FLAX_LEAF = {"weight": "kernel", "bias": "bias",
                       "running_mean": "running_mean",
                       "running_var": "running_var"}


def convert_d2_state_dict(state: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """Convert a detectron2-style torch state_dict (the published
    LocOV.pth / lsm_coco.pth) to our flat flax naming: detector trunk,
    language backbone (BERT), and the LSM mmss heads."""
    out = {}
    for tk, tv in state.items():
        tv = np.asarray(tv)
        for pat, template in _D2_RULES:
            m = re.match(pat, tk)
            if not m:
                continue
            groups = [
                _TORCH_TO_FLAX_LEAF.get(g, g) for g in m.groups()]
            fk = template
            for i, g in enumerate(groups):
                fk = fk.replace("{%d}" % i, g)
            # norm affine weight stays 'weight' in FrozenBatchNorm
            if "_norm/" in fk or "norm/" in fk.split("/")[-2:][0]:
                fk = fk.replace("/kernel", "/weight")
            out[fk] = torch_to_flax_leaf(tk, tv, fk)
            break
    lang = {k: v for k, v in state.items()
            if k.startswith("language_backbone.")}
    if lang:
        out.update(convert_bert_state_dict(
            lang, dest_prefix="language_backbone/bert_model/"))
    if any(k.startswith("mmss_heads.") for k in state):
        out.update(convert_lsm_extras(state))
    return out


def convert_caffe2_resnet(state: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """Import the ImageNet-pretrained MSRA R-50 (Caffe2 naming used by
    catalog://ImageNetPretrained/MSRA/R-50): d2 converts those names to
    its own backbone.* scheme; we accept either the d2 scheme (handled
    by convert_d2_state_dict) or d2's pkl with keys like
    'res2_0_branch2a_w'."""
    # d2-converted names first
    if any(k.startswith("backbone.") for k in state):
        return convert_d2_state_dict(state)
    out = {}
    stage_map = {"res2": "res2", "res3": "res3", "res4": "res4",
                 "res5": "res5"}
    branch_map = {"branch2a": "conv1", "branch2b": "conv2",
                  "branch2c": "conv3", "branch1": "shortcut"}
    suffix_map = {"w": ("kernel", True), "b": ("bias", False),
                  "bn_s": ("weight", False), "bn_b": ("bias", False),
                  "bn_rm": ("running_mean", False),
                  "bn_riv": ("running_var", False)}
    for tk, tv in state.items():
        tv = np.asarray(tv)
        if tk.startswith("conv1_"):
            suf = tk[len("conv1_"):]
            if suf == "w":
                out["backbone/stem/conv1/kernel"] = _t(
                    tv.transpose(2, 3, 1, 0))
            elif suf in ("bn_s", "bn_b", "bn_rm", "bn_riv"):
                leaf = suffix_map[suf][0]
                out[f"backbone/stem/conv1_norm/{leaf}"] = _t(tv)
            continue
        m = re.match(r"^(res\d)_(\d+)_(branch\w+)_(\w+)$", tk)
        if not m:
            continue
        stage, block, branch, suf = m.groups()
        if suf not in suffix_map:
            continue
        conv = branch_map.get(branch)
        if conv is None:
            continue
        leaf, is_conv = suffix_map[suf]
        if suf == "w":
            key = f"backbone/{stage_map[stage]}/{block}/{conv}/kernel"
            out[key] = _t(tv.transpose(2, 3, 1, 0))
        else:
            norm = f"{conv}_norm" if conv != "shortcut" else "shortcut_norm"
            key = f"backbone/{stage_map[stage]}/{block}/{norm}/{leaf}"
            out[key] = _t(tv)
    return out


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth/.pkl torch or Caffe2 checkpoint into numpy."""
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        state = data.get("model", data)
        return {k: np.asarray(v) for k, v in state.items()
                if isinstance(v, np.ndarray) or hasattr(v, "shape")}
    import torch
    data = torch.load(path, map_location="cpu", weights_only=False)
    state = data.get("model", data) if isinstance(data, dict) else data
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in state.items()}


# stage-transfer rename fan-out (trainer.py:308-326), in Flax naming
STT_FROM_LSM_RENAME = {
    "roi_heads/res5": ["backbone/res5", "roi_heads/res5"],
    "mmss_heads/v2l_projection": ["roi_heads/box_predictor/emb_pred"],
    "mmss_heads/grounding_head/v2l_projection":
        ["roi_heads/box_predictor/emb_pred"],
}


def torch_rename_map(rename_map: Dict[str, List[str]]
                     ) -> Dict[str, List[str]]:
    """A rename map in Flax names as ``state_dict`` names: its prefixes
    are module paths, and ``from_flax`` maps a path by ``/`` -> ``.``."""
    return {s.replace("/", "."): [d.replace("/", ".") for d in ds]
            for s, ds in rename_map.items()}


def read_weights(weights: str) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` in the port's names from ``weights``: a d2-named
    torch ``.pth`` (``convert_d2_state_dict``) or a Caffe2 ``.pkl``
    (``convert_caffe2_resnet``), each through ``from_flax``; any other
    path is a port checkpoint (its ``model`` entry)."""
    from .weights import from_flax
    if weights.endswith((".pth", ".pkl")):
        state = load_torch_file(weights)
        return from_flax(convert_caffe2_resnet(state)
                         if weights.endswith(".pkl")
                         else convert_d2_state_dict(state))
    data = torch.load(weights, map_location="cpu", weights_only=True)
    return data["model"] if "model" in data else data


def load_weights_standalone(model: torch.nn.Module, weights: str,
                            report_dir: Optional[str] = None
                            ) -> ImportReport:
    """Load ``weights`` (``read_weights``) into ``model``, in place;
    where the key sets differ (the LSM -> STT stage hand-off), through
    the rename fan-out map: the LSM's roi_heads.res5 seeds the STT
    model's roi_heads.res5 (and backbone.res5, where the model has one)
    and the tied v2l projection seeds emb_pred. Keys the source lacks
    keep the model's values. Writes ``import_report.json`` to
    ``report_dir`` when given. The trainer's ``load_pretrained`` calls
    it too (JAX's ``OVRTrainer.load_pretrained``)."""
    flat_src = read_weights(weights)
    flat_dst = model.state_dict()
    same_arch = set(flat_src) == set(flat_dst)
    rename = {} if same_arch else torch_rename_map(STT_FROM_LSM_RENAME)
    merged, report = load_with_rename_map(flat_src, flat_dst, rename)
    logger.info("Import from %s%s: %s", weights,
                "" if same_arch else " (stage-transfer rename map)",
                report.summary())
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
        with open(os.path.join(report_dir, "import_report.json"),
                  "w") as f:
            json.dump(report.asdict(weights), f, indent=1)
    model.load_state_dict(merged, strict=True)
    return report
