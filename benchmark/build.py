"""The cell's files, its configuration for the program and for the
plain reference, and the weights: made on the device from the seed, in
a few large draws, and handed to both sides as one state dict."""
from __future__ import annotations

import json
import os
from typing import Dict

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "locov_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, its
    configuration file, its traffic file, its workload file and its
    limits, by name."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = read_json(os.path.join(root, configs[entry["config"]]["file"]))
    return {
        "name": name, "entry": entry, "config": conf,
        "workload": read_json(os.path.join(BENCH, "workloads",
                                           name + ".json")),
        "traffic": read_json(os.path.join(BENCH, "traffic",
                                          entry["traffic"] + ".json")),
        "limits": read_json(os.path.join(BENCH, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def set_key(cfg, key: str, value) -> None:
    node = cfg
    *path, leaf = key.split(".")
    for part in path:
        node = getattr(node, part)
    setattr(node, leaf, value)


def _cfg(get_cfg, conf: dict, extra: Dict[str, object]):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, conf["yaml"]))
    for key, value in {**conf["settings"], **extra}.items():
        set_key(cfg, key, value)
    return cfg


def program_cfg(conf: dict, control: bool = False):
    """The program's config: the yaml and the file's settings (with
    ``control_settings`` for the control run)."""
    from locov_torch.config import get_cfg
    return _cfg(get_cfg, conf, conf.get("control_settings", {})
                if control else {})


def reference_cfg(conf: dict, dtype: str = "float32"):
    """The reference's config: the same, in ``dtype`` (its
    ``reference_settings``)."""
    from .reference.locov_ref.config import get_cfg
    return _cfg(get_cfg, conf, {**conf.get("reference_settings", {}),
                                "TPU.COMPUTE_DTYPE": dtype})


# --------------------------------------------------------------- weights
TRUNC = 0.87962566103423978  # the std of N(0, 1) truncated at 2 sigma
LAWS = ("normal", "trunc", "const")


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int, device,
                 trained_scale: bool) -> Dict[str, torch.Tensor]:
    """The model's state dict from ``seed``, with the laws of the
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
    device, in ``state_dict`` order. A leaf that none of these rules
    covers takes its law from the module that holds it: the module's
    ``seed_laws``, {leaf name: ("normal", std) | ("trunc", std) |
    ("const", value)}, which a new architecture's modules give for
    leaves such as a position table. Raises where a leaf has no law."""
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
    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        for leaf, law in getattr(mod, "seed_laws", {}).items():
            if law[0] not in LAWS:
                raise ValueError(f"{pre}{leaf}: no law {law[0]!r}")
            laws.setdefault(pre + leaf, tuple(law))
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
            std = laws[k][1] / (TRUNC if law == "trunc" else 1.0)
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
