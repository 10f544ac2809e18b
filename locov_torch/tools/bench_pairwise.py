"""The global-contrastive B x B joint-encoder pass on the card. Twin of
``tools/bench_pairwise.py``.

    python -m locov_torch.tools.bench_pairwise [--batch 32] [--chunk 128]
        [--regions 100] [--tokens 70] [--fwd-only] [--device cpu]

Runs the ``TransformerHead`` (``models/mmss/transformer_head.py``: the
6-layer, 8-head multimodal BERT of coco_lsm.yaml's
MMSS_HEAD.TRANSFORMER, ``v_dim`` 2048, ``l_dim`` 768, vocabulary 30522)
forward and backward (the gradients of the summed losses in every
parameter) at ``--batch`` B, so B x B (caption, image) pairs, with
``TPU.PAIRWISE_CHUNK`` ``--chunk``, bfloat16 compute, R = ``--regions``
regions and W = ``--tokens`` tokens: the workload of the global scope's
B x B encoder, 1,024 pairs at B = 32. Weights are seeded
(``utils/weights.py:seeded_init_``); the inputs, as JAX's tool makes
them, come from one seeded ``torch.Generator``: bfloat16 N(0, 1) region
features and caption encodings, uniform locations, every region and
token valid, random token ids and targets, 15% of the tokens masked for
MLM, a bfloat16 N(0, 1) [30522, 768] word-embedding matrix.

Timing as JAX's tool: the best of 3 repetitions of 4 iterations, each
repetition ended by a synchronisation. JAX's ``compile_s`` becomes
``first_call_s``, the seconds of the first call (no compilation here:
cuDNN and cuBLAS plans, the allocator). ``peak_hbm_gb`` is
``torch.cuda.max_memory_allocated`` over the first call and the timed
ones (GiB; null on the CPU). Prints one JSON line with JAX's keys, the
encoder's products in TFLOP (``matmul_tflop``, from the shapes) and the
device (``timing.describe``). Runs on ``cuda`` unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..config import config_path, get_cfg
from ..models.mmss.transformer_head import (TransformerHead,
                                            TransformerHeadConfig)
from ..structures.batches import CaptionFeatures, RegionFeatures
from ..utils.device import resolve_device
from ..utils.weights import seeded_init_
from .timing import describe, sync

VOCAB = 30522


def build(batch, chunk, regions, tokens, device, seed=0):
    """(head, image, caption, word_emb) of the pass on ``device``."""
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_lsm.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.PAIRWISE_CHUNK = chunk
    head = TransformerHead(TransformerHeadConfig.from_cfg(cfg), v_dim=2048,
                           l_dim=768, external_projection=False)
    head = seeded_init_(head, seed).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    b, r, w = batch, regions, tokens

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    def ids(*shape):
        return torch.randint(0, VOCAB, shape, generator=gen, device=device)

    image = RegionFeatures(
        features=normal(b, r, 2048),
        mask=torch.ones(b, r, dtype=torch.bool, device=device),
        loc=torch.rand(b, r, 2, generator=gen, device=device))
    enc = normal(b, w, 768)
    caption = CaptionFeatures(
        input_ids=ids(b, w),
        attention_mask=torch.ones(b, w, dtype=torch.int32, device=device),
        special_tokens_mask=torch.zeros(b, w, dtype=torch.int32,
                                        device=device),
        target_ids=ids(b, w),
        mlm_mask=(torch.rand(b, w, generator=gen, device=device)
                  < 0.15).int(),
        encoded_tokens=enc, input_embeddings=enc)
    return head, image, caption, normal(VOCAB, 768)


def matmul_tflop(head, pairs, seq, fwd_only) -> float:
    """The joint encoder's products in TFLOP (2 a multiply-add), from
    the shapes: per token and layer the four attention projections, the
    feed-forward pair and the two attention products; the backward
    twice the forward, and one more forward where the pairs are
    chunked (recomputed under remat)."""
    c = head.tcfg.bert
    d, ffn = c.hidden_size, c.intermediate_size
    fwd = pairs * seq * c.num_hidden_layers * 2 * (
        4 * d * d + 2 * d * ffn + 2 * seq * d)
    passes = 1 if fwd_only else (
        4 if 0 < head.tcfg.pairwise_chunk < pairs else 3)
    return fwd * passes / 1e12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch B; pairs = B*B")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--regions", type=int, default=100)
    ap.add_argument("--tokens", type=int, default=70)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch
    head, image, caption, word_emb = build(b, args.chunk, args.regions,
                                           args.tokens, device)
    params = [p for p in head.parameters() if p.requires_grad]
    print(f"pairs={b * b} chunk={args.chunk} "
          f"params={sum(p.numel() for p in params) / 1e6:.1f}M",
          file=sys.stderr)

    def loss_fn():
        # (other, losses[, dist]): the LSM sets return_dist
        return sum(head(image, caption, word_emb)[1].values())

    def step():
        if args.fwd_only:
            with torch.no_grad():
                return loss_fn()
        loss = loss_fn()
        return loss, torch.autograd.grad(loss, params)

    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = step()
    sync(device)
    first_call_s = time.perf_counter() - t0

    reps, iters = 3, 4
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    del out
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    line = {"metric": "pairwise_encoder_ms", "pairs": b * b,
            "chunk": args.chunk, "fwd_only": bool(args.fwd_only),
            "value": best * 1e3, "unit": "ms",
            "first_call_s": first_call_s, "peak_hbm_gb": peak,
            "ms_per_pair": best * 1e3 / (b * b),
            "matmul_tflop": matmul_tflop(head, b * b,
                                         args.regions + args.tokens,
                                         args.fwd_only),
            **describe(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
