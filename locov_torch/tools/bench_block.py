"""The fused bottleneck-block kernel against cuDNN's chain of three
convolutions, at res2 training shapes ([4, 200, 336, 256] bfloat16,
M 64) by default. Twin of ``tools/bench_block.py``.

    python -m locov_torch.tools.bench_block [--n 4 --h 200 --w 336
        --c 256 --m 64] [--check-only] [--device cuda|cpu] [--seed 0]
        [--reference SRC] [--trunk]

Inputs are seeded random arrays (an explicit ``torch.Generator``), as
the JAX tool makes them: x ~ N(0, 1), weights ~ N(0, 1) x 0.05 in
bfloat16, biases ~ N(0, 1) x 0.1 in float32. Prints one JSON line: the
block's time and ``bottleneck_block_ref``'s (three ``F.conv2d`` calls,
not one call), their ratio and the block's largest error relative to
max |ref|; with ``--check-only`` the error alone. On the card the block
is the CUDA kernel, timed with CUDA events (median after warm-up); with
``--device cpu`` it is the plain version, timed on the host clock.

``--reference`` builds another source of ``csrc/bottleneck_block.cu``
whose C entry ``bottleneck_block_fwd`` takes the same arguments (the
kernel of commit 5cb9de6 does: ``git show
5cb9de6:locov_torch/csrc/bottleneck_block.cu``, beside ``common.cuh``
and ``mma_bf16.cuh``) and times it in turns with the kernel, for
bfloat16 and float32 x: reference, kernel, kernel, reference; with the
largest difference of the two outputs.

``--trunk`` times, in bfloat16 under ``torch.no_grad()``, at the
inference path's identity-block shapes (res2 [8, 200, 336, 256] with
M 64, 2 such blocks a batch; res3 [8, 100, 168, 512] with M 128, 3 a
batch): the kernel, the trunk's own ``models/resnet.py:BottleneckBlock``
(cuDNN convolutions, then the FrozenBN shift, relu and residual as
separate kernels) and ``bottleneck_block_ref``, all three on the
block's FrozenBN folded into its weights; with the ms a batch of the
kernel and of the trunk's block, and the kernel's largest difference
from the trunk's block relative to its max |y|.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..models.resnet import BottleneckBlock
from ..ops import kernel_lib
from ..ops.bottleneck_block import (_DTYPES, bottleneck_block,
                                    bottleneck_block_cuda,
                                    bottleneck_block_ref)
from ..utils.device import resolve_device
from .timing import describe, time_ms

# the inference trunk's identity blocks at 800 x 1344, batch 8:
# (stage, x shape, M, identity blocks of the stage)
TRUNK_SHAPES = (("res2", (8, 200, 336, 256), 64, 2),
                ("res3", (8, 100, 168, 512), 128, 3))


def make_inputs(gen, shape, m, dtype=torch.bfloat16):
    """(x, w1, b1, w2, b2, w3, b3) on ``gen``'s device, as the JAX tool
    makes them: x [N, H, W, C] ~ N(0, 1) and weights ~ N(0, 1) x 0.05 in
    ``dtype``, biases ~ N(0, 1) x 0.1 in float32."""
    c = shape[3]

    def normal(s, scale, dt):
        return (torch.randn(s, generator=gen, device=gen.device)
                * scale).to(dt)

    f32 = torch.float32
    return (normal(shape, 1.0, dtype), normal((c, m), 0.05, dtype),
            normal((m,), 0.1, f32), normal((3, 3, m, m), 0.05, dtype),
            normal((m,), 0.1, f32), normal((m, c), 0.05, dtype),
            normal((c,), 0.1, f32))


def load_reference(src):
    """``src`` built by nvcc beside this build, its C entry bound."""
    lib = kernel_lib.load_source(src, "reference_bottleneck_block")

    def run(x, w1, b1, w2, b2, w3, b3):
        n, h, w, c = x.shape
        out = torch.empty_like(x)
        kernel_lib.launch(
            "bottleneck_block_fwd", x.device, x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
            b3.data_ptr(), out.data_ptr(), n, h, w, c, w1.shape[1],
            _DTYPES[x.dtype], lib=lib)
        return out
    return run


def turns(reference, args, device) -> dict:
    """The reference's and the kernel's launches in turns, on the same
    inputs (weights already in x's dtype, biases in float32)."""
    def kernel():
        return bottleneck_block_cuda(*args)

    def ref():
        return reference(*args)
    times = [time_ms(ref, device), time_ms(kernel, device),
             time_ms(kernel, device), time_ms(ref, device)]
    line = dict(zip(("reference", "kernel", "kernel_again",
                     "reference_again"), times))
    line["max_abs_diff"] = (ref().float() - kernel().float()).abs().max().item()
    return line


def trunk_block(c, m, gen):
    """A res-stage identity block of the port's trunk in bfloat16 with
    seeded weights (conv ~ N(0, 1) x 0.05, FrozenBN scale about 1 and
    shift about 0), and the same block folded into the kernel's
    arguments: (w1, b1, w2, b2, w3, b3), weights in bfloat16 as the
    trunk casts them after folding, biases the FrozenBN shifts."""
    dev = gen.device
    block = BottleneckBlock(c, m, c, compute_dtype=torch.bfloat16).to(dev)

    def normal(s, scale):
        return torch.randn(s, generator=gen, device=dev) * scale
    with torch.no_grad():
        for conv, norm in ((block.conv1, block.conv1_norm),
                           (block.conv2, block.conv2_norm),
                           (block.conv3, block.conv3_norm)):
            conv.weight.copy_(normal(conv.weight.shape, 0.05))
            k = norm.weight.numel()
            norm.weight.copy_(1 + normal(k, 0.1))
            norm.bias.copy_(normal(k, 0.1))
            norm.running_mean.copy_(normal(k, 0.1))
            norm.running_var.copy_(1 + normal(k, 0.1).abs())
        folded = []
        for conv, norm in ((block.conv1, block.conv1_norm),
                           (block.conv2, block.conv2_norm),
                           (block.conv3, block.conv3_norm)):
            scale, shift = norm.scale_shift()
            wk = (conv.weight * scale[:, None, None, None]).to(torch.bfloat16)
            # OIHW -> [C, M] / HWIO / [M, C]
            wk = wk.permute(2, 3, 1, 0)
            folded += [(wk[0, 0] if wk.shape[0] == 1 else wk).contiguous(),
                       shift.float().contiguous()]
    return block, tuple(folded)


def trunk_ab(device, seed=0) -> dict:
    """The kernel, the trunk's block and ``bottleneck_block_ref`` at the
    inference trunk's identity-block shapes (``TRUNK_SHAPES``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    with torch.no_grad():
        for stage, shape, m, blocks in TRUNK_SHAPES:
            block, wargs = trunk_block(shape[3], m, gen)
            x = torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16)
            y_trunk = block(x).float()
            y = bottleneck_block(x, *wargs).float()
            rel = float((y - y_trunk).abs().max()
                        / y_trunk.abs().max().clamp(min=1e-6))
            del y, y_trunk
            line = {"shape": list(shape), "m": m, "blocks": blocks,
                    "kernel_ms": time_ms(
                        lambda: bottleneck_block(x, *wargs), device),
                    "trunk_ms": time_ms(lambda: block(x), device),
                    "ref_ms": time_ms(
                        lambda: bottleneck_block_ref(x, *wargs), device),
                    "max_rel_diff_vs_trunk": rel}
            line["kernel_batch_ms"] = blocks * line["kernel_ms"]
            line["trunk_batch_ms"] = blocks * line["trunk_ms"]
            out[stage] = line
            del x, block, wargs
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--h", type=int, default=200)
    ap.add_argument("--w", type=int, default=336)
    ap.add_argument("--c", type=int, default=256)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--reference", default=None,
                    help="another bottleneck_block.cu to time in turns")
    ap.add_argument("--trunk", action="store_true",
                    help="time the kernel against the trunk's own block "
                         "at the inference shapes")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = (args.n, args.h, args.w, args.c)
    x, *wargs = make_inputs(gen, shape, args.m)
    with torch.no_grad():
        y = bottleneck_block(x, *wargs).float()
        y_ref = bottleneck_block_ref(x, *wargs).float()
        rel = float((y - y_ref).abs().max()
                    / y_ref.abs().max().clamp(min=1e-6))
        del y, y_ref
        if args.check_only:
            line = {"metric": "block_parity_max_rel_err", "value": rel,
                    **describe(device)}
        else:
            t_block = time_ms(lambda: bottleneck_block(x, *wargs), device)
            t_ref = time_ms(lambda: bottleneck_block_ref(x, *wargs), device)
            line = {"metric": "bottleneck_block_fwd_ms",
                    "shape": [*shape, args.m],
                    "dtype": "bfloat16", **describe(device),
                    "block": "cuda_kernel" if device.type == "cuda"
                    else "plain",
                    "block_ms": t_block, "ref_ms": t_ref,
                    "speedup": t_ref / t_block, "max_rel_err": rel}
        if args.reference:
            reference = load_reference(args.reference)
            line["turns_ms"] = {}
            for dt in (torch.bfloat16, torch.float32):
                targs = make_inputs(gen, shape, args.m, dt)
                line["turns_ms"][str(dt).split(".")[1]] = turns(
                    reference, targs, device)
                del targs
        if args.trunk:
            line["trunk_ab"] = trunk_ab(device, args.seed)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
