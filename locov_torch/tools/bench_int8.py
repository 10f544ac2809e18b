"""int8 against bfloat16 at the res5 shapes of STT evaluation: the int8
convolution kernel (KQ1, ``ops/int8_conv.py``) and cuBLASLt's int8
product (``torch._int_mm``) against a bfloat16 product
(``torch.matmul``) and cuDNN's bfloat16 convolution. Twin of
``tools/bench_int8.py``, which asks the same of XLA on the TPU.

    python -m locov_torch.tools.bench_int8 [--boxes 8000] [--seed 0]

The shapes are res5's convolutions on ``--boxes`` 14 x 14 ROI crops
(1,000 boxes of 8 images): block 0's conv1 and shortcut (1x1 / 2 from
1024 channels), the 3x3 conv2 (512 -> 512 on 7 x 7), conv3 (1x1 512 ->
2048) and blocks 1-2's conv1 (1x1 2048 -> 512). For each: the kernel
with a bfloat16 output, its shift and relu; for the 1x1s also
``torch._int_mm`` of the same product as a GEMM (M = boxes x 49 output
pixels; the stride-2 gather of block 0 left out: the input is taken
already subsampled) and ``torch.matmul`` in bfloat16; and cuDNN's
bfloat16 convolution (``F.conv2d`` on channels-last tensors). Then the
quantize passes the dynamic and static schemes add before each conv
(``quantize_per_tensor``: one max-abs reduce and one quantize pass;
``quantize_per_tensor_static``: the quantize pass alone) on res5's
[boxes, 7, 7, 512] bfloat16 activation and on res4's trunk activation
[8, 50, 84, 1024]. The static scheme's fused forms of each conv: conv1
and conv2 writing only int8 (``kq1_quant_only_ms``), conv3 adding the
residual and writing bfloat16 and int8 (``kq1_residual_quant_ms``).
Then one res5 identity block (``[boxes, 7, 7, 2048]`` bfloat16, its
conv1 input also as int8, max-abs values calibrated on it) under the
static scheme, fused (``BottleneckBlock.forward_static``) against the
unfused chain (``BottleneckBlock.forward``: each conv quantizing its
input), the same bits.
Inputs are seeded random int8 and bfloat16 tensors. Times are
CUDA-event medians after warm-up; TOP/s counts 2 x M x K x N. Prints
one JSON line with the card's name and power limit. The library calls
are yardsticks here only: the port never calls them.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..ops import int8_conv as iq
from .timing import describe, time_ms

# (name, input hw, input channels, output channels, kernel, stride)
RES5 = (("block0.conv1", 14, 1024, 512, 1, 2),
        ("block0.shortcut", 14, 1024, 2048, 1, 2),
        ("conv2", 7, 512, 512, 3, 1),
        ("conv3", 7, 512, 2048, 1, 1),
        ("block12.conv1", 7, 2048, 512, 1, 1))


def _int8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen,
                         device="cuda").to(torch.int8)


def conv_case(gen, boxes, hw, c, o, k, stride) -> dict:
    """One res5 conv: the kernel, the int8 and bf16 GEMMs (1x1), cuDNN."""
    pad = (k - 1) // 2
    xq = _int8(gen, (boxes, hw, hw, c))
    wq = _int8(gen, (o, k, k, c))
    scale = torch.rand(o, generator=gen, device="cuda") * 1e-3
    shift = torch.randn(o, generator=gen, device="cuda").to(torch.bfloat16)
    oh = (hw + 2 * pad - k) // stride + 1
    m, kk = boxes * oh * oh, k * k * c
    ops = 2.0 * m * kk * o
    line = {"boxes": boxes, "input": [boxes, hw, hw, c], "out_channels": o,
            "kernel": k, "stride": stride, "gemm_mnk": [m, o, kk],
            "kq1_ms": time_ms(lambda: iq.conv_int8_cuda(
                xq, wq, scale, shift, stride, pad, True), reps=10)}
    amax = torch.tensor(30.0, device="cuda")
    line["kq1_quant_only_ms"] = time_ms(lambda: iq.conv_int8_cuda(
        xq, wq, scale, shift, stride, pad, True, None, amax, False),
        reps=10)
    if k == 1 and stride == 1 and c < o:  # conv3
        res = torch.randn((boxes, oh, oh, o), generator=gen,
                          device="cuda").to(torch.bfloat16)
        line["kq1_residual_quant_ms"] = time_ms(
            lambda: iq.conv_int8_cuda(xq, wq, scale, shift, stride, pad,
                                      True, res, amax, True),
            reps=10)
        del res
    xb = torch.randn((boxes, hw, hw, c), generator=gen,
                     device="cuda").to(torch.bfloat16)
    wb = torch.randn((o, c, k, k), generator=gen,
                     device="cuda").to(torch.bfloat16)
    xc = xb.permute(0, 3, 1, 2)
    wc = wb.contiguous(memory_format=torch.channels_last)
    line["cudnn_bf16_ms"] = time_ms(
        lambda: F.conv2d(xc, wc, stride=stride, padding=pad), reps=10)
    del xb, xc, wc
    if k == 1:
        a8 = xq[:, ::stride, ::stride].reshape(m, c).contiguous()
        b8 = wq.reshape(o, c)
        try:
            line["int_mm_ms"] = time_ms(lambda: torch._int_mm(a8, b8.t()),
                                        reps=10)
        except RuntimeError as e:  # cuBLASLt's shape rules
            line["int_mm_ms"], line["int_mm_error"] = None, str(e)[:200]
        ab = torch.randn((m, c), generator=gen,
                         device="cuda").to(torch.bfloat16)
        bb = wb.reshape(o, c)
        line["matmul_bf16_ms"] = time_ms(lambda: torch.matmul(ab, bb.t()),
                                         reps=10)
        del a8, ab
    for key in [k_ for k_ in line if k_.endswith("_ms")]:
        if line[key]:
            line[key[:-3] + "_tops"] = ops / line[key] / 1e9
    return line


def static_block_case(gen, boxes) -> dict:
    """One res5 identity block under the static scheme, fused against the
    unfused chain, in turns."""
    from ..models.resnet import BottleneckBlock
    block = BottleneckBlock(2048, 512, 2048, compute_dtype=torch.bfloat16,
                            int8_amax=True).cuda()
    with torch.no_grad():
        for conv in (block.conv1, block.conv2, block.conv3):
            conv.weight.normal_(0, conv.weight[0].numel() ** -0.5,
                                generator=gen)
    x = torch.randn((boxes, 7, 7, 2048), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        block(x, int8="calibrate")  # the max-abs values of this input
        next_amax = block.conv1_amax.amax
        xq = iq.QuantizedTensor(*iq.quantize_per_tensor_static(x, next_amax))

        def fused():
            return block.forward_static(x, xq, next_amax)

        def unfused():
            out = block(x, int8="static")
            return out, iq.quantize_per_tensor_static(out, next_amax)[0]
        (out, q), (uout, uq) = fused(), unfused()
        same = bool(torch.equal(out.view(torch.int16),
                                uout.view(torch.int16)) and
                    torch.equal(q.q, uq))
        times = {"fused": [], "unfused": []}
        for _ in range(3):
            for name, fn in (("fused", fused), ("unfused", unfused),
                             ("unfused", unfused), ("fused", fused)):
                times[name].append(time_ms(fn, reps=5, warmup=1))
    return {"input": [boxes, 7, 7, 2048], "same_bits": same,
            "fused_ms": min(times["fused"]),
            "unfused_ms": min(times["unfused"]), "ms_all": times}


def quantize_case(gen, shape) -> dict:
    """The dynamic and the static scheme's quantize of one bfloat16
    activation."""
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    amax = x.float().abs().amax()
    return {"shape": list(shape),
            "dynamic_ms": time_ms(lambda: iq.quantize_per_tensor(x),
                                  reps=10),
            "static_ms": time_ms(
                lambda: iq.quantize_per_tensor_static(x, amax), reps=10)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--boxes", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    convs = {}
    for name, hw, c, o, k, stride in RES5:
        convs[name] = conv_case(gen, args.boxes, hw, c, o, k, stride)
        torch.cuda.empty_cache()
    line = {"bench": "int8", "convs": convs,
            "res5_kq1_ms": convs["block0.conv1"]["kq1_ms"] +
            convs["block0.shortcut"]["kq1_ms"] +
            3 * convs["conv2"]["kq1_ms"] + 3 * convs["conv3"]["kq1_ms"] +
            2 * convs["block12.conv1"]["kq1_ms"],
            "res5_cudnn_bf16_ms": convs["block0.conv1"]["cudnn_bf16_ms"] +
            convs["block0.shortcut"]["cudnn_bf16_ms"] +
            3 * convs["conv2"]["cudnn_bf16_ms"] +
            3 * convs["conv3"]["cudnn_bf16_ms"] +
            2 * convs["block12.conv1"]["cudnn_bf16_ms"],
            "quantize": {"res5": quantize_case(gen, (args.boxes, 7, 7, 512)),
                         "res4": quantize_case(gen, (8, 50, 84, 1024))},
            "static_block": static_block_case(gen, args.boxes),
            **describe(torch.device("cuda"))}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
