"""Fused ReLU + 3x3/2 max-pool (pad 1) of the ResNet stem, NHWC.

Counterpart of ``locov_tpu/ops/pallas_pool.py`` (forward). On a CUDA
tensor ``relu_maxpool`` launches the hand-written kernel
``csrc/relu_maxpool.cu``; on a CPU tensor it runs the plain version.
Taps outside the image act as -inf; the result equals the plain
version bit for bit (max is exact).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernel_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def relu_maxpool_plain(x: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C] pre-relu -> max_pool3x3/2,pad1(relu(x))
    [N, ceil(H/2), ceil(W/2), C], in plain PyTorch."""
    y = F.max_pool2d(F.relu(x.permute(0, 3, 1, 2)), 3, 2, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def _lib():
    lib = kernel_lib.load("relu_maxpool")
    fn = lib.relu_maxpool_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def relu_maxpool_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x a contiguous NHWC float32/bfloat16 CUDA
    tensor of any H, W, C."""
    kernel_lib.check_cuda_tensor(x, "relu_maxpool x", _DTYPES)
    if x.dim() != 4:
        raise ValueError(f"relu_maxpool: expected NHWC, got {x.shape}")
    n, h, w, c = x.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    fn = _lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow,
                 _DTYPES[x.dtype], vec, kernel_lib.stream_ptr(x.device))
    kernel_lib.check_launch(err, "relu_maxpool")
    kernel_lib.LAUNCHES["relu_maxpool"] += 1
    return y


def relu_maxpool(x: torch.Tensor) -> torch.Tensor:
    """y = maxpool3x3/2,pad1(relu(x)) on NHWC: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return relu_maxpool_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"relu_maxpool: unsupported device {x.device}")
    return relu_maxpool_plain(x)
