"""PyTorch / CUDA port of locov-tpu, for one NVIDIA H100.

The JAX package ``locov_tpu`` is the reference this port is held to;
the port mirrors its layout and names (``structures``, ``ops``,
``models``, ``models/meta_arch``, ``config``, ``utils``) and imports
nothing of it. Public functions keep JAX's NHWC layout. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``. The TPU
kernels of the ported path are hand-written CUDA kernels under
``csrc/``, built at first use (``ops/kernel_lib.py``).
"""
