"""Device ops: box algebra helpers, NMS, and the hand-written CUDA kernels
with their plain PyTorch versions."""
