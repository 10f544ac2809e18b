"""The training and evaluation steps on one device (data parallelism
comes later)."""
