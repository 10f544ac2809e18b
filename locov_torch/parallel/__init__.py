"""The training and evaluation steps, data parallel over the ranks of
``torch.distributed``, and the input prefetcher."""
