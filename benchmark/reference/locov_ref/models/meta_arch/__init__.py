"""Meta-architectures (counterpart of ``locov_tpu/models/meta_arch``)."""
