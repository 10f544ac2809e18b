"""Entry points of the port: twins of the repository's ``tools/`` scripts,
run as ``python -m locov_torch.tools.<name>``."""
