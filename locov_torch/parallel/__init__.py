"""The training step (one device for now; data parallelism comes
later)."""
