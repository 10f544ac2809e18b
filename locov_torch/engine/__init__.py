"""Training engine: optimizer and schedule, and the evaluation side of
the trainer (the trainer loop comes later)."""
