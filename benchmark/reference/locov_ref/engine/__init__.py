"""Training engine: the optimizer and schedule (with gradient
accumulation) and the trainer loop with its evaluation side."""
