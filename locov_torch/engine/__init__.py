"""Training engine: optimizer and schedule (the trainer loop comes
later)."""
