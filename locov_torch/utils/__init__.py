"""Weight import and device helpers."""
