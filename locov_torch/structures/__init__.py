"""Batch containers and box algebra."""
