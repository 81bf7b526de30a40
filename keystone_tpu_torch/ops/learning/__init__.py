"""Learned transformers (apply paths)."""
