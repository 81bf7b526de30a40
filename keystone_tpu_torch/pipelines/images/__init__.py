"""Image application pipelines."""
