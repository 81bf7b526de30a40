"""End-to-end application pipelines."""
