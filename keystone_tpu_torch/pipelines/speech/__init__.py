"""Speech application pipelines."""
