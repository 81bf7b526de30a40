"""Single-device ``Dataset``."""
