"""Statistical feature nodes."""
