"""Data loaders."""
