"""Shared numeric helpers."""
