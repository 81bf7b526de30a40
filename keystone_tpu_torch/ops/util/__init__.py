"""Representation and utility nodes."""
