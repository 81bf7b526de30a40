"""Bucketed serving of fitted pipelines."""
