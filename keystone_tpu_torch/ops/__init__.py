"""Operator library: the nodes of the flagship featurize and serving path."""
