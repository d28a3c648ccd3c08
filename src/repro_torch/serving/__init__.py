"""Serving side of the port: the bucketed decision fast path."""
