"""Synthetic data for the port: the textured-room renderer."""
