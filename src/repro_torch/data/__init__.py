"""Synthetic paper datasets for the port (dense path)."""
