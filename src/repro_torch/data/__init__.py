"""Synthetic data of the port, copied unchanged from ``repro.data``."""
