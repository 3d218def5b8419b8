"""Synthetic data of the port, copied unchanged from ``repro.data``."""
from repro_torch.data.synthetic import SyntheticLM, SyntheticConfig  # noqa: F401
