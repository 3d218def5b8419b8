"""PyTorch/CUDA port of the LAPS serving system.

Mirrors the layout of the JAX package ``repro`` (core/, configs/,
kernels/, models/, serving/, launch/) so each module's counterpart is
found at the same relative path.  Imports torch and numpy only: the
pure-Python modules it needs from the JAX package are copied, never
imported.
"""
