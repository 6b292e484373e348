"""Utilities of the PyTorch port: metrics, units, random streams, timing,
profiling, checkpoints and spectral analysis."""
