"""Compute engines and frequency-domain ops."""

from . import convolve, layout, stockham, xla_fft  # noqa: F401
