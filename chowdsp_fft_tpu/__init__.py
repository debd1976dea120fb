"""chowdsp_fft_tpu — a JAX FFT + fast-convolution framework for accelerators.

JAX/XLA implementation of the capabilities of Chowdhury-DSP/chowdsp_fft (a
SIMD pffft fork): single-precision real and complex FFTs, unordered
transforms, frequency-domain convolve/accumulate — extended with streaming
DSP and multi-device sharding layers (overlap-save partitioned convolution,
polyphase channelization, halo exchange between devices).

Layers (see SURVEY.md section 7):
  plans     — factorization + twiddle tables as pytrees
  ops       — compute engines: xla (jnp.fft; cuFFT on a GPU) + jnp Stockham
  api       — the public transform/convolve surface (this module re-exports)
  stream    — overlap-save FIR, polyphase resampling, channelizer, demod
  parallel  — mesh/shard_map sharding, halo exchange collectives
  models    — end-to-end SDR chains (the "model zoo" of a DSP framework)
  adapters  — drop-in shims (numpy-like, JUCE-engine analog)
"""

from .api import (  # noqa: F401
    FFT_BACKWARD,
    available_engines,
    engine_for,
    engine_supports,
    FFT_COMPLEX,
    FFT_FORWARD,
    FFT_REAL,
    FFTPlan,
    InvalidSizeError,
    accumulate,
    cached_plan,
    convolve_accumulate,
    factorize,
    fft,
    fft_unordered,
    ifft,
    ifft_unordered,
    convolve_accumulate_packed,
    convolve_irfft_packed,
    fft_planes,
    fft_planes_unordered,
    ifft_planes,
    ifft_planes_unordered,
    irfft,
    irfft_packed,
    irfft_packed_unordered,
    irfft_unordered,
    is_valid_size,
    make_plan,
    multiply_spectra,
    packed_planes_to_spectrum,
    plan_bytes,
    rfft,
    rfft_packed,
    rfft_packed_unordered,
    rfft_unordered,
    spectrum_to_packed_planes,
    vector_width_bytes,
)

__version__ = "0.2.0"
