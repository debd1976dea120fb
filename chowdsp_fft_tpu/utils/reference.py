"""Plain numpy/scipy float64 references for the model paths.

Independent of the code under test: each function restates the
semantics from its definition (zero-state FIR, mixer-definition
channelizer, quadrature FM discriminator), and only the filter taps are
shared, as data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fir_truncated", "sdr_chain", "fm_test_signal", "audio_valid"]


def fir_truncated(x, h) -> np.ndarray:
    """Zero-state linear FIR of the last axis, truncated to the input
    length: ``lfilter(h, 1, x)``, computed by an FFT convolution in
    float64."""
    from scipy.signal import oaconvolve

    x = np.asarray(x, np.float64 if not np.iscomplexobj(x) else np.complex128)
    h = np.asarray(h, np.float64)
    t = x.shape[-1]
    h = h.reshape((1,) * (x.ndim - 1) + h.shape) if h.ndim == 1 else h
    return oaconvolve(x, h, axes=-1)[..., :t]


def sdr_chain(
    iq,
    front_lp,
    proto,
    audio_lp,
    channels: int,
    decimation: int,
    audio_decimation: int,
    fm_gain: float,
    chans,
) -> tuple[np.ndarray, np.ndarray]:
    """Float64 decimate -> channelize -> FM demod -> audio decimate of one
    (T,) complex stream, for the channels ``chans`` only.

    - front end: zero-state FIR by ``front_lp``, keep every
      ``decimation``-th sample from 0 (T // decimation samples);
    - channelizer, by the mixer definition: channel c is the stream mixed
      down by exp(-2j*pi*c*n/C), filtered by the prototype ``proto``,
      sampled at m*C + C-1, rotated by exp(2j*pi*c*(C-1)/C) and scaled by
      1/C;
    - FM discriminator: y[n] = gain * angle(z[n] * conj(z[n-1])), y[0] = 0;
    - audio: zero-state FIR by ``audio_lp``, every ``audio_decimation``-th
      sample.

    Returns (channel streams (len(chans), S), audio (len(chans), S // ad)).
    """
    x = np.asarray(iq, np.complex128)
    t = x.shape[-1]
    f = fir_truncated(x, front_lp)[::decimation][: t // decimation]
    c = channels
    steps = f.shape[-1] // c
    f = f[: steps * c]
    n = np.arange(steps * c)
    zs, audio = [], []
    for ch in chans:
        mixed = f * np.exp(-2j * np.pi * ch * (n % c) / c)
        filt = fir_truncated(mixed, proto)
        z = filt[c - 1 :: c][:steps] * np.exp(2j * np.pi * ch * (c - 1) / c) / c
        y = np.zeros(steps)
        y[1:] = fm_gain * np.angle(z[1:] * np.conj(z[:-1]))
        a = fir_truncated(y, audio_lp)[::audio_decimation][: steps // audio_decimation]
        zs.append(z)
        audio.append(a)
    return np.stack(zs), np.stack(audio)


def audio_valid(z_ref, audio_taps: int, audio_decimation: int, frac: float = 0.5) -> np.ndarray:
    """(len(chans), S // ad) mask of the audio samples whose filter window
    covers only discriminator outputs with |z[n]| and |z[n-1]| above
    ``frac`` of the channel's median magnitude. Elsewhere (the filters'
    start-up transient, noise-only channels) the discriminator's error
    |dz| / |z| is unbounded, so the audio is not compared there."""
    mag = np.abs(z_ref)
    good = mag > frac * np.median(mag, axis=-1, keepdims=True)
    good[..., 1:] &= good[..., :-1]
    good[..., 0] = False
    bad = np.cumsum(~good, axis=-1)
    steps = z_ref.shape[-1]
    m = np.arange(steps // audio_decimation) * audio_decimation  # last input
    lo = m - audio_taps  # window is (lo, m]
    bad_lo = np.where(lo >= 0, bad[..., np.clip(lo, 0, None)], 0)
    return (bad[..., m] - bad_lo == 0) & (lo >= 0)


def fm_test_signal(
    t: int,
    channels: int,
    decimation: int,
    audio_decimation: int,
    carrier_chans,
    noise: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """(T,) complex64 wideband IQ: a unit FM carrier at the centre of each
    channel in ``carrier_chans`` (after the front end's decimation), a
    message tone at a tenth of the audio rate, and complex white noise of
    standard deviation ``noise`` per component."""
    rng = np.random.default_rng(seed)
    k = np.arange(t, dtype=np.float64)
    wide = channels * decimation  # wideband samples per channel bin
    msg_f = 0.1 / (wide * audio_decimation)
    dev = 0.1 / wide
    iq = np.zeros(t, np.complex128)
    for i, ch in enumerate(carrier_chans):
        fc = ch / wide if ch < channels // 2 else (ch - channels) / wide
        msg = np.sin(2 * np.pi * msg_f * k + i)
        iq += np.exp(1j * (2 * np.pi * fc * k + 2 * np.pi * dev * np.cumsum(msg)))
    iq += noise * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    return iq.astype(np.complex64)
