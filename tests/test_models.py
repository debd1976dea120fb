"""Model-level tests: multichannel convolver + SDR chain smoke.

The convolver is BASELINE config 4 as a model (channels x long-IR
partitioned convolution); differential reference is numpy float64
convolution, the same scheme the stream-layer tests use.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chowdsp_fft_tpu import parallel
from chowdsp_fft_tpu.models import ConvolverConfig, MultichannelConvolver


@pytest.fixture
def conv_setup(rng):
    ch, taps, t = 4, 700, 6144
    ir = (rng.standard_normal((ch, taps)) / 32).astype(np.float32)
    x = rng.standard_normal((ch, t)).astype(np.float32)
    ref = np.stack(
        [
            np.convolve(x[c].astype(np.float64), ir[c].astype(np.float64))[:t]
            for c in range(ch)
        ]
    )
    return ir, x, ref


def test_convolver_offline_matches_numpy(conv_setup):
    ir, x, ref = conv_setup
    conv = MultichannelConvolver(ir, ConvolverConfig(channels=4, block=512))
    y = np.asarray(conv.apply(jnp.asarray(x)))
    assert np.abs(y - ref).max() < 1e-3


def test_convolver_streaming_matches_offline(conv_setup):
    ir, x, ref = conv_setup
    cfg = ConvolverConfig(channels=4, block=512)
    conv = MultichannelConvolver(ir, cfg)
    off = np.asarray(conv.apply(jnp.asarray(x)))
    st = conv.init_state()
    outs = []
    for i in range(x.shape[1] // cfg.block):
        st, y = conv.step(st, jnp.asarray(x[:, i * cfg.block : (i + 1) * cfg.block]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=1)
    assert np.abs(got - off[:, : got.shape[1]]).max() < 1e-4


def test_convolver_channel_sharded(conv_setup):
    ir, x, ref = conv_setup
    conv = MultichannelConvolver(ir, ConvolverConfig(channels=4, block=512))
    mesh = parallel.dsp_mesh(4, axis=parallel.CHANNEL_AXIS)
    run = conv.channel_sharded_apply(mesh)
    y = np.asarray(run(jnp.asarray(x)))
    assert np.abs(y - ref).max() < 1e-3


def test_convolver_broadcast_ir(rng):
    taps, t = 256, 2048
    ir = (rng.standard_normal(taps) / 16).astype(np.float32)
    x = rng.standard_normal((2, t)).astype(np.float32)
    conv = MultichannelConvolver(ir, ConvolverConfig(channels=2, block=256))
    y = np.asarray(conv.apply(jnp.asarray(x)))
    ref = np.stack(
        [np.convolve(x[c].astype(np.float64), ir.astype(np.float64))[:t] for c in range(2)]
    )
    assert np.abs(y - ref).max() < 1e-3


def test_sdr_chain_matches_float64_composition():
    """SDRChain against the float64 decimate -> channelizer (mixer
    definition) -> FM demod -> audio decimate composition, on channels
    with an FM carrier and on noise-only channels. The channel streams
    are compared relative to their peak; the audio (radians) only where a
    carrier keeps |z| far from zero, since the discriminator's error is
    |dz| / |z|."""
    from chowdsp_fft_tpu.models import SDRChain, SDRChainConfig
    from chowdsp_fft_tpu.utils import reference

    cfg = SDRChainConfig(channels=16, decimation=2, audio_decimation=2)
    chain = SDRChain(cfg)
    t = 16 * 2 * 512
    carriers = (3, 12)
    iq = reference.fm_test_signal(t, 16, 2, 2, carriers, seed=3)
    chans = (0, 3, 12)
    z_ref, a_ref = reference.sdr_chain(
        iq,
        np.asarray(chain.front_lp),
        np.asarray(chain.channelizer.proto),
        np.asarray(chain.audio_lp),
        cfg.channels, cfg.decimation, cfg.audio_decimation, cfg.fm_gain, chans,
    )

    @jax.jit
    def run(v):
        return chain.channelizer(chain.front_end(v)), chain(v)

    z, audio = map(np.asarray, run(jnp.asarray(iq)))
    idx = list(chans)
    err_z = np.abs(z[idx] - z_ref).max(axis=-1) / np.abs(z_ref).max(axis=-1)
    assert (err_z < 1e-4).all(), err_z
    valid = reference.audio_valid(z_ref, cfg.audio_taps, cfg.audio_decimation)
    for i, ch in enumerate(chans):
        if ch in carriers:
            assert valid[i].mean() > 0.8, ch  # all but the start-up transient
            assert np.abs(audio[ch] - a_ref[i])[valid[i]].max() < 1e-4, ch
