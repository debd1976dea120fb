"""Flagship end-to-end pipeline: wideband SDR receiver chain.

BASELINE.json config 5: "polyphase decimate -> FFT channelizer -> FM demod,
256 channels on multi-host pod". This is the framework's "model": a jitted,
shardable composition of every layer —

    IQ stream (..., T)
      -> polyphase decimation (XLA convolutions at HIGHEST precision)
      -> polyphase FFT channelizer (api complex FFT)
      -> per-channel FM discriminator (elementwise)
      -> audio low-pass + decimate per channel

Multi-device: the wideband front half is time-sharded with halo exchange;
the per-channel back half is channel-sharded. The single
with_sharding_constraint between them lets XLA place the all_to_all
reshard between devices (the GSPMD-idiomatic seam).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..stream import (
    Channelizer,
    design_lowpass,
    fm_demod,
    polyphase_decimate,
)
from ..parallel.mesh import CHANNEL_AXIS, TIME_AXIS

__all__ = ["SDRChainConfig", "SDRChain"]


@dataclasses.dataclass(frozen=True)
class SDRChainConfig:
    channels: int = 256  # channelizer bins
    decimation: int = 2  # front-end decimation factor
    front_taps: int = 64  # anti-alias FIR length
    channel_taps_per_branch: int = 8
    audio_decimation: int = 4  # per-channel audio decimation
    audio_taps: int = 64
    fm_gain: float = 1.0
    engine: str = "auto"


class SDRChain:
    """Jit-compatible SDR receiver chain. Call with complex IQ (..., T)."""

    def __init__(self, config: SDRChainConfig = SDRChainConfig()):
        self.config = config
        c = config
        self.front_lp = design_lowpass(c.front_taps, 1.0 / c.decimation)
        self.audio_lp = design_lowpass(c.audio_taps, 1.0 / c.audio_decimation)
        self.channelizer = Channelizer(
            c.channels, c.channel_taps_per_branch, engine=c.engine
        )

    def front_end(self, iq: jax.Array) -> jax.Array:
        """Decimating anti-alias front end on the wideband stream. The I/Q
        planes are stacked into one batched decimator call (two single-row
        convs cost ~2x one 2-row conv)."""
        c = self.config
        planes = jnp.stack([jnp.real(iq), jnp.imag(iq)], axis=-2)
        dec = polyphase_decimate(planes, self.front_lp, c.decimation)
        return jax.lax.complex(dec[..., 0, :], dec[..., 1, :])

    def back_end(self, channels: jax.Array) -> jax.Array:
        """Per-channel FM demod + audio filtering. channels: (..., C, S)."""
        c = self.config
        audio = fm_demod(channels, gain=c.fm_gain)
        # Decimating filter: computes only the kept output samples
        # (filter-at-full-rate-then-slice did audio_decimation x the work).
        return polyphase_decimate(audio, self.audio_lp, c.audio_decimation)

    def __call__(self, iq: jax.Array) -> jax.Array:
        """(..., T) complex IQ -> (..., C, T/(decim*C*audio_decim)) audio."""
        return self.back_end(self.channelizer(self.front_end(iq)))

    # ------------------------------------------------------------------
    # Multi-device application
    # ------------------------------------------------------------------

    def sharded_step(self, mesh: Mesh, axis_name: str | None = None):
        """Returns a jitted fn computing the chain with the wideband input
        time-sharded and the channelized back half channel-sharded; XLA
        inserts the all_to_all at the seam."""
        axis = axis_name or (
            TIME_AXIS if TIME_AXIS in mesh.axis_names else mesh.axis_names[0]
        )

        @functools.partial(jax.jit)
        def step(iq):
            iq = jax.lax.with_sharding_constraint(
                iq, NamedSharding(mesh, P(*([None] * (iq.ndim - 1)), axis))
            )
            ch = self.channelizer(self.front_end(iq))
            # reshard: channels over the mesh axis for the demod half
            ch = jax.lax.with_sharding_constraint(
                ch, NamedSharding(mesh, P(*([None] * (ch.ndim - 2)), axis, None))
            )
            return self.back_end(ch)

        return step
