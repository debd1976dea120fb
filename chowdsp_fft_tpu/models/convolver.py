"""Multichannel partitioned convolution engine (convolution-reverb style).

BASELINE.json config 4 as a "model": 64 channels x 10 s @ 48 kHz streams
convolved with long impulse responses through the uniformly partitioned
overlap-save FDL (stream.PartitionedFIR) — the workload whose hot op is
the reference's fused ``ab += a * b * scaling`` convolve-accumulate
(/root/reference/simd/chowdsp_fft_impl_sse.cpp:1603-1645), batched over
channels and sharded over devices.

Two sharding modes (parallel/):
  - channel-sharded: each device owns whole channels; zero communication
    (the multi-device generalization of the reference's lane parallelism).
  - time-sharded: each device owns a time shard of every channel; one
    (taps-1)-sample halo ppermute per application crosses devices.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..stream import PartitionedFIR
from ..parallel.mesh import CHANNEL_AXIS
from ..parallel.sharded import sharded_partitioned_fir

__all__ = ["ConvolverConfig", "MultichannelConvolver"]


@dataclasses.dataclass(frozen=True)
class ConvolverConfig:
    channels: int = 64
    sample_rate: int = 48000
    block: int = 1024  # FDL partition size (FFT size = 2*block)
    engine: str = "auto"


class MultichannelConvolver:
    """Streaming convolver: per-channel impulse responses, shared FDL shape.

    ``ir`` is (channels, taps) — one impulse response per channel (or
    (taps,) broadcast to all). Offline: :meth:`apply` filters whole
    (channels, T) streams. Streaming: :meth:`init_state` + :meth:`step`
    process one (channels, block) frame at a time with O(1) state.
    """

    def __init__(self, ir: jax.Array, config: ConvolverConfig = ConvolverConfig()):
        self.config = config
        ir = jnp.asarray(ir, jnp.float32)
        if ir.ndim == 1:
            ir = jnp.broadcast_to(ir, (config.channels, ir.shape[-1]))
        if ir.shape[0] != config.channels:
            raise ValueError(f"ir has {ir.shape[0]} channels, config says {config.channels}")
        self._ir = ir
        self.fir = PartitionedFIR(ir, block=config.block, engine=config.engine)

    # -- offline -----------------------------------------------------------

    def apply(self, x: jax.Array) -> jax.Array:
        """Filter (channels, T) streams -> (channels, T): the batched
        offline FDL, reusing the IR bank's frequency-domain partitions
        computed once in __init__."""
        return self.fir.apply_offline(x)

    # -- streaming ----------------------------------------------------------

    def init_state(self) -> dict:
        return self.fir.init_state((self.config.channels,))

    def step(self, state: dict, frame: jax.Array) -> tuple[dict, jax.Array]:
        """One (channels, block) frame in -> one (channels, block) out."""
        return self.fir.step(state, frame)

    # -- multi-device --------------------------------------------------------

    def channel_sharded_apply(self, mesh: Mesh, axis_name: str = CHANNEL_AXIS):
        """Channels sharded over the mesh: zero-communication data parallel.
        Returns a jitted (channels, T) -> (channels, T) function."""
        sharding = NamedSharding(mesh, P(axis_name, None))

        @functools.partial(jax.jit, out_shardings=sharding)
        def run(x):
            x = jax.lax.with_sharding_constraint(x, sharding)
            return self.apply(x)

        return run

    def time_sharded_apply(self, mesh: Mesh, axis_name: str):
        """Time axis sharded over the mesh; halo exchange between neighbours. Returns
        a (T,) -> (T,) function applied per channel via vmap."""

        def run(x):
            f = lambda row, h: sharded_partitioned_fir(
                row, h, mesh, axis_name=axis_name, block=self.config.block
            )
            return jax.vmap(f)(x, self._ir)

        return run
