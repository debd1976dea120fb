"""The flagship SDR chain + multi-device sharding (virtual mesh friendly).

Run with a virtual mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/03_sdr_and_multichip.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import jax

# This demo runs on the CPU's virtual mesh; on a machine with several
# GPU cards, drop this line and the mesh spans the cards.
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from chowdsp_fft_tpu import parallel
from chowdsp_fft_tpu.models import SDRChain, SDRChainConfig
from chowdsp_fft_tpu.parallel import dist_fft

rng = np.random.default_rng(2)

# --- wideband receiver: decimate -> channelize -> FM demod --------------
chain = SDRChain(SDRChainConfig(channels=64, decimation=2))
t = 64 * 2 * 1024
iq = jnp.asarray(rng.standard_normal(t) + 1j * rng.standard_normal(t), jnp.complex64)
audio = jax.jit(chain.__call__)(iq)
print("SDR audio:", audio.shape)

n_dev = len(jax.devices())
mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)

# --- sharded streaming convolution (ppermute halo between cards) --------
x = jnp.asarray(rng.standard_normal(n_dev * 16384), jnp.float32)
taps = jnp.asarray(rng.standard_normal(2048) / 64, jnp.float32)
y = parallel.sharded_partitioned_fir(x, taps, mesh, block=1024)
print("sharded FIR:", y.shape)

# --- one giant FFT distributed across the mesh (all_to_all transposes) --
n = 1 << 16
sig = rng.standard_normal(n).astype(np.float32)
re, im = dist_fft.sharded_fft_planes(jnp.asarray(sig), jnp.zeros(n, jnp.float32), mesh)
br, bi = dist_fft.sharded_ifft_planes(re, im, mesh)
print("distributed FFT roundtrip err:",
      float(jnp.abs(br / n - sig).max()))
