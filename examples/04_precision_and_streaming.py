"""Engine choice and accuracy, and the streaming latency knob.

Run anywhere: python examples/04_precision_and_streaming.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

import chowdsp_fft_tpu as cf
from chowdsp_fft_tpu.stream import PartitionedFIR, partitioned_fir_apply

rng = np.random.default_rng(7)

# --- engines: both stay inside the reference's 2e-7*N error bound ----------
# (the use_avx-flag analog: an explicit engine= picks the implementation;
# "auto" takes the xla engine, cuFFT on a GPU).
n = 4096
x = jnp.asarray(rng.standard_normal((64, n)), jnp.float32)
ref = np.fft.rfft(np.asarray(x, np.float64), axis=-1)
for engine in cf.available_engines():
    re, _ = cf.rfft_packed(x, engine=engine)
    err = np.abs(np.asarray(re)[:, 1:] - ref[:, 1 : n // 2].real).max()
    print(f"engine {engine:9}: max err {err:.2e} (reference bound {2e-7 * n:.1e})")

# --- streaming FDL: latency vs throughput with step_k ---------------------
# step(K=1) is one set of kernel launches per block (lowest latency);
# step_k(K) amortizes the launches over K blocks; apply_offline processes
# the whole stream scan-free.
taps, block = 48000, 1024  # a 1-second reverb IR @ 48kHz
h = (rng.standard_normal(taps) * np.exp(-np.linspace(0, 8, taps))).astype(np.float32) / 100
fir = PartitionedFIR(jnp.asarray(h), block=block)

stream_x = rng.standard_normal(16 * block).astype(np.float32)

# real-time loop, 8-block latency budget:
state = fir.init_state()
chunks = stream_x.reshape(-1, 8, block)
outs = []
for c in chunks:
    state, y = fir.step_k(state, jnp.asarray(c))
    outs.append(np.asarray(y).reshape(-1))
y_stream = np.concatenate(outs)

# same math, offline:
y_offline = np.asarray(partitioned_fir_apply(jnp.asarray(stream_x), jnp.asarray(h), block=block))
print(f"streaming(K=8) vs offline max diff: {np.abs(y_stream - y_offline).max():.2e}")

# streaming scan with a chunk knob (jit-friendly single call):
y_chunked = np.asarray(
    partitioned_fir_apply(jnp.asarray(stream_x), jnp.asarray(h), block=block,
                          streaming=True, chunk=8)
)
print(f"chunked-scan vs offline max diff:   {np.abs(y_chunked - y_offline).max():.2e}")
