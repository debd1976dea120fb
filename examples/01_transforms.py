"""Basics: plans, transforms, packed fast path, unscaled semantics.

Run anywhere (CPU or GPU): python examples/01_transforms.py
"""

import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

import chowdsp_fft_tpu as cf

n, batch = 4096, 8
rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)

# Canonical interface (numpy-style bins, unscaled like the C library:
# backward(forward(x)) == N * x).
spec = jax.jit(cf.rfft)(x)  # (batch, n//2+1) complex64
back = jax.jit(cf.irfft)(spec) / n
print("roundtrip max err:", float(jnp.abs(back - x).max()))

# The packed interface: SoA planes (pffft's packed real layout,
# plane-separated), the format the convolution paths use.
re, im = jax.jit(cf.rfft_packed)(x)  # ((batch, n//2) f32) x 2
print("DC:", float(re[0, 0]), " Nyquist (packed in im[:,0]):", float(im[0, 0]))

# Which engine is auto-dispatch using?
print("engines:", cf.available_engines(), "| N=4096 real ->", cf.engine_for(n, cf.FFT_REAL))

# Plans are pytrees; persist/restore them like any other array data.
from chowdsp_fft_tpu import plans

p = cf.make_plan(n, cf.FFT_REAL)
with tempfile.TemporaryDirectory() as d:
    plans.save_plan(p, f"{d}/plan4096.npz")
    q = plans.load_plan(f"{d}/plan4096.npz")
print("plan saved and restored; radices:", q.radices)
