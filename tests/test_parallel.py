"""Multi-chip tests on the 8-device virtual CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8).

These are the distributed tests the reference cannot have (it is
single-core; SURVEY.md section 2 row 10): halo-exchange correctness at
chunk boundaries — the classic off-by-one surface — is checked by exact
equivalence with the single-device filter.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.signal as sig

import chowdsp_fft_tpu as cf
from chowdsp_fft_tpu import parallel, stream
from chowdsp_fft_tpu.models import SDRChain, SDRChainConfig


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return parallel.dsp_mesh(8, axis=parallel.TIME_AXIS)


def lfilter_ref(h, x):
    return sig.lfilter(np.asarray(h, np.float64), [1.0], np.asarray(x, np.float64), axis=-1)


def test_sharded_fir_ols_matches_single_device(mesh8, rng):
    t, taps = 8 * 2048, 127
    x = rng.standard_normal(t).astype(np.float32)
    h = (rng.standard_normal(taps) / 10).astype(np.float32)
    y = np.asarray(parallel.sharded_fir_ols(jnp.asarray(x), jnp.asarray(h), mesh8))
    ref = lfilter_ref(h, x)
    np.testing.assert_allclose(y, ref, atol=5e-4, rtol=0)


def test_sharded_fir_ols_batched_channels(mesh8, rng):
    t, taps, c = 8 * 1024, 65, 3
    x = rng.standard_normal((c, t)).astype(np.float32)
    h = (rng.standard_normal(taps) / 8).astype(np.float32)
    y = np.asarray(parallel.sharded_fir_ols(jnp.asarray(x), jnp.asarray(h), mesh8))
    np.testing.assert_allclose(y, lfilter_ref(h, x), atol=5e-4, rtol=0)


def test_sharded_partitioned_fir_long_filter(mesh8, rng):
    # 64 channels x 10s @ 48kHz analog, scaled down for CPU test speed:
    # long 4096-tap filter across 8 time shards.
    t, taps = 8 * 4096, 4096
    x = rng.standard_normal(t).astype(np.float32)
    h = (rng.standard_normal(taps) / np.sqrt(taps)).astype(np.float32)
    y = np.asarray(
        parallel.sharded_partitioned_fir(jnp.asarray(x), jnp.asarray(h), mesh8, block=1024)
    )
    np.testing.assert_allclose(y, lfilter_ref(h, x), atol=2e-3, rtol=0)


def test_halo_exchange_boundary_exactness(mesh8, rng):
    """The first taps-1 outputs of every shard depend on the neighbor's
    tail; compare those samples specifically."""
    t, taps = 8 * 512, 33
    x = rng.standard_normal(t).astype(np.float32)
    h = (rng.standard_normal(taps) / 4).astype(np.float32)
    y = np.asarray(parallel.sharded_fir_ols(jnp.asarray(x), jnp.asarray(h), mesh8))
    ref = lfilter_ref(h, x)
    for d in range(1, 8):
        lo = d * 512
        seg = slice(lo, lo + taps - 1)
        np.testing.assert_allclose(y[seg], ref[seg], atol=5e-4, rtol=0)


def test_shard_channels_placement(mesh8, rng):
    x = rng.standard_normal((8, 256)).astype(np.float32)
    xs = parallel.shard_channels(jnp.asarray(x), mesh8, axis_name=parallel.TIME_AXIS)
    assert len(xs.sharding.device_set) == 8
    # per-channel FFT still correct under sharding
    spec = np.asarray(cf.rfft(xs))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(spec, ref, atol=2e-7 * 256, rtol=0)


def test_sdr_chain_single_device(rng):
    cfg = SDRChainConfig(channels=16, decimation=2, fm_gain=1.0)
    chain = SDRChain(cfg)
    t = 16 * 2 * 256 * 4
    iq = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    audio = np.asarray(jax.jit(chain.__call__)(jnp.asarray(iq)))
    assert audio.shape[0] == 16
    assert np.all(np.isfinite(audio))


def test_sdr_chain_sharded_matches_single(mesh8, rng):
    cfg = SDRChainConfig(channels=16, decimation=2)
    chain = SDRChain(cfg)
    t = 8 * 16 * 2 * 128
    iq = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    single = np.asarray(jax.jit(chain.__call__)(jnp.asarray(iq)))
    step = chain.sharded_step(mesh8)
    with mesh8:
        sharded = np.asarray(step(jnp.asarray(iq)))
    np.testing.assert_allclose(sharded, single, atol=1e-4, rtol=0)


def test_sdr_chain_recovers_fm_tone(rng):
    """End-to-end validation: an FM-modulated tone placed in channel k is
    demodulated back to its message frequency."""
    cfg = SDRChainConfig(channels=16, decimation=2, audio_decimation=2)
    chain = SDRChain(cfg)
    c, dec, steps = 16, 2, 1024
    t_wide = np.arange(c * steps * dec, dtype=np.float64)
    ch = 5
    # FM carrier centered on channel ch of the post-decimation bank:
    # wideband frequency = ch / (c * dec) cycles/sample.
    msg_f = 0.001  # cycles per wideband sample (well inside audio band)
    dev = 0.1 / (c * dec)  # frequency deviation, cycles per wideband sample
    msg = np.sin(2 * np.pi * msg_f * t_wide)
    phase = 2 * np.pi * (ch / (c * dec)) * t_wide + 2 * np.pi * dev * np.cumsum(msg)
    iq = np.exp(1j * phase).astype(np.complex64)
    # The carrier's energy must land in channel `ch` of the bank...
    bank = np.asarray(
        jax.jit(lambda v: jnp.abs(chain.channelizer(chain.front_end(v))) ** 2)(
            jnp.asarray(iq)
        )
    )
    assert bank.mean(axis=-1).argmax() == ch
    # ...and its demodulated audio must peak at the message frequency.
    audio = np.asarray(jax.jit(chain.__call__)(jnp.asarray(iq)))
    a = audio[ch][32:]  # drop filter transient
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(a.size)))
    # audio sample period = dec * c * audio_decimation wideband samples
    expected_bin = msg_f * dec * c * cfg.audio_decimation * a.size
    assert abs(spec.argmax() - expected_bin) <= 2


def test_halo_exchange_guards():
    """halo=0 is a no-op; halo beyond the shard fails loudly at trace time."""
    import jax.numpy as jnp
    import pytest as _pytest

    mesh = parallel.dsp_mesh(4, axis=parallel.TIME_AXIS)
    x = jnp.arange(4 * 64, dtype=jnp.float32)
    h1 = jnp.ones(1, jnp.float32)  # taps=1 -> halo=0
    y = np.asarray(parallel.sharded_fir_ols(x, h1, mesh))
    assert y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(x), rtol=1e-5, atol=1e-3)
    hbig = jnp.ones(200, jnp.float32) / 200  # halo 199 > shard 64
    with _pytest.raises(ValueError, match="halo"):
        parallel.sharded_fir_ols(x, hbig, mesh)
    # the shared tail-ship helper itself rejects halo == 0 loudly
    # (x[..., -0:] would silently select the WHOLE chunk)
    from chowdsp_fft_tpu.parallel import sharded as _sharded

    with _pytest.raises(ValueError, match="halo"):
        _sharded._ship_tail_left(x, 0, parallel.TIME_AXIS)


def test_halo_overlap_structure(mesh8):
    """The halo ppermute and the main filter compute must share no
    dataflow edge, i.e. everything downstream of the collective is the
    small boundary correction — otherwise XLA can never schedule the
    collective concurrently with the block FFTs. Asserted on the
    shard_map body's jaxpr: every op downstream of ppermute is
    halo-sized, and at least one shard-sized op exists outside the
    downstream set."""
    import jax
    import jax.extend

    taps = 257
    t = 8 * 65536
    halo = taps - 1
    block = 1024
    x = jnp.zeros(t, jnp.float32)
    h = jnp.ones(taps, jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda xv, hv: parallel.sharded_fir_ols(xv, hv, mesh8, block=block)
    )(x, h)

    def find_shard_map(jx):
        for e in jx.eqns:
            if e.primitive.name == "shard_map":
                return e.params["jaxpr"]
            for v in e.params.values():
                inner = getattr(v, "jaxpr", None)
                if inner is not None:
                    r = find_shard_map(inner)
                    if r is not None:
                        return r
        return None

    body = find_shard_map(jaxpr.jaxpr)
    assert body is not None, "no shard_map in the traced program"

    def out_elems(e):
        return max(
            (int(np.prod(v.aval.shape)) for v in e.outvars if hasattr(v.aval, "shape")),
            default=0,
        )

    perm_eqns = [e for e in body.eqns if e.primitive.name == "ppermute"]
    assert len(perm_eqns) == 1
    downstream = {id(v) for v in perm_eqns[0].outvars}
    down_eqns = []
    for e in body.eqns:
        if any(id(v) in downstream for v in e.invars if not isinstance(v, jax.extend.core.Literal)):
            down_eqns.append(e)
            downstream.update(id(v) for v in e.outvars)

    shard_len = t // 8
    # the correction path's arrays are bounded by the OLS framing of a
    # (2*halo)-sample stream: ~block + overlap per frame, independent of
    # the shard length — that's the whole point
    small = 4 * (block + 2 * halo)
    big_down = [e for e in down_eqns if out_elems(e) > small]
    # the final stitched output legitimately depends on the correction;
    # allow only trivially-cheap ops (concat/slice/add family) at full size
    cheap = {"concatenate", "add", "dynamic_update_slice", "pad", "convert_element_type"}
    offenders = [e.primitive.name for e in big_down if e.primitive.name not in cheap]
    assert not offenders, f"shard-sized compute gated by the collective: {offenders}"
    big_outside = [
        e
        for e in body.eqns
        if e not in down_eqns and out_elems(e) >= shard_len
        and e.primitive.name not in cheap
    ]
    assert big_outside, "no shard-sized compute outside the collective's cone"


def test_dsp_mesh_rejects_too_many_devices():
    import pytest as _pytest

    with _pytest.raises(ValueError, match="devices"):
        parallel.dsp_mesh(64)


# ---------------------------------------------------------------------------
# Distributed FFT (one transform across the mesh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_fft_roundtrip_and_differential(n_dev, rng):
    from chowdsp_fft_tpu.parallel import dist_fft

    mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)
    n = 1 << 16
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    re, im = dist_fft.sharded_fft_planes(
        jnp.asarray(z.real), jnp.asarray(z.imag), mesh
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft(z.astype(np.complex128))
    perm = dist_fft.spectrum_order(n, n_dev)
    assert np.abs(got - ref[perm]).max() < 2e-7 * n
    br, bi = dist_fft.sharded_ifft_planes(re, im, mesh)
    back = (np.asarray(br) + 1j * np.asarray(bi)) / n
    assert np.abs(back - z).max() < 2e-7 * n


def test_sharded_fft_smooth_n(rng):
    """Round 3: the distributed FFT accepts any {2,3,5}-smooth N whose
    factors are engine row lengths (was pow2-only; the reference's size
    domain is any {2,3,4,5} product, impl_common.hpp:216-225)."""
    from chowdsp_fft_tpu.parallel import dist_fft

    n_dev = 8
    mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)
    n = 3 * (1 << 15)  # 98304 = 384 * 256
    a, c = dist_fft._dist_split(n, n_dev)
    assert a * c == n and a % n_dev == 0 and c % n_dev == 0
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    re, im = dist_fft.sharded_fft_planes(
        jnp.asarray(z.real), jnp.asarray(z.imag), mesh
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft(z.astype(np.complex128))
    perm = dist_fft.spectrum_order(n, n_dev)
    assert np.abs(got - ref[perm]).max() < 2e-7 * n
    br, bi = dist_fft.sharded_ifft_planes(re, im, mesh)
    back = (np.asarray(br) + 1j * np.asarray(bi)) / n
    assert np.abs(back - z).max() < 2e-7 * n
    # real variant rides the same split
    x = rng.standard_normal((2, n)).astype(np.float32)
    rr, ri = dist_fft.sharded_rfft_planes(jnp.asarray(x), mesh)
    xb = np.asarray(dist_fft.sharded_irfft_planes(rr, ri, mesh, n)) / n
    assert np.abs(xb - x).max() < 2e-7 * n


def test_dist_fft_pipeline_chunks(rng):
    """Round 3: pipeline_chunks splits the batch into independent
    all_to_all -> FFT -> all_to_all chains so XLA can overlap one chunk's
    collective with another's compute. Checks: (a) bit-identical results
    (the chunks run the exact same per-row program), (b) the traced
    program really contains chunk-many independent collective pairs, (c)
    the unbatched case rejects the knob with a clear error."""
    import jax

    from chowdsp_fft_tpu.parallel import dist_fft

    n_dev = 8
    mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)
    n = 1 << 16
    x = rng.standard_normal((4, n)).astype(np.float32)
    r1, i1 = dist_fft.sharded_rfft_planes(jnp.asarray(x), mesh)
    r2, i2 = dist_fft.sharded_rfft_planes(jnp.asarray(x), mesh, pipeline_chunks=2)
    # not bit-identical: the local kernels' batch tile depends on the
    # (chunked) batch size, which changes fp reduction order
    assert np.abs(np.asarray(r1) - np.asarray(r2)).max() < 2e-7 * n
    assert np.abs(np.asarray(i1) - np.asarray(i2)).max() < 2e-7 * n
    back = np.asarray(
        dist_fft.sharded_irfft_planes(r2, i2, mesh, n, pipeline_chunks=2)
    ) / n
    assert np.abs(back - x).max() < 2e-7 * n

    def count_a2a(jx):
        c = 0
        for e in jx.eqns:
            if e.primitive.name == "all_to_all":
                c += 1
            for v in e.params.values():
                # params hold either raw Jaxprs (shard_map) or ClosedJaxprs
                inner = v if hasattr(v, "eqns") else getattr(v, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    c += count_a2a(inner)
        return c

    jx1 = jax.make_jaxpr(
        lambda v: dist_fft.sharded_rfft_planes(v, mesh)
    )(x)
    jx2 = jax.make_jaxpr(
        lambda v: dist_fft.sharded_rfft_planes(v, mesh, pipeline_chunks=2)
    )(x)
    assert count_a2a(jx2.jaxpr) == 2 * count_a2a(jx1.jaxpr)

    with pytest.raises(ValueError, match="leading batch axis"):
        dist_fft.sharded_rfft_planes(
            jnp.asarray(x[0]), mesh, pipeline_chunks=2
        )
    # complex path + convolve ride the same splitter
    z = rng.standard_normal((2, n)).astype(np.float32)
    zi = rng.standard_normal((2, n)).astype(np.float32)
    cr1, ci1 = dist_fft.sharded_fft_planes(jnp.asarray(z), jnp.asarray(zi), mesh)
    cr2, ci2 = dist_fft.sharded_fft_planes(
        jnp.asarray(z), jnp.asarray(zi), mesh, pipeline_chunks=2
    )
    assert np.abs(np.asarray(cr1) - np.asarray(cr2)).max() < 2e-7 * n
    assert np.abs(np.asarray(ci1) - np.asarray(ci2)).max() < 2e-7 * n


def test_dist_fft_transform_chunks(rng):
    """Round 3: transform_chunks slabs the SECOND all_to_all inside one
    distributed transform (works unbatched, unlike pipeline_chunks), so
    slab g+1's collective can overlap slab g's level-2 FFT rows. The row
    relabeling is exposed via spectrum_order/rspectrum_order and inverted
    exactly by the matching inverse. Differential vs numpy, round trips,
    jaxpr slab count, and the divisibility guard."""
    import jax

    from chowdsp_fft_tpu.parallel import dist_fft

    n_dev, g = 8, 2
    mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)
    n = 1 << 16
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    re, im = dist_fft.sharded_fft_planes(
        jnp.asarray(z.real), jnp.asarray(z.imag), mesh, transform_chunks=g
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft(z.astype(np.complex128))
    perm = dist_fft.spectrum_order(n, n_dev, transform_chunks=g)
    assert np.abs(got - ref[perm]).max() < 2e-7 * n
    # the chunked order really differs from the unchunked one
    assert not np.array_equal(perm, dist_fft.spectrum_order(n, n_dev))
    br, bi = dist_fft.sharded_ifft_planes(re, im, mesh, transform_chunks=g)
    back = (np.asarray(br) + 1j * np.asarray(bi)) / n
    assert np.abs(back - z).max() < 2e-7 * n

    # real path: differential via rspectrum_order + round trip
    x = rng.standard_normal((2, n)).astype(np.float32)
    rr, ri = dist_fft.sharded_rfft_planes(jnp.asarray(x), mesh, transform_chunks=g)
    gotr = np.asarray(rr) + 1j * np.asarray(ri)
    full = np.fft.fft(x.astype(np.float64), axis=-1)
    rperm = dist_fft.rspectrum_order(n, n_dev, transform_chunks=g)
    valid = rperm >= 0
    exp = np.zeros_like(gotr, dtype=np.complex128)
    exp[:, valid] = full[:, rperm[valid]]
    assert np.abs(gotr - exp).max() < 2e-7 * n
    xb = np.asarray(
        dist_fft.sharded_irfft_planes(rr, ri, mesh, n, transform_chunks=g)
    ) / n
    assert np.abs(xb - x).max() < 2e-7 * n

    # the traced forward contains 1 (first) + g (chunked second) a2a
    def count_a2a(jx):
        c = 0
        for e in jx.eqns:
            if e.primitive.name == "all_to_all":
                c += 1
            for v in e.params.values():
                # params hold either raw Jaxprs (shard_map) or ClosedJaxprs
                inner = v if hasattr(v, "eqns") else getattr(v, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    c += count_a2a(inner)
        return c

    jx = jax.make_jaxpr(
        lambda r, i: dist_fft.sharded_fft_planes(r, i, mesh, transform_chunks=g)
    )(z.real, z.imag)
    # two planes: (1 + g) per plane
    assert count_a2a(jx.jaxpr) == 2 * (1 + g)

    with pytest.raises(ValueError, match="must divide"):
        dist_fft.sharded_fft_planes(
            jnp.asarray(z.real), jnp.asarray(z.imag), mesh, transform_chunks=3
        )


def test_dist_split_real_requires_even_a(rng):
    """Round-3 review fix: the smooth-N widening could hand the REAL path
    an odd level-1 factor (N=155520 over 3 devices balances to A=405),
    whose packed local rfft (half_a planes, DC/Nyquist rows) silently
    corrupts the spectrum. The real entry points now split with
    real=True, which skips odd-A candidates."""
    from chowdsp_fft_tpu.parallel import dist_fft

    n, n_dev = 155520, 3  # 2^7 * 3^5 * 5
    assert dist_fft._dist_split(n, n_dev)[0] % 2 == 1  # the odd-A trap exists
    a, c = dist_fft._dist_split(n, n_dev, real=True)
    assert a % 2 == 0 and a * c == n and a % n_dev == 0 and c % n_dev == 0
    mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = dist_fft.sharded_rfft_planes(jnp.asarray(x), mesh)
    got = np.asarray(re) + 1j * np.asarray(im)
    full = np.fft.fft(x.astype(np.float64), axis=-1)
    perm = dist_fft.rspectrum_order(n, n_dev)
    valid = perm >= 0
    exp = np.zeros_like(got, dtype=np.complex128)
    exp[:, valid] = full[:, perm[valid]]
    assert np.abs(got - exp).max() < 2e-7 * n
    back = np.asarray(dist_fft.sharded_irfft_planes(re, im, mesh, n)) / n
    assert np.abs(back - x).max() < 2e-7 * n


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_rfft_differential_and_roundtrip(n_dev, rng):
    """Distributed REAL forward (round 2): batched, packed-row layout,
    differential vs numpy via rspectrum_order, unscaled round trip."""
    from chowdsp_fft_tpu.parallel import dist_fft

    mesh = parallel.dsp_mesh(n_dev, axis=parallel.TIME_AXIS)
    n = 1 << 16
    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = dist_fft.sharded_rfft_planes(jnp.asarray(x), mesh)
    got = np.asarray(re) + 1j * np.asarray(im)
    full = np.fft.fft(x.astype(np.float64), axis=-1)
    perm = dist_fft.rspectrum_order(n, n_dev)
    valid = perm >= 0
    exp = np.zeros_like(got, dtype=np.complex128)
    exp[:, valid] = full[:, perm[valid]]
    assert np.abs(got - exp).max() < 2e-7 * n
    assert np.abs(got[:, ~valid]).max() == 0.0  # padding rows stay zero
    back = np.asarray(dist_fft.sharded_irfft_planes(re, im, mesh, n)) / n
    assert np.abs(back - x).max() < 2e-7 * n


def test_sharded_rfft_convolve_matches_numpy(rng):
    """Distributed real-stream convolution — the multi-chip, batched
    rendition of the reference's real convolve pipeline
    (/root/reference/chowdsp_fft.h:147-154, test.cpp:131-232)."""
    from chowdsp_fft_tpu.parallel import dist_fft

    mesh = parallel.dsp_mesh(8, axis=parallel.TIME_AXIS)
    n = 1 << 16
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal((2, n)).astype(np.float32)
    y = np.asarray(dist_fft.sharded_rfft_convolve(jnp.asarray(x), jnp.asarray(h), mesh))
    ref = np.fft.irfft(
        np.fft.rfft(x.astype(np.float64), axis=-1)
        * np.fft.rfft(h.astype(np.float64), axis=-1),
        axis=-1,
    )
    # conv outputs scale ~sqrt(N)*|x|*|h|; bound relative to the reference
    # magnitude (a fixed absolute 1e-3 left <1.3x margin and flaked with
    # rng draw order)
    assert np.abs(y - ref).max() < 4e-6 * np.abs(ref).max()


def test_sharded_fft_batched_matches_single(rng):
    """The complex distributed path accepts leading batch axes (round 2)."""
    from chowdsp_fft_tpu.parallel import dist_fft

    mesh = parallel.dsp_mesh(4, axis=parallel.TIME_AXIS)
    n = 1 << 16
    z = (rng.standard_normal((2, 3, n)) + 1j * rng.standard_normal((2, 3, n))).astype(
        np.complex64
    )
    re, im = dist_fft.sharded_fft_planes(jnp.asarray(z.real), jnp.asarray(z.imag), mesh)
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft(z.astype(np.complex128), axis=-1)
    perm = dist_fft.spectrum_order(n, 4)
    assert np.abs(got - ref[..., perm]).max() < 2e-7 * n
    br, bi = dist_fft.sharded_ifft_planes(re, im, mesh)
    back = (np.asarray(br) + 1j * np.asarray(bi)) / n
    assert np.abs(back - z).max() < 2e-7 * n


def test_multihost_mesh_device_injection():
    """multihost_mesh lays hosts out as mesh rows (time axis within a
    host, host axis across hosts) — validated by device-list injection since
    real multi-host cannot run here (SURVEY.md section 7 item 5)."""

    class FakeDev:
        def __init__(self, pid, i):
            self.process_index = pid
            self.id = i

        def __repr__(self):
            return f"d{self.process_index}:{self.id}"

    devs = [FakeDev(h, h * 4 + i) for h in range(2) for i in range(4)]
    mesh = parallel.multihost_mesh(devices=devs)
    assert mesh.axis_names == (parallel.HOST_AXIS, parallel.TIME_AXIS)
    assert mesh.devices.shape == (2, 4)
    # each row is one host
    for r in range(2):
        assert all(d.process_index == r for d in mesh.devices[r])
    # interleaved device list still groups by host
    shuffled = devs[::2] + devs[1::2]
    mesh2 = parallel.multihost_mesh(devices=shuffled)
    for r in range(2):
        assert len({d.process_index for d in mesh2.devices[r]}) == 1
    # uneven hosts fail loudly
    with pytest.raises(ValueError, match="uneven"):
        parallel.multihost_mesh(devices=devs[:7])


def test_init_multihost_single_process_noop():
    """Single-process (or unspecified) init after backend init is a
    harmless no-op; a true multi-process misconfiguration — distributed
    init after JAX use — must fail loudly."""
    jnp.zeros(1).block_until_ready()  # force backend init first
    parallel.init_multihost()  # backends are up in the test process: no-op
    parallel.init_multihost(num_processes=1, process_id=0)  # ditto
    with pytest.raises(RuntimeError, match="before any JAX"):
        parallel.init_multihost(
            coordinator_address="localhost:12355", num_processes=2, process_id=0
        )


def test_dist_split_invalid_n_raises_cleanly():
    """Regression (ADVICE r1): unsupported N must raise the documented
    ValueError up front, not fail deep inside kernel table construction.
    (Round 3 widened the domain to {2,3,5}-smooth N — the invalid cases
    here are a non-smooth N, a smooth N whose factors cannot both be
    device-divisible, and an N too small for two device-divisible
    factors.)"""
    from chowdsp_fft_tpu.parallel import dist_fft

    for bad_n in (7 * (1 << 16), 100000, 1 << 5):
        with pytest.raises(ValueError, match="smooth"):
            dist_fft._dist_split(bad_n, 8)


def test_sharded_fft_convolve_matches_numpy(rng):
    from chowdsp_fft_tpu.parallel import dist_fft

    mesh = parallel.dsp_mesh(8, axis=parallel.TIME_AXIS)
    n = 1 << 16
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    h = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    yr, yi = dist_fft.sharded_fft_convolve(
        jnp.asarray(x.real), jnp.asarray(x.imag),
        jnp.asarray(h.real), jnp.asarray(h.imag), mesh,
    )
    got = np.asarray(yr) + 1j * np.asarray(yi)
    ref = np.fft.ifft(np.fft.fft(x.astype(np.complex128)) * np.fft.fft(h.astype(np.complex128)))
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
