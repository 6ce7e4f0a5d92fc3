"""Parity of the port's demod functions with the JAX package's, on the CPU.

Tolerance 1e-6 relative for AM: both compute sqrt(I² + Q²) in float32; the
JAX version sums the pair with a one-hot matmul that adds exact zeros, and
``|z|`` of complex input may differ by an ulp between the two libraries.
The FM discriminator is held to 2e-6 rad absolute: the two libraries'
``atan2`` differ in the last bits, and XLA may contract the cross and dot
products into fused multiply-adds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempest_tpu.ops.demod as jdemod
from tempest_tpu.ops.demod import am_demod as jax_am_demod
from tempest_tpu.ops.demod import am_envelope_from_iq as jax_am_envelope
from tempest_tpu_torch.ops import demod as pdemod
from tempest_tpu_torch.ops.demod import am_demod, am_envelope_from_iq, invert_envelope
from tempest_tpu_torch.pipeline.offline import ReconstructionConfig, demodulate
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _words(dtype, n_words, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int16:
        return rng.integers(-32768, 32767, n_words, dtype=np.int16)
    return (rng.standard_normal(n_words) * 3.0).astype(np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("n_words", [4096, 1001 * 2 + 1])
def test_am_envelope_from_iq_matches_jax(dtype, n_words):
    words = _words(dtype, n_words, seed=n_words)
    ref = np.asarray(jax_am_envelope(jnp.asarray(words)))
    got = am_envelope_from_iq(torch.from_numpy(words)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert _rel(got, ref) < REL


def test_am_demod_complex_matches_jax():
    rng = np.random.default_rng(7)
    z = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64)
    ref = np.asarray(jax_am_demod(jnp.asarray(z)))
    got = am_demod(torch.from_numpy(z)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) < REL


def test_invert_option_matches_jax_formula():
    words = _words(np.int16, 2048, seed=3)
    env = np.asarray(jax_am_envelope(jnp.asarray(words)))
    ref = np.asarray(1.0 - env / jnp.max(env))
    cfg = ReconstructionConfig(sample_rate=2e6, mode=ALL_VIDEO_MODES["640x480 @ 60Hz"],
                               n_frames=1, invert=True, input_format="iq_interleaved")
    got = demodulate(torch.from_numpy(words), cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL)
    np.testing.assert_allclose(
        invert_envelope(torch.from_numpy(env)).numpy(), ref, rtol=0, atol=REL)


# ------------------------------------------------ power, planar, FM
FM_ATOL = 2e-6


def _complex(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
@pytest.mark.parametrize("n_words", [4096, 1001 * 2 + 1])
def test_am_power_from_iq_matches_jax(dtype, n_words):
    """I² + Q² with no square root; an odd trailing word is dropped.  int16
    words square exactly in float32 only below 2¹²; the sum rounds once in
    both, so 1e-6 relative."""
    words = _words(dtype, n_words, seed=n_words + 1)
    ref = np.asarray(jdemod.am_power_from_iq(jnp.asarray(words)))
    got = pdemod.am_power_from_iq(torch.from_numpy(words)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (n_words // 2,)
    assert _rel(got, ref) < REL


def test_am_demod_power_matches_jax():
    z = _complex(5000, seed=8)
    ref = np.asarray(jdemod.am_demod_power(jnp.asarray(z)))
    got = pdemod.am_demod_power(torch.from_numpy(z)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_planar_demods_match_jax(dtype):
    """``to_planar_iq`` equals the JAX package's host de-interleave, and the
    planar AM and FM demods equal their JAX counterparts and the port's
    interleaved ones."""
    words = _words(dtype, 6000, seed=4)
    planar = pdemod.to_planar_iq(words)
    np.testing.assert_array_equal(planar, jdemod.to_planar_iq(words))
    assert planar.shape == (2, 3000) and planar.flags.c_contiguous
    z = _complex(100, seed=2)
    np.testing.assert_array_equal(pdemod.to_planar_iq(z), jdemod.to_planar_iq(z))

    t = torch.from_numpy(planar)
    am = pdemod.am_envelope_from_iq_planar(t).numpy()
    assert _rel(am, np.asarray(jdemod.am_envelope_from_iq_planar(jnp.asarray(planar)))) < REL
    np.testing.assert_array_equal(am, am_envelope_from_iq(torch.from_numpy(words)).numpy())
    scaled = pdemod.am_envelope_from_iq_planar(t, scale=0.5).numpy()
    np.testing.assert_allclose(scaled, 0.5 * am, rtol=1e-7)

    fm = pdemod.fm_demod_from_iq_planar(t).numpy()
    ref = np.asarray(jdemod.fm_demod_from_iq_planar(jnp.asarray(planar)))
    assert fm.dtype == np.float32 and fm[0] == 0.0
    assert np.abs(fm - ref).max() < FM_ATOL
    np.testing.assert_array_equal(fm, pdemod.fm_demod_from_iq(torch.from_numpy(words)).numpy())


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
@pytest.mark.parametrize("n_words", [4096, 1001 * 2 + 1])
def test_fm_demod_from_iq_matches_jax(dtype, n_words):
    words = _words(dtype, n_words, seed=n_words + 2)
    ref = np.asarray(jdemod.fm_demod_from_iq(jnp.asarray(words)))
    got = pdemod.fm_demod_from_iq(torch.from_numpy(words)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (n_words // 2,)
    assert got[0] == 0.0
    assert np.abs(got - ref).max() < FM_ATOL


def test_fm_demod_complex_and_rows_match_jax():
    """``fm_demod`` on complex samples and ``fm_demod_rows`` on a bank of
    channels: element 0 of every row is 0."""
    z = _complex(5000, seed=9)
    ref = np.asarray(jdemod.fm_demod(jnp.asarray(z)))
    got = pdemod.fm_demod(torch.from_numpy(z)).numpy()
    assert got.dtype == np.float32 and got[0] == 0.0
    assert np.abs(got - ref).max() < FM_ATOL
    rows = _complex(3 * 700, seed=10).reshape(3, 700)
    ref = np.asarray(jdemod.fm_demod_rows(jnp.asarray(rows)))
    got = pdemod.fm_demod_rows(torch.from_numpy(rows)).numpy()
    assert got.shape == (3, 700) and got.dtype == np.float32 and (got[:, 0] == 0.0).all()
    assert np.abs(got - ref).max() < FM_ATOL
    # A row alone takes another vector path of the CPU's atan2: last bits.
    one = pdemod.fm_demod(torch.from_numpy(rows[1])).numpy()
    assert np.abs(got[1] - one).max() < FM_ATOL


@pytest.mark.parametrize("fmt", ["complex64", "iq_interleaved", "iq_planar"])
@pytest.mark.parametrize("demod", ["am", "fm"])
def test_demodulate_formats_match_jax(fmt, demod):
    """The step's demodulation stage, for every input format and both
    demodulators, against the JAX package's ``demodulate``."""
    import tempest_tpu.pipeline.offline as joff

    z = _complex(4000, seed=12)
    data = {"complex64": z, "iq_interleaved": z.view(np.float32),
            "iq_planar": pdemod.to_planar_iq(z)}[fmt]
    kw = dict(sample_rate=2e6, mode=ALL_VIDEO_MODES["640x480 @ 60Hz"], n_frames=1,
              input_format=fmt, demod=demod)
    ref = np.asarray(joff.demodulate(jnp.asarray(data), joff.ReconstructionConfig(**kw)))
    got = demodulate(torch.from_numpy(data), ReconstructionConfig(**kw)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (4000,)
    if demod == "fm":
        assert np.abs(got - ref).max() < FM_ATOL
    else:
        assert _rel(got, ref) < REL
