"""Parity of the port's AM demod with the JAX package's, on the CPU.

Tolerance 1e-6 relative: both compute sqrt(I² + Q²) in float32; the JAX
version sums the pair with a one-hot matmul that adds exact zeros, and
``|z|`` of complex input may differ by an ulp between the two libraries."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempest_tpu.ops.demod import am_demod as jax_am_demod
from tempest_tpu.ops.demod import am_envelope_from_iq as jax_am_envelope
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
