"""``tempest_tpu_torch.ops.spectrum`` against ``tempest_tpu.ops.spectrum`` on
the same numpy inputs.

Tolerance: both take one float32 FFT of the same samples, but numpy-style
pocketfft (PyTorch on the CPU) and XLA's CPU FFT add in another order, so
bins differ by a few float32 roundings of the LARGEST bin.  Linear power is
compared relative to the peak (1e-5), and dB values where the bin lies within
60 dB of the peak (0.01 dB); far below the peak a bin is rounding noise in
both and its dB value says nothing.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempest_tpu.ops import spectrum as jspec
from tempest_tpu_torch.ops import spectrum as pspec

FS = 2e6
N = 4096


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _signal(kind):
    rng = np.random.default_rng(3)
    t = np.arange(N) / FS
    z = (np.exp(2j * np.pi * 2.3e5 * t) + 0.3 * np.exp(-2j * np.pi * 6.1e5 * t)
         + 0.05 * (rng.standard_normal(N) + 1j * rng.standard_normal(N)))
    if kind == "complex64":
        return z.astype(np.complex64)
    if kind == "float32":
        return z.real.astype(np.float32)
    return np.round(z.real * 2000).astype(np.int16)


def _close_db(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    lin_g, lin_r = 10 ** (got / 10), 10 ** (ref / 10)
    assert np.abs(lin_g - lin_r).max() <= 1e-5 * lin_r.max()
    loud = ref > ref.max() - 60.0
    assert np.abs(got - ref)[loud].max() < 0.01


KINDS = ["complex64", "float32", "int16"]


@pytest.mark.parametrize("kind", KINDS)
def test_get_spectrum_matches_jax(kind):
    sig = _signal(kind)
    f_j, p_j = jspec.get_spectrum(FS, jnp.asarray(sig))
    f_p, p_p = pspec.get_spectrum(FS, sig, device="cpu")
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-6, atol=1e-3)
    _close_db(p_p.numpy(), p_j)


@pytest.mark.parametrize("kind", KINDS)
def test_get_spectrum_without_fs_and_with_n(kind):
    """The fs-less call form gives a normalised axis in [-0.5, 0.5); ``n``
    cuts the signal."""
    sig = _signal(kind)
    f_j, p_j = jspec.get_spectrum(jnp.asarray(sig))
    f_p, p_p = pspec.get_spectrum(torch.from_numpy(sig))   # a tensor stays where it lies
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), atol=1e-7)
    assert f_p[0] == -0.5 and f_p[-1] < 0.5
    _close_db(p_p.numpy(), p_j)
    f_j, p_j = jspec.get_spectrum(FS, jnp.asarray(sig), n=1000)
    f_p, p_p = pspec.get_spectrum(FS, sig, n=1000, device="cpu")
    assert p_p.shape == (1000,)
    _close_db(p_p.numpy(), p_j)


@pytest.mark.parametrize("kind", KINDS)
def test_get_welch_matches_jax(kind):
    sig = _signal(kind)
    f_j, p_j = jspec.get_welch(FS, jnp.asarray(sig), fft_size=500)   # drops a tail
    f_p, p_p = pspec.get_welch(FS, sig, fft_size=500, device="cpu")
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-6, atol=1e-3)
    _close_db(p_p.numpy(), p_j)


def test_welch_accumulate_matches_jax():
    segs = _signal("complex64").reshape(8, 512)
    acc_j = np.asarray(jspec.welch_accumulate(jnp.asarray(segs)))
    acc_p = pspec.welch_accumulate(torch.from_numpy(segs)).numpy()
    assert np.abs(acc_p - acc_j).max() <= 1e-5 * acc_j.max()


@pytest.mark.parametrize("kind", KINDS)
def test_get_waterfall_matches_jax(kind):
    sig = _signal(kind)
    t_j, f_j, p_j = jspec.get_waterfall(FS, jnp.asarray(sig), fft_size=256)
    t_p, f_p, p_p = pspec.get_waterfall(FS, sig, fft_size=256, device="cpu")
    assert p_p.shape == (256, N // 256)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-6)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-6, atol=1e-3)
    p_j = np.asarray(p_j)
    assert np.abs(p_p.numpy() - p_j).max() <= 1e-5 * p_j.max()


def test_host_array_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        pspec.get_welch(FS, _signal("float32"))
