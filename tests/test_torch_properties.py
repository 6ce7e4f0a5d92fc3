"""Property-based tests (Hypothesis) of the port: the two invariants of
``tests/test_properties.py`` that hold a ported function (``:47``,
``linear_resample``; ``:66``, ``autocorrelation``), on
``tempest_tpu_torch.ops.resample.linear_resample`` and
``tempest_tpu_torch.ops.autocorr.autocorrelation``, with the same settings
and inputs: the same tolerance (1e-5) and the same seeds from numpy."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tempest_tpu_torch.ops.autocorr import autocorrelation
from tempest_tpu_torch.ops.resample import linear_resample


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@settings(max_examples=20, deadline=None)
@given(
    n_in=st.integers(min_value=16, max_value=5000),
    n_out=st.integers(min_value=2, max_value=4000),
)
def test_linear_resample_bounds_and_shape(n_in, n_out):
    """Linear interpolation never extrapolates beyond the input range."""
    rng = np.random.default_rng(n_in * 7919 + n_out)
    x = rng.standard_normal(n_in).astype(np.float32)
    y = linear_resample(torch.from_numpy(x), n_out).numpy()
    assert y.shape == (n_out,)
    assert y.min() >= x.min() - 1e-5
    assert y.max() <= x.max() + 1e-5


@settings(max_examples=15, deadline=None)
@given(
    n=st.integers(min_value=64, max_value=4096),
    max_delay_frac=st.floats(min_value=0.05, max_value=2.0),
)
def test_autocorrelation_shapes_consistent(n, max_delay_frac):
    """gamma and lags always have equal length, even for short signals."""
    fs = 1e4
    max_delay = max_delay_frac * n / fs
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    gamma, lags = autocorrelation(torch.from_numpy(x), fs, 0.0, max_delay)
    assert gamma.shape == lags.shape
    assert gamma.shape[0] >= 1
