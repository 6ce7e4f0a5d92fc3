"""Parity of the port's MTF restoration (``tempest_tpu_torch.ops.enhance``)
with the JAX package's, on the CPU.

The gains are host numpy in float64 in both packages, built from each
package's own ``_interp_weights``: equal to 1e-6.  The filtering is two
float32 FFT pairs, held to 1e-5 of the image's range between the two FFT
libraries."""

import types

import numpy as np
import pytest
import torch

import tempest_tpu.ops.enhance as jen
from tempest_tpu_torch.io.synthetic import render_frame
from tempest_tpu_torch.ops import enhance as pen
from tempest_tpu_torch.ops.resample import downgrade_image
from tempest_tpu_torch.pipeline.offline import ReconstructionConfig
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_interp_kernel_ft_matches_jax(interp):
    u = np.linspace(0.0, 1.5, 64)
    ref = jen.interp_kernel_ft(interp, u)
    got = pen.interp_kernel_ft(interp, u)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if interp == "linear":
        np.testing.assert_allclose(got, np.sinc(u) ** 2, atol=2e-4)


@pytest.mark.parametrize("kernels", [(), ((2.7, "linear"),), ((1.3, "cubic"), (1.0, "linear"))],
                         ids=["identity", "linear", "cubic_and_linear"])
def test_wiener_gain_matches_jax(kernels):
    ref = jen.wiener_gain(64, kernels, 0.002)
    got = pen.wiener_gain(64, kernels, 0.002)
    assert got.dtype == np.float32 and got.shape == (33,)
    np.testing.assert_allclose(got, ref, atol=1e-6)


RESTORE_CASES = {
    "linear_subpixel": dict(interp_taps=2, do_align=True, align_subpixel=True),
    "cubic_subpixel_cubic": dict(interp_taps=4, do_align=True, align_subpixel=True,
                                 align_interp="cubic"),
    "no_registration": dict(interp_taps=2, do_align=False),
    "integer_sync": dict(interp_taps=4, do_align=True, align_subpixel=False),
}


@pytest.mark.parametrize("case", list(RESTORE_CASES))
@pytest.mark.parametrize("shape", [(48, 99), (60, 80)], ids=["48x99", "60x80"])
def test_restore_image_matches_jax(case, shape):
    """A blurred, noisy screen restored by both packages under the same
    config: 1e-5 of the image's range, and clipped to the input's range.
    The config is duck-typed by both, so one object serves the two."""
    cfg = ReconstructionConfig(sample_rate=4e6, mode=MODE, n_frames=1, render_size=shape,
                               **RESTORE_CASES[case])
    rng = np.random.default_rng(5)
    img = downgrade_image(torch.from_numpy(render_frame(MODE)), shape).numpy()
    img = (img + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    ref = jen.restore_image(img, cfg, nsr=0.002)
    got = pen.restore_image(img, cfg, nsr=0.002, device="cpu")
    assert got.shape == shape and got.dtype == np.float32
    span = float(img.max() - img.min())
    assert np.abs(got - ref).max() < 1e-5 * span
    assert got.min() >= img.min() and got.max() <= img.max()
    assert np.abs(got - img).max() > 1e-3 * span   # it did sharpen
    # A tensor is restored where it lies, with no device named.
    same = pen.restore_image(torch.from_numpy(img), cfg, nsr=0.002)
    np.testing.assert_array_equal(same, got)


def test_restore_image_reads_only_the_documented_fields():
    cfg = types.SimpleNamespace(sample_rate=4e6, mode=MODE, interp_taps=2, do_align=False,
                                align_subpixel=False, align_interp="linear")
    img = np.random.default_rng(1).random((16, 32), dtype=np.float32)
    got = pen.restore_image(img, cfg, device="cpu")
    np.testing.assert_allclose(got, jen.restore_image(img, cfg), atol=1e-5)
