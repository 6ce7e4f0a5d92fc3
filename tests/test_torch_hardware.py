"""The port's runtime over a ``HardwareSource`` with a fake ``SoapySDR``
module: the two tests of ``tests/test_hardware.py`` that run the JAX
runtime over that source (retuning, and the radio's counters in
``health()``), on the port's ``StreamingRuntime`` on the CPU.

``runtime/sources.py`` is a byte copy of the JAX package's module
(``tests/test_torch_copies.py``), so the fake module is the one
``tests/test_hardware.py`` defines, imported from there: the same calls
recorded, the same scripted reads."""

import sys

import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.runtime.sources import HardwareSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_soapy():
    """``tests/test_hardware.py``'s fake ``SoapySDR`` factory (pytest puts
    ``tests/`` on the import path; that module imports the JAX package)."""
    from test_hardware import _fake_soapy

    return _fake_soapy


def test_runtime_retune_through_hardware_source(monkeypatch, fake_soapy):
    """``tests/test_hardware.py::test_runtime_retune_through_hardware_source``
    on the port: ``set_carrier``/``set_gain`` reach the live source while the
    runtime streams its blocks through the chain."""
    record = []
    monkeypatch.setitem(sys.modules, "SoapySDR", fake_soapy(record))
    src = HardwareSource("bladerf", 764e6, FS, 40.0, block_size=int(FS * 0.1))
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu")
    rt.start()
    try:
        rt.process_blocks(1)
        rt.set_carrier(600e6)
        rt.set_gain(10.0)
    finally:
        rt.stop()
    assert ("freq", 600e6) in record
    assert ("gain", 10.0) in record
    assert rt.frames_out > 0


def test_runtime_health_surfaces_source_counters(monkeypatch, fake_soapy):
    """``tests/test_hardware.py::test_runtime_health_surfaces_source_counters``
    on the port: the radio's overflows and timeouts before the first full
    block show in ``health()``."""
    record = []
    storm = [-4, -1, -4]  # before the first full block
    monkeypatch.setitem(sys.modules, "SoapySDR", fake_soapy(record, storm))
    src = HardwareSource("uhd", 764e6, FS, 40.0, block_size=int(FS * 0.1))
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu")
    rt.start()
    try:
        rt.process_blocks(1)
        h = rt.health()
    finally:
        rt.stop()
    assert h["source_overflows"] == 2
    assert h["source_timeouts"] == 1
