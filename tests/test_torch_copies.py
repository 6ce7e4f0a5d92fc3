"""The port's jax-free host modules are byte copies of the JAX package's, and
importing the port pulls in no jax."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

COPIES = [
    "video/modes.py",
    "io/dat.py",
    "io/synthetic.py",
    "render/screen.py",
    "utils/checkpoint.py",
    "runtime/ring.py",
    "runtime/sources.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    original = (ROOT / "tempest_tpu" / rel).read_bytes()
    copy = (ROOT / "tempest_tpu_torch" / rel).read_bytes()
    assert copy == original, f"tempest_tpu_torch/{rel} differs from tempest_tpu/{rel}"


def test_port_imports_no_jax():
    code = ("import sys, tempest_tpu_torch, tempest_tpu_torch.runtime.stream; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('tempest_tpu.') or m == 'tempest_tpu'); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax():
    """No module of the port imports jax, even lazily inside a function."""
    for path in (ROOT / "tempest_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert not words[1].startswith(("jax", "tempest_tpu.", "..tempest_tpu")), \
                    f"{path}: {line.strip()}"
                assert words[1] != "tempest_tpu", f"{path}: {line.strip()}"
