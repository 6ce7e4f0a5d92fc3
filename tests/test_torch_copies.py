"""The port's jax-free host modules are byte copies of the JAX package's, and
importing the port pulls in no jax."""

import ast
import difflib
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
    "render/plots.py",
    "native/host_core.cpp",
    "native/ring_stress.cpp",
    "utils/checkpoint.py",
    "runtime/ring.py",
    "runtime/sources.py",
]


# Copies whose named functions the port rewrote to record its spans
# (``utils.profiling``), with the import that takes them: the rest of the
# file is the original's, line for line.  The port's ring keeps the
# original's semantics (``tests/test_torch_tracing.py`` runs the JAX
# package's ring cases on it).
TRACED = {
    "runtime/ring.py": ({"put", "take", "_wait_ready"},
                        "from ..utils.profiling import annotate"),
}


def _outside(text: str, names: set, extra: str) -> list[str]:
    """The non-blank lines of ``text`` outside the functions ``names``,
    without the line ``extra``."""
    inside = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            inside.update(range(node.lineno - 1, node.end_lineno))
    return [l for i, l in enumerate(text.splitlines())
            if i not in inside and l.strip() and l != extra]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    original = (ROOT / "tempest_tpu" / rel).read_bytes()
    copy = (ROOT / "tempest_tpu_torch" / rel).read_bytes()
    if rel in TRACED:
        names, extra = TRACED[rel]
        assert (_outside(copy.decode(), names, extra)
                == _outside(original.decode(), names, extra)), rel
        return
    assert copy == original, f"tempest_tpu_torch/{rel} differs from tempest_tpu/{rel}"


def test_native_loader_differs_only_in_where_it_builds():
    """``native/__init__.py`` is the original but for two things: the
    library is built under the package's git-ignored ``_build/`` instead of
    beside the sources (the path, the directory's creation, and the three
    docstring lines that name the place and the package), and the ring's
    take is the program's span ``ring.take``."""
    original = (ROOT / "tempest_tpu/native/__init__.py").read_text().splitlines()
    copy = (ROOT / "tempest_tpu_torch/native/__init__.py").read_text().splitlines()
    diff = [l for l in difflib.unified_diff(original, copy, lineterm="", n=0)
            if l[:1] in "+-" and l[:3] not in ("+++", "---")]
    assert diff == [
        "-hundred ms, cached next to the source) and exposes it through ctypes.  If no",
        "+hundred ms, cached under the package's git-ignored ``_build/``) and exposes it",
        "+through ctypes.  If no",
        "-implementations (``tempest_tpu.runtime.ring``) — same semantics, GIL held.",
        "+implementations (``tempest_tpu_torch.runtime.ring``) — same semantics, GIL held.",
        "+from ..utils.profiling import annotate",
        "+",
        '-_LIB = os.path.join(_HERE, "libhost_core.so")',
        '+_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libhost_core.so")',
        "+    os.makedirs(os.path.dirname(_LIB), exist_ok=True)",
        "-    ``tempest_tpu.runtime.ring.RingBuffer`` (put/take/close/overflows).\"\"\"",
        "+    ``tempest_tpu_torch.runtime.ring.RingBuffer`` (put/take/close/overflows).\"\"\"",
        "-        ok = self._lib.ring_take(self._handle, _fptr(view), t_ms)",
        '+        with annotate("ring.take"):',
        "+            ok = self._lib.ring_take(self._handle, _fptr(view), t_ms)",
    ]


def test_web_view_differs_only_in_its_docstring():
    """``runtime/webview.py`` has no JAX in it: the port's is the original
    (page, routes, handlers and all) but for three docstring lines that named
    the reference checkout's place and the TPU."""
    original = (ROOT / "tempest_tpu/runtime/webview.py").read_text().splitlines()
    copy = (ROOT / "tempest_tpu_torch/runtime/webview.py").read_text().splitlines()
    diff = [l for l in difflib.unified_diff(original, copy, lineterm="", n=0)
            if l[:1] in "+-" and l[:3] not in ("+++", "---")]
    assert [l for l in diff if l[0] == "+"] == [
        "+all updating together (``GUI.jl:296-356``,",
        "+``ScreenRenderer.jl:93-148``).  This module is that surface for headless",
        "+GPU hosts, with zero dependencies beyond the standard library: a localhost",
    ]
    assert len(diff) == 6 and all(i < 8 for i, l in enumerate(original) if l not in copy)


def test_metrics_class_is_the_original():
    """``utils/profiling.py``: ``trace`` and ``annotate`` are ported to
    ``torch.profiler``; the ``Metrics`` registry has no JAX in it and keeps
    the original's source text."""
    def metrics_source(path):
        text = path.read_text()
        return text[text.index("class Metrics:"): text.index("@contextlib.contextmanager")]

    assert (metrics_source(ROOT / "tempest_tpu_torch/utils/profiling.py")
            == metrics_source(ROOT / "tempest_tpu/utils/profiling.py"))


def test_port_imports_no_jax():
    code = ("import sys, tempest_tpu_torch, tempest_tpu_torch.runtime.stream, "
            "tempest_tpu_torch.runtime.console, tempest_tpu_torch.native, "
            "tempest_tpu_torch.render.plots, tempest_tpu_torch.ops.spectrum, "
            "tempest_tpu_torch.app.cli, tempest_tpu_torch.runtime.webview, "
            "tempest_tpu_torch.parallel.sharded, tempest_tpu_torch.utils.roofline, "
            "tempest_tpu_torch.utils.profiling; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('tempest_tpu.') or m == 'tempest_tpu'); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax():
    """No module of the port, nor ``chip_smoke.py``, imports jax or the JAX
    package, even lazily inside a function (a scan of the sources: it needs
    no card)."""
    sources = (sorted((ROOT / "tempest_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
               + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(sources) > 30
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert not words[1].startswith(("jax", "tempest_tpu.", "..tempest_tpu")), \
                    f"{path}: {line.strip()}"
                assert words[1] != "tempest_tpu", f"{path}: {line.strip()}"
