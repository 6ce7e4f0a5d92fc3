"""The port's command line (``tempest_tpu_torch.app.cli``) against the JAX
package's on the same capture files: every subcommand through
``main([... "--device", "cpu"])``, mirroring ``tests/test_runtime.py`` and
``tests/test_combine.py``.

What is compared, and how closely:

* files the two CLIs write without computing (``synth``, ``convert``,
  ``modes``): equal to the byte, since the generator, the .dat codec and the
  mode table are copies;
* printed results (mode names, refresh to the 4 decimals printed, rankings,
  carrier lists): equal as text; line counts and scores as numbers, to the
  last digit printed ± 1;
* PNGs: decoded and compared as 8-bit images.  ``reconstruct --mode auto``
  runs the same chain in both (K1's read here, the gather read there, float32
  against float64 positions; sub-pixel sync; MTF restoration), normalised to
  full scale and quantised to 8 bits: mean absolute difference under 1 grey
  level (measured 0.46), at most 2% of pixels more than 2 levels apart
  (measured 1.1%: three quarters of the two rows where the frames' last rows
  land after alignment, where K1 reads on past the frame end and the gather
  read clips, a difference by design that the restoration spreads; and the
  pattern's sharpest edges, where a sync fraction that moves in the 5th digit
  moves a pixel by a few levels).  With a named mode
  the JAX CLI takes its ``mxu3`` tables (64 phases, bfloat16 envelope) where
  the port's takes K1 unquantised: mean under 2 levels.

Captures: 640x480 @ 60 Hz at 4 Msps, 0.3 s; wideband: two carriers at 8 Msps,
0.5 s, 2 MHz channels (an 8 Msps capture has no empty channel, so three
carriers would merge: see ``tests/test_torch_combine.py``).
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.app.cli import build_parser
from tempest_tpu_torch.app.cli import main as torch_main

MODE_NAME = "640x480 @ 60Hz"
FS = "4e6"
WIDE_FS = "8e6"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_main():
    return pytest.importorskip("tempest_tpu.app.cli").main


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def capture(workdir):
    path = workdir / "cap.dat"
    assert torch_main(["synth", "--mode", MODE_NAME, "--fs", FS, "--seconds", "0.3",
                       "--snr", "20", "--out", str(path)]) == 0
    return path


@pytest.fixture(scope="module")
def wideband(workdir):
    path = workdir / "wide.dat"
    assert torch_main(["synth", "--mode", MODE_NAME, "--fs", WIDE_FS, "--seconds", "0.5",
                       "--snr", "10", "--harmonics=-2.4e6,1.8e6", "--out", str(path)]) == 0
    return path


def _read_png(path) -> np.ndarray:
    """Decode the 8-bit grayscale PNGs that ``render/screen.py`` writes."""
    data = open(path, "rb").read()
    assert data[:8] == PNG_MAGIC
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    assert (depth, colour) == (8, 0)
    pos, idat = 8, b""
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos: pos + 4]), data[pos + 4: pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8: pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not raw[:, 0].any()   # filter type 0 on every row
    return raw[:, 1:].astype(np.int16)


def _both(jax_main, capsys, argv, jax_extra=(), torch_extra=()):
    """Run one command line through both CLIs; returns (rc, text) of each."""
    capsys.readouterr()
    rc_j = jax_main(list(argv) + list(jax_extra))
    text_j = capsys.readouterr().out
    rc_t = torch_main(list(argv) + list(torch_extra) + ["--device", "cpu"])
    text_t = capsys.readouterr().out
    return (rc_j, text_j), (rc_t, text_t)


def _field(text: str, label: str) -> str:
    line = next(l for l in text.splitlines() if l.startswith(label))
    return line.split(":", 1)[1].strip()


# ------------------------------------------------- files, without computing
def test_synth_convert_and_modes_equal_the_jax_cli_to_the_byte(jax_main, workdir, capture, capsys):
    other = workdir / "cap_jax.dat"
    capsys.readouterr()
    assert jax_main(["synth", "--mode", MODE_NAME, "--fs", FS, "--seconds", "0.3",
                     "--snr", "20", "--out", str(other)]) == 0
    assert "wrote" in capsys.readouterr().out
    assert other.read_bytes() == capture.read_bytes()
    assert jax_main(["convert", str(capture), str(workdir / "j.dat"),
                     "--from-format", "single", "--to-format", "short"]) == 0
    assert torch_main(["convert", str(capture), str(workdir / "t.dat"),
                       "--from-format", "single", "--to-format", "short"]) == 0
    assert "converted 1200000 samples" in capsys.readouterr().out
    assert (workdir / "j.dat").read_bytes() == (workdir / "t.dat").read_bytes()
    assert jax_main(["modes"]) == 0
    listing = capsys.readouterr().out
    assert torch_main(["modes"]) == 0
    assert capsys.readouterr().out == listing and MODE_NAME in listing


def test_synth_options_match(jax_main, workdir, capsys):
    for extra in (["--modulation", "fm", "--seed", "3"],
                  ["--harmonics=-1e6,1e6", "--modulation", "fm", "--deviation", "50000"]):
        argv = ["synth", "--mode", MODE_NAME, "--fs", FS, "--seconds", "0.05", "--snr", "15"]
        assert jax_main(argv + extra + ["--out", str(workdir / "sj.dat")]) == 0
        assert torch_main(argv + extra + ["--out", str(workdir / "st.dat")]) == 0
        assert (workdir / "sj.dat").read_bytes() == (workdir / "st.dat").read_bytes()
    capsys.readouterr()


# ------------------------------------------------------------------ analyze
def test_analyze_matches_the_jax_cli(jax_main, capture, capsys):
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys, ["analyze", str(capture), "--fs", FS])
    assert rc_j == rc_t == 0
    for label in ("samples", "refresh rate", "closest mode", "mode geometry"):
        assert _field(tt, label) == _field(tj, label), label
    assert _field(tt, "closest mode") == MODE_NAME
    assert abs(float(_field(tt, "line count (est)")) - float(_field(tj, "line count (est)"))) <= 0.1
    snr_t = float(_field(tt, "snr proxy").split()[0])
    snr_j = float(_field(tj, "snr proxy").split()[0])
    assert abs(snr_t - snr_j) <= 0.1
    assert "analysis time" in tt


def test_analyze_evidence_options(jax_main, workdir, capture, capsys):
    argv = ["analyze", str(capture), "--fs", FS, "--peaks", "3", "--pick-line-peak", "0"]
    (rc_j, tj), (rc_t, tt) = _both(
        jax_main, capsys, argv,
        jax_extra=["--plots", str(workdir / "jev"), "--waterfall", str(workdir / "jwf.png")],
        torch_extra=["--plots", str(workdir / "tev"), "--waterfall", str(workdir / "twf.png")])
    assert rc_j == rc_t == 0
    ranked_j = [l for l in tj.splitlines() if l.startswith("  #")]
    ranked_t = [l for l in tt.splitlines() if l.startswith("  #")]
    assert len(ranked_t) == len(ranked_j) == 3 and "*picked" in ranked_t[0]
    for a, b in zip(ranked_t, ranked_j):
        # "#i: lag L samples -> Y lines -> name (score s)": same lag, lines, name.
        assert a.split("(score")[0] == b.split("(score")[0]
    for stem in ("ev_refresh.png", "ev_lines.png"):
        a, b = _read_png(workdir / f"t{stem}"), _read_png(workdir / f"j{stem}")
        assert a.shape == b.shape and np.abs(a - b).mean() < 1.0
    wf_t, wf_j = _read_png(workdir / "twf.png"), _read_png(workdir / "jwf.png")
    # Power in dB of the same FFT segments, full-scaled to 8 bits.
    assert wf_t.shape == wf_j.shape == (1024, 1171) and np.abs(wf_t - wf_j).max() <= 1
    assert "peak 60.000 Hz" in tt and "waterfall         : wrote" in tt
    # A pick out of range prints the list and fails the command, in both.
    (rc_j, _), (rc_t, tt) = _both(
        jax_main, capsys, ["analyze", str(capture), "--fs", FS, "--pick-line-peak", "99"])
    assert rc_j == rc_t == 2 and "error: --pick-line-peak 99" in tt


def test_analyze_fm(jax_main, workdir, capsys):
    path = workdir / "fm.dat"
    assert torch_main(["synth", "--mode", MODE_NAME, "--fs", FS, "--seconds", "0.3", "--snr", "25",
                       "--modulation", "fm", "--out", str(path)]) == 0
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys,
                                   ["analyze", str(path), "--fs", FS, "--demod", "fm"])
    assert rc_j == rc_t == 0
    assert _field(tt, "closest mode") == _field(tj, "closest mode") == MODE_NAME
    assert _field(tt, "refresh rate") == _field(tj, "refresh rate")


# -------------------------------------------------------------- reconstruct
def test_reconstruct_auto_matches_the_jax_cli(jax_main, workdir, capture, capsys):
    argv = ["reconstruct", str(capture), "--fs", FS, "--alpha", "0.5"]
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys, argv,
                                   jax_extra=["--out", str(workdir / "jr.png")],
                                   torch_extra=["--out", str(workdir / "tr.png")])
    assert rc_j == rc_t == 0
    assert tt.splitlines()[0] == tj.splitlines()[0] == f"detected mode: {MODE_NAME} (fv=60.0000 Hz)"
    assert "17 frames averaged" in tt and "17 frames averaged" in tj
    a, b = _read_png(workdir / "tr.png"), _read_png(workdir / "jr.png")
    assert a.shape == b.shape == (600, 800)
    diff = np.abs(a - b)
    assert diff.mean() < 1.0 and (diff > 2).mean() < 0.02


def test_reconstruct_named_mode_and_output_options(jax_main, workdir, capture, capsys):
    argv = ["reconstruct", str(capture), "--fs", FS, "--alpha", "0.5", "--mode", MODE_NAME,
            "--subsample-align", "--no-align", "--no-restore"]
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys, argv,
                                   jax_extra=["--out", str(workdir / "jn.png")],
                                   torch_extra=["--out", str(workdir / "tn.png")])
    assert rc_j == rc_t == 0 and "sync score 0" in tt and "sync score 0" in tj
    a, b = _read_png(workdir / "tn.png"), _read_png(workdir / "jn.png")
    assert np.abs(a - b).mean() < 2.0
    out = workdir / "opt.png"
    assert torch_main(["reconstruct", str(capture), "--fs", FS, "--alpha", "auto",
                       "--search", "--auto-polarity", "--sync-overlay", "--no-subpixel",
                       "--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"detected mode: {MODE_NAME}" in text and "polarity: blanking is" in text
    assert _read_png(out).shape == (600, 800)
    assert torch_main(["reconstruct", str(capture), "--fs", FS, "--pick-line-peak", "99",
                       "--device", "cpu", "--out", str(out)]) == 2
    assert "hint: run `analyze --peaks N`" in capsys.readouterr().out


def test_reconstruct_combine_matches_the_jax_cli(jax_main, workdir, wideband, capsys):
    argv = ["reconstruct", str(wideband), "--fs", WIDE_FS, "--alpha", "0.7",
            "--combine=-2e6,2e6", "--chan-bw", "2e6"]
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys, argv,
                                   jax_extra=["--out", str(workdir / "jc.png")],
                                   torch_extra=["--out", str(workdir / "tc.png")])
    assert rc_j == rc_t == 0
    assert tt.splitlines()[0] == tj.splitlines()[0] and MODE_NAME in tt
    carriers_t = [l for l in tt.splitlines() if l.startswith("  carrier ")]
    carriers_j = [l for l in tj.splitlines() if l.startswith("  carrier ")]
    assert len(carriers_t) == len(carriers_j) == 2
    for a, b in zip(carriers_t, carriers_j):
        # "carrier f MHz: weight w polarity p comb m dB": weights to 0.01
        # (MRC weights agree to 1e-4), comb masses to 0.1 dB.
        fa, fb = a.split(), b.split()
        assert fa[1] == fb[1] and fa[6] == fb[6]
        assert abs(float(fa[4]) - float(fb[4])) <= 0.011
        assert abs(float(fa[8]) - float(fb[8])) <= 0.11
    assert _read_png(workdir / "tc.png").shape == (600, 800)


def test_reconstruct_combine_auto_and_all(workdir, wideband, capsys):
    out = workdir / "auto.png"
    assert torch_main(["reconstruct", str(wideband), "--fs", WIDE_FS, "--alpha", "0.7",
                       "--combine", "auto", "--chan-bw", "2e6", "--device", "cpu",
                       "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert MODE_NAME in text and text.count("  carrier ") >= 1
    assert torch_main(["reconstruct", str(wideband), "--fs", WIDE_FS, "--alpha", "0.7",
                       "--combine", "all", "--chan-bw", "2e6", "--device", "cpu",
                       "--out", str(workdir / "all.png")]) == 0
    text = capsys.readouterr().out
    assert "1 screen(s) detected" in text and f"screen 1: {MODE_NAME}" in text
    assert _read_png(workdir / "all.png").shape == (600, 800)


def test_no_emission_paths_fail_gracefully(workdir, capsys):
    rng = np.random.default_rng(0)
    n = int(8e6 * 0.2)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    path = workdir / "noise.dat"
    tp.write_complex_binary(noise, str(path), "single")
    rc = torch_main(["reconstruct", str(path), "--fs", WIDE_FS, "--combine", "auto",
                     "--chan-bw", "2e6", "--device", "cpu", "--out", str(workdir / "x.png")])
    text = capsys.readouterr().out
    assert rc == 2 and "error:" in text and "hint:" in text
    rc = torch_main(["survey", str(path), "--fs", WIDE_FS, "--bw", "2e6", "--device", "cpu",
                     "--out", str(workdir / "noise_report")])
    assert rc == 2 and "no emissions above the detection threshold" in capsys.readouterr().out
    assert (workdir / "noise_report" / "band.png").read_bytes()[:8] == PNG_MAGIC


# ------------------------------------------------------ search, scan, survey
def test_search_matches_the_jax_cli(jax_main, capture, capsys):
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys,
                                   ["search", str(capture), "--fs", FS, "--tol", "0.5"])
    assert rc_j == rc_t == 0 and "static-table" in tt
    assert tt.splitlines()[0] == tj.splitlines()[0]
    rank_t = [l for l in tt.splitlines()[1:] if l.strip()]
    rank_j = [l for l in tj.splitlines()[1:] if l.strip()]
    assert rank_t[0].split("score")[0] == rank_j[0].split("score")[0]
    assert MODE_NAME in rank_t[0] and rank_t[0].endswith("<== best")
    names = lambda rows: [r[4:44].strip() for r in rows]   # noqa: E731
    assert names(rank_t)[:3] == names(rank_j)[:3]
    for a, b in zip(rank_t, rank_j):
        sa, sb = (float(r.split("score")[1].split()[0]) for r in (a, b))
        assert abs(sa - sb) <= 2e-3 * sb   # 4 significant digits printed


def test_scan_matches_the_jax_cli(jax_main, wideband, capsys):
    (rc_j, tj), (rc_t, tt) = _both(
        jax_main, capsys, ["scan", str(wideband), "--fs", WIDE_FS, "--bw", "2e6", "--top", "3"])
    assert rc_j == rc_t == 0
    assert _field(tt, "best candidate") == _field(tj, "best candidate")
    assert "scanned 7 channels x 2.00 MHz" in tt and "scanned 7 channels x 2.00 MHz" in tj
    rows_t = [l.split() for l in tt.splitlines() if l.startswith("  #")]
    rows_j = [l.split() for l in tj.splitlines() if l.startswith("  #")]
    assert [r[1] for r in rows_t] == [r[1] for r in rows_j]       # ranked offsets
    for a, b in zip(rows_t, rows_j):
        assert abs(float(a[2]) - float(b[2])) <= 0.11             # comb mass, dB
        assert abs(float(a[3]) - float(b[3])) <= 0.11             # screen-ness, dB
        assert a[4] == b[4]                                       # refresh, 3 decimals
    assert _field(tt, "emissions").split()[0] == _field(tj, "emissions").split()[0]


def test_survey_matches_the_jax_cli(jax_main, workdir, wideband, capsys):
    argv = ["survey", str(wideband), "--fs", WIDE_FS, "--bw", "2e6"]
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys, argv,
                                   jax_extra=["--out", str(workdir / "jrep")],
                                   torch_extra=["--out", str(workdir / "trep")])
    assert rc_j == rc_t == 0
    assert tt.splitlines()[0].split(":")[1] == tj.splitlines()[0].split(":")[1]
    screens_t = [l.split(" -> ")[0] for l in tt.splitlines() if l.startswith("screen ")]
    screens_j = [l.split(" -> ")[0] for l in tj.splitlines() if l.startswith("screen ")]
    assert screens_t == screens_j and MODE_NAME in screens_t[0]
    rep = workdir / "trep"
    assert (rep / "band.png").read_bytes()[:8] == PNG_MAGIC
    assert _read_png(rep / "screen_1.png").shape == (600, 800)
    assert "screen 1:" in (rep / "survey.txt").read_text()
    assert f"report written to {rep}/" in tt


# ------------------------------------------------------------------- stream
def test_stream_matches_the_jax_cli(jax_main, workdir, capture, capsys):
    argv = ["stream", "--source", "replay", "--file", str(capture), "--mode", MODE_NAME,
            "--fs", FS, "--block-seconds", "0.1", "--blocks", "2", "--alpha", "0.5",
            "--render", "png"]
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys, argv,
                                   jax_extra=["--out-prefix", str(workdir / "jf")],
                                   torch_extra=["--out-prefix", str(workdir / "tf")])
    assert rc_j == rc_t == 0
    assert "| 8 frames reconstructed" in tt and "| 8 frames reconstructed" in tj
    assert "health:" in tt
    for i in range(2):
        a = _read_png(workdir / f"tf_{i:05d}.png")
        assert a.shape == (600, 800)
    # The replay loops and the producer may drop blocks while the JAX step
    # compiles, so the two runs need not average the same blocks: frames are
    # compared through `reconstruct`, here only that both render a screen.
    assert _read_png(workdir / "jf_00001.png").shape == (600, 800)


def test_stream_options(workdir, capture, capsys):
    ckpt = workdir / "state.npz"
    rec = workdir / "rec.dat"
    base = ["stream", "--source", "replay", "--file", str(capture), "--mode", MODE_NAME,
            "--fs", FS, "--block-seconds", "0.1", "--device", "cpu"]
    assert torch_main(base + ["--blocks", "4", "--correlate", "--drift-lock", "--fidelity",
                              "--record", str(rec), "--record-blocks", "1",
                              "--checkpoint", str(ckpt), "--ring", "native"]) == 0
    text = capsys.readouterr().out
    assert f"live correlate: {MODE_NAME}" in text and "drift lock: refined refresh to" in text
    assert "fidelity mode: sub-sample-exact cuts, sync skipped" in text
    assert "recorded 400000 samples" in text and f"checkpointed streaming state to {ckpt}" in text
    assert tp.num_samples(str(rec), "single") == 400000
    assert torch_main(base + ["--blocks", "1", "--resume", str(ckpt), "--resampler", "mxu3",
                              "--num-phases", "16", "--interp-taps", "4", "--einsum-bf16"]) == 0
    assert f"resumed from {ckpt}" in capsys.readouterr().out
    assert torch_main(base + ["--blocks", "1", "--demod", "fm", "--invert"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        torch_main(base + ["--demod", "fm", "--combine", "1e6"])


def test_stream_console_and_combine(workdir, wideband, capsys, monkeypatch):
    import io
    import sys

    monkeypatch.setattr(sys, "stdin", io.StringIO("status\nalpha 0.6\nquit\n"))
    assert torch_main(["stream", "--source", "replay", "--file", str(wideband),
                       "--mode", MODE_NAME, "--fs", WIDE_FS, "--block-seconds", "0.3",
                       "--combine=-2e6,2e6", "--chan-bw", "2e6", "--console",
                       "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "alpha" in text and "frames reconstructed" in text
    assert "'combine': {" in text


# ------------------------------------------------------------------- warmup
def test_warmup_prints_the_jax_cli_s_lines(capsys):
    assert torch_main(["warmup", "--fs", FS, "--frames", "1", "--modes", MODE_NAME,
                       "--cache-dir", "unused", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    # The lines tests/test_runtime.py::test_cli_warmup looks for.
    assert f"compiled {MODE_NAME} (stream/f32)" in text
    assert f"compiled {MODE_NAME} (batch/int16)" in text
    assert f"compiled {MODE_NAME} (stream fidelity" in text
    assert "compiled timing estimator" in text
    assert "--cache-dir unused: ignored" in text and "native ring" in text


# ------------------------------------------ the mesh options, the parser
def test_stream_mesh_runs_on_a_cpu_mesh(workdir, capture, wideband, capsys):
    """``stream --mesh N`` with ``--device cpu``: N shards on the CPU, the
    port's counterpart of ``tests/test_runtime.py::test_cli_stream_mesh``.
    --fidelity and --combine compose with --mesh: the fidelity chain and
    live combining run on the mesh as on one device."""
    base = ["stream", "--source", "replay", "--file", str(capture), "--mode", MODE_NAME,
            "--fs", FS, "--block-seconds", "0.2", "--mesh", "4", "--device", "cpu",
            "--render", "png"]
    assert torch_main(base + ["--blocks", "2", "--out-prefix", str(workdir / "mesh")]) == 0
    text = capsys.readouterr().out
    assert "| 8 frames reconstructed" in text and "'n_shards': 4" in text
    assert "'dispatched': 2" in text
    assert _read_png(workdir / "mesh_00001.png").shape == (600, 800)
    assert torch_main(base + ["--blocks", "1", "--fidelity",
                              "--out-prefix", str(workdir / "meshfid")]) == 0
    assert "| 4 frames reconstructed" in capsys.readouterr().out
    assert (workdir / "meshfid_00000.png").exists()
    # Live combining on the mesh: the block is the channeliser's power-of-two
    # window (0.3 s at 8 Msps -> 2^21 samples), its channel split in two.
    assert torch_main(["stream", "--source", "replay", "--file", str(wideband), "--mode",
                       MODE_NAME, "--fs", WIDE_FS, "--block-seconds", "0.3", "--blocks", "1",
                       "--combine=-2e6,2e6", "--chan-bw", "2e6", "--mesh", "2",
                       "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "'combine': {" in text and "'shard_samples': 262144" in text


@pytest.mark.parametrize("argv,message", [
    (["--block-seconds", "5e-7", "--mesh", "8"], "4 samples cannot be split into 8 spans"),
    (["--block-seconds", "0.3", "--mesh", "3", "--combine=-2e6,2e6", "--chan-bw", "2e6"],
     "does not split into 3 equal spans"),
], ids=["block_smaller_than_mesh", "combine_mesh_not_dividing"])
def test_stream_mesh_refuses_what_it_cannot_split(argv, message, wideband):
    """A block smaller than the mesh, or with --combine a mesh size that does
    not divide the power-of-two block, is refused with a message; the block
    is not changed behind the operator's back."""
    with pytest.raises(SystemExit, match=message):
        torch_main(["stream", "--source", "replay", "--file", str(wideband), "--mode",
                    MODE_NAME, "--fs", WIDE_FS, "--blocks", "1", "--device", "cpu", *argv])


def test_search_dynamic_matches_the_jax_cli(jax_main, capture, capsys):
    """``search --dynamic``: the candidates split over 8 CPU shards here, over
    the JAX package's 8 virtual devices there; the same ranking of the
    leaders and the winner."""
    (rc_j, tj), (rc_t, tt) = _both(jax_main, capsys,
                                   ["search", str(capture), "--fs", FS, "--tol", "0.5",
                                    "--dynamic", "--devices", "8"])
    assert rc_j == rc_t == 0
    assert tt.splitlines()[0] == tj.splitlines()[0]
    assert "on 8 devices" in tt
    rank_t = [l for l in tt.splitlines()[1:] if l.strip()]
    rank_j = [l for l in tj.splitlines()[1:] if l.strip()]
    assert MODE_NAME in rank_t[0] and rank_t[0].endswith("<== best")
    names = lambda rows: [r[4:44].strip() for r in rows]   # noqa: E731
    assert names(rank_t)[:3] == names(rank_j)[:3]


def test_parser_has_the_jax_cli_s_subcommands_and_options(jax_main):
    import argparse

    jax_parser = pytest.importorskip("tempest_tpu.app.cli").build_parser()

    def surface(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: {o for a in p._actions for o in a.option_strings} | {
            a.dest for a in p._actions if not a.option_strings}
            for name, p in sub.choices.items()}

    ours, theirs = surface(build_parser()), surface(jax_parser)
    assert set(ours) == set(theirs) == {"analyze", "reconstruct", "stream", "search", "scan",
                                        "survey", "synth", "convert", "warmup", "modes"}
    computing = {"analyze", "reconstruct", "stream", "search", "scan", "survey", "warmup"}
    for name in theirs:
        extra = ours[name] - theirs[name]
        assert theirs[name] <= ours[name], (name, theirs[name] - ours[name])
        assert extra == ({"--device"} if name in computing else set()), (name, extra)


def test_without_a_card_the_default_device_is_refused(capture):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main(["analyze", str(capture), "--fs", FS])


def test_help_texts_carry_no_tpu_figures():
    import contextlib
    import io

    parser = build_parser()
    for cmd in ("stream", "search", "reconstruct", "warmup"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
            parser.parse_args([cmd, "--help"])
        text = buf.getvalue()
        for word in ("v5e", "TPU", "90x", "Msps", "MXU"):
            assert word not in text, (cmd, word)
