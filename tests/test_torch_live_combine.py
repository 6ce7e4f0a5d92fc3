"""The streaming runtime's per-block path with live combining
(``StreamingRuntime.step_words``): ``process_blocks`` runs through it, its
spans and counter, and the plain reference of the benchmark
(``portbench/reference/livecombine.py``) that holds it.

Tolerances against the reference, at a small size (2 Msps, blocks of 2^18
samples, three carriers in 0.4 MHz channels, 60x80 screens).  The program
channelises with one batched inverse FFT and fuses with matrix-vector
products where the reference takes each channel's own inverse FFT and sums
over the rows in a loop: the same values up to float32 rounding.  So the
weights lie within ``WEIGHTS_GAP`` = 1e-5 and the fused envelope within
``ENVELOPE_REL`` = 1e-5 of its range (about 2^-24 times the few roundings
of a sum of three rows and of an FFT of 2^18 points), and each polarity is
equal.  The blanking sync is a parabola through three contrast scores, so a
rounding of the envelope moves the centre by a few 1e-4 px: ``SYNC_PX`` =
0.01 px, circularly on the screen.  A centre that far off moves an aligned
frame by that share of its largest step between neighbouring pixels, and
the EMA with it: ``FRAMES_REL`` = ``EMA_REL`` = 1e-3 of the range.  The
reference in bfloat16 misses each of these but the polarity by 190 to 2,000
times (``portbench/limits/live1080-combine3.json``).

The ``cuda`` case holds the same comparison on the card (K1's envelope
entry, K2, K3 and cuFFT): ``python -m pytest --noconftest
tests/test_torch_live_combine.py -m cuda``.  This file imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.capture_wide import WideSpec, capture_words
from portbench.entries.livecombine import HeldSource
from portbench.reference import chain, livecombine
from tempest_tpu_torch.runtime.stream import StreamingRuntime
from tempest_tpu_torch.utils import profiling
from tempest_tpu_torch.video.modes import VideoMode

ROOT = Path(__file__).resolve().parent.parent

# The benchmark cell's configuration at its CPU size (portbench/small).
CFG = {
    "width_total": 2576, "height_total": 1125, "refresh_hz": 60.0, "sample_rate": 2e6,
    "alpha": 0.1, "render_size": [60, 80],
    "assumed": {"carriers_hz": [-600000.0, 150000.0, 700000.0], "chan_bw": 400000.0,
                "amplitudes": [1.0, 0.7, 0.5], "depths": [0.8, -0.8, 0.8], "snr_db": 6.0,
                "dc_level": 1.0, "int16_scale": 4096.0},
}
BLOCK = 1 << 18
N_BLOCKS = 3
SEED = 2**33 + 77
WEIGHTS_GAP = 1e-5
ENVELOPE_REL = 1e-5
SYNC_PX = 0.01
FRAMES_REL = 1e-3
EMA_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _words(device="cpu") -> torch.Tensor:
    """N_BLOCKS consecutive blocks of the seeded wideband capture, float32
    words."""
    return capture_words(WideSpec.from_config(CFG), BLOCK * N_BLOCKS, SEED, device).to(
        torch.float32)


def _runtime(combine: bool, device="cpu") -> StreamingRuntime:
    a = CFG["assumed"]
    mode = VideoMode(CFG["width_total"], CFG["height_total"], CFG["refresh_hz"])
    options = {"combine": a["carriers_hz"], "combine_bw": a["chan_bw"]} if combine else {}
    return StreamingRuntime(HeldSource(CFG["sample_rate"], BLOCK), mode, alpha=CFG["alpha"],
                            ring_depth=N_BLOCKS + 1, device=device,
                            config_overrides={"render_size": tuple(CFG["render_size"])},
                            **options)


def _phase(rt: StreamingRuntime, b: int) -> float:
    return (-(b * BLOCK)) % rt._spf


@pytest.mark.parametrize("combine", [True, False], ids=["combine", "plain"])
def test_process_blocks_runs_through_step_words(combine):
    """The same blocks through ``process_blocks`` (ring, upload, sink),
    through ``step_words`` at the blocks' phases, and through the front and
    the step called as ``process_blocks`` called them before it had
    ``step_words``: the same EMA, frames, sync and weights, to the bit."""
    words = _words()
    blocks = words.numpy().view(np.complex64).reshape(N_BLOCKS, BLOCK)

    ring_rt = _runtime(combine)
    for b in blocks:
        ring_rt.ring.put(b)
    got = []

    def sink(frame, info):
        got.append((frame, info["sync"], ring_rt.combine_weights))

    ema = ring_rt.process_blocks(N_BLOCKS, sink=sink, emit_every_frame=True)
    n_frames = ring_rt.config.n_frames
    assert len(got) == N_BLOCKS * n_frames and ring_rt.abs_pos == N_BLOCKS * BLOCK

    rt, old = _runtime(combine), _runtime(combine)
    for b in range(N_BLOCKS):
        iq = torch.from_numpy(blocks[b][: rt._upload_samples].view(np.float32))
        out = rt.step_words(iq, _phase(rt, b))
        # The body of process_blocks before step_words.
        if combine:
            env, w, pol, mass = old._combine_front(iq)
            old.combine_weights = (w, pol, mass)
            want = old._step(env, old.ema, old.alpha, _phase(old, b) * old._phase_scale)
        else:
            want = old._step(iq, old.ema, old.alpha, _phase(old, b))
        old.ema = want[0]
        for x, y in zip(out, want):
            assert torch.equal(x, y)
        for f in range(n_frames):
            frame, sync, weights = got[b * n_frames + f]
            assert np.array_equal(frame, out[1][f].numpy())
            assert np.array_equal(sync, out[2].numpy())
            if combine:
                for x, y in zip(weights, rt.combine_weights):
                    assert torch.equal(x, y)
            else:
                assert weights is None and rt.combine_weights is None
    assert rt.ema is out[0]
    assert np.array_equal(ema, rt.ema.numpy())
    assert np.array_equal(ema, old.ema.numpy())


def _circular_gap(got: torch.Tensor, want: torch.Tensor, periods) -> float:
    p = torch.tensor([float(x) for x in periods], dtype=torch.float64)
    d = torch.remainder(got.double().cpu() - want.double().cpu(), p)
    return float(torch.max(torch.minimum(d, p - d)))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / (want.max() - want.min()))


def _hold_to_reference(device):
    """Every block of the seeded capture through ``step_words`` with three
    carriers and through the reference, the EMA threaded in both; each
    number within its tolerance."""
    words = _words(device)
    rt = _runtime(True, device)
    g = livecombine.geometry(CFG, BLOCK)
    assert (g.n_fft, g.m, g.fs_chan) == rt._combine_geometry
    assert (g.n_frames, g.block_len) == (rt.config.n_frames, rt.config.block_samples)
    ema = torch.zeros(tuple(CFG["render_size"]), dtype=torch.float32, device=device)
    for b in range(N_BLOCKS):
        block = words[2 * b * BLOCK: 2 * (b + 1) * BLOCK]
        got_ema, frames, sync, _ = rt.step_words(block, _phase(rt, b))
        w, pol, _ = rt.combine_weights
        ref = livecombine.block(block, _phase(rt, b), g, CFG["assumed"]["carriers_hz"], ema,
                                CFG["alpha"], chain.exact)
        ema = ref["ema"]
        env, *_ = rt._combine_front(block)
        assert torch.equal(pol.cpu(), ref["polarity"].cpu())
        assert float((w - ref["weights"]).abs().max()) < WEIGHTS_GAP
        assert float(w.min()) > 0.1, w    # every carrier weighted
        assert _rel(env, ref["envelope"]) < ENVELOPE_REL
        assert _circular_gap(sync, ref["sync"], CFG["render_size"]) < SYNC_PX
        assert _rel(frames, ref["frames"]) < FRAMES_REL
        assert _rel(got_ema, ref["ema"]) < EMA_REL
    assert torch.equal(pol.cpu(), torch.tensor([1.0, -1.0, 1.0]))


def test_step_words_with_three_carriers_matches_the_reference():
    _hold_to_reference(torch.device("cpu"))


def test_spans_and_counter_while_the_tracer_is_on(tracer):
    rt = _runtime(True)
    block = _words()[: 2 * BLOCK]
    tracer.enable()
    rt.step_words(block, 0.0)
    tracer.disable()
    recs = {r.name: r for r in tracer.records()}
    assert {"runtime.step", "runtime.combine", "combine.channels", "combine.fuse"} <= set(recs)
    assert recs["runtime.combine"].parent == recs["runtime.step"].id
    assert recs["combine.channels"].parent == recs["runtime.combine"].id
    assert recs["combine.fuse"].parent == recs["runtime.combine"].id
    # The front reads the block's first N complex samples: 8 bytes each.
    assert tracer.summary()["counters"]["runtime.combine.bytes"] == 8 * rt._combine_geometry[0]


def test_nothing_is_recorded_while_the_tracer_is_off(tracer):
    rt = _runtime(True)
    rt.step_words(_words()[: 2 * BLOCK], 0.0)
    assert tracer.records() == []
    assert tracer.summary() == {"spans": {}, "counters": {}}


def test_the_reference_loads_nothing_of_the_port_or_of_jax():
    code = (
        "import json, sys, torch\n"
        "from portbench.capture_wide import WideSpec, capture_words\n"
        "from portbench.reference import livecombine\n"
        f"cfg = {CFG!r}\n"
        f"w = capture_words(WideSpec.from_config(cfg), {BLOCK}, 3, 'cpu').to(torch.float32)\n"
        f"g = livecombine.geometry(cfg, {BLOCK})\n"
        "livecombine.block(w, 0.0, g, cfg['assumed']['carriers_hz'], "
        "torch.zeros(60, 80), 0.1)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"tempest_tpu_torch", "tempest_tpu", "jax", "jaxlib", "flax"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2 and K3 have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_step_words_with_three_carriers_matches_the_reference_on_the_card(cuda_device):
    _hold_to_reference(cuda_device)
