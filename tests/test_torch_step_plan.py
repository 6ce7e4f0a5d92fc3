"""The step's plan (``pipeline/offline.py`` ``_StepPlan``, ``_step``) and the
cuts' upload through pinned slots.

A key's first step goes through the kernels' wrappers and keeps its plan; the
steps after it issue the plan's launches alone.  On the CPU the kernels have
no launch, so these cases hand the step a library that records each
launcher's arguments (as ``tests/test_torch_tracing.py``'s ``no_launch``
does) and let the plan launch into it: the planned launches pass every
launcher what the unplanned wrappers pass it, but the addresses of the
outputs and the scratch; a new key builds a new plan; two steps return
tensors that share no storage; and the counters of N steps read one build
and N - 1 reuses.  On the card (the ``cuda`` case) 24 resident steps issued
back to back synchronise nothing, are bit-equal to the wrappers' steps, and
send every cut through the pinned slots.

Shapes: the resident cell's step (36 frames, ``mxu3``, exact cuts, sub-pixel
sync, the fold) and the capture's stage 2 (4 taps, 479 frames), both at
640x480 @ 60 Hz on 60x80 screens (2 Msps and 1 Msps); on the card the
resident cell's own (1920x1080 @ 60 Hz at 20 Msps, 600x800).  Imports no JAX,
so the ``cuda`` case runs on a machine without it (``--noconftest``).
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch import _build
from tempest_tpu_torch.ops import align_kernel, resample_kernel, sync_kernel
from tempest_tpu_torch.pipeline import offline
from tempest_tpu_torch.utils import profiling

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
SHAPE = (60, 80)
# The launchers' arguments that are addresses of a step's outputs or scratch
# (K1's screens; K2's screens, scratch and results; K3's screens, aligned
# frames, new EMA and shifts): the planned step lays these out itself.
OWN = {"tt_resample_frames": {10}, "tt_blanking_sync": {0, 1, 2, 18, 19, 20, 21},
       "tt_align_fold": {0, 1, 3, 4, 5}}
LAUNCHERS = tuple(OWN)


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_plans(monkeypatch):
    monkeypatch.setattr(offline, "_PLANS", {})


class _Recording:
    """A kernels' library whose every entry records its arguments, returns
    success and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.fixture
def recording(monkeypatch):
    """The step launching on CPU tensors into a recording library, with K1's
    check of a CUDA source passed and K2's cluster count fixed."""
    lib = _Recording()
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    monkeypatch.setattr(resample_kernel, "_check_launch", lambda src, n, starts: starts.shape[0])
    monkeypatch.setattr(sync_kernel, "_max_clusters", lambda index, smem, size: 132 // size)
    monkeypatch.setattr(offline, "_on_card", lambda device: True)
    return lib


def _config(shapes):
    if shapes == "resident":
        return offline.ReconstructionConfig(
            sample_rate=2e6, mode=MODE, n_frames=36, render_size=SHAPE,
            input_format="iq_interleaved", carry_phase=True, subsample_align=True,
            align_subpixel=True, resampler="mxu3")
    return offline.ReconstructionConfig(
        sample_rate=1e6, mode=MODE, n_frames=479, render_size=SHAPE,
        input_format="iq_interleaved", align_subpixel=True, interp_taps=4)


def _inputs(config, seed=5):
    """(int16 words, int32 starts, float32 residuals or None, EMA) of one
    block: the resident step's cuts at phase 0.25, the capture's rounded."""
    n = config.block_samples
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(-8000, 8000, 2 * n).astype(np.int16))
    if config.subsample_align:
        starts, fracs = offline.exact_cut_starts(0.25, config.samples_per_frame, config.n_frames)
        fracs = torch.from_numpy(fracs)
    else:
        starts = np.round(np.arange(config.n_frames) * config.samples_per_frame).astype(np.int32)
        fracs = None
    ema = torch.from_numpy(rng.random(SHAPE, dtype=np.float32))
    return words, torch.from_numpy(starts), fracs, ema


def _step(config, words, starts, fracs, ema, alpha=0.1, n_streams=1):
    return offline._process_and_fold(words, starts, config, int(config.samples_per_frame), ema,
                                     alpha, n_streams, from_words=True, frac_offsets=fracs)


def _wrappers(config, words, starts, fracs, ema, alpha=0.1):
    """The launch halves of the wrappers a step calls (K1's words entry, K2
    with pairs, K3 with the fold), as the parent's step called them."""
    raster = (int(config.samples_per_frame), MODE.height, MODE.width, SHAPE)
    staged, load = resample_kernel._words_load(words.dtype, "am", config.resampler == "mxu3",
                                               False)
    screens = resample_kernel._launch(words, words.shape[0] // 2, staged, starts, *raster, fracs,
                                      config.interp_taps, None, None, 1, load)
    s_y, s_x, _, _ = sync_kernel._launch(screens, 0.01, 0.05, 0, True, True)
    align_kernel._launch(screens, s_y, s_x, ema, alpha, "linear", 1)


def _storages(outs):
    return {t.untyped_storage().data_ptr() for t in outs if t is not None}


@pytest.mark.parametrize("shapes", ["resident", "capture"])
def test_planned_launches_are_the_wrappers_and_each_key_its_own(shapes, recording):
    config = _config(shapes)
    words, starts, fracs, ema = _inputs(config)
    profiling.enable()
    plain = _step(config, words, starts, fracs, ema)  # the key's first step: the wrappers
    assert not recording.calls
    recording.calls.clear()
    first = _step(config, words, starts, fracs, ema)
    planned = list(recording.calls)
    recording.calls.clear()
    _wrappers(config, words, starts, fracs, ema)
    unplanned = list(recording.calls)
    assert [name for name, _ in planned] == [name for name, _ in unplanned] == list(LAUNCHERS)
    for (name, got), (_, ref) in zip(planned, unplanned):
        assert len(got) == len(ref), name
        for i, (a, b) in enumerate(zip(got, ref)):
            if i not in OWN[name]:
                assert a == b, (name, i)
    # K3 reads K1's screens and K2's centres where they wrote them.
    k1, k2, k3 = (args for _, args in planned)
    assert k2[0] == k3[0] == k1[10] and (k3[4], k3[5]) == (k2[18], k2[19])

    second = _step(config, words, starts, fracs, ema)
    assert not _storages(first) & _storages(second)
    for outs in (first, second):
        assert [(t.shape, t.dtype) for t in outs] == [(t.shape, t.dtype) for t in plain]
    counters = profiling.summary()["counters"]
    assert (counters["step.plan.builds"], counters["step.plan.reuses"]) == (1, 2)

    # A changed key builds a new plan, each once.
    two = torch.cat([words, words]), torch.cat([starts, starts + words.shape[0] // 2])
    changed = [
        (words[:-2], starts, fracs, ema, 0.1, 1),                       # the block's shape
        (*two, None if fracs is None else torch.cat([fracs, fracs]),
         torch.stack([ema, ema]), 0.1, 2),                               # n_streams
        (words, starts, fracs, ema, torch.tensor(0.1), 1),               # alpha a tensor
    ]
    if fracs is not None:
        changed.append((words, starts, None, ema, 0.1, 1))               # no residuals
    for i, args in enumerate(changed):
        for _ in range(2):
            _step(config, *args)
        counters = profiling.summary()["counters"]
        assert counters["step.plan.builds"] == 2 + i, i
        assert counters["step.plan.reuses"] == 3 + i, i
    assert len(offline._PLANS) == 1 + len(changed)


@pytest.mark.parametrize("launching", [False, True], ids=["plain", "launching"])
def test_counters_of_steps_of_one_geometry(launching, request):
    """N resident steps: one plan built, N - 1 reused; the cuts' bytes as
    the parent counted them, none of them pinned on the CPU; the launches as
    the parent's (none off the card; through the planned launches K1 once,
    K2 twice and K3 once a step, as the parent's step on the card)."""
    if launching:
        request.getfixturevalue("recording")
    config = _config("resident")
    step = offline.make_reconstruct_fn(config, device="cpu")
    words, _, _, ema = _inputs(config)
    n_steps = 5
    profiling.enable()
    for i in range(n_steps):
        ema = step(words, ema, 0.1, 0.25 + i)[0]
    counters = profiling.summary()["counters"]
    assert counters["step.plan.builds"] == 1
    assert counters["step.plan.reuses"] == n_steps - 1
    assert counters["step.upload_cuts.bytes"] == n_steps * 8 * config.n_frames
    assert counters["step.upload_cuts.pinned.bytes"] == 0
    launches = {k: v for k, v in counters.items() if k.startswith("launches.")}
    planned = n_steps - 1 if launching else 0
    assert launches == ({"launches.k1": planned, "launches.k2": 2 * planned,
                         "launches.k3": planned} if launching else {})


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the planned step launches the kernels")
    return torch.device("cuda", 0)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
def test_resident_steps_run_ahead_and_equal_the_wrappers():
    """24 steps of the resident cell's configuration over 8 blocks of int16
    words on the card, the EMA threaded, issued with no fence: after the
    key's first step nothing synchronises the stream, and every step's
    (ema, frames, sync, score), kept to the end, is the wrappers' to the
    bit."""
    dev = _card()
    config = offline.ReconstructionConfig(
        sample_rate=20e6, mode=tp.VideoMode(2576, 1125, 60.0), n_frames=36,
        render_size=(600, 800), input_format="iq_interleaved", carry_phase=True,
        subsample_align=True, align_subpixel=True, resampler="mxu3")
    n, spf = config.block_samples, config.samples_per_frame
    gen = torch.Generator(device=dev).manual_seed(23)
    words = torch.randint(-8192, 8192, (8, 2 * n), dtype=torch.int16, device=dev, generator=gen)
    phases = [(-b * n) % spf for b in range(8)]
    step = offline.make_reconstruct_fn(config, dev)
    ema = torch.zeros(config.render_size, dtype=torch.float32, device=dev)
    profiling.enable()
    kept = [step(words[0], ema, 0.1, phases[0])]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(1, 24):
            kept.append(step(words[i % 8], kept[-1][0], 0.1, phases[i % 8]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counters = profiling.summary()["counters"]
    profiling.disable()
    torch.cuda.synchronize()
    assert counters["step.plan.builds"] == 1 and counters["step.plan.reuses"] == 23
    assert counters["step.upload_cuts.pinned.bytes"] == counters["step.upload_cuts.bytes"]
    assert counters["step.upload_cuts.bytes"] == 24 * 8 * 36
    assert counters["launches.k1"] == 24 and counters["launches.k2"] == 48
    assert counters["launches.k3"] == 24

    ema = torch.zeros_like(ema)
    raster = (int(spf), 1125, 2576, (600, 800))
    for i, outs in enumerate(kept):
        starts, fracs = offline.exact_cut_starts(phases[i % 8], spf, 36)
        screens = resample_kernel.frames_to_screens_from_words(
            words[i % 8], torch.from_numpy(starts).to(dev), *raster,
            torch.from_numpy(fracs).to(dev), 2, bf16=True)
        s_y, s_x, score, sync = sync_kernel.blanking_sync(screens, subpixel=True, pairs=True)
        frames, ema = align_kernel.align_fold(screens, s_y, s_x, ema, 0.1, "linear")
        for name, got, ref in zip(("ema", "frames", "sync", "score"), outs,
                                  (ema, frames, sync, score)):
            assert got.shape == ref.shape and got.dtype == ref.dtype, (i, name)
            assert torch.equal(_bits(got), _bits(ref)), (i, name)
    # No two steps' outputs share storage.
    seen = set()
    for outs in kept:
        own = _storages(outs)
        assert not own & seen
        seen |= own
