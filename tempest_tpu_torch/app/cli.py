"""Command-line application — the framework's ``julia_main`` equivalent.

Covers the reference's app layer (``TempestSDR.jl:62-137``: ARGS parsing
with typed defaults and the ``gui()`` bootstrap) and its production scripts
(``production/investigate_data.jl`` offline analysis,
``production/record_signal.jl`` capture, ``production/runtime.jl`` headless
runtime) as argparse subcommands:

  analyze      timing estimation + mode inference on a capture (offline script)
  reconstruct  capture → reconstructed screen image(s)
  stream       streaming runtime over replay/synthetic source (headless gui())
  search       multi-mode hypothesis search
  scan         find emission carriers across a wideband capture
  survey       scan, fuse and reconstruct every screen of a wideband capture
  synth        generate a synthetic golden capture to .dat
  convert      re-encode a capture between .dat word formats
  warmup       build the kernels and run every chain once
  modes        list the video-mode database

The subcommands, their options and the printed lines are those of the JAX
package's CLI, so that an operator's scripts read both.  One option is this
port's own: ``--device`` on every command that computes, default the CUDA
card (the command fails when there is none), ``cpu`` to run on the CPU.
``stream --mesh N`` and ``search --dynamic --devices N`` shard over the
first N cards, or with ``--device`` over N shards on that one device (the
CPU, or one card).

Run ``python -m tempest_tpu_torch.app.cli <cmd> --help`` for options.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fs", type=float, default=20e6, help="sample rate [Hz] (default 20e6, the reference's recommended live rate)")
    p.add_argument("--format", default="single", choices=["short", "single", "double"], help=".dat word format")
    p.add_argument("--rate-min", type=float, default=50.0, help="refresh search band lower bound [Hz]")
    p.add_argument("--rate-max", type=float, default=90.0, help="refresh search band upper bound [Hz]")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="where to compute: default the CUDA card (an error when "
                        "there is none), or 'cpu'")


def _mesh(n: int | None, device: str | None):
    """The one-process mesh of ``--mesh``/``--devices``: the first ``n``
    cards (all of them when ``n`` is None), or ``n`` shards on ``--device``."""
    from ..parallel.mesh import make_mesh

    if device is None:
        return make_mesh(n)
    return make_mesh(devices=[device] * (n or 1))


def _mesh_block(block: int, n: int, combine: bool, fs: float, chan_bw: float) -> int:
    """The source block of ``stream --mesh n``: equal spans of the block, or
    with ``--combine`` the power-of-two channeliser window, whose channel
    length must split into ``n`` equal spans.  Refuses what it cannot split,
    rather than change the block behind the operator's back."""
    if n < 1:
        raise SystemExit(f"--mesh {n}: a mesh needs at least one shard")
    if not combine:
        if block < n:
            raise SystemExit(f"--mesh {n}: a block of {block} samples cannot be split into "
                             f"{n} spans; raise --block-seconds")
        return block - block % n
    from ..ops.scan import _channel_geometry

    # The lookahead tail must continue exactly where the previous envelope
    # ends, so the block IS the channeliser's FFT window.
    block = 1 << (max(block, 2).bit_length() - 1)
    _, m_chan, _ = _channel_geometry(block, fs, chan_bw)
    if block % n or m_chan % n:
        raise SystemExit(f"--mesh {n} with --combine: the power-of-two block of {block} "
                         f"samples ({m_chan} channel samples) does not split into {n} equal "
                         "spans; use a power-of-two mesh size")
    return block


def cmd_analyze(args: argparse.Namespace) -> int:
    from ..io.dat import read_complex_binary
    from ..pipeline.offline import estimate_timing, timing_evidence

    iq = read_complex_binary(args.input, args.format, count=args.samples)
    t0 = time.perf_counter()
    sig, is_env = iq, False
    if args.demod == "fm":
        from ..ops.demod import fm_demod_from_iq
        from ..utils.device import as_tensor

        words = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        sig = fm_demod_from_iq(as_tensor(words, args.device))
        is_env = True
    evidence = None
    pick_failed = False
    want_evidence = args.plots or args.peaks or args.pick_line_peak is not None
    if want_evidence:
        timing, evidence = timing_evidence(
            sig, args.fs, args.seconds, args.rate_min, args.rate_max,
            envelope=is_env, device=args.device,
        )
        if args.pick_line_peak is not None:
            from ..pipeline.offline import pick_line_peak

            try:
                timing = pick_line_peak(timing, evidence, args.pick_line_peak)
            except (IndexError, ValueError) as e:
                # Still print the ranked list below so the operator can pick
                # a valid index on the next run, but fail the command.
                print(f"error: --pick-line-peak {args.pick_line_peak}: {e}")
                pick_failed = True
    else:
        timing = estimate_timing(
            sig, args.fs, args.seconds, args.rate_min, args.rate_max,
            envelope=is_env, device=args.device,
        )
    dt = time.perf_counter() - t0
    print(f"samples           : {len(iq)} ({len(iq)/args.fs:.3f} s @ {args.fs/1e6:.1f} MHz)")
    print(f"refresh rate      : {timing.refresh_hz:.4f} Hz")
    print(f"line count (est)  : {timing.line_count:.1f}")
    print(f"closest mode      : {timing.mode_name}")
    print(f"mode geometry     : {timing.mode.width} x {timing.mode.height} @ {timing.mode.refresh:.3f} Hz")
    print(f"snr proxy         : {timing.snr_db:.1f} dB (suggested alpha {timing.suggested_alpha:.2f})")
    print(f"analysis time     : {dt*1e3:.1f} ms")
    if evidence is not None and evidence.line_peaks is not None and len(evidence.line_peaks):
        from ..video.modes import find_closest_mode

        # Ranked alternatives — the reference's click-the-other-peak recovery
        # (GUI.jl:512-523) as a printed list; re-run with --pick-line-peak N
        # (or reconstruct --pick-line-peak N) to adopt one.
        k = args.peaks or 5
        top = evidence.line_peaks[:k]
        s0 = max(float(top[0][2]), 1e-12)
        print("ranked line peaks :")
        for i, (lag, y, sc) in enumerate(top):
            name, _m = find_closest_mode(float(y), timing.refresh_hz)
            mark = " *picked" if args.pick_line_peak == i else ""
            print(f"  #{i}: lag {lag:9.2f} samples -> {y:7.1f} lines -> "
                  f"{name} (score {sc/s0:.2f}){mark}")
    if args.plots:
        from ..render.plots import render_line_plot, sparkline
        from ..render.screen import write_png

        # The two panels the reference GUI shows live (GUI.jl:296-356):
        # refresh-band autocorrelation and line-period lag window, detected
        # peaks marked.
        p1 = f"{args.plots}_refresh.png"
        write_png(render_line_plot(
            evidence.gamma_rates, marks=[evidence.rate_mark()]), p1)
        p2 = f"{args.plots}_lines.png"
        write_png(render_line_plot(
            evidence.gamma_lines, marks=[evidence.line_mark()]), p2)
        print(f"refresh evidence  : {p1} "
              f"[{evidence.rates_hz[0]:.1f}..{evidence.rates_hz[-1]:.1f} Hz] "
              f"peak {evidence.refresh_hz:.3f} Hz")
        print(f"  {sparkline(evidence.gamma_rates, mark=evidence.rate_mark())}")
        print(f"line evidence     : {p2} "
              f"[lags {evidence.line_lags[0]:.0f}..{evidence.line_lags[-1]:.0f} "
              f"samples] peak {evidence.line_lag:.2f} ({evidence.line_count:.1f} lines)")
        print(f"  {sparkline(evidence.gamma_lines, mark=evidence.line_mark())}")
    if args.waterfall:
        from ..ops.spectrum import get_waterfall
        from ..render.screen import write_png

        _, _, mat = get_waterfall(args.fs, np.ascontiguousarray(iq[: 1 << 21], np.complex64),
                                  fft_size=1024, device=args.device)
        power_db = 10.0 * np.log10(mat.cpu().numpy() + 1e-30)
        write_png(power_db, args.waterfall)
        print(f"waterfall         : wrote {args.waterfall} "
              f"({power_db.shape[1]} slices x {power_db.shape[0]} bins)")
    return 2 if pick_failed else 0


def cmd_reconstruct(args: argparse.Namespace) -> int:
    from ..io.dat import read_complex_binary
    from ..pipeline.offline import (
        ReconstructionConfig,
        auto_reconstruct,
        reconstruct_frames,
    )
    from ..render.screen import overlay_sync, write_png
    from ..video.modes import ALL_VIDEO_MODES

    iq = read_complex_binary(args.input, args.format, count=args.samples)
    alpha = args.alpha if args.alpha == "auto" else float(args.alpha)
    if args.combine == "all":
        from ..pipeline.offline import reconstruct_all_emissions

        results = reconstruct_all_emissions(
            iq, args.fs, chan_bw=args.chan_bw, n_frames=args.frames,
            alpha=alpha, invert=args.invert, rate_min=args.rate_min,
            rate_max=args.rate_max, restore=args.restore,
            restore_nsr=args.restore_nsr, demod=args.combine_demod,
            excise_db=args.excise, device=args.device,
        )
        if not results:
            print("no emissions detected in the band")
            return 2
        stem, dot, ext = args.out.rpartition(".")
        if not dot:
            stem, ext = args.out, "png"
        print(f"{len(results)} screen(s) detected")
        for i, (timing, recon, comb) in enumerate(results, 1):
            out = f"{stem}_{i}.{ext}" if len(results) > 1 else args.out
            print(f"screen {i}: {timing.mode_name} "
                  f"(fv={timing.refresh_hz:.4f} Hz), "
                  f"{len(comb.centers_hz)} carrier(s) at "
                  + ", ".join(f"{c/1e6:+.2f} MHz" for c in comb.centers_hz))
            write_png(recon.image, out, invert=args.invert_output)
            print(f"  wrote {out} ({recon.image.shape[1]}x"
                  f"{recon.image.shape[0]})")
        return 0
    if args.combine:
        from ..pipeline.offline import combined_reconstruct

        centers = (None if args.combine == "auto"
                   else [float(x) for x in args.combine.split(",")])
        try:
            timing, recon, comb = combined_reconstruct(
                iq, args.fs, centers, chan_bw=args.chan_bw,
                n_frames=args.frames, alpha=alpha, invert=args.invert,
                rate_min=args.rate_min, rate_max=args.rate_max,
                restore=args.restore, restore_nsr=args.restore_nsr,
                mode=(None if args.mode == "auto"
                      else ALL_VIDEO_MODES[args.mode]),
                demod=args.combine_demod,
                excise_db=args.excise, device=args.device,
            )
        except ValueError as e:
            # No emissions found by the auto-discovery scan.
            print(f"error: {e}")
            print("hint: `scan` the capture to see what the band contains, "
                  "or pass explicit carriers with --combine F1,F2")
            return 2
        print(f"detected mode: {timing.mode_name} "
              f"(fv={timing.refresh_hz:.4f} Hz)")
        for c, w, p, m in zip(comb.centers_hz, comb.weights, comb.polarity,
                              comb.mass_db):
            print(f"  carrier {c/1e6:+9.3f} MHz: weight {w:.3f} "
                  f"polarity {'+' if p > 0 else '-'} comb {m:.1f} dB")
    elif args.mode == "auto":
        try:
            timing, recon = auto_reconstruct(
                iq, args.fs, n_frames=args.frames, alpha=alpha,
                invert=args.invert, refine_with_search=args.search,
                rate_min=args.rate_min, rate_max=args.rate_max,
                align_subpixel=args.subpixel,
                pick_line_peak=args.pick_line_peak,
                restore=args.restore, restore_nsr=args.restore_nsr,
                demod=args.demod, device=args.device,
            )
        except (IndexError, ValueError) as e:
            if args.pick_line_peak is None:
                raise
            print(f"error: --pick-line-peak {args.pick_line_peak}: {e}")
            print("hint: run `analyze --peaks N` to list the ranked peaks")
            return 2
        print(f"detected mode: {timing.mode_name} (fv={timing.refresh_hz:.4f} Hz)")
    else:
        mode = ALL_VIDEO_MODES[args.mode]
        n_frames = args.frames or max(int(len(iq) * mode.refresh / args.fs) - 1, 1)
        config = ReconstructionConfig(
            sample_rate=args.fs, mode=mode, n_frames=n_frames, invert=args.invert,
            demod=args.demod,
            do_align=not args.no_align,
            # The config's default resampler: K1, which takes the exact
            # cuts' residuals itself.
            subsample_align=args.subsample_align,
            align_subpixel=args.subpixel,
        )
        recon = reconstruct_frames(
            iq, config, alpha=0.1 if alpha == "auto" else alpha, device=args.device
        )
        if args.restore:
            from ..ops.enhance import restore_image

            recon.image_raw = recon.image
            recon.image = restore_image(recon.image, config,
                                        nsr=args.restore_nsr, device=args.device)
    img = recon.image
    if args.sync_overlay:
        img = overlay_sync(img, int(recon.sync[-1][0]), int(recon.sync[-1][1]))
    invert_out = args.invert_output
    if args.auto_polarity:
        invert_out = not recon.blanking_is_dark
        print(f"polarity: blanking is {'dark' if recon.blanking_is_dark else 'bright'}"
              f" -> {'inverting' if invert_out else 'keeping'} output")
    write_png(img, args.out, invert=invert_out)
    print(f"wrote {args.out} ({img.shape[1]}x{img.shape[0]}), "
          f"{recon.frames.shape[0]} frames averaged, "
          f"sync score {recon.score.mean():.3g}")
    return 0


def cmd_stream(args: argparse.Namespace) -> int:
    from ..render.screen import FileRenderer, TerminalRenderer
    from ..runtime.sources import open_source
    from ..runtime.stream import StreamingRuntime
    from ..video.modes import ALL_VIDEO_MODES

    mode = ALL_VIDEO_MODES[args.mode]
    block = int(args.fs * args.block_seconds)
    if args.mesh is not None:
        block = _mesh_block(block, args.mesh, bool(args.combine), args.fs, args.chan_bw)
    source = open_source(
        args.source,
        sample_rate=args.fs,
        block_size=block,
        path=args.file,
        mode=mode,
        snr_db=args.snr,
    )
    overrides = {}
    if args.resampler:
        overrides["resampler"] = args.resampler
    if args.num_phases:
        overrides["num_phases"] = args.num_phases
    if args.interp_taps:
        overrides["interp_taps"] = args.interp_taps
    if args.einsum_bf16:
        overrides["einsum_bf16"] = True
    if args.demod != "am":
        # Single-carrier live FM: the chain's demod stage is a config field
        # (ops.demod.fm_demod_from_iq); with --combine active the per-channel
        # front demodulates instead (--combine-demod) and the chain reads the
        # fused envelope.
        if args.combine:
            raise SystemExit("--demod applies to the single-carrier chain; "
                             "with --combine use --combine-demod")
        overrides["demod"] = args.demod
    # With --drift-lock the warm-up needs per-frame sync measurements, so
    # fidelity mode (which skips sync) is switched on after the lock.
    combine = None
    if args.combine and args.combine != "auto":
        combine = [float(x) for x in args.combine.split(",")]
    options = dict(alpha=args.alpha, invert=args.invert,
                   fidelity=args.fidelity and not args.drift_lock,
                   fidelity_bins=args.fidelity_bins, ring_impl=args.ring,
                   config_overrides=overrides or None, combine=combine,
                   combine_bw=args.chan_bw, combine_demod=args.combine_demod,
                   combine_excise_db=args.excise)
    if args.mesh is not None:
        # Live streaming over a mesh: each ring block split into N time
        # spans, one a shard (halos, the associative EMA combine, one block
        # of lookahead); --fidelity and --combine compose with it.
        from ..runtime.mesh_stream import MeshStreamingRuntime

        rt = MeshStreamingRuntime(source, mode, _mesh(args.mesh, args.device), **options)
    else:
        rt = StreamingRuntime(source, mode, device=args.device, **options)
    if args.render == "terminal":
        sink = TerminalRenderer(crosshair=args.crosshair)
    elif args.render == "png":
        sink = FileRenderer(prefix=args.out_prefix, every=args.every,
                            crosshair=args.crosshair)
    else:
        sink = None
    if args.resume:
        rt.load_checkpoint(args.resume)
        print(f"resumed from {args.resume} ({rt.frames_out} frames so far)")
    rt.start()
    try:
        if args.combine == "auto":
            centers = rt.combine_auto()
            if centers:
                print("live combine: "
                      + ", ".join(f"{c/1e6:+.2f} MHz" for c in centers))
            else:
                print("live combine: no emissions detected, combining off")
        if args.correlate:
            timing = rt.correlate(rate_min=args.rate_min, rate_max=args.rate_max,
                                  keep_evidence=True)
            print(f"live correlate: {timing.mode_name} fv={timing.refresh_hz:.4f} Hz")
            print(f"  {rt.corr_spark}")
        if args.record:
            # "auto" rotates dumpIQ_N.dat files like the reference's task 3.
            path = None if args.record == "auto" else args.record
            n = rt.record(path, n_blocks=args.record_blocks, fmt=args.format)
            print(f"recorded {n} samples to {rt.last_record_path}")
        if args.drift_lock:
            # Warm-up pass, then close the refresh loop on the observed drift.
            syncs = []
            warm = max(args.blocks // 4, 2)
            rt.process_blocks(warm, sink=lambda img, info: syncs.append(info["sync"]))
            fv = rt.refine_refresh_from_drift(np.concatenate(syncs))
            print(f"drift lock: refined refresh to {fv:.5f} Hz")
            if args.fidelity:
                rt.set_fidelity(True)
                print("fidelity mode: sub-sample-exact cuts, sync skipped")
        if args.web is not None:
            # Live web operator view (the reference's one-window GUI —
            # image + correlation panels + controls, GUI.jl:296-356 — over
            # zero-dependency localhost HTTP); runs until `quit` is posted.
            from ..runtime.webview import WebOperatorView

            web = WebOperatorView(rt, port=args.web, crosshair=args.crosshair,
                                  extra_sink=sink)
            print(f"web operator view: http://{web.host}:{web.port}/ "
                  "(post `quit` or Ctrl-C to stop)")
            web.run()
        elif args.console:
            # Live operator session (the reference's interactive GUI layer,
            # GUI.jl:394-658, as a stdin command loop) — runs until `quit`
            # or EOF; --blocks does not apply.
            from ..runtime.console import HELP, OperatorConsole

            print(HELP)
            OperatorConsole(rt, sink, crosshair=args.crosshair).run()
        elif args.drift_lock:
            rt.process_blocks(args.blocks - warm, sink)
        else:
            rt.process_blocks(args.blocks, sink)
    finally:
        rt.stop()
    if args.checkpoint:
        rt.save_checkpoint(args.checkpoint)
        print(f"checkpointed streaming state to {args.checkpoint}")
    print(rt.summary())
    print("health:", rt.health())
    return 0


def cmd_search(args: argparse.Namespace) -> int:
    from ..io.dat import read_complex_binary
    from ..parallel.sharded import mode_search_static
    from ..pipeline.offline import estimate_timing
    from ..video.modes import candidate_modes

    iq = read_complex_binary(args.input, args.format, count=args.samples)
    timing = estimate_timing(iq, args.fs, device=args.device)
    cands = candidate_modes(timing.refresh_hz, tol_hz=args.tol)
    if args.dynamic:
        # The candidates split over a mesh, each scored with its exact line
        # table at the full screen size.
        from ..parallel.sharded import sharded_mode_search

        mesh = _mesh(args.devices, args.device)
        print(f"fv = {timing.refresh_hz:.4f} Hz; scoring {len(cands)} "
              f"candidate modes on {mesh.shape['blocks']} devices")
        res = sharded_mode_search(iq, args.fs, timing.refresh_hz, cands, mesh,
                                  n_frames=args.frames or 2)
    else:
        # Static scoring: one K1 launch over the candidate geometries on a small
        # score grid; also what auto_reconstruct(refine_with_search=True) uses.
        print(f"fv = {timing.refresh_hz:.4f} Hz; static-table scoring "
              f"{len(cands)} candidate modes")
        res = mode_search_static(iq, args.fs, timing.refresh_hz, cands,
                                 n_frames=args.frames or 2, device=args.device)
    order = np.argsort(res.scores)[::-1]
    for rank, i in enumerate(order[:10]):
        marker = " <== best" if i == res.best_index else ""
        print(f"{rank+1:2d}. {res.names[i]:40s} score {res.scores[i]:.4g}{marker}")
    return 0


def cmd_synth(args: argparse.Namespace) -> int:
    from ..io.dat import write_complex_binary
    from ..io.synthetic import generate_iq, generate_iq_harmonics
    from ..video.modes import ALL_VIDEO_MODES

    mode = ALL_VIDEO_MODES[args.mode]
    n = int(args.fs * args.seconds)
    if args.harmonics:
        carriers = [float(x) for x in args.harmonics.split(",")]
        cap = generate_iq_harmonics(mode, args.fs, n, carriers,
                                    snr_db=args.snr, seed=args.seed,
                                    modulation=args.modulation,
                                    deviation_hz=args.deviation)
        extra = f", {len(carriers)} carriers"
    else:
        cap = generate_iq(mode, args.fs, n, snr_db=args.snr, seed=args.seed,
                          modulation=args.modulation)
        extra = ""
    write_complex_binary(cap.iq, args.out, args.format)
    print(f"wrote {args.out}: {len(cap.iq)} samples of {args.mode} "
          f"@ {args.fs/1e6:.1f} MHz, SNR {args.snr} dB{extra}")
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    """Re-encode a capture between .dat word formats (the reference's
    ``production/convert_dat32_dat64.jl``)."""
    from ..io.dat import read_complex_binary, write_complex_binary

    x = read_complex_binary(args.input, args.from_format)
    write_complex_binary(x, args.output, args.to_format)
    print(f"converted {len(x)} samples: {args.input} ({args.from_format}) "
          f"-> {args.output} ({args.to_format})")
    return 0


def cmd_warmup(args: argparse.Namespace) -> int:
    """Make a live session start hot — the role PackageCompiler sysimages
    play for the reference (``production/script_compilation.jl``,
    ``docs/src/precompilation.md``).  On the card that means: build the CUDA
    kernel library and the native ring into the package's ``_build/``
    directory (they are built at first use otherwise), and run every chain
    once for the given modes and rate, so that the CUDA context, the FFT
    plans and the kernel library are loaded.  Each step prints its time."""
    import torch

    from ..native import native_available
    from ..pipeline.offline import (
        ReconstructionConfig,
        estimate_timing,
        make_reconstruct_fn,
    )
    from ..utils.device import resolve_device
    from ..video.modes import ALL_VIDEO_MODES

    device = resolve_device(args.device)
    if args.cache_dir:
        print(f"--cache-dir {args.cache_dir}: ignored, nothing here compiles at run time; "
              "the kernels are built once into the package's _build/ directory")

    def fence() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        from .. import _build

        t0 = time.perf_counter()
        lib = _build.load_library("resample")
        print(f"built kernels ({lib.path}): {time.perf_counter()-t0:.1f} s")
    t0 = time.perf_counter()
    print(f"native ring {'built' if native_available() else 'unavailable (no C++ compiler)'}: "
          f"{time.perf_counter()-t0:.1f} s")

    def run_once(label: str, cfg, dtype, *phase) -> None:
        step = make_reconstruct_fn(cfg, device)
        iq = torch.zeros(2 * cfg.block_samples, dtype=dtype, device=device)
        ema = torch.zeros(cfg.render_size, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        step(iq, ema, 0.1, *phase)
        fence()
        print(f"compiled {label}: {time.perf_counter()-t0:.1f} s")

    mode_names = args.modes or ["1920x1080 @ 60Hz"]
    for name in mode_names:
        mode = ALL_VIDEO_MODES[name]
        base = dict(sample_rate=args.fs, mode=mode, n_frames=args.frames,
                    input_format="iq_interleaved")
        # Streaming path: float32 interleaved + carry_phase (what
        # StreamingRuntime feeds).
        run_once(f"{name} (stream/f32)", ReconstructionConfig(carry_phase=True, **base),
                 torch.float32, 0.0)
        # Batch path: int16 ingest without phase carry.
        run_once(f"{name} (batch/int16)", ReconstructionConfig(**base), torch.int16)
        # Streaming fidelity path: exact cuts through K1's residuals, sync skipped.
        fid = ReconstructionConfig(carry_phase=True, subsample_align=True, do_align=False,
                                   **base)
        run_once(f"{name} (stream fidelity)", fid, torch.float32, 0.0)
        # Exact cuts with the sub-pixel sync on top.
        run_once(f"{name} (exact cuts+subpixel sync)",
                 dataclasses.replace(fid, do_align=True, align_subpixel=True), torch.float32, 0.0)
    # Timing estimator too.
    n = int(args.fs * 0.2)
    t0 = time.perf_counter()
    estimate_timing(torch.ones(2 * n, dtype=torch.float32, device=device), args.fs)
    fence()
    print(f"compiled timing estimator: {time.perf_counter()-t0:.1f} s")
    return 0


def cmd_survey(args: argparse.Namespace) -> int:
    """One-shot wideband survey: scan the band, group emissions into
    screens, fuse and reconstruct every screen, and write a small report
    directory (band plot + one PNG per monitor + text summary).  The whole
    workflow the reference operator performs by hand across its waterfall,
    textboxes and plots (``GUI.jl:394-658``), as one command."""
    import os

    from ..io.dat import read_complex_binary
    from ..ops.scan import scan_band, scan_centers
    from ..pipeline.offline import combined_reconstruct
    from ..render.plots import render_line_plot
    from ..render.screen import write_png

    iq = read_complex_binary(args.input, args.format, count=args.samples)
    os.makedirs(args.out, exist_ok=True)
    step = args.bw / 2.0
    centers = scan_centers(args.fs, step, guard_hz=args.bw / 2.0)
    if not len(centers):
        print("error: no candidate centers fit the band — lower --bw")
        return 2
    words = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    res = scan_band(words, args.fs, centers, chan_bw=args.bw,
                    corr_seconds=args.seconds,
                    rate_min=args.rate_min, rate_max=args.rate_max,
                    demod=args.demod, device=args.device)
    lines = [f"survey of {args.input}: {len(centers)} channels x "
             f"{res.fs_channel/1e6:.2f} MHz"]
    ems = res.emissions(min_margin_db=args.margin)
    # Band evidence plot: per-channel screen-ness in center order, emission
    # centroids marked.
    order = np.argsort(res.centers_hz)
    span = res.centers_hz[order[-1]] - res.centers_hz[order[0]] or 1.0
    marks = tuple((e["center_hz"] - res.centers_hz[order[0]]) / span
                  for e in ems)
    write_png(render_line_plot(res.prominence_db[order], marks=marks),
              os.path.join(args.out, "band.png"))
    if not ems:
        lines.append("no emissions above the detection threshold")
        print("\n".join(lines))
        (open(os.path.join(args.out, "survey.txt"), "w")
         .write("\n".join(lines) + "\n"))
        return 2
    # Group emissions into screens by exact refresh agreement (reuse the
    # sweep already run above).
    from ..pipeline.offline import discover_screens

    screens = discover_screens(words, args.fs, args.bw,
                               min_margin_db=args.margin, scan_result=res)
    lines.append(f"{len(ems)} emission(s) in {len(screens)} screen(s)")
    alpha = args.alpha if args.alpha == "auto" else float(args.alpha)
    for i, group in enumerate(screens, 1):
        centers_hz = [e["best_channel_hz"] for e in group]
        timing, recon, comb = combined_reconstruct(
            iq, args.fs, centers_hz, chan_bw=args.bw, alpha=alpha,
            rate_min=args.rate_min, rate_max=args.rate_max,
            demod=args.demod, device=args.device)
        png = os.path.join(args.out, f"screen_{i}.png")
        write_png(recon.image, png)
        lines.append(
            f"screen {i}: {timing.mode_name} (fv={timing.refresh_hz:.4f} "
            f"Hz), {len(centers_hz)} carrier(s) at "
            + ", ".join(f"{c/1e6:+.2f} MHz" for c in centers_hz)
            + f" -> {png}")
        for c, w, p, m in zip(comb.centers_hz, comb.weights, comb.polarity,
                              comb.mass_db):
            lines.append(f"    carrier {c/1e6:+9.3f} MHz: weight {w:.3f} "
                         f"polarity {'+' if p > 0 else '-'} "
                         f"comb {m:.1f} dB")
    text = "\n".join(lines)
    print(text)
    with open(os.path.join(args.out, "survey.txt"), "w") as f:
        f.write(text + "\n")
    print(f"report written to {args.out}/")
    return 0


def cmd_scan(args: argparse.Namespace) -> int:
    from ..io.dat import read_complex_binary
    from ..ops.scan import scan_band, scan_centers

    iq = read_complex_binary(args.input, args.format, count=args.samples)
    step = args.step if args.step is not None else args.bw / 2.0
    centers = scan_centers(args.fs, step, guard_hz=args.bw / 2.0)
    if not len(centers):
        print("error: no candidate centers fit the band — lower --bw/--step")
        return 2
    t0 = time.perf_counter()
    res = scan_band(iq, args.fs, centers, chan_bw=args.bw,
                    corr_seconds=args.seconds,
                    rate_min=args.rate_min, rate_max=args.rate_max, device=args.device)
    dt = time.perf_counter() - t0
    print(f"scanned {len(centers)} channels x {res.fs_channel/1e6:.2f} MHz "
          f"in {dt*1e3:.0f} ms (one batched program)")
    print("rank  offset [MHz]  comb mass [dB]  screen-ness [dB]  refresh [Hz]")
    for r, i in enumerate(res.ranking()[: args.top]):
        print(f"  #{r}  {res.centers_hz[i]/1e6:+11.3f} "
              f"{res.scores_db[i]:15.1f} {res.prominence_db[i]:17.1f} "
              f"{res.refresh_hz[i]:13.3f}")
    ems = res.emissions()
    if ems:
        print(f"emissions         : {len(ems)} distinct "
              "(contiguous detecting channels grouped)")
        for e in ems:
            lo, hi = e["span_hz"]
            print(f"  {e['center_hz']/1e6:+8.3f} MHz centroid "
                  f"[channels {lo/1e6:+.1f}..{hi/1e6:+.1f}], refresh "
                  f"{e['refresh_hz']:.3f} Hz, screen-ness "
                  f"{e['prominence_db']:.1f} dB "
                  f"(noise floor {e['floor_db']:.1f} dB)")
    else:
        print("emissions         : none above the detection threshold")
    c, s, fv = res.best()
    print(f"best candidate    : {c/1e6:+.3f} MHz off capture center "
          f"(refresh {fv:.3f} Hz)")
    print("next              : retune there and run `analyze`/`reconstruct` "
          "on a narrowband capture")
    return 0


def cmd_modes(args: argparse.Namespace) -> int:
    from ..video.modes import ALL_VIDEO_MODES

    for name, m in sorted(ALL_VIDEO_MODES.items(), key=lambda kv: (kv[1].refresh, kv[1].height)):
        print(f"{name:40s} total {m.width:5d} x {m.height:5d} @ {m.refresh:5.1f} Hz "
              f"(pixel clock {m.pixel_clock/1e6:7.1f} MHz)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tempest-tpu-torch",
        description="TEMPEST screen-emanation reconstruction in PyTorch on a CUDA card "
                    "(authorized security research use)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("analyze", help="estimate timing + infer video mode from a capture")
    p.add_argument("input")
    _add_common(p)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--seconds", type=float, default=0.1, help="autocorrelation window")
    p.add_argument("--plots", default=None, metavar="PREFIX",
                   help="write the correlation-evidence panels (refresh band "
                        "+ line-period window, detected peaks marked) as "
                        "PREFIX_refresh.png / PREFIX_lines.png")
    p.add_argument("--waterfall", default=None, help="write a waterfall PNG here")
    p.add_argument("--peaks", type=int, default=0, metavar="K",
                   help="print the top-K ranked line-period peaks with their "
                        "mode matches (the reference's interactive peak pick, "
                        "GUI.jl:512-523, as a list)")
    p.add_argument("--pick-line-peak", type=int, default=None, metavar="N",
                   help="adopt ranked line peak N (0-based) instead of the "
                        "automatic lock")
    p.add_argument("--demod", default="am", choices=["am", "fm"],
                   help="demodulator for the timing statistics (a constant-"
                        "amplitude FM capture has a flat envelope — the AM "
                        "statistic cannot find its refresh)")
    _add_device(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("reconstruct", help="reconstruct the screen from a capture")
    p.add_argument("input")
    _add_common(p)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--mode", default="auto", help="'auto' or a mode name from `modes`")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--alpha", default="0.1",
                   help="EMA coefficient, or 'auto' (SNR-adaptive)")
    p.add_argument("--invert", action="store_true", help="use inverted envelope")
    p.add_argument("--demod", default="am", choices=["am", "fm"],
                   help="demodulator for the single-carrier chain (the "
                        "reference GUI's selector incl. fmDemod; timing "
                        "estimation and mode search follow)")
    p.add_argument("--invert-output", action="store_true")
    p.add_argument("--auto-polarity", action="store_true",
                   help="invert the output automatically if blanking is bright")
    p.add_argument("--sync-overlay", action="store_true", help="draw sync crosshair")
    p.add_argument("--subsample-align", action="store_true",
                   help="sub-sample-exact frame cuts (highest fidelity with "
                        "--no-align; explicit --mode only)")
    p.add_argument("--no-align", action="store_true",
                   help="skip per-frame sync alignment (explicit --mode only)")
    p.add_argument("--subpixel", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="sub-pixel sync registration (parabolic peak + "
                        "fractional circular shift) — shift-and-add "
                        "accumulation, default ON; "
                        "--no-subpixel restores integer circshift")
    p.add_argument("--search", action="store_true",
                   help="refine the detected mode by sync-score search over "
                        "the video modes near the measured refresh")
    p.add_argument("--pick-line-peak", type=int, default=None, metavar="N",
                   help="with --mode auto: adopt ranked line peak N instead "
                        "of the automatic lock (see analyze --peaks)")
    p.add_argument("--restore", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Wiener-invert the chain's known resampling/"
                        "registration MTF on the final average "
                        "(--no-restore keeps the raw EMA)")
    p.add_argument("--restore-nsr", type=float, default=0.002,
                   help="Wiener noise-to-signal floor (raise for noisy/"
                        "shallow averages)")
    p.add_argument("--combine", default=None, metavar="AUTO|ALL|F1,F2,...",
                   help="multi-harmonic fusion: channelise the wideband "
                        "capture at these carrier offsets [Hz] ('auto' "
                        "scans the band and groups same-refresh emissions; "
                        "'all' reconstructs EVERY distinct screen found, "
                        "one image per screen), MRC-combine the envelopes, "
                        "reconstruct the fusion")
    p.add_argument("--chan-bw", type=float, default=4e6,
                   help="per-carrier channel bandwidth for --combine [Hz]")
    p.add_argument("--combine-demod", default="am", choices=["am", "fm"],
                   help="per-channel demodulator for --combine: 'fm' runs "
                        "the discriminator (frequency-leaking targets; the "
                        "discovery sweep switches statistic too)")
    p.add_argument("--excise", type=float, default=None, metavar="DB",
                   help="null in-channel CW interference louder than each "
                        "channel's carrier peak by this margin (dB; 0 is a "
                        "good setting) before demod — recovers a hit "
                        "channel instead of just down-weighting it")
    p.add_argument("--out", default="reconstruction.png")
    _add_device(p)
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("stream", help="streaming runtime (replay or synthetic source)")
    _add_common(p)
    p.add_argument("--source", default="synthetic",
                   choices=["synthetic", "radiosim", "replay", "uhd", "pluto", "bladerf", "rtlsdr"])
    p.add_argument("--file", default=None, help="capture for replay source")
    p.add_argument("--mode", default="1920x1080 @ 60Hz")
    p.add_argument("--block-seconds", type=float, default=0.1)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--snr", type=float, default=20.0)
    p.add_argument("--invert", action="store_true")
    p.add_argument("--correlate", action="store_true", help="auto-detect mode first")
    p.add_argument("--record", default=None,
                   help="record raw IQ to this .dat ('auto' rotates dumpIQ_N.dat)")
    p.add_argument("--record-blocks", type=int, default=10)
    p.add_argument("--render", default="none", choices=["none", "terminal", "png"])
    p.add_argument("--drift-lock", action="store_true",
                   help="refine the refresh rate from observed sync drift")
    p.add_argument("--fidelity", action="store_true",
                   help="sub-sample-exact frame cuts, per-frame sync skipped "
                        "(highest measured fidelity; combine with --drift-lock "
                        "warm-up so the frame grid stays locked)")
    p.add_argument("--checkpoint", default=None, help="save streaming state here on exit")
    p.add_argument("--resume", default=None, help="resume streaming state from checkpoint")
    p.add_argument("--out-prefix", default="frame")
    p.add_argument("--every", type=int, default=1)
    p.add_argument("--console", action="store_true",
                   help="interactive operator console on stdin (nudge lines, "
                        "correlate, pick peaks, record, fidelity, ... — the "
                        "reference's GUI controls as commands; `help` lists "
                        "them); runs until `quit`/EOF")
    p.add_argument("--web", type=int, default=None, metavar="PORT",
                   help="live web operator view on localhost:PORT — image + "
                        "correlation panels + full command surface in a "
                        "browser (the reference's one-window GUI, zero "
                        "dependencies); runs until `quit` is posted")
    p.add_argument("--crosshair", action="store_true",
                   help="overlay the detected sync position on the live view "
                        "(displayScreen_vsync! parity)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="stream through the mesh runtime: each block split "
                        "into N time spans over the first N cards (with "
                        "--device: N shards on that device)")
    p.add_argument("--ring", default="python", choices=["python", "native"],
                   help="host ring buffer implementation (native = C++, "
                        "GIL-free)")
    p.add_argument("--fidelity-bins", type=int, default=64,
                   help="the JAX runtime's carry-phase quantisation bins "
                        "for --fidelity; kept and checkpointed, changes no "
                        "value here (K1 takes each frame's exact residual)")
    p.add_argument("--resampler", default=None,
                   help="override the resampler (pallas = K1, the default; "
                        "mxu/mxu2/mxu3/mxu4/mxu_batched/aligned/rows/gather/"
                        "fft keep the JAX package's values)")
    p.add_argument("--num-phases", type=int, default=None,
                   help="fractional-phase quantisation of the mxu resamplers")
    p.add_argument("--interp-taps", type=int, default=None, choices=[2, 4],
                   help="interpolation order: 2=linear, 4=Catmull-Rom")
    p.add_argument("--combine", default=None, metavar="AUTO|F1,F2,...",
                   help="live multi-harmonic fusion: channelise every block "
                        "at these carrier offsets [Hz] and reconstruct the "
                        "MRC-fused envelope ('auto' scans the live stream "
                        "for the strongest screen's harmonics first)")
    p.add_argument("--chan-bw", type=float, default=4e6,
                   help="per-carrier channel bandwidth for --combine [Hz]")
    p.add_argument("--combine-demod", default="am", choices=["am", "fm"],
                   help="per-channel demodulator of the live combine front")
    p.add_argument("--demod", default="am", choices=["am", "fm"],
                   help="single-carrier demodulator of the live chain "
                        "(FM discriminator for targets leaking the video "
                        "in carrier frequency; combine fronts use "
                        "--combine-demod instead)")
    p.add_argument("--excise", type=float, default=None, metavar="DB",
                   help="live CW excision margin over the carrier peak "
                        "(dB) in the combine front")
    p.add_argument("--einsum-bf16", action="store_true",
                   help="the JAX package's bfloat16 weights einsum; accepted, "
                        "changes no value here (K1 forms its weights in "
                        "float32)")
    _add_device(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("search", help="multi-mode hypothesis search")
    p.add_argument("input")
    _add_common(p)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--tol", type=float, default=2.0, help="refresh tolerance [Hz]")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="shards of --dynamic (default: every card; with "
                        "--device, one)")
    p.add_argument("--dynamic", action="store_true",
                   help="score every candidate with its exact geometry at "
                        "the full screen size, the candidates split over a "
                        "mesh (--devices)")
    p.add_argument("--fast", action="store_true",
                   help="(deprecated, now the default) static-table scoring")
    _add_device(p)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser(
        "scan",
        help="find emission carriers across a wideband capture (batched "
             "channeliser + refresh-comb scoring; the reference operator "
             "hunts this by eye on the waterfall)")
    p.add_argument("input")
    _add_common(p)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--bw", type=float, default=4e6,
                   help="channel bandwidth to extract per candidate [Hz]")
    p.add_argument("--step", type=float, default=None,
                   help="candidate center spacing [Hz] (default bw/2)")
    p.add_argument("--seconds", type=float, default=0.1,
                   help="autocorrelation window per channel")
    p.add_argument("--top", type=int, default=8, help="candidates to print")
    _add_device(p)
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser(
        "survey",
        help="one-shot wideband survey: scan the band, fuse each screen's "
             "harmonics, reconstruct every monitor, write a report dir "
             "(band plot + per-screen PNGs + summary)")
    p.add_argument("input")
    _add_common(p)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--bw", type=float, default=4e6,
                   help="channel bandwidth per candidate carrier [Hz]")
    p.add_argument("--seconds", type=float, default=0.1,
                   help="autocorrelation window per channel")
    p.add_argument("--margin", type=float, default=5.0,
                   help="detection margin over the measured noise floor [dB]")
    p.add_argument("--alpha", default=0.7,
                   help="EMA coefficient for the reconstructions")
    p.add_argument("--demod", default="am", choices=["am", "fm"],
                   help="per-channel statistic/demodulator for the sweep "
                        "and the fusions (FM-leaking targets)")
    p.add_argument("--out", default="survey",
                   help="report directory")
    _add_device(p)
    p.set_defaults(fn=cmd_survey)

    p = sub.add_parser("synth", help="generate a synthetic golden capture")
    _add_common(p)
    p.add_argument("--mode", default="1920x1080 @ 60Hz")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--snr", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--harmonics", default=None, metavar="F1,F2,...",
                   help="radiate the screen at several carrier offsets [Hz] "
                        "(one shared envelope — the --combine test fixture)")
    p.add_argument("--modulation", default="am", choices=["am", "fm"],
                   help="leakage model: 'fm' rides each carrier at constant "
                        "amplitude with the video in its frequency")
    p.add_argument("--deviation", type=float, default=None,
                   help="FM peak deviation [Hz] (default fs/64; keep inside "
                        "the combiner's channel half-bandwidth)")
    p.add_argument("--out", default="synthetic.dat")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("convert", help="re-encode a capture between .dat formats")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--from-format", default="single", choices=["short", "single", "double"])
    p.add_argument("--to-format", default="double", choices=["short", "single", "double"])
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("warmup", help="build the kernels and run every chain once "
                                      "(sysimage analogue)")
    _add_common(p)
    p.add_argument("--modes", nargs="*", default=None)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--cache-dir", default=None,
                   help="accepted for the JAX CLI's scripts and ignored: "
                        "nothing here compiles at run time, and the kernel "
                        "library is built once into the package's _build/ "
                        "directory")
    _add_device(p)
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("modes", help="list the video-mode database")
    p.set_defaults(fn=cmd_modes)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
