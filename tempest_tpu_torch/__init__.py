"""tempest_tpu_torch — the PyTorch/CUDA port of ``tempest_tpu``.

Capture → image (``auto_reconstruct``: timing estimation, reconstruction,
MTF restoration) and the streaming reconstruction chain (AM or FM demod →
carry-phase frame cuts, rounded or exact to the sub-sample → signal→screen
resample → sub-pixel blanking sync → fractional alignment → EMA) in PyTorch,
with the resampler as a hand-written CUDA kernel for Hopper
(``csrc/resample.cu``); and wideband capture → carriers → fused image: the
band scan (``scan_band``), multi-harmonic combining (``combine_harmonics``,
``combined_reconstruct``, ``reconstruct_all_emissions``) and the same live in
the streaming runtime, with its tasks and operator console; and the operator
surface: the command line (``app.cli``), the web view
(``runtime.webview``), batched serving (``make_batched_reconstruct_fn``), the
video-mode search (``parallel.sharded.mode_search_static``) and every
``resampler=`` name of the JAX package; and the multi-device layer: device
meshes of one process or of one process a card (``parallel.mesh``,
``parallel.distributed``), the time-, stream-, candidate- and carrier-sharded
pipelines (``parallel.sharded``) and the live mesh runtime
(``runtime.mesh_stream``).  The sub-package layout mirrors ``tempest_tpu``;
this package imports ``torch`` and never ``jax``.

For authorized security research into electromagnetic side-channel leakage.
"""

from .video.modes import (
    VideoMode,
    ALL_VIDEO_MODES,
    find_closest_mode,
    find_closest_configuration,
    find_configuration,
    get_refresh_rates,
    candidate_modes,
)
from .io.dat import (
    read_complex_binary,
    write_complex_binary,
    iter_complex_blocks,
    num_samples,
)
from .io.synthetic import (
    SyntheticCapture,
    generate_iq,
    generate_iq_harmonics,
    render_frame,
    test_pattern,
)
from .ops.demod import (
    am_demod,
    am_demod_power,
    am_envelope_from_iq,
    fm_demod,
    fm_demod_rows,
    invert_am_demod,
    invert_envelope,
)
from .ops.autocorr import (
    autocorrelation,
    zoom_autocorr,
    estimate_refresh,
    estimate_line_count,
    top_line_period_peaks,
)
from .ops.spectrum import get_spectrum, get_welch, get_welch_sharded, get_waterfall
from .ops.scan import ScanResult, carrier_score, channelize, scan_band, scan_centers
from .ops.combine import CombineResult, combine_harmonics
from .ops.resample import (
    linear_resample,
    sig_to_image,
    downgrade_image,
    naive_upsample,
    upsample_fft,
    polyphase_resample,
    RENDER_SIZE,
)
from .ops.resample import frame_to_screen as frame_to_screen_gather
from .ops.enhance import interp_kernel_ft, restore_image, wiener_gain
from .ops.resample_kernel import (
    frames_to_screens,
    frames_to_screens_candidates,
    frames_to_screens_from_words,
    frame_to_screen,
)
from .ops.framesync import (
    frame_sync,
    frame_sync_subpixel,
    align_frame,
    align_frame_subpixel,
    blank_scores,
    contrast_scores,
    SyncSpec,
)
from .pipeline.offline import (
    TimingEstimate,
    TimingEvidence,
    ReconstructionConfig,
    Reconstruction,
    estimate_timing,
    timing_evidence,
    pick_line_peak,
    make_reconstruct_fn,
    make_batched_reconstruct_fn,
    reconstruct_frames,
    auto_reconstruct,
    combined_reconstruct,
    discover_screens,
    reconstruct_all_emissions,
)
from .render.screen import aligned_psnr, psnr
from .runtime.sources import ReplaySource, SyntheticSource
from .runtime.stream import StreamingRuntime, state_from_jax
from .runtime.console import OperatorConsole
from .runtime.webview import WebOperatorView
from .runtime.mesh_stream import MeshStreamingRuntime
from .parallel.mesh import Mesh, block_sharding, make_mesh, replicated
from .parallel.distributed import global_mesh, initialize, is_distributed
from .parallel.sharded import (
    ModeSearchResult,
    mode_search_static,
    sharded_batched_reconstruct_fn,
    sharded_combine_harmonics,
    sharded_combined_reconstruct_fn,
    sharded_mode_search,
    sharded_mode_search_2d,
    sharded_reconstruct_fn,
    sharded_scan_band,
    sharded_streaming_combine_front,
    sharded_streaming_reconstruct_fn,
)
from .utils.profiling import Metrics, annotate, trace
from .utils.roofline import H100_PEAKS, RooflineReport, roofline

__version__ = "0.1.0"
