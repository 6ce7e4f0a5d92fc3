"""K3, alignment fused with the EMA fold (``tempest_tpu_torch.ops.align_kernel``):
its wrapper, its cost count, its plain version against the JAX package's
``align_frame*`` and ``ema_fold``, the fold's algebra, and — on a card — the
kernel against its plain version.

Tolerances.  Against the JAX package on the CPU: aligned frames within 1e-6
(the same taps and weights in the same order; XLA may contract a product
and a sum), integer shifts equal; the EMA within ``FOLD_REL`` = 1e-6 of its
largest value, because the JAX ``einsum`` adds the F products in its own
order where the fold adds them in frame order (F roundings of 2⁻²⁴ at most,
F = 5 here).  The plain batched fold equals B single folds, and the fold
from a zero image composed as ``A·e + B`` equals the fold of ``e``, to the
bit: the same operations on the same values.  On the card the kernel equals
its plain version to the bit (every product and sum one rounding, in the
plain version's order, no FMA), aligned frames and EMA; against
``torch.tensordot`` (the fold before K3, cuBLAS's order) the EMA is held to
``FOLD_REL``.  The JAX package is imported inside the parity tests, so that
the ``cuda`` cases run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_align_ema.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.ops import align_kernel
from tempest_tpu_torch.ops.align_kernel import align_fold, align_fold_plain, fold_weights
from tempest_tpu_torch.pipeline import offline as poff

SHAPES = ((30, 40), (60, 80))
N_FRAMES = 5
ALPHA = 0.7
FOLD_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(shape, n_streams=1, seed=3, integer=False):
    """Frames, shifts (fractional, negative, past the edge and exact
    integers among them) and an EMA image, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    h, w = shape
    n = n_streams * N_FRAMES
    frames = rng.random((n, h, w), dtype=np.float32)
    s_y = rng.uniform(-h, 2 * h, n).astype(np.float32)
    s_x = rng.uniform(-w, 2 * w, n).astype(np.float32)
    s_y[0], s_x[0] = 3.0, -1.0
    if integer:
        s_y, s_x = np.floor(s_y).astype(np.int32), np.floor(s_x).astype(np.int32)
    ema = rng.random((n_streams, h, w), dtype=np.float32)
    return frames, s_y, s_x, ema


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _jax():
    return (pytest.importorskip("tempest_tpu.ops.framesync"),
            pytest.importorskip("tempest_tpu.pipeline.offline"),
            pytest.importorskip("jax.numpy"))


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("bad", ["align", "shifts", "ema_shape", "streams", "fold_needs_ema"])
def test_wrapper_checks_its_arguments(bad):
    frames, s_y, s_x, ema = _torch(*_inputs(SHAPES[0], n_streams=2))
    with pytest.raises(ValueError):
        if bad == "align":
            align_fold(frames, s_y, s_x, align="nearest")
        elif bad == "shifts":
            align_fold(frames, s_y[:3], s_x)
        elif bad == "ema_shape":
            align_fold(frames, s_y, s_x, ema[0], ALPHA, n_streams=2)
        elif bad == "streams":
            align_fold(frames, s_y, s_x, ema, ALPHA, n_streams=3)
        else:
            align_fold(frames, align=None)


@pytest.mark.parametrize("align", [None, "integer", "linear", "cubic"])
def test_launch_cost_counts_each_byte_once(align):
    n_streams, h, w = 2, 30, 40
    n = n_streams * N_FRAMES
    nbytes, flops = align_kernel.launch_cost(n, h, w, n_streams, align, align is not None, True)
    taps = align_kernel.ALIGN_MODES[align]
    tables = 0 if not taps else 16 * n + (8 * taps * n if taps > 1 else 0)
    ema = 2 * 4 * n_streams * h * w + 4 * N_FRAMES + 4
    assert nbytes == 4 * n * h * w * (2 if align else 1) + tables + ema
    interp = 2 * n * h * w * (2 * taps - 1) if taps > 1 else 0
    assert flops == interp + 2 * n * h * w + 2 * n_streams * h * w
    alone, _ = align_kernel.launch_cost(n, h, w, n_streams, "linear", True, False)
    assert alone == 8 * n * h * w + 16 * n + 16 * n


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_version_matches_jax(shape, interp):
    jfs, joff, jnp = _jax()
    frames, s_y, s_x, ema = _inputs(shape)
    aligned, ema_out = align_fold(*_torch(frames, s_y, s_x, ema[0]), ALPHA, interp)
    ref = np.stack([np.asarray(jfs.align_frame_subpixel(jnp.asarray(f), jnp.float32(a),
                                                        jnp.float32(b), interp))
                    for f, a, b in zip(frames, s_y, s_x)])
    assert np.abs(aligned.numpy() - ref).max() < 1e-6
    ref_ema = np.asarray(joff.ema_fold(jnp.asarray(ema[0]), jnp.asarray(ref), ALPHA))
    assert np.abs(ema_out.numpy() - ref_ema).max() < FOLD_REL * np.abs(ref_ema).max()


def test_integer_plain_version_matches_jax():
    jfs, _, jnp = _jax()
    frames, s_y, s_x, _ = _inputs(SHAPES[0], integer=True)
    aligned, none = align_fold(*_torch(frames, s_y, s_x), align="integer")
    ref = np.stack([np.asarray(jfs.align_frame(jnp.asarray(f), int(a), int(b)))
                    for f, a, b in zip(frames, s_y, s_x)])
    assert none is None
    np.testing.assert_array_equal(aligned.numpy(), ref)


@pytest.mark.parametrize("align", ["integer", "linear", "cubic"])
def test_shift_taps_are_what_roll_frac_takes(align):
    """The kernel's shift tables, both axes in one pass, hold the integer
    parts and tap weights that the plain alignment computes axis by axis,
    to the bit (the kernel reduces the integer parts mod h and mod w)."""
    from tempest_tpu_torch.ops.framesync import _interp_weights

    _, s_y, s_x, _ = _torch(*_inputs(SHAPES[1], n_streams=2, integer=align == "integer"))
    k, weights = align_kernel.shift_taps(s_y, s_x, align)
    assert k.dtype == torch.int64 and k.shape == (2, s_y.shape[0])
    for axis, s in enumerate((s_y, s_x)):
        if align == "integer":
            assert weights is None and torch.equal(k[axis], s.to(torch.int64))
            continue
        ki = torch.floor(s).to(torch.int64)
        _, ws = _interp_weights((s - ki.to(s.dtype)).to(torch.float32), align)
        assert torch.equal(k[axis], ki)
        assert torch.equal(weights[axis], torch.stack(ws, dim=-1))


@pytest.mark.parametrize("align", [None, "integer", "linear", "cubic"])
def test_plain_batched_fold_equals_single_folds(align):
    frames, s_y, s_x, ema = _inputs(SHAPES[1], n_streams=3, integer=align == "integer")
    frames, s_y, s_x, ema = _torch(frames, s_y, s_x, ema)
    aligned, ema_out = align_fold(frames, s_y, s_x, ema, ALPHA, align, n_streams=3)
    for b in range(3):
        part = slice(b * N_FRAMES, (b + 1) * N_FRAMES)
        a1, e1 = align_fold(frames[part], s_y[part], s_x[part], ema[b], ALPHA, align)
        assert torch.equal(aligned[part], a1) and torch.equal(ema_out[b], e1), f"stream {b}"


def test_fold_from_zero_composes_to_the_fold():
    """``A·e + B`` with ``B`` the fold from a zero image and ``A = α^F``
    (the mesh's combine) equals the fold of ``e``, and ``ema_fold`` is the
    fold alone."""
    frames, _, _, ema = _torch(*_inputs(SHAPES[0]))
    e = ema[0]
    _, b = align_fold(frames, ema=torch.zeros_like(e), alpha=ALPHA, align=None)
    _, big_a = fold_weights(ALPHA, N_FRAMES, "cpu")
    whole = poff.ema_fold(e, frames, ALPHA)
    assert torch.equal(big_a * e + b, whole)
    assert torch.equal(whole, align_fold_plain(frames, ema=e, alpha=ALPHA, align=None)[1])


def test_fold_agrees_with_one_weighted_sum():
    """The frame-order fold against ``torch.tensordot`` (the fold before
    K3): within ``FOLD_REL`` of the largest value."""
    frames, _, _, ema = _torch(*_inputs(SHAPES[1]))
    w, big_a = fold_weights(ALPHA, N_FRAMES, "cpu")
    ref = big_a * ema[0] + torch.tensordot(w, frames, dims=1)
    got = poff.ema_fold(ema[0], frames, ALPHA)
    assert float((got - ref).abs().max()) < FOLD_REL * float(ref.abs().max())


@pytest.mark.parametrize("w", [3, 40, 80, 83, 800, 2048, 4100])
@pytest.mark.parametrize("align", [None, "integer", "linear", "cubic"])
def test_launch_shape_covers_the_row_within_a_block(align, w):
    """Threads (a multiple of 32, at most 1024) times units (at most 2)
    cover the row's quads (w % 4 == 0) or columns; the ring of source rows
    and the shared row fit 227 KB with the frames' slots."""
    taps = align_kernel.ALIGN_MODES[align]
    for vec in [v for v in (True, False) if (w % 4 == 0 or not v) and (v or w <= 2048)]:
        threads, units, smem = align_kernel.launch_shape(w, taps, vec)
        cover = w // 4 if vec else w
        assert threads % 32 == 0 and 32 <= threads <= 1024 and units in (1, 2)
        assert threads * units >= cover and threads * units - cover < 32 * units
        assert smem + 64 * 44 <= 227 * 1024
    if w == 800:   # the slice: 224 threads of one quad each; 4 stages (3 cubic)
        rows = {0: 4, 1: 4, 2: 9, 4: 13}[taps]
        assert align_kernel.launch_shape(800, taps, True) == (224, 1, 4 * 800 * rows)


def test_launch_shape_refuses_rows_a_block_cannot_hold():
    with pytest.raises(ValueError, match="wide"):
        align_kernel.launch_shape(8192, 2, True)
    with pytest.raises(ValueError, match="wide"):
        align_kernel.launch_shape(2049, 0, False)


@pytest.mark.parametrize("dtype,kept", [
    (torch.int32, True), (torch.int64, True), (torch.float32, True), (torch.float64, True),
    (torch.float16, True), (torch.bfloat16, True), (torch.int16, False), (torch.uint8, False)])
def test_kernel_shifts_take_the_sync_dtypes_as_they_are(dtype, kept):
    s = torch.arange(6).to(dtype)
    got = align_kernel._kernel_shifts(s)
    assert (got is s) == kept
    assert got.dtype == (dtype if kept else torch.int64)
    with pytest.raises(TypeError):
        align_kernel._kernel_shifts(torch.ones(3, dtype=torch.bool))


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("n_streams", [1, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("align", [None, "integer", "linear", "cubic"])
def test_k3_equals_plain_to_the_bit(cuda_device, align, shape, n_streams):
    frames, s_y, s_x, ema = _torch(*_inputs(shape, n_streams, integer=align == "integer"),
                                   device=cuda_device)
    with count_launches() as seen:
        aligned, ema_out = align_fold(frames, s_y, s_x, ema, ALPHA, align, n_streams)
    ref_aligned, ref_ema = align_fold_plain(frames, s_y, s_x, ema, ALPHA, align, n_streams)
    torch.cuda.synchronize()
    assert seen["k3"] == 1
    assert torch.equal(aligned, ref_aligned), "aligned frames"
    assert torch.equal(ema_out, ref_ema), "EMA"
    # Against the weighted sum of the fold before K3, stream by stream.
    w, big_a = fold_weights(ALPHA, N_FRAMES, cuda_device)
    for b in range(n_streams):
        part = ref_aligned[b * N_FRAMES: (b + 1) * N_FRAMES]
        ref = big_a * ema[b] + torch.tensordot(w, part, dims=1)
        assert float((ema_out[b] - ref).abs().max()) < FOLD_REL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("align", ["integer", "linear", "cubic"])
def test_k3_aligns_alone(cuda_device, align):
    """Without an EMA (``align_frame*`` on a CUDA tensor) K3 writes the
    aligned frames only; equal to the plain alignment to the bit."""
    from tempest_tpu_torch.ops import framesync as pfs

    frames, s_y, s_x, _ = _torch(*_inputs(SHAPES[1], integer=align == "integer"),
                                 device=cuda_device)
    with count_launches() as seen:
        got = (pfs.align_frame(frames, s_y, s_x) if align == "integer"
               else pfs.align_frame_subpixel(frames, s_y, s_x, align))
    ref = align_fold_plain(frames, s_y, s_x, align=align)[0]
    assert seen["k3", align, False] == 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_k3_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    frames, s_y, s_x, ema = _torch(*_inputs(SHAPES[0]), device=cuda_device)
    with pytest.raises(TypeError):
        align_fold(frames.double(), s_y, s_x)
    with pytest.raises(TypeError):
        align_fold(frames, s_y, s_x, ema.transpose(1, 2).contiguous().transpose(1, 2), ALPHA)


def _edge_shifts(n, h, w, dtype):
    """Shifts the kernel decodes itself: negative, at and past h and w, exact
    integers, zero, and a tiny negative one whose fraction rounds to 1.0 in
    float32 (-1e-9 in float32, -1e-12 in float64: floor -1, s + 1 = 1.0f)."""
    tiny = -1e-12 if dtype == torch.float64 else -1e-9
    base_y = [tiny, -0.25, h + 0.5, 2.0 * h + 3.0, -3.0 * h - 0.75, 5.0, 0.0, h - 0.125]
    base_x = [-1.5, tiny, w + 0.75, 3.0 * w, -w - 0.5, -7.0, 0.5, w - 1e-3]
    s_y = torch.tensor([base_y[k % len(base_y)] for k in range(n)], dtype=torch.float64)
    s_x = torch.tensor([base_x[k % len(base_x)] for k in range(n)], dtype=torch.float64)
    if dtype.is_floating_point:
        return s_y.to(dtype), s_x.to(dtype)
    return torch.floor(s_y).to(dtype), torch.floor(s_x).to(dtype)


_FLOATS = (torch.float32, torch.float64, torch.float16, torch.bfloat16)
# (align, shift dtype): sub-pixel alignment of real shifts of every width the
# kernel decodes; the integer alignment of the sync's int32, of int64 and of
# float32 shifts (truncated, as .to(int64) does); the fold alone (no shift).
_DECODED = ([(a, d) for a in ("linear", "cubic") for d in _FLOATS]
            + [("integer", d) for d in (torch.int32, torch.int64, torch.float32)]
            + [(None, torch.float32)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_streams", [1, 4])
@pytest.mark.parametrize("align,dtype", _DECODED,
                         ids=[f"{a}-{str(d).split('.')[1]}" for a, d in _DECODED])
def test_k3_decodes_the_shifts_to_the_plain_bits(cuda_device, align, dtype, n_streams):
    """The integer parts and weights computed in the kernel, from shifts of
    every dtype it takes and of every edge, give the plain version's aligned
    frames and EMA to the bit (a fold only: no shift read)."""
    h, w = SHAPES[1]
    frames, _, _, ema = _inputs((h, w), n_streams)
    frames, ema = _torch(frames, ema, device=cuda_device)
    s_y, s_x = (s.to(cuda_device) for s in _edge_shifts(frames.shape[0], h, w, dtype))
    got = align_fold(frames, s_y, s_x, ema, ALPHA, align, n_streams)
    ref = align_fold_plain(frames, s_y, s_x, ema, ALPHA, align, n_streams)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]), "aligned frames"
    assert torch.equal(got[1], ref[1]), "EMA"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((61, 83), 0), ((30, 40), 1), ((3, 4100), 0),
                                          ((5, 1030), 0)],
                         ids=["odd-width", "unaligned", "wide-quads", "wide-columns"])
@pytest.mark.parametrize("align", [None, "integer", "linear", "cubic"])
def test_k3_rows_of_any_width_and_alignment(cuda_device, align, shape, offset):
    """The per-column route (w % 4 != 0, or rows not 16-byte aligned) and
    rows of two units a thread, to the bit."""
    h, w = shape
    frames, s_y, s_x, ema = _inputs(shape, 2, integer=align == "integer")
    buf = torch.zeros(frames.size + offset, dtype=torch.float32, device=cuda_device)
    buf[offset:] = torch.from_numpy(frames.ravel()).to(cuda_device)
    frames = buf[offset:].view(frames.shape)
    s_y, s_x, ema = _torch(s_y, s_x, ema, device=cuda_device)
    got = align_fold(frames, s_y, s_x, ema, ALPHA, align, 2)
    ref = align_fold_plain(frames, s_y, s_x, ema, ALPHA, align, 2)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("align", [None, "integer", "linear", "cubic"])
def test_k3_is_one_launch_and_no_torch_operation(cuda_device, align):
    """For the sync's float32 and int32 shifts the wrapper runs no torch
    operation but allocating its outputs, and the card sees one kernel."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    frames, s_y, s_x, ema = _torch(*_inputs(SHAPES[1], integer=align == "integer"),
                                   device=cuda_device)
    ema = ema[0]
    align_fold(frames, s_y, s_x, ema, ALPHA, align)   # the build, the fold's weights
    torch.cuda.synchronize()
    with Ops() as ops:
        align_fold(frames, s_y, s_x, ema, ALPHA, align)
    assert set(ops.names) <= {"aten.empty_like", "aten.empty"}, ops.names
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        align_fold(frames, s_y, s_x, ema, ALPHA, align)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    assert len(kernels) == 1 and sum(kernels.values()) == 1, kernels
    assert "align_fold_kernel" in next(iter(kernels))
