"""fft_ms.wide: device ms of cuFFT's kernels a call (the band scan's capture FFT and
batched inverse FFT, the fusion's capture FFT and inverse FFTs, the autocorrelations'
real FFT pairs), from the trace: the traced device operations whose name holds one of
``PATTERNS``, case aside, over the calls of the window."""

# cuFFT's kernels in a traced run of the cell on the H100 (CUDA 12, torch 2.x):
# ``regular_fft_factor<...>``, ``regular_fft_r2c`` / ``_c2r``, and the real
# transforms' ``packR2C_kernel_impl``, ``preprocess_kernel<float, ...>`` and
# ``postprocess_kernel<float, ...>``.
PATTERNS = ("fft", "packr2c", "preprocess_kernel<", "postprocess_kernel<")


def read(run):
    ops = [op for op in run.device_ops if any(p in op[0].lower() for p in PATTERNS)]
    if not ops or not run.count:
        return None
    return 1e3 * sum(e - s for _, s, e, _ in ops) * 1e-6 / run.count
