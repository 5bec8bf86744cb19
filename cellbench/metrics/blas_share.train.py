"""Device time of cuBLAS's products (GEMM, GEMV) over the device's busy
time, in the traced training window."""
from counts import kernels


def read(trace):
    t = trace.seconds(kernels.BLAS)
    return 100.0 * t / trace.busy_s if t > 0 else None
