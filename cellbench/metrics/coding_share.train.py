"""Device time of the coding kernels (the encodes and the decode) over the
device's busy time, in the traced training window."""
from counts import kernels


def read(trace):
    t = trace.seconds(kernels.CODING)
    return 100.0 * t / trace.busy_s if t > 0 else None
