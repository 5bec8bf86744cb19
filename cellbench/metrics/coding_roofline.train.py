"""The coding kernels' share of their byte bound in the traced training
window: the least time the step's encodes and decode could take, the bytes
the algorithm needs read once and written once at the device memory's
peak rate (``counts/coding.py``), over the time the coding kernels ran."""
from counts import coding, kernels, peaks


def read(trace):
    t = trace.seconds(kernels.CODING)
    if t <= 0:
        return None
    w = trace.work
    n, d, s, m = w["code"]
    nbytes = w["steps"] * coding.train_step(w["params"], n, d, s, m)
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t
