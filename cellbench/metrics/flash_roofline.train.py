"""Flash attention's share of its operation bound in the traced training
window: the least time the steps' attention could take (2 products forward
and 4 backward, halved for the causal mask, nothing recomputed) at the
float32 peak, over the time the flash kernels ran."""
from counts import kernels, lm, peaks


def read(trace):
    t = trace.seconds(kernels.FLASH)
    if t <= 0:
        return None
    w = trace.work
    n, d = w["code"][:2]
    seqs = w["steps"] * n * d * w["sequences_per_subset"]
    ops = lm.flash(w["model"], w["seq_len"], seqs, backward=True)
    return 100.0 * ops / peaks.F32_FLOPS / t
