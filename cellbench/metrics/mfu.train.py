"""The whole training step's share of the chip's float32 peak, for a
language model: the model operations of the traced window's steps (forward
and backward of every subset pass, nothing recomputed, no capacity
padding; ``counts/lm.py``) over the window times the peak.  Nothing for the
linear model, whose step the device memory bounds."""
from counts import lm, peaks


def read(trace):
    w = trace.work
    if "features" in w["model"]:
        return None
    n, d = w["code"][:2]
    per_step = lm.train_step(w["model"], w["seq_len"],
                             n * d * w["sequences_per_subset"])
    return 100.0 * w["steps"] * per_step / (trace.window_s * peaks.F32_FLOPS)
