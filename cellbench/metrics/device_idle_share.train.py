"""Share of the traced training window in which no operation ran on the
device (the union of its activities over all streams): the time the host
held the card back."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
