"""The yardstick of the rooflines and of ``mfu``: the chip's peaks, the
operations and bytes the algorithm needs for a cell's shapes, and which
device operations belong to which layer.  Frozen here, so that a change to
the program cannot change what it is measured against."""
