"""Bytes the coding layer needs, in float32, as the algorithm needs them and
whatever implements it: each input byte read once and each output byte
written once.

A worker's encode reads its ``d`` subset gradients of ``P`` values each and
its ``d m`` coefficients, and writes one wire of ``P / m`` values: the
``d`` gradients folded, ``m`` values to a row, into the combination it
sends.  A decode reads the ``n - s`` wires it needs (any ``n - s`` workers'
suffice, whoever straggles) and their ``(n - s, m)`` weights, and writes the
``P`` values of the decoded sum.  A coded step has ``n`` workers' encodes
and one decode.
"""
from __future__ import annotations

F32 = 4


def wire(P: int, m: int) -> int:
    """Values of one wire: ``P / m``, rounded up."""
    return -(-P // m)


def encode(P: int, d: int, m: int) -> int:
    """One worker's encode of its ``d`` subset gradients of ``P`` values."""
    return F32 * (d * P + d * m + wire(P, m))


def decode(P: int, wires: int, m: int) -> int:
    """One decode of ``P`` values from ``wires`` wires."""
    return F32 * (wires * wire(P, m) + wires * m + P)


def train_step(P: int, n: int, d: int, s: int, m: int) -> int:
    """A coded step's encodes and decode under the code ``(n, d, s, m)``."""
    return n * encode(P, d, m) + decode(P, n - s, m)
