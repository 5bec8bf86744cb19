"""The benchmark's own machinery: the manifest, the chip checks, the inputs
made from the seed, the trace reduction and the import guard.

Nothing here imports the JAX package or JAX; the program under test
(``repro_torch``) is imported only by ``drivers/`` and ``harness.port``,
inside their functions.
"""
