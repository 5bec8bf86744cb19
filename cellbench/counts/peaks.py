"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit; a run records the card's own limit beside its
numbers).

Every product of the port is float32.  No float32-accurate implementation
on this chip exceeds the TF32 tensor-core rate (3xTF32 and split-bf16 run
below it), so float32 work is held against it and no share of it can pass
100 %; against the 67 TFLOP/s of the CUDA cores it could.
"""
HBM_BYTES_PER_S = 3.35e12       # device memory
F32_FLOPS = 495e12              # TF32 tensor cores, dense
