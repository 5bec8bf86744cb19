"""Which device operations belong to which layer, by the names the
profiler gives them (regular expressions, matched case-insensitively)."""
# the hand-written coding kernels (kernels/csrc/coded_encode.cu, coded_decode.cu)
CODING = r"\b(encode2d|encode3d|decode2d|decode3d)_kernel\b"
# the hand-written flash attention, forward and backward (flash_attn*.cu)
FLASH = r"\b(flash_kernel|fb_kernel|fb_dot_kernel)\b"
# cuBLAS and cuBLASLt products: GEMM, GEMV, their split-K reductions
BLAS = r"gemm|gemv|xmma|cutlass|splitkreduce|(?<!fb_)\bdot_kernel"
