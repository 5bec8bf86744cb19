"""Hand-written Hopper kernels for the paper's per-step hot spots: coded
encode (eq. 17/18) and coded decode (eq. 19-21), and their fused forms of
the pipelined step (the accumulating encode, the decode + SGD-momentum
apply), as CUDA C++ under ``csrc/``, each with its plain PyTorch version
beside the wrapper."""
from . import ops, ref
from .coded_decode import (coded_decode, coded_decode_apply,
                           coded_decode_apply_plain, coded_decode_plain)
from .coded_encode import (coded_encode, coded_encode_acc,
                           coded_encode_acc_plain, coded_encode_plain)

__all__ = ["ops", "ref", "coded_encode", "coded_decode",
           "coded_encode_plain", "coded_decode_plain",
           "coded_encode_acc", "coded_encode_acc_plain",
           "coded_decode_apply", "coded_decode_apply_plain"]
