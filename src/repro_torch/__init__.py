"""PyTorch / CUDA port of the gradient-coding system (``repro`` is the JAX
reference and stays as it is).

Same sub-package and module names as the reference, so a reader finds the
counterpart: ``repro_torch.coding.packing`` <-> ``repro.coding.packing``.
The package imports ``torch`` and ``numpy`` only.  Entry points take an
explicit ``device`` that defaults to ``"cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
