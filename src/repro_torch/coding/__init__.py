"""Codec subsystem: the paper's gradient coding as a pluggable pipeline.

  plan     — per-leaf grouping-dimension choice (``plan.py``)
  encode   — fold subset gradients into l/m encodings (``codec.py``)
  wire     — straggler mask + cast to the wire dtype (``wire.py``)
  pack     — bucketed flat wire buffers, O(1) collectives/bucket (``packing.py``)
  decode   — gather / a2a / psum schedules (``schedules.py``)
  backends — plain PyTorch vs the CUDA kernels, chosen by the explicit
             device (``backends.py``)

Entry points: ``make_codec(code, schedule=..., backend=..., wire_dtype=...,
device=...)`` for the raw codec, and ``SchemeSpec`` (``spec.py``) — the
frozen value object consolidating every scheme lever — consumed by
``make_coded_train_step`` and the ``Trainer``.
"""
from .backends import (BACKEND_NAMES, CodecBackend, HopperBackend,
                       TorchRefBackend, resolve_backend)
from .codec import Codec, encode_leaf, make_codec
from .inputs import admit_code, make_step_inputs, uncovered_subsets
from .layout import groups_to_leaf, leaf_to_groups
from .packing import (WIRE_ALIGN, LeafSlot, PackPlan, WireBucket, enc_shape,
                      make_pack_plan, pack_bucket, pack_param_groups,
                      psum_fallback, unpack_bucket, unpack_param_groups)
from .plan import (LeafPlan, coded_fraction, param_specs, plan_leaf,
                   plan_tree)
from .schedules import (SCHEDULES, AllToAllSchedule, GatherSchedule,
                        PsumSchedule, Schedule, get_schedule)
from .spec import SPEC_FIELDS, SchemeSpec

__all__ = [
    "Codec", "make_codec", "encode_leaf",
    "SchemeSpec", "SPEC_FIELDS",
    "CodecBackend", "TorchRefBackend", "HopperBackend", "resolve_backend",
    "BACKEND_NAMES",
    "Schedule", "GatherSchedule", "AllToAllSchedule", "PsumSchedule",
    "SCHEDULES", "get_schedule",
    "LeafPlan", "plan_leaf", "plan_tree", "coded_fraction", "param_specs",
    "PackPlan", "WireBucket", "LeafSlot", "WIRE_ALIGN",
    "make_pack_plan", "pack_bucket", "unpack_bucket", "psum_fallback",
    "pack_param_groups", "unpack_param_groups", "enc_shape",
    "leaf_to_groups", "groups_to_leaf",
    "make_step_inputs", "uncovered_subsets", "admit_code",
]
