#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--global-batch 512] [--profile] [--out report.json]

Drives ``repro_torch`` only (nothing of the JAX package), on the card only:

  env      ``repro_torch.bench.capture_env``: versions, the TF32 flags,
           and the card's name and power limit from nvidia-smi
  build    compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc into
           ``build/`` and loads the library
  kernels  holds each CUDA kernel (coded_encode / coded_decode, 2D and 3D;
           coded_encode_acc 2D and 3D; coded_decode_apply) against its plain
           PyTorch version over ragged sweeps and every path's own shapes
           (the serving path's encode and decode included) in f32 and bf16,
           the plain pair also against ``torch.einsum``, the fused pair bitwise
           against their two-step spellings on the card, the scalar path of
           the encodes, the 2D decode and the fused decode-apply (operands
           one element off an aligned base) bitwise against their vector
           path, the fused decode-apply as one device kernel a call (read by
           torch.profiler); and times each at the main path's shapes, on
           inputs that are not in the L2 cache, beside its plain version,
           one library call where there is one, and its byte bound; the
           coding kernels also as a run of 64 back-to-back launches and by
           the host's cost a call (200 calls, no sync), beside the launch
           floor (an empty kernel of the library, timed both ways)
  bench    the harness ``repro_torch.bench`` on the card: the main path's
           2D encode and in-place 2D encode-acc timed by
           ``time_callable`` (each at or above 0.9 x its ``time_ms``);
           a ``BenchResult`` a kernel at its main-path shape, written,
           loaded back and gated (clean against this run's baseline,
           caught against a doctored one), in a temporary directory
  checks_packed_small
           ROADMAP C.3 on the card: packed == per-leaf bitwise on the kernel
           backend for the trees [(8,)] and [(8,), (16,)], code (4, 3, 1, 2),
           both schedules and both wire types
  train    the synchronous path: ``Trainer`` on ``logistic-paper`` at full
           width (l = 343474), code (n, d, s, m) = (8, 4, 2, 2), NAG, random
           stragglers, 5 steps
  train_pipelined
           the pipelined path: the same ``Trainer`` with
           ``SchemeSpec(pipelined=True, fuse_apply=True)`` and SGD-momentum,
           5 steps and a drain (``coded_encode_acc`` 2D and
           ``coded_decode_apply``)
  train_generic
           a two-layer MLP as a plain parameter dict through
           ``make_coded_train_step`` (trailing dims -> the 3D kernel
           variants), synchronous and pipelined fused.  Each of the three
           paths has its own counts: the kernel launch counts are set to 0
           just before it and read just after it; each of its encodes,
           2D decodes and fused decode-applies must have taken the vector
           path.
  checks   the synchronous 5 steps on the plain backend on the card, the
           decoded gradient with 2 stragglers against the uncoded gradient,
           packed against per-leaf bitwise; pipelined fill + drain against
           the synchronous step bitwise (fused and not), a steady call
           against the synchronous update of the batch it retires, and the
           pipelined run against the plain backend
  autotune_train
           ``Trainer(autotune=AutotunePolicy(...))`` on ``logistic-paper`` at
           full width from code (8, 4, 2, 2), NAG, a drifting timed straggler
           source (the reference's drift of tests/test_tune.py), exact and
           FRC plans: 16 steps counted from 0, each step's launches by kernel
           and kernel path filed under the scheme it ran under, at least one
           switch, every scheme that codes beta launching the 2D encode and
           decode; a plain-backend twin replaying the same swaps at the same
           steps (beta within rtol 1e-4); swaps back build nothing; a
           pipelined fused trainer swapped with an update in flight (the swap
           launches one ``coded_decode_apply``: the drain under the outgoing
           code), against its plain twin; one step each under a forced
           rotation, block, hetero and expander plan; the coding kernels
           timed at every coded scheme's own shapes, vector and scalar path
  elastic  ``ElasticTrainer`` on ``logistic-paper`` at full width, home code
           (8, 3, 1, 2), NAG, no stragglers, one batch of 448 rows (splits
           over 8 and 7 workers), each run counted from 0 and held against a
           plain-backend twin on the same trace (beta within rtol 1e-4):
           (a) a leave at step 3 and a join at step 9 walk prewarm 7, the
           zero-load re-plan (loads 5,5,5,5,4,4,4,0), a resize to 7 and back
           to 8 (the state bitwise and in place through each resize, nothing
           built, the home code and its decode weights bitwise at the end);
           (b) two preemptions at step 3 fail over to partial decode (a
           finite error bound), then re-plan to s = 3; (c) a pipelined fused
           trainer re-plans with an update in flight (one
           ``coded_decode_apply`` in the swap); (d) a tuner plan with
           ``resize_to = 7`` goes through resize (with checkpoints), and is
           skipped on a 512-row batch.  Every step's launches by scheme:
           24 / 40 / 21 / 56 encodes (home, degraded, 7, burst) and one
           decode, all on the vector path; resize and prewarm walls; the 2D
           decode timed at both cluster sizes' buckets
  serve    the serving path: ``CodedServer`` on ``qwen3-1.7b`` at full width
           (28 layers, d_model 2048, random weights from a seed, f32) with
           code (4, 3, 1, 2), one request per subset and 4096-token prompts:
           2 batches submitted and stepped, every prefill's attention through
           the flash attention kernel (n * d * 28 = 336 launches a batch);
           the decoded logits against the uncoded forward of the same
           prompts, the hedge (a straggler's payload never reaches the
           output bits), and no failed requests
  autotune_serve
           ``CodedServer(autotune=ServingPolicy(...))`` on the serve phase's
           weights, 4096-token prompts, from code (4, 3, 1, 2) under a
           drifting timed source: 7 batches counted from 0, each batch's
           flash launches (n * d * 28 of its scheme) and coding launches by
           path filed under its scheme, at least one change of code; each
           scheme's first batch against the uncoded forward, and one traced
           batch a scheme for its device idle share; the coding kernels
           timed at each scheme's shapes, vector and scalar path
  checkpoint
           (a) ``Trainer`` on ``logistic-paper`` at full width, code (8, 4,
           2, 2), NAG, random stragglers, a snapshot every 2 steps into a
           temporary directory: 6 steps, the step-6 snapshot torn to a third
           of its size, a fresh ``Trainer`` that warns ``unreadable``, falls
           back to step 4, replays the data stream (``skip_to_cursor``) and
           the straggler stream to its cursor and takes 2 steps (counted from
           0): the uninterrupted run's parameters and state, bitwise.
           (b) inside ``train_lm``, after the synchronous steps: that
           trainer's parameters and NAG state (16.3 GB) saved with
           ``maybe_checkpoint(force=True)`` and restored onto the host into a
           tree of the same structure, compared leaf by leaf bitwise; the
           directory's free bytes, the seconds and GB/s of both
  generate ``BatchedEngine`` on the serve phase's ``qwen3-1.7b`` weights at
           full width and depth, f32: 4 prompts of 4096 tokens from a seed,
           a dense cache of 4096 + 32 positions, 32 greedy tokens; counted
           from 0 just before ``generate``: the prefill launches the flash
           forward once a layer, the decode never; decode steps 0, 1 and 31
           against the full-prompt forward of prompt ++ tokens with the
           materialized f32 softmax (rtol = atol = 2e-4), the forward
           through the flash kernel printed beside; the prefill's seconds, a decode step's median ms (steps
           2-31, CUDA events), tokens/s, peak memory and the step's byte
           bound (the weights but the input embedding, and the KV cache)
  train_lm coded training of the same ``qwen3-1.7b`` at full width on
           4096-token sequences, code (4, 3, 1, 2), one sequence a subset
           (a global batch of 4), random stragglers: ``Trainer`` with NAG
           over all 28 layers, 2 steps; then the pipelined ``Trainer``
           (``fuse_apply=True``, SGD-momentum), also at full width and
           depth, 2 steps and a drain (3 steps each until the dist
           phase came in).  Each
           path counted from 0: flash forward twice a layer and subset (the
           checkpoint recomputes it), its backward once, one encode a coded
           leaf and subset, one decode (or decode-apply) a bucket; no plain
           flash call.  Outside the counts: the decoded gradient with a
           straggler against the uncoded one, and fill + drain against the
           synchronous step, bitwise
  serve_moe
           the serve phase on ``olmoe-1b-7b`` (the MoE family: 16 layers,
           d_model 2048, 64 experts of d_ff 1024, top 8, capacity factor
           1.25; random f32 weights from a seed, 27.7 GB), code (4, 3, 1, 2),
           one 4096-token prompt a subset, 2 batches: 192 flash launches, 12
           encodes and 1 decode a batch.  An MoE forward depends on its
           batch (an expert's capacity counts the forward's tokens), so the
           decoded logits of each subset are held against the uncoded
           forward of that subset's prompt alone (no hedge re-run: qwen3's
           serve phase holds it); the
           share of picks each layer drops on one prompt
  generate_moe
           ``BatchedEngine`` on serve_moe's weights: 4 prompts of 4096
           tokens, 16 greedy tokens; 16 flash launches in the prefill and 0
           in the decode, every step's logits finite; outside the window the
           prefill's logits against ``last_logits`` and two decodes of one
           step from clones of one cache, both bitwise.  A decode step's
           capacity is 1 slot an expert (4 tokens), so its picks collide and
           drop and it is not held against the full forward (the reference's
           semantics); its median ms against a byte bound that reads every
           expert of every layer
  train_moe
           the synchronous ``Trainer`` of train_lm on ``olmoe-1b-7b`` at full
           width and 4 of its 16 layers (cut: the f32 trainer at full depth
           would need about 6.7 x 27.7 GB), 4096-token sequences, NAG, 2
           steps counted as train_lm's; outside the window the decoded
           gradient with a straggler against the uncoded one, and one
           subset's gradient twice, bitwise (the dispatch sums in a fixed
           order: no atomics)
  serve_vlm
           the serve phase on ``internvl2-26b`` (the VLM family: the
           InternLM2 backbone at full width, d_model 6144, 48 query heads on
           8 KV heads of 128, d_ff 16384, vocab 92553; random f32 weights
           from a seed) at 12 of its 48 layers (cut: 79.4 GB of f32 weights
           at full depth), code (4, 3, 1, 2), one request a subset, each
           256 seeded f32 patch embeddings and 4096 tokens (4352
           positions), 2 batches: 144 flash launches, 12 encodes and 1
           decode a batch, all on the vector path; each subset against its
           own prompt's uncoded forward (no hedge re-run)
  generate_vlm
           ``BatchedEngine`` on serve_vlm's weights: 4 prompts of 4096
           tokens after 256 zero patches (the reference engine's), 16
           greedy tokens; 12 flash launches in the prefill and 0 in the
           decode; outside the window the prefill's logits against
           ``last_logits`` bitwise, and decode step 0 against each prompt's
           full forward with its first token (materialized softmax,
           rtol = atol = 2e-4); a decode step's median ms against its byte
           bound
  train_vlm
           the synchronous ``Trainer`` of train_lm on ``internvl2-26b`` at
           full width and 2 of its 48 layers (7.67 GB of weights), one
           sequence of 256 patch embeddings and 4096 tokens a subset, the
           loss on the text positions, NAG, 2 steps counted as train_lm's;
           outside the window the decoded gradient with a straggler against
           the uncoded one, and one subset's gradient twice, bitwise.  The
           3D encodes of the leaves whose trailing elements are no whole
           number of 16-byte vectors (the embedding and unembedding, whose
           rows of the odd vocabulary 92553 are cut by their grouping dim,
           and the 2-layer norms) take the scalar path, exactly as many as
           those shapes imply; every other coding launch the vector path
  serve_ssm
           the serve phase on ``xlstm-350m`` (the SSM family: 12 (mLSTM,
           sLSTM) pairs, d_model 1024, inner width 2048, 4 heads of 512,
           vocab 50304; random f32 weights from a seed, 2.53 GB) at full
           width and full depth, code (4, 3, 1, 2), one prompt of
           SSM_SERVE_SEQ tokens a subset, 1 batch: 12 encodes, 1 decode
           and no flash launch a batch, all on the vector path; each
           subset against its own prompt's uncoded forward; the device's
           idle share over a traced forward of a prompt's first 64 tokens
           (the sLSTM steps one token at a time, host-paced)
  generate_ssm
           ``BatchedEngine`` on serve_ssm's weights: 4 prompts of
           SSM_SERVE_SEQ tokens, 16 greedy tokens from the recurrent state
           (no KV cache, no flash launch); the prefill's state at ``pos =
           SSM_SERVE_SEQ``; outside the window decode steps 0, 1 and 15
           against the chunked forward over the prompt and the tokens so
           far, within 5e-2 of the largest logit at 24 layers and 1e-3
           over the first 8 layers of the same weights (the model's f32
           rounding grows with depth: the same forward at half the chunk
           is printed beside); a decode step's
           median ms against its byte bound (the weights but the embedding,
           the state read and written) and its idle share
  train_ssm
           the synchronous ``Trainer`` of train_lm on ``xlstm-350m`` at
           full width and 6 of its 24 layers (cut: the script's 900 s),
           one sequence of SSM_TRAIN_SEQ tokens a subset, NAG, 2 steps
           counted from 0: per step 12 2D encodes (``ln_f``), 288 3D
           encodes (the 24 stacked leaves) and 1 decode; the six stacked
           vectors of 3 pairs (R = 3, no whole number of 16-byte vectors)
           on the scalar path, every other launch on the vector path;
           step 0's decoded gradient
           (straggler 0) against the uncoded one taken before the window,
           and one subset's gradient twice, bitwise.  The three SSM
           phases' wall is printed as ``ssm_phases``
  serve_hybrid
           the serve phase on ``zamba2-1.2b`` (the hybrid family: 38
           Mamba2 layers, d_model 2048, 64 SSM heads of 64, state 64, and
           one shared attention block of 32 / 32 heads of 64 and d_ff 8192
           applied after every 6 layers, 7 times; vocab 32000; random f32
           weights from a seed, 4.68 GB) at full width and full depth, code
           (4, 3, 1, 2), one 4096-token prompt a subset, 1 batch: 84 flash
           launches (at head dim 64), 12 encodes and 1 decode a batch, all
           on the vector path; each subset against its own prompt's
           uncoded forward; the device's idle share over a traced forward
           of one prompt
  generate_hybrid
           ``BatchedEngine`` on serve_hybrid's weights: 4 prompts of 4096
           tokens, 16 greedy tokens from the SSM states, conv rings and the
           shared block's 7 KV caches (4112 positions); 7 flash launches in
           the prefill and 0 in the decode; the prefill's state at ``pos =
           4096``; outside the window decode steps 0, 3 and 7 (forward
           lengths 4097, 4100 and 4104: chunks of 241, 205 and 228) against
           the chunked forward over the prompt and the tokens so far,
           within 1e-3 of the largest logit (the forward at half the chunk
           printed beside the last); a
           decode step's median ms against its byte bound and its idle
           share
  train_hybrid
           the synchronous ``Trainer`` of train_lm on ``zamba2-1.2b`` at
           full width and full depth, one sequence of HYBRID_TRAIN_SEQ =
           2304 tokens a subset (4096 took 131.9 s for the three phases),
           NAG, 2 steps counted from 0: per step 36 2D encodes
           (``ln_f``, the shared block's norms), 216 3D (72 on the scalar
           path: the six stacked vectors, R = 38), 1 decode, 168 flash
           forwards and 84 backwards; step 0's decoded gradient
           (a straggler) against the uncoded one taken before the window,
           the shared block's leaves named, and one subset's gradient
           twice, bitwise.  The three hybrid phases' wall is printed as
           ``hybrid_phases``
  serve_encdec
           the serve phase on ``whisper-tiny`` (the encoder-decoder family:
           4 encoder and 4 decoder layers, d_model 384, 6 heads of 64,
           d_ff 1536, vocab 51865, ``dec_ctx`` 448; random f32 weights
           from a seed, 247 MB) at full width and depth, code (4, 3, 1,
           2), one request of 1500 seeded frame embeddings a subset, 2
           batches: no flash launch (1500 frames: the materialized
           softmax), 12 encodes and 1 decode a batch, all on the vector
           path; each subset against its own request's uncoded forward;
           the device's idle share over a traced forward of one request
  generate_encdec
           ``BatchedEngine`` on serve_encdec's weights: a batch of 4 on
           1500 zero frames, 64 greedy tokens against the self-KV ring
           (448 slots) and the cross-KV; no flash launch; the prefill's
           cache at ``pos = 1``; outside the window decode steps 0, 7 and
           63 against the unrolled chain of the port's own prefill and
           decode steps (decode against decode, rtol = atol = 2e-4), and
           the decode against the teacher-forced ``decode_train`` at
           positions 0 and 7 printed (ROADMAP C.7: the reference's decode
           does not rotate q and k); a decode step's median ms against its
           byte bound (the decoder weights, the unembedding, the self-KV
           and cross-KV read once) and its idle share
  train_encdec
           the synchronous ``Trainer`` of train_lm on ``whisper-tiny`` at
           full width and depth, one sequence of 1500 frames and 448
           tokens a subset, NAG, 2 steps counted from 0: per step 24 2D
           encodes, 324 3D (``embed`` and ``unembed`` on the scalar path,
           rows of the odd vocabulary 51865), 1 decode, no flash launch;
           step 0's decoded gradient (a straggler) against the uncoded
           one taken before the window, and one subset's gradient twice,
           bitwise
  long_encdec
           the same model at 3000 frames (``enc_pos`` tiled twice), above
           ``CHUNK_THRESHOLD``: the encoder's self-attention and every
           cross-attention through the flash kernels with the full mask
           (keys 3000, queries 3000, 448 or 1).  One served batch (96
           flash launches: 4 encoder and 4 cross a prefill), 4 generated
           tokens (8 flash launches in the prefill, 4 a decode step), one
           training step on 448 tokens (192 flash forwards and 96
           backwards), each counted from 0 and checked as the 1500-frame
           phases; the plain flash version never runs over the phase.  The
           four phases' wall is printed as ``encdec_phases``
  examples the twins of the reference's examples (``examples/*_torch.py``)
           through their ``run()``, each counted from 0: ``logistic_amazon``
           at l = 343474, n = 8, the naive (8, 1, 0, 1) on psum and the
           optimal m = 1 and m > 1 codes ((8, 8, 7, 1), (8, 8, 5, 3)) on
           gather with random stragglers, 512 samples and 10 iterations:
           640 2D encodes and 10 decodes on the vector path for the m = 1
           code, none for the m = 3 one (3 does not divide l: beta is summed
           by its weights, as in the reference's plan); each scheme again on
           the plain backend (the final betas within 1e-4 of the largest
           element), each coded scheme's beta against the naive one's (1e-3);
           ``serve_batched`` on qwen3-1.7b at full width and depth, batch 8,
           32-token prompts, 16 greedy tokens, the first token against the
           argmax of ``make_forward``'s logits; ``train_lm_coded`` on its
           ``--full-100m`` config, 3 steps, finite losses and the coding
           launches; ``quickstart`` at its own sizes (20 + 10 + 1 + 22
           steps of the reduced qwen3-1.7b): at least one switch of the
           tuner and a finite partial-step bound.  One line a twin
  launch   ``python -m repro_torch.launch.train`` on logistic-paper at full
           width, code (8, 4, 2, 2), 5 NAG steps, as a subprocess: exit 0, a
           finite final loss, coded fraction 1.000, the library phase
           ``build`` made, 160 encodes and 5 decodes on the vector path
  dist     (last: see main) the coded train step across processes on
           the one card, two ``gloo`` ranks each computing half the workers
           (``repro_torch.comm.DistComm``), each rank bitwise against the
           single-process run: parameters and optimizer state by digest,
           each step's loss and grad_norm, each step's collectives.  (a)
           the launcher with ``--nproc 2 --dist-backend gloo`` on the launch
           phase's flags, synchronous, against the launch phase's report
           (half the encodes and every decode a rank); then its pipelined
           job (``--optimizer sgd --pipelined --steps 2``) on a group of 2
           ranks this script starts (``repro_torch.launch.ranks.run_ranks``)
           against the same job in this process; (b) on that group, one
           synchronous step of ``qwen3-1.7b`` at full width and 2 of its 28
           layers on 512-token sequences, code (4, 3, 1, 2), against
           ``LocalComm`` in this process: half the 3D and 2D encodes a
           rank, the whole decode, no flash.  Each part prints the
           transport, the bytes by collective and step and rank, the host
           seconds inside the collectives (a device sync around each, timed
           by the group's ranks; the launcher's ranks run untimed), the
           step walls against the single process's, and peak memory by
           rank.  (c) on the same group, ``CodedServer`` on ``qwen3-1.7b``
           at full width and depth, 4096-token prompts, code (4, 3, 1, 2),
           a batch with no straggler and one with straggler 1: each rank's
           outputs bitwise the single-process server's, 168 flash, 6 2D
           encodes and 1 2D decode a rank a batch (336, 12, 1 in one
           process), the collectives' counts and bytes the single
           process's.  (d) on the same group, ``logistic-paper`` at full
           width: the autotune_train phase's tuned trainer for 16 steps
           (the same plans, events and state on both ranks, at least one
           switch), then the checkpoint phase's trainer, 6 steps
           uninterrupted and 4 with a snapshot every 2 (rank 0 alone
           saves); a fresh group of 2 ranks resumes at step 4 and ends at
           6 with the state of both uninterrupted runs and of the single
           process, bitwise.  (e) on the same group, the elastic phase's
           (a) and (c) over a ``DistComm`` of 8 workers, ``ElasticTrainer``
           re-splitting the workers at each resize (blocks of 4 and 4 at 8,
           3 and 4 at 7): each rank's ladder log, each step's loss and
           grad_norm and its state digest bitwise the elastic phase's, each
           rank launching its own workers' encodes and every decode.  (f)
           on the same group, ``BatchedEngine.generate`` on (c)'s weights
           with the generate phase's 4 prompts of 4096 tokens, 2 a rank
           (``rows_per_rank``): every rank's tokens exactly the generate
           phase's, its rows' prefill logits within GEN_TOL of it, 28 flash
           launches a rank in the prefill on its own rows

The kernel checks also hold ``flash_attention`` (tensor cores: 3xTF32 for
f32, one bf16 pass for bf16) against its plain version (the reference's
online-softmax loop) at the sweep of tests/test_kernels.py, at the serving
shapes (qwen3-1.7b's and olmoe-1b-7b's at 4096 tokens, internvl2-26b's
q_per_kv = 6 at 4352 positions, zamba2-1.2b's MHA at head dim 64, one
prompt and the 4-prompt generate prefill), with a window and a query
offset, at hd 32 and 64 with a ragged S, q_per_kv = 4, B > 1 with a window
and an offset, on views of one fused projection, at whisper-tiny's
full-mask shapes at 3000 frames (FLASH_CROSS: 3000, 448 and 1 queries
against 3000 keys, and a ragged GQA case), and on layer slices of a
stacked cross-KV cache; check what it refuses (TMA alignment) and that under grad mode it is
differentiable; and time it beside ``scaled_dot_product_attention`` in
the same type, against the tensor-core bounds.  They hold the flash
backward (``csrc/flash_attn_bwd.cu``) against the plain version's autograd
over the same sweep and the backward's tile edges (f32 1e-5 in relative
error norm and 1e-4 of the largest gradient elementwise, bf16 2e-2 in
relative norm), require the same bits from a second call, and the
forward's bits with and without its log-sum-exp residual; and time the
backward at the 4096-token shape beside SDPA's backward in the same type.
The build phase reports every flash kernel's registers and spills, forward
and backward, and the shared memory of both, and fails if one spills.
Float32 products
of the plain versions run in full f32: TF32 is switched off for matmuls
and cuDNN.

Each phase prints one JSON line.  Any failed phase ends the run with a
non-zero exit code; without a CUDA device the script exits with code 2 and
prints no result.  The last line of standard output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parent

# the LM training path allocates and frees buffers of several GB; segments
# that grow in place keep the cache from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
try:
    import torch
except ImportError:
    print("chip_smoke: PyTorch is not installed", file=sys.stderr)
    sys.exit(2)

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script runs "
          "on an NVIDIA GPU only", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, str(HERE / "src"))
try:
    import numpy as np

    from repro_torch import coding, convert
    from repro_torch.bench import (BenchResult, TimerPolicy, capture_env,
                                   load_results, time_callable,
                                   write_results)
    from repro_torch.bench import gate as bench_gate
    from repro_torch.bench.env import nvidia_smi_line
    from repro_torch.bench.timing import (RUN_LAUNCHES, _union_us,
                                          host_us_per_call, profile_device,
                                          time_ms, time_run_ms)
    from repro_torch.configs import get_config
    from repro_torch.core import HeteroCode, make_code
    from repro_torch.data import (CodedBatcher, make_synthetic_batch,
                                  synthetic_logistic_dataset)
    from repro_torch.elastic import (ElasticPolicy, ElasticTrainer,
                                     MembershipTrace)
    from repro_torch.kernels import _build, _launch, flash_attn, ops
    from repro_torch.kernels.coded_decode import (coded_decode,
                                                  coded_decode_apply,
                                                  coded_decode_apply_plain,
                                                  coded_decode_plain,
                                                  apply_path, decode_path)
    from repro_torch.kernels.coded_encode import (coded_encode,
                                                  coded_encode_acc,
                                                  coded_encode_acc_plain,
                                                  coded_encode_plain,
                                                  encode_path)
    from repro_torch.models import api as model_api
    from repro_torch.models import common as model_common
    from repro_torch.models import encdec, moe
    from repro_torch.optim import nag, sgd_momentum
    from repro_torch.serving import BatchedEngine, CodedServer
    from repro_torch.train import (PipelineDriver, Trainer,
                                   make_coded_train_step)
    from repro_torch.tune import NoStragglers, RandomStragglers
except ImportError as e:
    print(f"chip_smoke: the port's package does not import from "
          f"{HERE / 'src'}: {e}", file=sys.stderr)
    sys.exit(3)

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor-core rate, dense
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor-core rate, dense
L2_BYTES = 50e6                # H100 L2 cache; timed inputs rotate past it
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
F32 = torch.float32
STEPS = 5                      # train steps on the main path
SEED = 0                       # of the synthetic batch
PIPE_LR = 1e-6                 # SGD-momentum step of the pipelined path
PATTERNS = ((2, 5), (), (0,))  # straggler sets of the chained parity checks
SERVE_SEQ = 4096               # prompt length of the serving path
SERVE_CODE = (4, 3, 1, 2)      # (n, d, s, m) of the serving path
SERVE_BATCHES = 2              # batches the serve phase submits and steps
#                                (3 until the dist phase came in)
# decoded logits against the uncoded forward of each subset's prompt alone,
# as the coded forward runs it: f32 throughout, the forward's logits through
# the encode's and the decode's weights; held to 1e-3 of the largest logit
SERVE_REL_TOL = 1e-3
LM_SEQ = 4096                  # tokens a sequence on the LM training path
LM_CODE = (4, 3, 1, 2)         # (n, d, s, m): one sequence a subset
LM_STEPS = 2                   # steps of each LM training path (3 until the
#                                dist phase came in: cut for the script's time)
LM_STEPS_CUT = {"steps": f"{LM_STEPS}, cut from 3 for the script's time "
                         f"(phase dist)"}
LM_NAG_LR = 1e-3               # NAG step of the synchronous LM path
LM_SGD_LR = 1e-3               # SGD-momentum step of the pipelined LM path
# the decoded gradient with a straggler against the uncoded one: f32, the
# decode's float64-solved weights applied in f32 to sums of 3 subsets
LM_GRAD_REL_TOL = 1e-4
CKPT_BATCH = 64                # global batch of the checkpoint phase's run
CKPT_STEPS = 6                 # steps of its uninterrupted run
CKPT_EVERY = 2                 # a snapshot every 2 steps: 2, 4 and 6
GEN_BATCH = 4                  # prompts of the generate phase
GEN_PROMPT = 4096              # tokens a prompt
GEN_NEW = 32                   # greedy tokens a prompt
GEN_CHECKED = (0, 1, GEN_NEW - 1)   # decode steps held against the forward
# decode logits against the full-prompt forward with the same attention
# math (the materialized f32 softmax at every length, as the reference's
# branch below 2048 tokens): f32, products of other shapes
# (tests/test_models_math.py's tolerance).  The forward through the flash
# kernel (3xTF32) is printed beside it: at 28 layers it is itself 2.9e-4
# from the materialized one (tools/decode_vs_forward.py, PERF.md)
GEN_TOL = 2e-4
MOE_ARCH = "olmoe-1b-7b"       # the MoE phases' model
MOE_SERVE_BATCHES = 2          # batches the serve_moe phase steps
MOE_GEN_NEW = 16               # greedy tokens a prompt in generate_moe
MOE_TRAIN_LAYERS = 4           # of 16: coded training at full depth needs
                               # about 6.7 x its 27.7 GB of f32 parameters
VLM_ARCH = "internvl2-26b"     # the VLM phases' model
VLM_SERVE_LAYERS = 12          # of 48: 23.3 GB of f32 weights (79.4 at 48)
VLM_TRAIN_LAYERS = 2           # of 48: the trainer needs about 6.7 x 7.67 GB
VLM_SERVE_BATCHES = 2          # batches the serve_vlm phase steps
VLM_GEN_NEW = 16               # greedy tokens a prompt in generate_vlm
# positions of a VLM prompt: its patch embeddings, then SERVE_SEQ tokens
VLM_SEQ = get_config(VLM_ARCH).n_frontend_tokens + SERVE_SEQ
SSM_ARCH = "xlstm-350m"        # the SSM phases' model, full width and depth
# the sLSTM runs one cell step a token, eagerly: a 4096-token forward takes
# 7.8-9.6 s on the card, the device idle 80-83 % of it (tools/ssm_probe.py),
# so the SSM phases run shorter sequences, the longest multiples of 256 that
# keep the three phases within 150 s
SSM_SERVE_SEQ = 512            # prompt tokens of serve_ssm and generate_ssm
SSM_TRAIN_SEQ = 512            # tokens a sequence of train_ssm
SSM_SERVE_BATCHES = 1          # batches the serve_ssm phase steps
SSM_TRACE_SEQ = 64             # tokens of serve_ssm's traced forward
SSM_GEN_NEW = 16               # greedy tokens a prompt in generate_ssm
SSM_GEN_CHECKED = (0, 1, SSM_GEN_NEW - 1)
SSM_TRAIN_STEPS = 2            # steps of train_ssm
# layers of train_ssm, of 24: with the hybrid phases the script took 928.1
# and 974.8 s on the card (train_ssm 94-125 s of it, the sLSTM host-paced),
# past its 900 s, so 12 layers; with the encdec phases 938.9 s (train_ssm
# at 12 layers 67 s of it, on a host that ran the SSM phases 1.8x slower
# than the run before), so 6; serving and generation keep the full depth
SSM_TRAIN_LAYERS = 6
# decode steps (the recurrent form) against the chunked forward over the
# prompt and the tokens so far, relative to the largest logit.  The f32
# rounding of this random-weight model grows with depth whatever the form
# (tools/ssm_probe.py, decode_gap on the card at 512 tokens: 3e-6 at 2
# layers, 5e-5 to 1.2e-4 at 8, 3.8e-3 to 1.1e-2 at 24, where the same
# chunked forward with half the chunk is 2.4e-3 to 3.8e-3 from itself; this
# phase's prompts reached 2.5e-2 at 24), so the decode is held to 1e-3 over
# the first SSM_GEN_CHECK_LAYERS layers of the same weights, and to
# SSM_GEN_REL_TOL_FULL at full depth, where a state read or written at the
# wrong layer or position moves the logits by their own size
SSM_GEN_REL_TOL = 1e-3
SSM_GEN_CHECK_LAYERS = 8
SSM_GEN_REL_TOL_FULL = 5e-2
HYBRID_ARCH = "zamba2-1.2b"    # the hybrid phases' model, full width and depth
HYBRID_SERVE_BATCHES = 1       # batches serve_hybrid steps (no hedge re-run:
                               # qwen3's serve phase holds the hedge)
HYBRID_GEN_NEW = 16            # greedy tokens a prompt in generate_hybrid
# decode steps held against the chunked forward over the prompt and the
# tokens fed so far: the forward's chunk is the largest divisor of its
# length up to ssm_chunk (the reference's search), so the checked lengths
# are picked for large chunks: step t runs a forward of 4096 + t + 1 tokens,
# 4097, 4100 and 4104 with chunks of 241, 205 and 228 (4104 at half the
# chunk: 114), where steps 1, 2 and 15 would run chunks of 6, 1 and 16 (a
# forward of 4099 tokens is 4099 one-token chunks a layer)
HYBRID_GEN_CHECKED = (0, 3, 7)
# tokens a sequence of train_hybrid: at 4096 the three hybrid phases took
# 131.9 s on the card (a training step 39.5-39.8 s), past their 90 s, and
# at 2304 the script took 928.1-974.8 s, past its 900 s; 2304 is the
# shortest multiple of 256 whose attention still runs the flash kernels
# (above CHUNK_THRESHOLD)
HYBRID_TRAIN_SEQ = 2304
HYBRID_TRAIN_STEPS = 2         # steps of train_hybrid
# decode steps (the one-step recurrence and the attention over the KV
# cache) against the chunked forward at full depth, relative to the largest
# logit; the reference holds its chunked form against its recurrence at
# 5e-4 (tests/test_models_math.py).  On the card the gap is 1.9-2.7e-5 at
# 38 layers, where the same forward at half the chunk is 2.3-2.7e-5 from
# itself (tools/ssm_probe.py --arch zamba2-1.2b, decode_gap)
HYBRID_GEN_REL_TOL = 1e-3
ENCDEC_ARCH = "whisper-tiny"   # the encdec phases' model, full width and depth
ENCDEC_FRAMES = get_config(ENCDEC_ARCH).n_frontend_tokens   # 1500: 30 s
ENCDEC_SERVE_BATCHES = 2       # batches serve_encdec steps
ENCDEC_GEN_NEW = 64            # greedy tokens a request in generate_encdec
# decode steps held against the unrolled chain of the port's own prefill
# and decode_step (the reference's decode semantics: no RoPE in the
# decoder's self-attention, ROADMAP C.7); step 6 also gives position 7's
# logits for the decode-against-decode_train gap
ENCDEC_GEN_CHECKED = (0, 7, ENCDEC_GEN_NEW - 1)
ENCDEC_TRAIN_TOKENS = 448      # decoder tokens a sequence: dec_ctx
ENCDEC_TRAIN_STEPS = 2         # steps of train_encdec
# long_encdec: 60 s of audio (enc_pos tiled twice), above CHUNK_THRESHOLD,
# so the encoder's self-attention and every cross-attention run the flash
# kernels with the full mask
ENCDEC_LONG_FRAMES = 3000
# greedy tokens a request in long_encdec: 8 took 0.13 s of the script's
# 938.9 s; cut first all the same, as the script passed its 900 s
ENCDEC_LONG_GEN_NEW = 4
ENCDEC_LONG_GEN_CHECKED = (0, ENCDEC_LONG_GEN_NEW - 1)
PLAIN_FLASH_REPS = 5           # timed calls of a plain flash version (25
#                                until the examples phase came in)
KERNELS_CHECK_CUT = (
    "the timed operands drawn on the card from a seeded CUDA generator, "
    "not on the host and copied, for the script's time (phase dist parts "
    "(e) and (f)); the same shapes, copies and calls")

torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in full f32
torch.backends.cudnn.allow_tf32 = False


SECONDS_BY_PHASE = {}   # wall since the previous line, by the line's phase
_LAST_LINE = [time.perf_counter()]


def say(**obj):
    now = time.perf_counter()
    if "phase" in obj:
        SECONDS_BY_PHASE[obj["phase"]] = (SECONDS_BY_PHASE.get(obj["phase"], 0)
                                          + now - _LAST_LINE[0])
    _LAST_LINE[0] = now
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ kernels
def _randn(gen, shape, dtype):
    """Normal draws on the card from ``gen`` (drawn there when ``gen`` is
    a CUDA generator, else on the host and copied)."""
    if gen.device.type == "cuda":
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    return torch.randn(*shape, generator=gen).to(dtype).to(DEV)


def attention_layers(cfg) -> int:
    """Attention blocks a forward runs: none for an SSM, one a group for a
    hybrid (one shared block, applied after each group), an encoder's
    self-attention a layer and a decoder's cross-attention a layer for an
    encoder-decoder, else a layer's."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.attn_every)
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.n_layers
    return cfg.n_layers


def flash_layers(cfg, frames=None) -> int:
    """Flash launches of one forward: ``attention_layers``, but none for an
    encoder-decoder on ``CHUNK_THRESHOLD`` frames or fewer, whose
    attention over the frames is then the materialized softmax (its
    decoder's self-attention always is)."""
    if cfg.family == "encdec" and frames <= model_common.CHUNK_THRESHOLD:
        return 0
    return attention_layers(cfg)


def _offset_copy(x):
    """``x``'s values in a contiguous view whose base lies one element past
    an aligned allocation: the coding kernels' scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _serve_codec_shapes(code_nsdm=SERVE_CODE, arch="qwen3-1.7b"):
    """The serving path's encode ``G (1, q, m)`` and decode ``(n, L, m)``:
    one request a subset, its ``(vocab,)`` logits folded m-fold, and the
    wire of k blocks of q rounded up to lcm(WIRE_ALIGN, n), as
    ``make_coded_forward`` lays them out."""
    code = make_code(*code_nsdm)
    q = -(-get_config(arch).vocab // code.m)
    align = math.lcm(coding.WIRE_ALIGN, code.n)
    L = -(-(code.num_subsets * q) // align) * align
    return (1, q, code.m), (code.n, L, code.m)


SERVE_ENC, SERVE_DEC = _serve_codec_shapes()
MOE_ENC, MOE_DEC = _serve_codec_shapes(SERVE_CODE, MOE_ARCH)
VLM_ENC, VLM_DEC = _serve_codec_shapes(SERVE_CODE, VLM_ARCH)
HYBRID_ENC, HYBRID_DEC = _serve_codec_shapes(SERVE_CODE, HYBRID_ARCH)
ENCDEC_ENC, ENCDEC_DEC = _serve_codec_shapes(SERVE_CODE, ENCDEC_ARCH)
# the 3D encode of the VLM's unembedding gradient (6144, 92553), grouped on
# its first dim: rows of an odd R, so the scalar path by shape
VLM_UNEMBED_ENC = (1, 3072, 2, 92553)
# train_encdec's 3D encodes of whisper-tiny's embed (51865, 384), grouped on
# its 384, and unembed (384, 51865): one shape, rows of the odd vocabulary
# 51865, so the scalar path by shape
ENCDEC_VOCAB_ENC = (1, 192, 2, 51865)
ENC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (8, 1024, 8), (31, 96, 3),
         (2, 1001, 7), (1, 171737, 2), SERVE_ENC, MOE_ENC, VLM_ENC,
         HYBRID_ENC, ENCDEC_ENC]
ENC3D = [(3, 16, 2, 128), (4, 256, 2, 64), (2, 40, 5, 96), (2, 7, 3, 33),
         (1, 3072, 2, 2048), ENCDEC_VOCAB_ENC]
# xlstm-350m's largest 3D encodes at full depth, f32 (train_ssm runs half
# the pairs: the stacks' R halved): the 2048 x 2048 stacks (12, 2048, 2048),
# pairs/slstm/r (12, 4, 4, 512, 512), embed (50304, 1024) and unembed
# (1024, 50304), grouped on d_model (the vocabulary lies on the reference's
# model axis, which the planner skips)
SSM_ENC3D = [(1, 1024, 2, 24576), (1, 256, 2, 98304), (1, 512, 2, 50304)]
# train_hybrid's: mamba/in_proj (38, 2048, 8384) grouped on 2048 (its 8384
# lies on the reference's model axis; 2.61 GB a launch), and a stacked
# vector (38, 4096) whose R = 38 is no whole number of 16-byte vectors (the
# scalar path by shape)
HYBRID_ENC3D = [(1, 1024, 2, 318592), (1, 2048, 2, 38)]
DEC2D = [(4, 64, 2), (16, 512, 3), (32, 96, 8), (10, 1280, 1), (12, 1001, 19),
         (64, 77, 32), (8, 171776, 2), SERVE_DEC, MOE_DEC, VLM_DEC,
         HYBRID_DEC, ENCDEC_DEC]
DEC3D = [(4, 32, 2, 128), (16, 128, 4, 64), (5, 9, 11, 17), (8, 3072, 2048)]
ACC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (2, 1001, 7), (1, 171737, 2)]
ACC3D = [(2, 7, 3, 33), (2, 40, 5, 96), (3, 16, 2, 128), (1, 3072, 2, 2048)]
APPLY = [(4, 64, 2), (8, 1001, 3), (16, 512, 8), (5, 77, 11), (3, 300, 1),
         (8, 171776, 2)]                                    # (n, L, m)
HYPER = {"lr": 1e-2, "momentum": 0.9, "scale": 0.25}


def _einsum(kernel, a, b, out_dtype):
    """One library call for the same contraction: an independent witness of
    the kernels, and the ``library_ms`` yardstick."""
    if kernel is coded_encode:
        sub = "jvur,ju->vr" if a.dim() == 4 else "jvu,ju->v"
    else:
        sub = "nvr,nu->vur" if a.dim() == 3 else "nv,nu->vu"
    return torch.einsum(sub, a.to(F32), b.to(F32)).to(out_dtype or a.dtype)


def _compare(kernel, plain, a, b, out_dtype, dtype):
    """(max abs, max rel) error against the plain version, and max abs
    error against ``torch.einsum``; fails past the output type's tolerance."""
    got = kernel(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = plain(a, b, out_dtype=out_dtype)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{kernel.__name__}{tuple(a.shape)}: shape/dtype "
             f"{got.shape}/{got.dtype} != {want.shape}/{want.dtype}")
    if not torch.isfinite(got.to(F32)).all():
        fail(f"{kernel.__name__}{tuple(a.shape)}: non-finite output")
    diff = (got.to(F32) - want.to(F32)).abs()
    # both sides add the same f32 products in the same order (the kernel
    # with fused multiply-add), so the output type sets the tolerance
    tol = TOL[got.dtype]
    allowed = tol + tol * want.to(F32).abs()
    if (diff > allowed).any():
        fail(f"{kernel.__name__}{tuple(a.shape)} {dtype}->{got.dtype}: max abs "
             f"err {diff.max().item():.3e} exceeds atol=rtol={tol}")
    rel = (diff / want.to(F32).abs().clamp_min(1.0)).max().item()
    # the library's contraction adds in an order of its own
    lib = _einsum(kernel, a, b, out_dtype).to(F32)
    ldiff = (got.to(F32) - lib).abs()
    if (ldiff > tol + tol * lib.abs()).any():
        fail(f"{kernel.__name__}{tuple(a.shape)} {dtype}->{got.dtype}: max abs "
             f"err {ldiff.max().item():.3e} against torch.einsum exceeds "
             f"atol=rtol={tol}")
    return diff.max().item(), rel, ldiff.max().item()


def check_kernels():
    """Every variant against its plain version and against ``torch.einsum``;
    returns per-kernel max errors over the f32 cases (the bf16 cases are
    held to their own tolerance and reported apart)."""
    gen = torch.Generator().manual_seed(0)
    fused = ("coded_encode_acc_2d", "coded_encode_acc_3d", "coded_decode_apply")
    errs = {k: ({"max_abs_err": 0.0, "max_abs_err_bf16": 0.0, "cases": 0}
                if k in fused else
                {"max_abs_err": 0.0, "max_rel_err": 0.0,
                 "max_abs_err_vs_einsum": 0.0, "max_abs_err_bf16": 0.0,
                 "max_abs_err_bf16_vs_einsum": 0.0, "cases": 0})
            for k in ops.launch_counts() if k != "flash_attention"}

    def note(name, dtype, e):
        r = errs[name]
        r["cases"] += 1
        if dtype == F32:
            r["max_abs_err"] = max(r["max_abs_err"], e[0])
            r["max_rel_err"] = max(r["max_rel_err"], e[1])
            r["max_abs_err_vs_einsum"] = max(r["max_abs_err_vs_einsum"], e[2])
        else:
            r["max_abs_err_bf16"] = max(r["max_abs_err_bf16"], e[0])
            r["max_abs_err_bf16_vs_einsum"] = max(
                r["max_abs_err_bf16_vs_einsum"], e[2])

    for dtype in (F32, torch.bfloat16):
        for out_dtype in (None, F32):
            for shape in ENC2D + ENC3D:
                G = _randn(gen, shape, dtype)
                C = _randn(gen, (shape[0], shape[2]), dtype)
                name = "coded_encode_3d" if len(shape) == 4 else "coded_encode_2d"
                note(name, dtype, _compare(coded_encode, coded_encode_plain,
                                           G, C, out_dtype, dtype))
                # the scalar path (G one element off an aligned base) gives
                # the aligned call's bits
                got = coded_encode(G, C, out_dtype=out_dtype)
                G1 = _offset_copy(G)
                if encode_path(G1, got) != "scalar" or not torch.equal(
                        coded_encode(G1, C, out_dtype=out_dtype), got):
                    fail(f"coded_encode{shape} {dtype}: the scalar path "
                         f"differs from the {encode_path(G, got)} path bitwise")
                errs[name]["paths_bitwise_cases"] = \
                    errs[name].get("paths_bitwise_cases", 0) + 1
            for shape, m in [(s[:2], s[2]) for s in DEC2D] + \
                            [((s[0], s[1], s[3]), s[2]) if len(s) == 4
                             else (s, 2) for s in DEC3D]:
                Fm = _randn(gen, shape, dtype)
                W = _randn(gen, (shape[0], m), dtype)
                name = "coded_decode_3d" if len(shape) == 3 else "coded_decode_2d"
                note(name, dtype, _compare(coded_decode, coded_decode_plain,
                                           Fm, W, out_dtype, dtype))
                if len(shape) == 3:
                    continue
                # the 2D scalar path (F one element off an aligned base)
                # gives the aligned call's bits
                got = coded_decode(Fm, W, out_dtype=out_dtype)
                F1 = _offset_copy(Fm)
                if decode_path(F1, got) != "scalar" or not torch.equal(
                        coded_decode(F1, W, out_dtype=out_dtype), got):
                    fail(f"coded_decode{shape} {dtype}: the scalar path "
                         f"differs from the {decode_path(Fm, got)} path bitwise")
                errs[name]["paths_bitwise_cases"] = \
                    errs[name].get("paths_bitwise_cases", 0) + 1
    # train_ssm's and train_hybrid's largest 3D encodes, in the path's type
    # (f32, drawn on the card): against the plain version and
    # torch.einsum, on the path their shape gives (vector where R is a
    # whole number of 16-byte vectors), and the scalar path's bits against
    # it
    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    for shape in SSM_ENC3D + HYBRID_ENC3D:
        G = _randn(dev_gen, shape, F32)
        C = _randn(dev_gen, (shape[0], shape[2]), F32)
        note("coded_encode_3d", F32, _compare(coded_encode, coded_encode_plain,
                                              G, C, None, F32))
        got = coded_encode(G, C)
        G1 = _offset_copy(G)
        by_shape = "vector" if shape[3] % 4 == 0 else "scalar"
        if encode_path(G, got) != by_shape or \
                encode_path(G1, got) != "scalar" \
                or not torch.equal(coded_encode(G1, C), got):
            fail(f"coded_encode{shape}: not the {by_shape} path, or the "
                 f"scalar path differs from it bitwise")
        errs["coded_encode_3d"]["paths_bitwise_cases"] += 1
        del G, G1, got
    # what the wrappers must refuse on the card
    G = _randn(gen, (2, 64, 2), F32)
    for bad in (lambda: coded_encode(G.transpose(1, 2).contiguous().transpose(1, 2),
                                     G[:, 0]),
                lambda: coded_encode(G.double(), G[:, 0]),
                lambda: coded_decode(G[0], torch.zeros(64, 2))):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        fail("a wrapper accepted an operand the kernel does not take")
    check_fused_kernels(gen, errs)
    errs["flash_attention"] = check_flash(gen)
    return errs


def _close(what, got, want, tol):
    """Max abs error of ``got`` against ``want``; fails past atol=rtol=tol."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: shape/dtype {got.shape}/{got.dtype} != "
             f"{want.shape}/{want.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    diff = (got - want).abs()
    if (diff > tol + tol * want.abs()).any():
        fail(f"{what}: max abs err {diff.max().item():.3e} exceeds "
             f"atol=rtol={tol}")
    return diff.max().item()


def check_fused_kernels(gen, errs):
    """The pipelined step's kernels against their plain versions (ragged
    sweeps, G / F in f32 and bf16, acc / P / MU in f32), in place as
    promised, and bit for bit against the two-step spellings the
    synchronous step runs on the card: ``acc + coded_encode(G, C, f32)``,
    and ``coded_decode`` followed by the ``sgd_momentum`` expressions."""
    def note(name, dtype, e):
        r = errs[name]
        r["cases"] += 1
        key = "max_abs_err" if dtype == F32 else "max_abs_err_bf16"
        r[key] = max(r[key], e)

    for dtype in (F32, torch.bfloat16):
        for shape in ACC2D + ACC3D:
            G = _randn(gen, shape, dtype)
            C = _randn(gen, (shape[0], shape[2]), F32)
            out_shape = (shape[1], shape[3]) if len(shape) == 4 else (shape[1],)
            acc0 = _randn(gen, out_shape, F32)
            acc = acc0.clone()
            got = coded_encode_acc(acc, G, C)
            torch.cuda.synchronize()
            what = f"coded_encode_acc{tuple(shape)} {dtype}"
            if got.data_ptr() != acc.data_ptr():
                fail(f"{what}: the result is not acc, updated in place")
            e = _close(what, got, coded_encode_acc_plain(acc0, G, C), TOL[dtype])
            if not torch.equal(got, acc0 + coded_encode(G, C, out_dtype=F32)):
                fail(f"{what}: differs from acc + coded_encode(G, C) bitwise")
            # the scalar path, G or acc one element off an aligned base
            for G_, acc_ in ((_offset_copy(G), acc0.clone()),
                             (G, _offset_copy(acc0))):
                if encode_path(G_, acc_) != "scalar" or not torch.equal(
                        coded_encode_acc(acc_, G_, C), got):
                    fail(f"{what}: the scalar path differs from the "
                         f"{encode_path(G, acc)} path bitwise")
            name = "coded_encode_acc_3d" if len(shape) == 4 else "coded_encode_acc_2d"
            note(name, dtype, e)
            errs[name]["paths_bitwise_cases"] = \
                errs[name].get("paths_bitwise_cases", 0) + 2
        for n, L, m in APPLY:
            F = _randn(gen, (n, L), dtype)
            W = _randn(gen, (n, m), F32)
            P0, MU0 = _randn(gen, (L, m), F32), _randn(gen, (L, m), F32)
            P, MU = P0.clone(), MU0.clone()
            pn, mun, ss = coded_decode_apply(F, W, P, MU, **HYPER)
            torch.cuda.synchronize()
            what = f"coded_decode_apply{(n, L, m)} {dtype}"
            if pn.data_ptr() != P.data_ptr() or mun.data_ptr() != MU.data_ptr():
                fail(f"{what}: p' and mu' are not P and MU, updated in place")
            wp, wmu, wss = coded_decode_apply_plain(F, W, P0, MU0, **HYPER)
            e = max(_close(what + " p'", pn, wp, TOL[dtype]),
                    _close(what + " mu'", mun, wmu, TOL[dtype]))
            ss_rel = abs(ss.item() - wss.item()) / max(wss.item(), 1e-30)
            if ss.shape != () or ss_rel > 1e-5:
                fail(f"{what}: sum g^2 {ss.item()} vs plain {wss.item()} "
                     f"(rel {ss_rel:.3e} > 1e-5)")
            g = coded_decode(F, W, out_dtype=F32) * HYPER["scale"]
            mu = HYPER["momentum"] * MU0 + g
            if not (torch.equal(mun, mu) and torch.equal(pn, P0 - HYPER["lr"] * mu)):
                fail(f"{what}: p', mu' differ from coded_decode + the "
                     f"sgd_momentum expressions bitwise")
            again = coded_decode_apply(F, W, P0.clone(), MU0.clone(), **HYPER)[2]
            if not torch.equal(again, ss):
                fail(f"{what}: sum g^2 differs from run to run")
            # the scalar path (F, P or MU one element off an aligned base)
            # gives the aligned call's p' and mu' bit for bit
            for F_, P_, MU_ in ((_offset_copy(F), P0.clone(), MU0.clone()),
                                (F, _offset_copy(P0), MU0.clone()),
                                (F, P0.clone(), _offset_copy(MU0))):
                if apply_path(F_, P_, MU_) != "scalar":
                    fail(f"{what}: an offset operand kept the vector path")
                p1, mu1, _ = coded_decode_apply(F_, W, P_, MU_, **HYPER)
                if not (torch.equal(p1, pn) and torch.equal(mu1, mun)):
                    fail(f"{what}: the scalar path differs from the "
                         f"{apply_path(F, P0, MU0)} path bitwise")
            note("coded_decode_apply", dtype, e)
            r = errs["coded_decode_apply"]
            r["max_rel_err_sum_g2"] = max(r.get("max_rel_err_sum_g2", 0.0), ss_rel)
            r["paths_bitwise_cases"] = r.get("paths_bitwise_cases", 0) + 3
    errs["coded_decode_apply"]["device_kernels_per_call"] = _apply_kernels_per_call(gen)
    # what the fused wrappers must refuse on the card, and a CPU tensor
    # takes the plain version without a launch
    G = _randn(gen, (1, 64, 2), F32)
    C = _randn(gen, (1, 2), F32)
    F = _randn(gen, (4, 128), F32)
    W = _randn(gen, (4, 2), F32)
    shared = torch.zeros(4 * 128 + 256, device=DEV)
    for exc, bad in (
            (TypeError, lambda: coded_encode_acc(
                torch.zeros(64, device=DEV, dtype=torch.bfloat16), G, C)),
            (ValueError, lambda: coded_encode_acc(
                torch.zeros(128, device=DEV)[::2], G, C)),
            (ValueError, lambda: coded_decode_apply(
                F, W, torch.zeros(128, 2, device=DEV).t().contiguous().t(),
                torch.zeros(128, 2, device=DEV), **HYPER)),
            (AssertionError, lambda: coded_decode_apply(
                shared[:512].view(4, 128), W, shared[256:512].view(128, 2),
                torch.zeros(128, 2, device=DEV), **HYPER))):
        try:
            bad()
        except exc:
            continue
        fail(f"a fused wrapper accepted an operand it must refuse ({exc.__name__})")
    before = ops.launch_counts()
    coded_encode_acc(torch.zeros(64), G.cpu(), C.cpu())
    coded_decode_apply(F.cpu(), W.cpu(), torch.zeros(128, 2),
                       torch.zeros(128, 2), **HYPER)
    if ops.launch_counts() != before:
        fail("a CPU tensor launched a kernel")


def _apply_kernels_per_call(gen):
    """The device kernels of one ``coded_decode_apply`` call at the main
    path's bucket, as ``torch.profiler`` records them (after a warm call, so
    the stream's counter exists): the fused pass and the sum of the partials
    are one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, L, m = APPLY[-1]
    args = (_randn(gen, (n, L), F32), _randn(gen, (n, m), F32),
            _randn(gen, (L, m), F32), _randn(gen, (L, m), F32))
    coded_decode_apply(*args, **HYPER)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coded_decode_apply(*args, **HYPER)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if len(kernels) != 1 or "decode2d_kernel" not in kernels[0]:
        fail(f"coded_decode_apply ran {len(kernels)} device kernels a call, "
             f"not one: {kernels}")
    return len(kernels)


# (B, S, H, Hkv, hd, mask_kind, window, query offset): the sweep of
# tests/test_kernels.py, the serving shapes (qwen3-1.7b's GQA, olmoe-1b-7b's
# MHA: q_per_kv = 1 at hd 128, also its training shape; internvl2-26b's
# q_per_kv = 6 over 256 patches and 4096 tokens, served and trained), a
# window and a query offset; then the edges of the tensor-core kernel: hd
# 32 and 64 with a ragged S (a last key tile and query tile cut short),
# q_per_kv = 4, and B > 1 with a window and a query offset
FLASH = [(2, 256, 4, 2, 64, "causal", 0, 0), (1, 128, 2, 2, 32, "full", 0, 0),
         (2, 256, 4, 4, 64, "window", 64, 0), (1, 192, 4, 1, 128, "causal", 0, 0),
         (1, SERVE_SEQ, 16, 8, 128, "causal", 0, 0),
         (1, SERVE_SEQ, 16, 16, 128, "causal", 0, 0),
         (1, VLM_SEQ, 48, 8, 128, "causal", 0, 0),
         (1, 1024, 16, 8, 128, "window", 256, 0),
         (2, 200, 8, 2, 128, "causal", 0, 312),
         (1, 200, 4, 2, 32, "causal", 0, 0), (1, 200, 4, 2, 64, "causal", 0, 0),
         (1, 256, 8, 2, 128, "causal", 0, 0),
         (2, 300, 4, 2, 64, "window", 96, 40),
         (1, SERVE_SEQ, 32, 32, 64, "causal", 0, 0)]
# q, k, v as views of one fused projection (B, S, H + 2 Hkv, hd): strided
# heads and rows, read in place by TMA
FLASH_FUSED = (2, 320, 8, 2, 128)
# the backward's own edges on top of FLASH: an S that is no multiple of its
# 32- or 64-row tiles at hd 128, q_per_kv = 4 with a window and a query
# offset, hd 32 (64-byte rows for bf16) with q_per_kv = 4 and a window, and
# train_hybrid's shape (MHA at hd 64)
FLASH_BWD_EDGES = [(1, 1000, 16, 8, 128, "causal", 0, 0),
                   (2, 97, 8, 2, 64, "window", 33, 5),
                   (1, 160, 8, 2, 32, "window", 48, 16),
                   (1, HYBRID_TRAIN_SEQ, 32, 32, 64, "causal", 0, 0)]
# the forward's own shapes on top of FLASH: the generate prefills of
# olmoe-1b-7b and internvl2-26b, 4 prompts of 4096 tokens (after 256
# patches for the VLM; the grid's batch axis at its largest)
FLASH_FWD_EDGES = [(GEN_BATCH, GEN_PROMPT, 16, 16, 128, "causal", 0, 0),
                   (GEN_BATCH, VLM_SEQ, 48, 8, 128, "causal", 0, 0),
                   (GEN_BATCH, GEN_PROMPT, 32, 32, 64, "causal", 0, 0)]


# cross-attention and the encoder's self-attention of an encoder-decoder
# past CHUNK_THRESHOLD frames, (B, Sq, Sk, H, Hkv, hd, mask_kind): Sk is no
# Sq + kv_pos0 and every key tile is visited.  whisper-tiny at 3000 frames:
# its encoder, its training cross-attention (448 queries) and its decode
# step's (one query, below a query tile, at the generate batch of 4); and a
# ragged GQA case (97 queries, 1000 keys: no whole tile of either)
FLASH_CROSS = [(1, ENCDEC_LONG_FRAMES, ENCDEC_LONG_FRAMES, 6, 6, 64, "full"),
               (1, ENCDEC_TRAIN_TOKENS, ENCDEC_LONG_FRAMES, 6, 6, 64, "full"),
               (GEN_BATCH, 1, ENCDEC_LONG_FRAMES, 6, 6, 64, "full"),
               (2, 97, 1000, 4, 2, 64, "full")]
FLASH_BF16_REL_NORM = 1e-2


def _flash_inputs(gen, case, dtype):
    """q, k, v of one case: fresh tensors (a FLASH_CROSS case: Sq queries
    against Sk keys), or (``case`` of FLASH_FUSED's length) views of one
    fused projection."""
    if len(case) == len(FLASH_CROSS[0]):
        B, Sq, Sk, H, Hkv, hd, kind = case
        return (_randn(gen, (B, Sq, H, hd), dtype),
                _randn(gen, (B, Sk, Hkv, hd), dtype),
                _randn(gen, (B, Sk, Hkv, hd), dtype), (kind, 0, 0))
    if len(case) == len(FLASH_FUSED):
        B, S, H, Hkv, hd = case
        qkv = _randn(gen, (B, S, H + 2 * Hkv, hd), dtype)
        return (qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:],
                ("causal", 0, 0))
    B, S, H, Hkv, hd, kind, w, p0 = case
    return (_randn(gen, (B, S, H, hd), dtype),
            _randn(gen, (B, S + p0, Hkv, hd), dtype),
            _randn(gen, (B, S + p0, Hkv, hd), dtype), (kind, w, p0))


def check_flash(gen):
    """``flash_attention`` against its plain version on the card (f32 and
    bf16), one launch a call, FLASH_CROSS's full-mask cases among them,
    and on layer slices of a stacked cross-KV cache; then what the wrapper
    must refuse.  The errors of the cases at the serving lengths and of
    FLASH_CROSS (max abs and relative norm) are kept by case."""
    r = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0, "cases": 0,
         "serve_len_max_abs_err": {}, "serve_len_rel_norm_err": {},
         "cross_max_abs_err": {}, "cross_rel_norm_err": {}}
    for dtype in (F32, torch.bfloat16):
        for case in FLASH + FLASH_FWD_EDGES + [FLASH_FUSED] + FLASH_CROSS:
            q, k, v, (kind, w, p0) = _flash_inputs(gen, case, dtype)
            H, Hkv = q.shape[2], k.shape[2]
            n0 = flash_attn.LAUNCHES["flash_attention"]
            got = flash_attn.flash_attention_gqa(q, k, v, H // Hkv,
                                                 mask_kind=kind, window=w,
                                                 kv_pos0=p0)
            torch.cuda.synchronize()
            if flash_attn.LAUNCHES["flash_attention"] != n0 + 1:
                fail("flash_attention did not launch its kernel once")
            want = flash_attn.flash_attention_gqa_plain(
                q, k, v, H // Hkv, mask_kind=kind, window=w, kv_pos0=p0)
            what = f"flash_attention{case} {dtype}"
            if got.dtype != dtype:
                fail(f"{what}: output dtype {got.dtype}")
            e = _close(what, got.to(F32), want.to(F32), TOL[dtype])
            key = "max_abs_err" if dtype == F32 else "max_abs_err_bf16"
            r[key] = max(r[key], e)
            if case[1] in (SERVE_SEQ, VLM_SEQ):
                r["serve_len_max_abs_err"][f"{case[:5]} {dtype}"] = e
                r["serve_len_rel_norm_err"][f"{case[:5]} {dtype}"] = ((
                    got.float() - want.float()).norm() / want.float().norm()).item()
            if case in FLASH_CROSS:
                r["cross_max_abs_err"][f"{case[:6]} {dtype}"] = e
                r["cross_rel_norm_err"][f"{case[:6]} {dtype}"] = ((
                    got.float() - want.float()).norm() / want.float().norm()).item()
            if dtype == torch.bfloat16:
                # at long S the outputs are small (about 0.03 for S = 4096),
                # so the elementwise 2e-2 alone is loose: the error's norm
                # is held to 1e-2 of the output's as well
                rel = ((got.float() - want.float()).norm() /
                       want.float().norm()).item()
                if rel > FLASH_BF16_REL_NORM:
                    fail(f"{what}: relative error norm {rel:.3e} exceeds "
                         f"{FLASH_BF16_REL_NORM}")
                r["max_rel_norm_err_bf16"] = max(
                    r.get("max_rel_norm_err_bf16", 0.0), rel)
            r["cases"] += 1
    r["cross_kv_cache_slices"] = _flash_on_cache_slices(gen)
    x = _randn(gen, (1, 64, 2, 48), F32)
    y = _randn(gen, (1, 64, 2, 64), F32)
    # TMA takes bases and strides in multiples of 16 bytes: a head stride of
    # 66 floats, and a base 4 bytes past an aligned one, are refused
    odd_stride = _randn(gen, (1, 64, 2, 66), F32)[..., :64]
    odd_base = _randn(gen, (64 * 2 * 64 + 1,), F32)[1:].view(1, 64, 2, 64)
    needs_grad = y.clone().requires_grad_()
    for exc, bad in ((ValueError, lambda: flash_attn.flash_attention_gqa(x, x, x, 1)),
                     (TypeError, lambda: flash_attn.flash_attention_gqa(
                         y, y.bfloat16(), y, 1)),
                     (ValueError, lambda: flash_attn.flash_attention_gqa(
                         _randn(gen, (1, 64, 2, 128), F32)[..., ::2], y, y, 1)),
                     (ValueError, lambda: flash_attn.flash_attention_gqa(
                         odd_stride, y, y, 1)),
                     (ValueError, lambda: flash_attn.flash_attention_gqa(
                         y, odd_base, y, 1))):
        n0 = flash_attn.LAUNCHES["flash_attention"]
        try:
            bad()
        except exc:
            if flash_attn.LAUNCHES["flash_attention"] != n0:
                fail("flash_attention launched on an operand it refused")
            continue
        fail(f"flash_attention accepted an operand it must refuse ({exc.__name__})")
    # under no_grad an input that requires grad runs the forward alone; under
    # grad mode the call is differentiable through the backward kernel
    with torch.no_grad():
        if flash_attn.flash_attention_gqa(needs_grad, y, y, 1).requires_grad:
            fail("flash_attention under no_grad returned a graph")
    b0 = flash_attn.LAUNCHES["flash_attention_bwd"]
    (got,) = torch.autograd.grad(
        flash_attn.flash_attention_gqa(needs_grad, y, y, 1), needs_grad, y)
    ref = y.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        flash_attn.flash_attention_gqa_plain(ref, y, y, 1), ref, y)
    torch.cuda.synchronize()
    if flash_attn.LAUNCHES["flash_attention_bwd"] != b0 + 1:
        fail("a grad-mode flash_attention did not launch its backward once")
    _close("flash_attention grad under grad mode", got, want, 1e-4)
    return r


def _flash_on_cache_slices(gen):
    """The encoder-decoder's decode reads the cross-KV as layer slices of
    its stacked (L, B, F, Hkv, hd) cache: each slice is taken by TMA in
    place (``tma_refusal`` finds nothing to refuse; nothing is copied) and
    one query row a request against 3000 keys matches the plain version.
    Returns the max abs error over the layers (f32, the decode's type)."""
    L, (B, Sq, Sk, H, Hkv, hd, kind) = 4, FLASH_CROSS[2]
    xk = _randn(gen, (L, B, Sk, Hkv, hd), F32)
    xv = _randn(gen, (L, B, Sk, Hkv, hd), F32)
    q = _randn(gen, (B, Sq, H, hd), F32)
    err = 0.0
    for k, v in zip(torch.unbind(xk), torch.unbind(xv)):
        why = flash_attn.tma_refusal("k", k) or flash_attn.tma_refusal("v", v)
        if why:
            fail(f"flash_attention on a cross-KV cache slice: {why}")
        n0 = flash_attn.LAUNCHES["flash_attention"]
        got = flash_attn.flash_attention_gqa(q, k, v, H // Hkv, mask_kind=kind)
        torch.cuda.synchronize()
        if flash_attn.LAUNCHES["flash_attention"] != n0 + 1:
            fail("flash_attention on a cache slice did not launch once")
        want = flash_attn.flash_attention_gqa_plain(q, k, v, H // Hkv,
                                                    mask_kind=kind)
        err = max(err, _close("flash_attention on a cross-KV cache slice",
                              got, want, TOL[F32]))
    return {"layers": L, "shape": [B, Sq, Sk, H, Hkv, hd], "max_abs_err": err}


# The backward's tolerances against the plain version's autograd (TF32 off):
# the kernel runs its products as 3xTF32 (about 1e-6 relative) and sums in
# f32 in other orders than the plain loop's einsums, over up to S keys; bf16
# against autograd through bf16 products (the plain version rounds P and
# the products to bf16, the kernel P and dS)
FLASH_BWD_REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_BWD_MAX_ABS_OF_MAX = 1e-4      # f32: max |err| over max |plain grad|


def _flash_grads(fn, q, k, v, dout, g, kind, w, p0):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, g, mask_kind=kind, window=w, kv_pos0=p0)
    return torch.autograd.grad(out, leaves, dout)


def check_flash_bwd(gen):
    """The backward kernel against the plain version's autograd on the
    card over the forward's sweep (the 4096-token serve shapes with
    q_per_kv = 2 and 1, the VLM's 4352 positions with q_per_kv = 6, a
    window, query offsets, hd 32 and 64 with ragged S,
    views of one fused projection), the backward's edges
    (FLASH_BWD_EDGES) and the full-mask cases of FLASH_CROSS (dK / dV over
    3000 keys from 448 queries or one), f32 and bf16: one backward launch
    a call; the same bits on a second call (no atomics); and the forward's
    output with the log-sum-exp residual written bitwise the output
    without it.  The relative error norms of the cases at the serving
    length and of FLASH_CROSS are kept by case."""
    r = {"max_abs_err": 0.0, "max_rel_norm_err": 0.0,
         "max_rel_norm_err_bf16": 0.0, "cases": 0,
         "serve_len_max_rel_norm_err": {}, "cross_max_rel_norm_err": {}}
    for dtype in (F32, torch.bfloat16):
        for case in FLASH + FLASH_BWD_EDGES + [FLASH_FUSED] + FLASH_CROSS:
            q, k, v, (kind, w, p0) = _flash_inputs(gen, case, dtype)
            g = q.shape[2] // k.shape[2]
            dout = _randn(gen, tuple(q.shape), dtype)
            what = f"flash_attention_bwd{case} {dtype}"
            out0 = flash_attn._forward(q, k, v, kind, w, p0, residual=False)[0]
            out, lse = flash_attn._forward(q, k, v, kind, w, p0, residual=True)
            if not torch.equal(out0, out):
                fail(f"{what}: writing the residual changed the forward's bits")
            n0 = flash_attn.LAUNCHES["flash_attention_bwd"]
            p_0 = flash_attn.PLAIN_CALLS["flash_attention"]
            got = _flash_grads(flash_attn.flash_attention_gqa, q, k, v, dout,
                               g, kind, w, p0)
            torch.cuda.synchronize()
            if (flash_attn.LAUNCHES["flash_attention_bwd"] != n0 + 1
                    or flash_attn.PLAIN_CALLS["flash_attention"] != p_0):
                fail(f"{what}: not one backward launch, or a plain call")
            again = flash_attn.flash_attention_bwd(
                q, k, v, out, lse, dout, mask_kind=kind, window=w, kv_pos0=p0)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{what}: two calls gave other bits")
            want = _flash_grads(flash_attn.flash_attention_gqa_plain, q, k, v,
                                dout, g, kind, w, p0)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                if a.dtype != dtype or a.shape != b.shape:
                    fail(f"{what} {name}: {a.dtype} {tuple(a.shape)}")
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    fail(f"{what} {name}: non-finite")
                rel = ((a - b).norm() / b.norm()).item()
                if rel > FLASH_BWD_REL_NORM[dtype]:
                    fail(f"{what} {name}: relative error norm {rel:.3e} "
                         f"exceeds {FLASH_BWD_REL_NORM[dtype]}")
                if dtype == F32:
                    err = (a - b).abs().max().item()
                    if err > FLASH_BWD_MAX_ABS_OF_MAX * b.abs().max().item():
                        fail(f"{what} {name}: max abs err {err:.3e} exceeds "
                             f"{FLASH_BWD_MAX_ABS_OF_MAX} of max |plain|")
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["max_rel_norm_err"] = max(r["max_rel_norm_err"], rel)
                else:
                    r["max_rel_norm_err_bf16"] = max(
                        r["max_rel_norm_err_bf16"], rel)
                if case[1] in (SERVE_SEQ, VLM_SEQ) or case in FLASH_CROSS:
                    by = r["cross_max_rel_norm_err" if case in FLASH_CROSS
                           else "serve_len_max_rel_norm_err"]
                    key = f"{case[:6 if case in FLASH_CROSS else 5]} {dtype}"
                    by[key] = max(by.get(key, 0.0), rel)
            r["cases"] += 1
    r["tolerance"] = {"f32_rel_norm": 1e-5,
                      "f32_max_abs_of_max": FLASH_BWD_MAX_ABS_OF_MAX,
                      "bf16_rel_norm": 2e-2}
    return r


def measure_launch_floor():
    """The launch floor: an empty kernel of the built library (one block,
    no work), timed as one launch and as a run of back-to-back launches,
    and its host cost per call through the same ``ctypes`` path."""
    def empty(*_):
        _launch.call("empty_kernel_launch", DEV)
    return {"ms": time_ms(empty), "ms_per_launch_run": time_run_ms(empty),
            "run_launches": RUN_LAUNCHES, "host_us_per_call": host_us_per_call(empty)}


def _bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _operands(kind, shape, m, dtype, out_dtype, gen):
    """What one timed call of ``kind`` needs: a maker of the operands that
    rotate past the L2, the kernel, the plain version and the library call
    (None where no single PyTorch call computes the same function) on those
    operands, and the bytes and operations that bound it."""
    isz = torch.empty((), dtype=dtype).element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    if kind == "flash":
        return _flash_operands(shape, dtype, gen, isz)
    if kind == "flash_bwd":
        return _flash_bwd_operands(shape, dtype, gen, isz)
    n_in = int(np.prod(shape))
    if kind in ("encode", "encode_acc"):
        d, V, mm = shape[:3]
        R = shape[3] if len(shape) == 4 else 1
        coef = _randn(gen, (d, mm), F32)
        acc_shape = (V, R) if len(shape) == 4 else (V,)
        if kind == "encode":
            return ((lambda: (_randn(gen, shape, dtype),)),
                    lambda o: coded_encode(o[0], coef, out_dtype=out_dtype),
                    lambda o: coded_encode_plain(o[0], coef, out_dtype=out_dtype),
                    lambda o: _einsum(coded_encode, o[0], coef, out_dtype),
                    n_in * isz + V * R * osz, 2 * n_in)
        if d != 1:
            raise ValueError("the library yardstick of encode_acc takes d = 1")
        # one call for acc + G C with d = 1: a gemv (2D), a batched gemm
        # with one row per v (3D)
        lib = ((lambda o: torch.addmv(o[1], o[0][0], coef[0]))
               if len(shape) == 3 else
               (lambda o: torch.baddbmm(o[1][:, None, :],
                                        coef[0].expand(V, 1, mm), o[0][0])))
        return ((lambda: (_randn(gen, shape, dtype), _randn(gen, acc_shape, F32))),
                lambda o: coded_encode_acc(o[1], o[0], coef),
                lambda o: coded_encode_acc_plain(o[1], o[0], coef),
                lib, n_in * isz + 2 * V * R * 4, 2 * n_in + V * R)
    if kind == "decode":
        coef = _randn(gen, (shape[0], m), F32)
        return ((lambda: (_randn(gen, shape, dtype),)),
                lambda o: coded_decode(o[0], coef, out_dtype=out_dtype),
                lambda o: coded_decode_plain(o[0], coef, out_dtype=out_dtype),
                lambda o: _einsum(coded_decode, o[0], coef, out_dtype),
                n_in * isz + n_in // shape[0] * m * osz, 2 * n_in * m)
    n, L = shape
    W = _randn(gen, (n, m), F32)
    hy = {"lr": PIPE_LR, "momentum": 0.9, "scale": 1.0}
    return ((lambda: (_randn(gen, shape, dtype), _randn(gen, (L, m), F32),
                      _randn(gen, (L, m), F32))),
            lambda o: coded_decode_apply(o[0], W, o[1], o[2], **hy),
            lambda o: coded_decode_apply_plain(o[0], W, o[1], o[2], **hy),
            None,                # decode + momentum + update: no one call
            n_in * isz + 4 * L * m * 4, 2 * n_in * m + 6 * L * m)


def _flash_case(shape):
    """``(B, S, H, Hkv, hd)`` (causal, Sq = Sk = S) or a FLASH_CROSS case
    ``(B, Sq, Sk, H, Hkv, hd, "full")`` -> (B, Sq, Sk, H, Hkv, hd, kind,
    the (query, key) pairs the mask admits a head)."""
    if len(shape) == 5:
        B, S, H, Hkv, hd = shape
        return B, S, S, H, Hkv, hd, "causal", S * (S + 1) // 2
    B, Sq, Sk, H, Hkv, hd, kind = shape
    if kind != "full":
        raise ValueError(f"timed cross cases take the full mask, not {kind}")
    return B, Sq, Sk, H, Hkv, hd, kind, Sq * Sk


def _flash_operands(shape, dtype, gen, isz):
    """Attention at ``shape`` (``_flash_case``): the kernel, the plain
    version and ``scaled_dot_product_attention`` in the same type (the
    yardstick; the port never calls it) on the same q, k, v.  Operations:
    the pairs the mask admits (S (S + 1) / 2 a head causal, Sq Sk full),
    times 2 hd for the scores and 2 hd for P V; bytes: q, k, v read once,
    the output written once."""
    B, Sq, Sk, H, Hkv, hd, kind, pairs = _flash_case(shape)
    g = H // Hkv

    def make():
        return (_randn(gen, (B, Sq, H, hd), dtype),
                _randn(gen, (B, Sk, Hkv, hd), dtype),
                _randn(gen, (B, Sk, Hkv, hd), dtype))

    def library(o):
        q, k, v = (x.transpose(1, 2) for x in o)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=kind == "causal", enable_gqa=g > 1)

    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd) * isz
    flops = 4 * hd * B * H * pairs
    return (make,
            lambda o: flash_attn.flash_attention_gqa(*o, g, mask_kind=kind),
            lambda o: flash_attn.flash_attention_gqa_plain(*o, g,
                                                           mask_kind=kind),
            library, nbytes, flops)


def _flash_bwd_operands(shape, dtype, gen, isz):
    """The backward at ``shape`` (``_flash_case``): the kernels on a
    forward's output and residual; the plain version's autograd backward
    and ``scaled_dot_product_attention``'s backward in the same type (the
    yardstick; the port never calls it), each on a graph built once and
    kept.  Operations: the five products of the gradient over the pairs
    the mask admits (S, dP, dV, dQ, dK), 2 hd each a pair and head; bytes:
    q, k, v, o, dO and the residual read once, dq, dk, dv written once."""
    B, Sq, Sk, H, Hkv, hd, kind, pairs = _flash_case(shape)
    g = H // Hkv

    def make():
        q = _randn(gen, (B, Sq, H, hd), dtype)
        k = _randn(gen, (B, Sk, Hkv, hd), dtype)
        v = _randn(gen, (B, Sk, Hkv, hd), dtype)
        dout = _randn(gen, (B, Sq, H, hd), dtype)
        out, lse = flash_attn._forward(q, k, v, kind, 0, 0, residual=True)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        plain = flash_attn.flash_attention_gqa_plain(*leaves, g,
                                                     mask_kind=kind)
        sdpa_leaves = [x.transpose(1, 2).clone().requires_grad_()
                       for x in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            *sdpa_leaves, is_causal=kind == "causal", enable_gqa=g > 1)
        return (q, k, v, out, lse, dout, leaves, plain, sdpa_leaves, sdpa,
                dout.transpose(1, 2))

    def kernel(o):
        return flash_attn.flash_attention_bwd(*o[:6], mask_kind=kind)

    def plain(o):
        return torch.autograd.grad(o[7], o[6], o[5], retain_graph=True)

    def library(o):
        return torch.autograd.grad(o[9], o[8], o[10], retain_graph=True)

    nbytes = ((4 * B * Sq * H * hd + 4 * B * Sk * Hkv * hd) * isz
              + B * H * Sq * 4)
    flops = 5 * 2 * hd * B * H * pairs
    return make, kernel, plain, library, nbytes, flops


def _paths_since(before, prefix):
    """Launches by kernel path since the path counts ``before``, summed
    over the variants whose names start with ``prefix``."""
    now = ops.path_counts()
    return {p: sum(now[k][p] - before[k][p] for k in now if k.startswith(prefix))
            for p in ("vector", "scalar")}


def measure(kind, shape, m=None, dtype=F32, out_dtype=F32, scalar=False):
    """ms / plain_ms / library_ms / bound_ms of one kernel at one shape
    (``scalar``: every operand one element off an aligned base, the coding
    kernels' scalar path).  The operands are drawn on the card from a
    seeded generator (KERNELS_CHECK_CUT).

    ``bound_ms`` takes the bytes from device memory, so the three times are
    read on inputs that are not in the L2 cache: each call gets the next of
    enough copies of the operands to pass twice the cache's size before one
    comes round again.  ``ms_l2_warm`` is the kernel on one copy, every
    call, as the train step finds an operand that was written just before.
    The in-place kernels update their copy on every call."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    make, kernel, plain, library, nbytes, flops = _operands(
        kind, shape, m, dtype, out_dtype, gen)
    if scalar:
        aligned = make

        def make():
            return tuple(_offset_copy(x) for x in aligned())
    first = make()
    per_copy = sum(x.numel() * x.element_size() for x in first
                   if isinstance(x, torch.Tensor))
    copies = max(2, int(2 * L2_BYTES // per_copy) + 1)
    sets = [first] + [make() for _ in range(copies - 1)]
    # the coding kernels compute in f32 whatever the input type; the bf16
    # bound is the tensor cores' rate, the most the card offers for bf16.
    # Flash attention runs on the tensor cores: bf16 in one pass, f32 as
    # 3xTF32, three TF32 products for each one
    extra = {}
    if kind in ("flash", "flash_bwd") and dtype == F32:
        bound_ms, bound_by = _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        extra["bound_ms_f32_cuda_cores"] = _bound(nbytes, flops)[0]
    else:
        bound_ms, bound_by = _bound(nbytes, flops,
                                    BF16_FLOP_PER_S if dtype == torch.bfloat16
                                    else F32_FLOP_PER_S)
    paths0 = ops.path_counts()
    ms = time_ms(lambda i: kernel(sets[i % copies]))
    if kind in ("encode", "encode_acc", "decode_apply") or (
            kind == "decode" and len(shape) == 2):
        prefix = "coded_decode" if kind.startswith("decode") else "coded_encode"
        extra["path"] = [p for p, n in _paths_since(paths0, prefix).items() if n]
    # the plain flash versions take 3-170 ms a call: fewer calls
    plain_reps = (dict(reps=PLAIN_FLASH_REPS, warmup=1)
                  if kind.startswith("flash") else {})
    plain_ms = time_ms(lambda i: plain(sets[i % copies]), **plain_reps)
    library_ms = (time_ms(lambda i: library(sets[i % copies]))
                  if library is not None else None)
    ms_warm = time_ms(lambda i: kernel(sets[0]))
    if not kind.startswith("flash"):
        # the coding kernels' launch-bound regime: a run of back-to-back
        # launches on rotating operands, and the host's cost per call
        extra["ms_per_launch_run"] = time_run_ms(lambda i: kernel(sets[i % copies]))
        extra["host_us_per_call"] = host_us_per_call(lambda: kernel(sets[0]))
    return {"shape": list(shape) + ([m] if m else []),
            "dtype": str(dtype).split(".")[-1],
            "out_dtype": str(out_dtype).split(".")[-1],
            "bytes": nbytes, "input_copies": copies, "ms": ms,
            "ms_l2_warm": ms_warm, "plain_ms": plain_ms,
            "plain_reps": plain_reps.get("reps", 25),
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops,
            "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
            "achieved_TFLOPps": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": bound_ms / ms, **extra}


_FLASH_ENTRY = re.compile(r"(flash_kernel|fb_kernel|fb_dot_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)E(?:Lb([01])E)?")


def flash_kernels_ptxas(report):
    """The flash kernels' lines of ``_build.ptxas_report()`` (registers and
    spill bytes), forward and backward, under readable names such as
    ``fb_kernel f32 hd128 dkdv``; fails when the build's log names none."""
    out = {}
    for name, info in report.items():
        m = _FLASH_ENTRY.search(name)
        if m:
            kind = {"1": " dkdv", "0": " dq"}.get(m.group(4), "")
            dtype = "f32" if m.group(2) == "f" else "bf16"
            out[f"{m.group(1)} {dtype} hd{m.group(3)}{kind}"] = info
    if not out:
        fail("the build's ptxas report names no flash kernel")
    return out


# ---------------------------------------------------------------- main path
def _mlp_case(gen_seed=21):
    """A two-layer MLP as a plain parameter dict: ``w1`` (6144, 2048) and
    ``w2`` (2048, 512) are grouped on dim 0 and keep a trailing dim, so their
    encodes go through the 3D kernel and, per leaf, so do their decodes."""
    rng = np.random.default_rng(gen_seed)

    def t(shape, scale):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(DEV)

    params = {"w1": t((6144, 2048), 0.01), "b": t((512,), 0.1),
              "w2": t((2048, 512), 0.02)}

    def loss_fn(p, batch):
        h = torch.tanh(batch["x"] @ p["w1"])
        return torch.sum((h @ p["w2"] + p["b"] - batch["t"]) ** 2)

    batch = {"x": t((128, 6144), 1.0), "t": t((128, 512), 1.0)}
    return params, loss_fn, batch


# ROADMAP C.3's leaf shapes: with code (4, 3, 1, 2) the a2a schedule cuts
# each encoding into one-element chunks
SMALL_TREES = ([(8,)], [(8,), (16,)])


def check_packed_per_leaf_small():
    """Packed == per-leaf bitwise on the card, on the kernel backend, for
    the C.3 trees, both schedules and both wire types (the CPU test
    ``test_decode_matches_reference_and_packed_is_bitwise_per_leaf`` holds
    the same on the plain versions), through ``make_coded_train_step``'s
    ``aggregate`` with a straggler; each result is also held to the plain
    backend on the card at the wire type's tolerance."""
    code = make_code(4, 3, 1, 2)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(8 * code.num_subsets, 16, generator=gen).to(DEV)
    placed = CodedBatcher(code).place({"x": x})

    def loss_fn(p, b):
        return sum(torch.sum(torch.sin(b["x"][:, :v.numel()] * v))
                   for v in p.values())

    def aggregate(params, schedule, wire, packed, backend):
        arts = make_coded_train_step(
            None, code, sgd_momentum(1e-3), loss_fn=loss_fn, params_like=params,
            grad_scale=1.0, spec=coding.SchemeSpec(packed=packed, schedule=schedule,
                                                   encode_dtype=wire, backend=backend))
        if arts.coded_fraction != 1.0:
            fail(f"C.3 tree {[tuple(v.shape) for v in params.values()]}: "
                 f"coded_fraction {arts.coded_fraction}")
        inp = arts.step_inputs((1,))
        return arts.aggregate(params, placed, inp["W"], inp["mask"], inp["rho"])[0]

    cases = []
    paths0 = ops.path_counts()
    for shapes in SMALL_TREES:
        params = {f"p{i}": (0.5 * torch.randn(s, generator=gen)).to(DEV)
                  for i, s in enumerate(shapes)}
        for schedule in ("gather", "a2a"):
            for wire in ("float32", "bfloat16"):
                before = ops.launch_counts()
                leaf = aggregate(params, schedule, wire, False, "auto")
                packed = aggregate(params, schedule, wire, True, "auto")
                now = ops.launch_counts()
                launched = {k: now[k] - before[k] for k in now if now[k] != before[k]}
                plain = aggregate(params, schedule, wire, True, "ref")
                torch.cuda.synchronize()
                what = f"C.3 tree {shapes}, {schedule}, {wire} wire"
                if not (launched.get("coded_encode_2d") and launched.get("coded_decode_2d")):
                    fail(f"{what}: the kernels were not launched ({launched})")
                tol = TOL[torch.float32 if wire == "float32" else torch.bfloat16]
                for k in params:
                    if not torch.equal(leaf[k], packed[k]):
                        fail(f"{what}, leaf {k}: packed != per-leaf bitwise")
                    err = _rel_err(packed[k], plain[k])
                    if err > tol:
                        fail(f"{what}, leaf {k}: kernels vs plain backend {err:.3e}")
                cases.append({"shapes": [list(s) for s in shapes],
                              "schedule": schedule, "wire": wire,
                              "launches": launched})
    say(phase="checks_packed_small", packed_equals_per_leaf_bitwise=True,
        stragglers=[1], cases=cases,
        encode_launches_by_kernel_path=_paths_since(paths0, "coded_encode"),
        decode_launches_by_kernel_path=_paths_since(paths0, "coded_decode"))


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


KERNEL_PATHS = {}   # launches of each counted path by kernel path, of the
                    # kernels that have two (encodes, 2D decode, decode-apply)


def _note_paths(label, require_vector=True):
    """Record the launches of the path ``label`` by kernel path, read with
    its launch counts; fail if one of them left the vector path."""
    paths = {k: v for k, v in ops.path_counts().items() if v["vector"] or v["scalar"]}
    KERNEL_PATHS[label] = paths
    scalar = {k: v["scalar"] for k, v in paths.items() if v["scalar"]}
    if scalar and require_vector:
        fail(f"{label}: kernels took the scalar path {scalar}")
    return paths


def _expect(**launches):
    """Every kernel's expected launch count: the given ones, 0 elsewhere."""
    return {**{k: 0 for k in ops.launch_counts()}, **launches}


def _timed_steps(tr, batch, steps):
    """``steps`` Trainer steps, each with its wall time up to a device sync
    (a pipelined fill reports no metrics, so nothing else waits for it)."""
    logs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        m["wall_ms"] = (time.perf_counter() - t0) * 1e3
        logs.append(m)
    return logs


def profile_steps(step, step_ms, label, steps=3):
    """Where a step's time goes (``step()`` runs one), by
    ``repro_torch.bench.timing.profile_device``: says its line under the
    phase ``profile`` and returns the device's idle share."""
    prof = profile_device(step, step_ms, steps)
    say(phase="profile", path=label, **prof)
    return prof["device_idle_share"]


def pipelined_trainer(cfg, code, backend="auto"):
    return Trainer(cfg, code, optimizer=sgd_momentum(PIPE_LR, 0.9),
                   spec=coding.SchemeSpec(backend=backend, pipelined=True,
                                          fuse_apply=True),
                   straggler_source=RandomStragglers(seed=1), seed=0)


def run_pipelined_path(args, cfg, code, batch):
    """The pipelined fused ``Trainer`` at full width: 5 steps and a drain,
    counted from 0; then, outside the window, the synchronous SGD-momentum
    ``Trainer`` on the same batch for the step-time comparison."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = pipelined_trainer(cfg, code)
    logs = _timed_steps(tr, batch, STEPS)
    t0 = time.perf_counter()
    drained = tr.drain()
    torch.cuda.synchronize()
    drained["wall_ms"] = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _note_paths("logistic-paper pipelined Trainer.step")
    peak = torch.cuda.max_memory_allocated()
    first, later = logs[0], logs[1:] + [drained]
    if not (np.isnan(first["loss"]) and np.isnan(first["grad_norm"])):
        fail(f"the fill step reported metrics: {first}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in later):
        fail(f"non-finite pipelined metrics: {later}")
    losses = [m["loss"] for m in later]
    if not drained["loss"] < losses[0]:
        fail(f"pipelined loss does not decrease: {losses}")
    want = _expect(coded_encode_acc_2d=STEPS * code.n * code.d,
                   coded_decode_apply=STEPS - 1 + 1)
    if counts != want:
        fail(f"pipelined kernel launches {counts}, the steps should issue {want}")
    beta = tr.params["beta"]
    if beta.shape != (343474,) or not torch.isfinite(beta).all() or \
            beta.device.type != "cuda":
        fail("beta after the pipelined run: wrong shape, device or non-finite")
    sync = Trainer(cfg, code, optimizer=sgd_momentum(PIPE_LR, 0.9),
                   straggler_source=RandomStragglers(seed=1), seed=0)
    sync_logs = _timed_steps(sync, batch, STEPS)
    # the steady metric describes the previous batch: the first one reported
    # is the synchronous step's first
    if not np.isclose(losses[0], sync_logs[0]["loss"], rtol=1e-6, atol=0):
        fail(f"first reported pipelined loss {losses[0]} != the synchronous "
             f"step's {sync_logs[0]['loss']}")
    steady_ms = [m["wall_ms"] for m in logs[1:]]
    sync_ms = [m["wall_ms"] for m in sync_logs[1:]]
    say(phase="train_pipelined", model=cfg.name, l=cfg.d_model,
        code=[8, 4, 2, 2], global_batch=args.global_batch,
        optimizer="sgd_momentum", lr=PIPE_LR, momentum=0.9, schedule="gather",
        pipelined=True, fuse_apply=True, losses_reported=losses,
        grad_norm=[m["grad_norm"] for m in later],
        fill_ms=logs[0]["wall_ms"], steady_ms=steady_ms,
        drain_ms=drained["wall_ms"], sync_step_ms=[m["wall_ms"] for m in sync_logs],
        steady_ms_median=statistics.median(steady_ms),
        sync_ms_median_after_first=statistics.median(sync_ms),
        sync_losses=[m["loss"] for m in sync_logs], launches=counts,
        peak_memory_bytes=peak)
    return tr, counts, statistics.median(steady_ms), statistics.median(sync_ms)


def _device_batch(gen, rows, width):
    return {"x": torch.randn((rows, width), generator=gen, device=DEV),
            "y": (torch.rand(rows, generator=gen, device=DEV) < 0.5).to(torch.int32)}


def pipelined_checks(args, cfg, code, batch, tr_p):
    """On the card, kernels on both sides: fill + drain == the synchronous
    step bitwise over 3 chained batches and straggler patterns, fused and
    not; steady(b1, W0) retires exactly the synchronous update of b0; the
    pipelined run against the plain backend."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    batcher = CodedBatcher(code)
    placed = [batcher.place(b) for b in
              [batch] + [_device_batch(gen, args.global_batch, cfg.d_model)
                         for _ in range(2)]]
    opt = sgd_momentum(1e-4, 0.9)
    arts_s = make_coded_train_step(cfg, code, opt)
    beta0 = {"beta": 1e-3 * torch.randn(cfg.d_model, generator=gen, device=DEV)}
    gnorm_rel = {}
    for fuse in (False, True):
        arts_p = make_coded_train_step(
            cfg, code, opt,
            spec=coding.SchemeSpec(pipelined=True, fuse_apply=fuse))
        ps = pp = beta0
        os_ = op = opt.init(beta0)
        drv = PipelineDriver(arts_p)
        rel = 0.0
        for b, st in zip(placed, PATTERNS):
            inp = arts_s.step_inputs(st)
            a = (inp["W"], inp["mask"], inp["rho"])
            ps, os_, ms = arts_s.step(ps, os_, b, *a)
            pp, op, mp = drv.step(pp, op, b, *a)
            if mp is not None:
                fail("a pipelined fill returned metrics")
            pp, op, mp = drv.drain(pp, op)
            if not (torch.equal(ps["beta"], pp["beta"])
                    and torch.equal(os_["mu"]["beta"], op["mu"]["beta"])
                    and torch.equal(ms["loss"], mp["loss"])):
                fail(f"fill + drain (fuse_apply={fuse}) differs from the "
                     f"synchronous step bitwise at stragglers {st}")
            rel = max(rel, abs(mp["grad_norm"].item() / ms["grad_norm"].item() - 1))
            if (not fuse and not torch.equal(ms["grad_norm"], mp["grad_norm"])) \
                    or rel > 1e-5:
                fail(f"fill + drain (fuse_apply={fuse}) grad_norm off by {rel:.3e}")
        gnorm_rel[f"fuse_apply={fuse}"] = rel
        inp0, inp1 = arts_s.step_inputs((1,)), arts_s.step_inputs(())
        st0 = opt.init(beta0)
        wire = arts_p.pipeline.fill(beta0, placed[0], inp0["mask"], inp0["rho"])
        out = arts_p.pipeline.steady(beta0, st0, placed[1], inp0["W"],
                                     inp1["mask"], inp1["rho"], *wire)
        ps, os_, ms = arts_s.step(beta0, st0, placed[0], inp0["W"],
                                  inp0["mask"], inp0["rho"])
        torch.cuda.synchronize()
        if not (torch.equal(out[0]["beta"], ps["beta"])
                and torch.equal(out[1]["mu"]["beta"], os_["mu"]["beta"])
                and torch.equal(out[2]["loss"], ms["loss"])):
            fail(f"steady(b1, W0) (fuse_apply={fuse}) is not the synchronous "
                 f"update of b0 bitwise")
    ref = pipelined_trainer(cfg, code, backend="ref")
    _timed_steps(ref, batch, STEPS)
    ref.drain()
    want = ref.params["beta"]
    err = _rel_err(tr_p.params["beta"], want)
    if not torch.allclose(tr_p.params["beta"], want, rtol=1e-4,
                          atol=1e-4 * want.abs().max().item()):
        fail(f"pipelined beta: kernels vs plain backend differ by {err:.3e}")
    say(phase="checks_pipelined", fill_drain_bitwise=True,
        steady_retires_sync_update_bitwise=True, patterns=PATTERNS,
        grad_norm_rel_err=gnorm_rel, beta_rel_err_vs_plain_backend=err)


def run_main_path(args):
    cfg = get_config("logistic-paper")
    code = make_code(8, 4, 2, 2)
    lr = 1e-6
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    batch = make_synthetic_batch(rng, cfg, args.global_batch)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    def trainer(backend):
        return Trainer(cfg, code, optimizer=nag(lr),
                       spec=coding.SchemeSpec(backend=backend),
                       straggler_source=RandomStragglers(seed=1), seed=0)

    # ---- the first counted path: every launch count is 0 just before it
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = trainer("auto")
    if tr.arts.coded_fraction != 1.0:
        fail(f"coded_fraction {tr.arts.coded_fraction} != 1.0: beta is not coded")
    if tr.arts.codec.backend.name != "hopper":
        fail(f"backend {tr.arts.codec.backend.name!r} on the card, not the kernels")
    logs = [tr.step(batch) for _ in range(STEPS)]
    torch.cuda.synchronize()
    counts_train = ops.launch_counts()
    _note_paths("logistic-paper Trainer.step")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in logs]
    if not all(np.isfinite(list(m.values())).all() for m in logs):
        fail(f"non-finite metrics: {logs}")
    # NAG's lambda sequence starts at 0, so its first step leaves the carried
    # point where it was: the loss moves from the second step on
    if not (losses[-1] < losses[0]
            and all(b < a for a, b in zip(losses[1:], losses[2:]))):
        fail(f"loss does not decrease: {losses}")
    want = _expect(coded_encode_2d=STEPS * code.n * code.d,
                   coded_decode_2d=STEPS)
    if counts_train != want:
        fail(f"kernel launches {counts_train}, the steps should issue {want}")
    beta = tr.params["beta"]
    if beta.shape != (343474,) or not torch.isfinite(beta).all() or \
            beta.device.type != "cuda":
        fail("beta after training: wrong shape, device or non-finite")
    steps_ms = [m["step_time_s"] * 1e3 for m in logs]
    say(phase="train", model=cfg.name, l=cfg.d_model, code=[8, 4, 2, 2],
        global_batch=args.global_batch, optimizer="nag", lr=lr,
        schedule="gather", packed=True, coded_fraction=tr.arts.coded_fraction,
        bucket_len=tr.arts.pack_plan.buckets[0].size, losses=losses,
        grad_norm=[m["grad_norm"] for m in logs], step_ms=steps_ms,
        step_ms_median_after_first=statistics.median(steps_ms[1:]),
        launches=counts_train, collectives=tr.arts.comm.counts,
        peak_memory_bytes=peak, batch_on_device_s=data_s)

    # ---- the second counted path, with counts of its own
    tr_p, counts_pipe, steady_ms, sync_sgd_ms = run_pipelined_path(
        args, cfg, code, batch)

    # ---- the third counted path, with counts of its own: a generic
    # parameter dict whose leaves keep trailing dims, synchronous (per leaf,
    # packed) and pipelined fused (fill + drain)
    params, loss_fn, mbatch = _mlp_case()
    placed = CodedBatcher(code).place(mbatch)
    grads = {}
    mopt = sgd_momentum(1e-3)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for key, spec in (("leaf", coding.SchemeSpec(packed=False)),
                      ("packed", coding.SchemeSpec()),
                      ("pipelined", coding.SchemeSpec(pipelined=True,
                                                      fuse_apply=True)),
                      ("ref", coding.SchemeSpec(packed=False, backend="ref"))):
        if key == "ref":
            torch.cuda.synchronize()
            counts_mlp = ops.launch_counts()      # read just after the drive
            _note_paths("mlp make_coded_train_step")
        arts = make_coded_train_step(None, code, mopt,
                                     loss_fn=loss_fn, params_like=params,
                                     grad_scale=1.0, spec=spec)
        inp = arts.step_inputs((2, 5))
        if key == "pipelined":
            drv = PipelineDriver(arts)
            drv.step(params, mopt.init(params), placed, inp["W"], inp["mask"],
                     inp["rho"])
            pipe_p, pipe_s, _ = drv.drain(params, mopt.init(params))
            continue
        grads[key], _ = arts.aggregate(params, placed, inp["W"], inp["mask"],
                                       inp["rho"])
    torch.cuda.synchronize()
    # per leaf and packed alike, each worker encodes each of its d subset
    # gradients leaf by leaf: w1 and w2 through the 3D kernel, b through the
    # 2D one; per leaf every leaf is decoded alone, packed the one bucket is;
    # the pipelined fill folds the same encodes into the bucket
    # (coded_encode_acc) and the drain decodes and applies it in one launch
    per_drive = code.n * code.d
    want = _expect(coded_encode_2d=2 * per_drive, coded_encode_3d=4 * per_drive,
                   coded_decode_2d=1 + 1, coded_decode_3d=2,
                   coded_encode_acc_2d=per_drive,
                   coded_encode_acc_3d=2 * per_drive, coded_decode_apply=1)
    if counts_mlp != want:
        fail(f"generic step: kernel launches {counts_mlp}, the three drives "
             f"should issue {want}")
    if ops.launch_counts() != counts_mlp:
        fail("the plain backend launched a kernel")
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    direct = dict(zip(p, torch.autograd.grad(loss_fn(p, mbatch), list(p.values()))))
    mlp = {}
    for k in params:
        mlp[k] = {"vs_plain": _rel_err(grads["leaf"][k], grads["ref"][k]),
                  "vs_uncoded": _rel_err(grads["leaf"][k], direct[k]),
                  "packed_bitwise": bool(torch.equal(grads["leaf"][k],
                                                     grads["packed"][k]))}
        if mlp[k]["vs_plain"] > 1e-4 or mlp[k]["vs_uncoded"] > 1e-4:
            fail(f"generic step, leaf {k}: {mlp[k]}")
        if not mlp[k]["packed_bitwise"]:
            fail(f"generic step, leaf {k}: packed != per-leaf bitwise")
    # the synchronous update of the packed gradient (the optimizer alone:
    # no kernel) against the pipelined fused fill + drain, bit for bit
    sync_p, sync_s = mopt.update(grads["packed"], mopt.init(params), params)
    for k in params:
        mlp[k]["pipelined_fused_bitwise"] = bool(
            torch.equal(sync_p[k], pipe_p[k])
            and torch.equal(sync_s["mu"][k], pipe_s["mu"][k]))
        if not mlp[k]["pipelined_fused_bitwise"]:
            fail(f"generic step, leaf {k}: pipelined fused != sync bitwise")
    say(phase="train_generic", leaves={k: list(v.shape) for k, v in params.items()},
        stragglers=[2, 5], rel_err=mlp, seconds=time.perf_counter() - t0,
        launches=counts_mlp)

    # ---- checks outside the window
    ref = trainer("ref")
    ref_logs = [ref.step(batch) for _ in range(STEPS)]
    err = _rel_err(tr.params["beta"], ref.params["beta"])
    if not torch.allclose(tr.params["beta"], ref.params["beta"], rtol=1e-4,
                          atol=1e-4 * ref.params["beta"].abs().max().item()):
        fail(f"beta after {STEPS} steps: kernels vs plain backend differ "
             f"by {err:.3e} relative")
    inp = tr.arts.step_inputs((2, 5))
    placed = tr.batcher.place(batch)
    gen = torch.Generator().manual_seed(3)
    beta0 = (1e-3 * torch.randn(cfg.d_model, generator=gen)).to(DEV)
    g, _ = tr.arts.aggregate({"beta": beta0}, placed, inp["W"], inp["mask"],
                             inp["rho"])
    x, y = batch["x"], batch["y"].to(F32)
    uncoded = x.T @ (torch.sigmoid(x @ beta0) - y)
    gerr = _rel_err(g["beta"], uncoded)
    if gerr > 1e-4:
        fail(f"decoded gradient with stragglers (2, 5) differs from the "
             f"uncoded sum by {gerr:.3e} relative")
    say(phase="checks", beta_rel_err_vs_plain_backend=err,
        loss_plain_backend=[m["loss"] for m in ref_logs],
        plain_backend_step_ms=[m["step_time_s"] * 1e3 for m in ref_logs],
        decoded_grad_rel_err_2_stragglers=gerr)
    pipelined_checks(args, cfg, code, batch, tr_p)
    if args.profile:
        idle_sync = profile_steps(lambda: tr.step(batch),
                                  statistics.median(steps_ms[1:]),
                                  "synchronous NAG")
        tr_p.step(batch)                  # fill, then 3 steady steps
        torch.cuda.synchronize()
        idle_steady = profile_steps(lambda: tr_p.step(batch), steady_ms,
                                    "pipelined steady")
        tr_p.drain()
        say(phase="profile_idle", sync_nag=idle_sync, pipelined_steady=idle_steady,
            sync_sgd_step_ms=sync_sgd_ms, steady_step_ms=steady_ms)
    return {"logistic-paper Trainer.step": counts_train,
            "logistic-paper pipelined Trainer.step": counts_pipe,
            "mlp make_coded_train_step": counts_mlp}


# ------------------------------------------------------------- serve path
def _bitwise(a, b):
    """Equal bits (f32/int32 tensors of one shape, any devices)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def run_checkpoint_resume(args):
    """Checkpoint phase (a): a crash while the step-6 snapshot is written
    and a resume past it, on ``logistic-paper`` at full width.

    The uninterrupted run takes 6 steps with a snapshot every 2.  The
    step-6 file is then torn to a third of its size; a fresh ``Trainer`` on
    the same directory warns ``unreadable`` and resumes from step 4.  The
    data stream is replayed to its cursor by ``skip_to_cursor`` and the
    straggler stream by drawing the 4 patterns already inside the
    parameters (the trainer, like the reference's, keeps no straggler
    state), so its 2 steps (counted from 0) are the run's steps 5 and 6 and
    must give the same bits."""
    cfg = get_config("logistic-paper")
    code = make_code(8, 4, 2, 2)
    lr = 1e-6
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t_phase = time.perf_counter()

    def batches():
        rng = np.random.default_rng(SEED + 7)
        while True:
            yield {k: torch.from_numpy(v).to(DEV) for k, v in
                   make_synthetic_batch(rng, cfg, CKPT_BATCH).items()}

    def stragglers(skip):
        src = RandomStragglers(seed=1)
        for i in range(skip):
            src.draw(i, code)
        return src

    def trainer(skip):
        return Trainer(cfg, code, optimizer=nag(lr), seed=0, device=DEV,
                       straggler_source=stragglers(skip), checkpoint_dir=d,
                       checkpoint_every=CKPT_EVERY)

    try:
        tr = trainer(0)
        stream = batches()
        t0 = time.perf_counter()
        logs = [tr.step(next(stream)) for _ in range(CKPT_STEPS)]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        saved = tr._ckpt.steps()
        if saved != [2, 4, 6]:
            fail(f"checkpoint: snapshots at steps {saved}, not [2, 4, 6]")
        p6 = tr._ckpt.dir / "ckpt_00000006.npz"
        size = p6.stat().st_size
        p6.write_bytes(p6.read_bytes()[: size // 3])

        # ---- the counted path: the resumed trainer's construction and steps
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr2 = trainer(4)
        restore_s = time.perf_counter() - t0
        said = [str(w.message) for w in caught]
        if not any("unreadable" in m for m in said):
            fail(f"checkpoint: no 'unreadable' warning past the torn file: {said}")
        if (tr2._step_count, tr2._data_cursor) != (4, 4):
            fail(f"checkpoint: resumed at step {tr2._step_count}, cursor "
                 f"{tr2._data_cursor}, not 4 and 4")
        stream2 = tr2.skip_to_cursor(batches())
        logs2 = [tr2.step(next(stream2)) for _ in range(CKPT_STEPS - 4)]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        _note_paths("logistic-paper Trainer resumed from a checkpoint")
        want = _expect(coded_encode_2d=2 * code.n * code.d, coded_decode_2d=2)
        if counts != want:
            fail(f"checkpoint: the resumed steps launched {counts}, not {want}")
        same = {"beta": _bitwise(tr.params["beta"], tr2.params["beta"]),
                "x_prev": _bitwise(tr.opt_state["x_prev"]["beta"],
                                   tr2.opt_state["x_prev"]["beta"]),
                "lam": _bitwise(tr.opt_state["lam"], tr2.opt_state["lam"]),
                "losses": [m["loss"] for m in logs[4:]] ==
                          [m["loss"] for m in logs2]}
        if not all(same.values()):
            fail(f"checkpoint: the resumed run differs from the uninterrupted "
                 f"one: {same}")
        resaved = tr2._ckpt.steps()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    say(phase="checkpoint", part="a", model=cfg.name, l=cfg.d_model,
        code=[8, 4, 2, 2], optimizer="nag", lr=lr, global_batch=CKPT_BATCH,
        steps=CKPT_STEPS, checkpoint_every=CKPT_EVERY, snapshots=saved,
        snapshot_bytes=size, torn_to_bytes=size // 3,
        warnings=[m[:120] for m in said], resumed_at_step=4,
        run_s=run_s, restore_s=restore_s, snapshots_after_resume=resaved,
        bitwise=same, launches=counts, losses=[m["loss"] for m in logs],
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


def _requests(rng, cfg, rows, seq=SERVE_SEQ):
    """``rows`` requests of ``seq`` tokens from ``rng``, and for a VLM
    each one's patch embeddings (n_frontend_tokens, d_model) in f32; an
    encoder-decoder's request is ``seq`` frame embeddings alone."""
    if cfg.family == "encdec":
        return {"embeds": rng.standard_normal((rows, seq, cfg.d_model),
                                              dtype=np.float32)}
    req = {"tokens": rng.integers(0, cfg.vocab, (rows, seq),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        req["embeds"] = rng.standard_normal(
            (rows, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    return req


def run_serve_path(args, arch="qwen3-1.7b", n_batches=SERVE_BATCHES,
                   phase="serve", n_layers=None, reduced=None, seq=SERVE_SEQ,
                   hedge=True, label=None, into=None):
    """``CodedServer`` on ``arch`` at full width with prompts of ``seq``
    tokens (after their patch embeddings for a VLM; ``seq`` frames for an
    encoder-decoder), one prompt a subset; ``n_layers`` cuts the depth
    (listed in the phase line's ``reduced``).  ``label`` names the path
    (default: the model's ``CodedServer.step``); with ``into`` a dict, the
    phase line goes there instead of to the output.

    Counted window: the launch counts and the plain flash version's call
    count are set to 0 just before the batches are submitted and read just
    after the last one is stepped; every encode and decode must take the
    vector path.  Outside it: the uncoded forward of each of the first
    batch's prompts alone, as the coded forward runs each subset (an MoE
    forward depends on its batch: the experts' capacity counts its
    tokens), the hedge, and the straggler-free serve (with ``hedge``:
    three more coded batches); for an MoE model also the share of picks
    each layer drops on the first prompt; for an SSM model the device's
    idle share over a traced forward of a prompt's first SSM_TRACE_SEQ
    tokens (the forward a served batch runs n * d times, shorter), for a
    hybrid or an encoder-decoder over a traced forward of a whole
    prompt."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    code = make_code(*SERVE_CODE)
    k = code.num_subsets
    label = label or f"{cfg.name} CodedServer.step"
    gc.collect()
    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = model_api.init(cfg, DEV, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    rng = np.random.default_rng(SEED)
    requests = _requests(rng, cfg, n_batches * k, seq)
    srv = CodedServer(cfg, code, params, batch_per_subset=1, seq_len=seq,
                      straggler_source=RandomStragglers(seed=2), device=DEV)
    if srv.artifacts.codec.backend.name != "hopper":
        fail(f"serve backend {srv.artifacts.codec.backend.name!r}, not the kernels")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    for j in range(n_batches * k):
        srv.submit({key: v[j] for key, v in requests.items()})
    results, per_batch, step_ms = [], [], []
    before = ops.launch_counts()
    while True:
        t1 = time.perf_counter()
        res = srv.step()
        if res is None:
            break
        step_ms.append((time.perf_counter() - t1) * 1e3)
        now = ops.launch_counts()
        per_batch.append({kk: now[kk] - before[kk] for kk in now if now[kk] != before[kk]})
        before = now
        results.append(res)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    serve_paths = _note_paths(label)
    plain_calls = flash_attn.PLAIN_CALLS["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if plain_calls:
        fail(f"the serving path called the plain flash version {plain_calls} times")
    per_prefill = flash_layers(cfg, seq)
    want_batch = {"flash_attention": code.n * code.d * per_prefill,
                  "coded_encode_2d": code.n * code.d, "coded_decode_2d": 1}
    want_batch = {kk: v for kk, v in want_batch.items() if v}
    if len(results) != n_batches or any(pb != want_batch for pb in per_batch):
        fail(f"{label}: launches per batch {per_batch}, expected {want_batch} "
             f"in each of {n_batches} batches")
    for res in results:
        if res.outputs.shape != (k, cfg.vocab) or not np.isfinite(res.outputs).all():
            fail(f"served outputs: shape {res.outputs.shape} or non-finite")
        if res.failed_rows:
            fail(f"failed request rows {res.failed_rows} within the design s")
    ids = [r.req_id for res in results for r in res.requests]
    if ids != list(range(1, n_batches * k + 1)):
        fail(f"requests served out of order: {ids}")

    # ---- outside the window: the uncoded forward of each of batch 0's
    # prompts alone
    batch0 = {key: v[:k] for key, v in requests.items()}
    first = {key: torch.from_numpy(v).to(DEV) for key, v in batch0.items()}
    forward = model_api.make_forward(cfg)
    t1 = time.perf_counter()
    with torch.no_grad():
        direct = torch.cat([forward(params, {key: v[j:j + 1]
                                             for key, v in first.items()})
                            for j in range(k)])
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t1) * 1e3
    direct = direct.cpu().numpy()
    extra = {}
    if cfg.family == "moe":
        extra = {"dropped_pick_share_by_layer": _moe_dropped_share(
            lambda: forward(params, {"tokens": first["tokens"][:1]}))}
    scale = float(np.abs(direct).max())
    err = float(np.abs(results[0].outputs - direct).max())
    if err > SERVE_REL_TOL * max(1.0, scale):
        fail(f"decoded logits differ from the uncoded forward by {err:.3e} "
             f"(max |logit| {scale:.3e}, tolerance {SERVE_REL_TOL} of it)")
    if cfg.family in ("ssm", "hybrid", "encdec"):
        # the device's idle share over the forward of the first prompt
        # (an SSM's first SSM_TRACE_SEQ tokens: a whole prompt's 100 K
        # launches take the profiler half a minute to read), traced
        trace_seq = SSM_TRACE_SEQ if cfg.family == "ssm" else seq
        one = {key: v[:1, :trace_seq] for key, v in first.items()}
        with torch.no_grad():
            forward(params, one)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            forward(params, one)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t2) * 1e3
            busy_s, n_launch = _device_busy_s(lambda: forward(params, one))
        extra.update(traced_forward_tokens=trace_seq,
                     traced_forward_ms=one_ms,
                     traced_forward_device_busy_ms=busy_s * 1e3,
                     traced_forward_launches=n_launch,
                     device_idle_share_traced_forward=1.0 - busy_s * 1e3
                     / one_ms)
    if hedge:
        extra.update(_serve_hedge(srv, code, params, batch0, first, rng,
                                  scale))
    if args.profile:
        profile_steps(lambda: srv.serve_batch(batch0),
                      statistics.median(r.wall_s * 1e3 for r in results),
                      f"{cfg.name} coded serve batch", steps=1)
    line = dict(
        phase=phase, path=label, model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, params=n_params,
        param_bytes=sum(v.numel() * v.element_size() for v in params.values()),
        init_s=init_s, code=list(SERVE_CODE), batch_requests=k,
        seq_len=seq, positions=seq + (
            cfg.n_frontend_tokens if cfg.family == "vlm" else 0),
        flash_launches_per_prefill=per_prefill,
        batches=len(results), **({"reduced": reduced} if reduced else {}),
        stragglers=[list(r.stragglers) for r in results],
        wall_ms=[r.wall_s * 1e3 for r in results], step_ms=step_ms,
        launches_per_batch=per_batch, launches=counts,
        launches_by_kernel_path=serve_paths,
        plain_flash_calls=plain_calls, peak_memory_bytes=peak,
        uncoded_forward_ms=direct_ms, max_abs_logit=scale,
        max_abs_err_vs_uncoded=err, tolerance=SERVE_REL_TOL * max(1.0, scale),
        memory_at_start_bytes=at_start, **extra,
        seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    if into is None:
        say(**line)
    else:
        into.update(line)
    return counts, len(results), params


def _device_busy_s(fn):
    """The device's busy time (the union of its kernels' intervals) and
    its launches over one call of ``fn``, traced with ``torch.profiler``
    from the device's activity alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and e.time_range.end > e.time_range.start]
    if not spans:
        fail("torch.profiler recorded no device time")
    return _union_us(spans) / 1e6, len(spans)


def _serve_hedge(srv, code, params, batch0, first, rng, scale):
    """The hedge: under the pattern's W the straggler's payload never
    reaches the output bits (its prompts replaced by others: the same
    bits); and the straggler-free serve within SERVE_REL_TOL of it."""
    seq = first["tokens"].shape[1]
    hedged = srv.serve_batch(batch0, stragglers=(1,))
    arts = srv.artifacts
    placed = CodedBatcher(code).place(first)
    for key, v in _requests(rng, srv.cfg, code.d, seq).items():
        placed[key][1] = torch.from_numpy(v[:, None]).to(DEV)
    inp = arts.step_inputs((1,))
    with torch.no_grad():
        junk = arts.step(params, placed, inp["W"], inp["mask"], inp["rho"])
    junk = junk.cpu().numpy()
    if not np.array_equal(junk, hedged.outputs):
        fail("a straggler's payload changed the decoded bits")
    full = srv.serve_batch(batch0, stragglers=())
    diff_full = float(np.abs(full.outputs - hedged.outputs).max())
    if diff_full > SERVE_REL_TOL * max(1.0, scale):
        fail(f"stragglers (1,) and () decode {diff_full:.3e} apart")
    return {"hedge_bitwise": True,
            "stragglers_1_vs_none_max_abs_diff": diff_full,
            "hedged_wall_ms": hedged.wall_s * 1e3,
            "unhedged_wall_ms": full.wall_s * 1e3}


def _moe_dropped_share(run):
    """The share of the top-k picks each MoE layer drops while ``run()``
    runs, read from the scatter dispatch of the port's own routing (the
    module keeps no counter)."""
    kept = []
    dispatch = moe.dispatch

    def record(*a):
        r = dispatch(*a)
        kept.append(r.keep)
        return r

    moe.dispatch = record
    try:
        with torch.no_grad():
            run()
    finally:
        moe.dispatch = dispatch
    return [1.0 - k.float().mean().item() for k in kept]


# ------------------------------------------------------------ autotune paths
AT_CODE = (8, 4, 2, 2)         # (n, d, s, m) the autotuned trainer starts at
AT_STEPS = 16                  # steps of the autotuned logistic-paper run
AT_PIPE_STEPS = 3              # pipelined steps before and after the swap
AT_SERVE_CODE = (4, 3, 1, 2)   # the autotuned server's first scheme
AT_SERVE_BATCHES = 7           # batches the autotuned server serves (10
#                                until the dist phase came in; the code
#                                changed at batch 6, and 5 batches ran one)
# the drift of the reference's trainer tests (tests/test_tune.py:406-407):
# communication-heavy (t2 = 16 s) before the switch, compute-heavy after
AT_DRIFT = (dict(lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0),
            dict(lambda1=0.5, lambda2=0.2, t1=16.0, t2=0.5))


def _drift(n, at, seed):
    """A timed straggler source at ``n`` workers whose constants switch from
    ``AT_DRIFT[0]`` to ``AT_DRIFT[1]`` at step ``at``."""
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.tune import DriftingSampler
    pa, pb = (RuntimeParams(n=n, **kw) for kw in AT_DRIFT)
    return DriftingSampler([(0, pa), (at, pb)], seed=seed)


def _at_policy():
    """The trainer's tuning policy of autotune_train and dist (d): a
    re-plan every 3 steps over exact and FRC plans."""
    from repro_torch.tune import AutotunePolicy
    return AutotunePolicy(interval=3, window=6, min_samples=3,
                          schedules=("gather",), npts=4000,
                          approx_options=("frc",), max_err=3.0)


def _plan_label(plan):
    return (f"{plan.family}({plan.d},{plan.s},{plan.m})"
            + (",pipelined" if plan.pipelined else ""))


def _launch_delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}


def _path_delta(p0, p1):
    out = {}
    for k in p1:
        d = {p: p1[k][p] - p0[k][p] for p in ("vector", "scalar")}
        if d["vector"] or d["scalar"]:
            out[k] = d
    return out


def _add_into(total, delta):
    for k, v in delta.items():
        if isinstance(v, dict):
            _add_into(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0) + v


def _coded_launches(launches):
    return sum(v for k, v in launches.items() if k.startswith("coded_"))


def _record_scheme(schemes, label, launches, paths, **row):
    """Fold one step's (or batch's) launches and times into its scheme."""
    sc = schemes.setdefault(label, {"steps": 0, "launches": {},
                                    "launches_by_kernel_path": {}})
    sc["steps"] += 1
    _add_into(sc["launches"], launches)
    _add_into(sc["launches_by_kernel_path"], paths)
    for k, v in row.items():
        sc.setdefault(k, []).append(v)


def _coding_times(enc_shape, dec_shape):
    """The 2D encode and decode timed at one scheme's own shapes, on their
    vector path and, one element off an aligned base, on their scalar
    path (``dec_shape`` is ``(n, L, m)``)."""
    n, L, m = dec_shape
    row = {"m": m}
    for kname, kind, shape, mm in (("encode", "encode", enc_shape, None),
                                   ("decode", "decode", (n, L), m)):
        for path in ("vector", "scalar"):
            meas = measure(kind, shape, m=mm, scalar=path == "scalar")
            if meas["path"] != [path]:
                fail(f"{kname} {shape} took the {meas['path']} path, "
                     f"timed as {path}")
            row[kname] = {**row.get(kname, {}), "shape": meas["shape"],
                          "bound_ms": meas["bound_ms"],
                          "plain_ms": meas["plain_ms"],
                          f"{path}_ms": meas["ms"],
                          f"{path}_ms_per_launch_run":
                              meas["ms_per_launch_run"]}
    return row


def _forced_plan(family, d, s, m, n, **kw):
    from repro_torch.tune import Plan
    return Plan(family=family, d=d, s=s, m=m, k=kw.pop("k", n),
                loads=kw.pop("loads", (d,) * n), schedule="gather",
                packed=True, predicted_wait_s=0.0, predicted_step_s=0.0,
                predicted_total_s=0.0, **kw)


def run_autotune_train(args):
    """The autotuned ``Trainer`` on logistic-paper at full width.

    (a) counted window: launch counts set to 0 just before a synchronous
    NAG trainer with ``autotune=AutotunePolicy(...)`` (exact and FRC plans)
    under a drifting timed source takes 16 steps; each step's launches by
    kernel and kernel path go to the scheme it ran under.  Outside it: a
    twin on the plain backend replays the same swaps at the same steps
    (beta within rtol 1e-4), and a swap back to the first scheme builds no
    artifact.  (b) a pipelined fused trainer swaps while an update is in
    flight: the swap itself launches one ``coded_decode_apply`` (the drain
    under the outgoing code), and the run agrees with its plain twin.
    (c) one step under each of a forced rotation, block, hetero and
    expander plan.  Then the coding kernels are timed at every coded
    scheme's own shapes, on both kernel paths."""
    from repro_torch.core import plan_hetero
    cfg = get_config("logistic-paper")
    n = AT_CODE[0]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in
             make_synthetic_batch(rng, cfg, args.global_batch).items()}
    policy = _at_policy()
    lr = 1e-6

    def trainer(backend, autotune=None, pipelined=False):
        opt = sgd_momentum(PIPE_LR, 0.9) if pipelined else nag(lr)
        spec = coding.SchemeSpec(backend=backend, pipelined=pipelined,
                                 fuse_apply=pipelined or None)
        return Trainer(cfg, make_code(*AT_CODE), optimizer=opt, spec=spec,
                       straggler_source=_drift(n, 6, 3), autotune=autotune,
                       seed=0)

    # ---- (a) the counted path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = trainer("auto", policy)
    if tr.arts.codec.backend.name != "hopper":
        fail(f"autotune: backend {tr.arts.codec.backend.name!r}, not the kernels")
    first_plan = tr._current_plan()
    applied, replan_ms = [], []
    apply_plan, replan = tr._apply_plan, tr._tuner.maybe_replan

    def recording_apply(plan):
        applied.append((tr._step_count, plan))
        apply_plan(plan)

    def timed_replan(*a, **kw):
        events = len(tr._tuner.events)
        t0 = time.perf_counter()
        out = replan(*a, **kw)
        if len(tr._tuner.events) != events:
            replan_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr._apply_plan, tr._tuner.maybe_replan = recording_apply, timed_replan
    schemes, logs = {}, []
    for _ in range(AT_STEPS):
        label = _plan_label(tr._current_plan())
        frac = tr.arts.coded_fraction
        c0, p0 = ops.launch_counts(), ops.path_counts()
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        logs.append(m)
        _record_scheme(schemes, label, _launch_delta(c0, ops.launch_counts()),
                       _path_delta(p0, ops.path_counts()),
                       step_ms=m["step_time_s"] * 1e3, wall_ms=wall,
                       coded_fraction=frac)
    counts = ops.launch_counts()
    del tr._apply_plan, tr._tuner.maybe_replan      # the methods again
    label_a = "logistic-paper autotuned Trainer.step"
    paths = _note_paths(label_a, require_vector=False)
    peak = torch.cuda.max_memory_allocated()
    switched = [e for e in tr.autotune_events if e["switched"]]
    if not switched:
        fail(f"autotune_train: the tuner never switched: {tr.autotune_events}")
    if len(tr.telemetry) != AT_STEPS or tr.cached_schemes < 2:
        fail(f"autotune_train: {len(tr.telemetry)} records and "
             f"{tr.cached_schemes} cached schemes after {AT_STEPS} steps")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in logs):
        fail(f"autotune_train: non-finite metrics {logs}")
    if not _coded_launches(counts):
        fail("autotune_train: no coding kernel was launched")
    for label, sc in schemes.items():
        # l = 343474 = 2 * 171737: only m in (1, 2) groups beta; for any
        # other m the leaf rides the straggler-aware weighted sum uncoded
        coded = sc["coded_fraction"][0] == 1.0
        enc, dec = (sc["launches"].get("coded_encode_2d", 0),
                    sc["launches"].get("coded_decode_2d", 0))
        if coded and not (enc and dec):
            fail(f"autotune_train: scheme {label} codes beta but launched "
                 f"encode {enc} / decode {dec} times")
        if not coded and _coded_launches(sc["launches"]):
            fail(f"autotune_train: scheme {label} does not code beta but "
                 f"launched {sc['launches']}")
    # ---- outside the window: the plain-backend twin replays the swaps
    twin = trainer("ref")
    for t in range(AT_STEPS):
        twin.step(batch)
        for at, plan in applied:
            if at == t:
                twin._apply_plan(plan)
    torch.cuda.synchronize()
    b_k, b_p = tr.params["beta"], twin.params["beta"]
    atol = 1e-4 * b_p.abs().max().item()
    beta_err = _rel_err(b_k, b_p)
    if twin._scheme_sig != tr._scheme_sig or \
            not torch.allclose(b_k, b_p, rtol=1e-4, atol=atol):
        fail(f"autotune_train: beta against the plain twin {beta_err:.3e} "
             f"relative (schemes {tr._scheme_sig} / {twin._scheme_sig})")
    # a return to the first scheme (and a round trip more) builds nothing
    # once the first scheme has artifacts in the trainer's partial mode
    last_plan = tr._current_plan()
    cached0 = tr.cached_schemes
    tr._apply_plan(first_plan)
    cached1 = tr.cached_schemes
    tr._apply_plan(last_plan)
    tr._apply_plan(first_plan)
    if tr.cached_schemes != cached1 or (cached1 != cached0 and not tr.partial):
        fail(f"autotune_train: swaps back rebuilt artifacts ({cached0} -> "
             f"{cached1} -> {tr.cached_schemes})")
    run_a_s = time.perf_counter() - t_phase

    # ---- (b) a pipelined swap while an update is in flight
    plan_b = _forced_plan("uniform", 3, 1, 2, n, pipelined=True)
    pipe = {}
    for backend in ("auto", "ref"):
        tp = trainer(backend, pipelined=True)
        plog = [tp.step(batch) for _ in range(AT_PIPE_STEPS)]
        torch.cuda.synchronize()
        c0 = ops.launch_counts()
        if not tp._driver.in_flight:
            fail("autotune_train (b): nothing in flight before the swap")
        tp._apply_plan(plan_b)
        torch.cuda.synchronize()
        swap_launches = _launch_delta(c0, ops.launch_counts())
        plog += [tp.step(batch) for _ in range(AT_PIPE_STEPS)]
        plog.append(tp.drain())
        torch.cuda.synchronize()
        pipe[backend] = (tp, plog, swap_launches)
    tp, plog, swap_launches = pipe["auto"]
    if swap_launches != {"coded_decode_apply": 1}:
        fail(f"autotune_train (b): the swap launched {swap_launches}; the "
             f"drain under the outgoing code should launch one "
             f"coded_decode_apply")
    if pipe["ref"][2]:
        fail(f"autotune_train (b): the plain twin launched {pipe['ref'][2]}")
    fills = [i for i, m in enumerate(plog) if np.isnan(m["loss"])]
    if fills != [0, AT_PIPE_STEPS]:
        fail(f"autotune_train (b): fills at steps {fills}, expected 0 and "
             f"{AT_PIPE_STEPS}")
    pb_k, pb_p = tp.params["beta"], pipe["ref"][0].params["beta"]
    pipe_err = _rel_err(pb_k, pb_p)
    if not torch.allclose(pb_k, pb_p, rtol=1e-4,
                          atol=1e-4 * pb_p.abs().max().item()):
        fail(f"autotune_train (b): beta against the plain twin "
             f"{pipe_err:.3e} relative")

    # ---- (c) one step under each forced family
    hetero_loads = plan_hetero((1.0,) * n, s=1, m=2, k=2 * n).loads
    forced = [("rotation", _forced_plan("rotation", 3, 1, 2, n)),
              ("block", _forced_plan("block", 2, 1, 1, n, n0=2)),
              ("hetero", _forced_plan("hetero", max(hetero_loads), 1, 2, n,
                                      k=2 * n, loads=hetero_loads)),
              ("expander", _forced_plan("expander", 2, 1, 1, n))]
    tf = trainer("auto")
    families = {}
    for fam, plan in forced:
        tf._apply_plan(plan)
        c0, p0 = ops.launch_counts(), ops.path_counts()
        t0 = time.perf_counter()
        m = tf.step(batch)
        torch.cuda.synchronize()
        launches = _launch_delta(c0, ops.launch_counts())
        families[fam] = {"code": [tf.code.n, tf.code.d, tf.code.s, tf.code.m],
                         "k": tf.code.num_subsets, "partial": tf.partial,
                         "loss": m["loss"], "step_ms": m["step_time_s"] * 1e3,
                         "wall_ms": (time.perf_counter() - t0) * 1e3,
                         "launches": launches,
                         "launches_by_kernel_path": _path_delta(
                             p0, ops.path_counts())}
        if not np.isfinite(m["loss"]) or not _coded_launches(launches):
            fail(f"autotune_train (c): {fam}: {families[fam]}")

    # ---- the coding kernels at every coded scheme's own shapes
    shapes = set()
    for arts in list(tr._arts_cache.values()) + list(tf._arts_cache.values()):
        if arts.coded_fraction == 1.0 and arts.pack_plan is not None:
            mm = arts.codec.code.m
            shapes.add((mm, cfg.d_model // mm, arts.pack_plan.buckets[0].size))
    at_shapes = [_coding_times((1, V, mm), (n, L, mm))
                 for mm, V, L in sorted(shapes)]
    say(phase="autotune_train", model=cfg.name, l=cfg.d_model,
        start_code=list(AT_CODE), global_batch=args.global_batch,
        policy={"interval": 3, "window": 6, "min_samples": 3,
                "schedules": ["gather"], "npts": 4000,
                "approx_options": ["frc"], "max_err": 3.0},
        drift={"at_step": 6, "params": AT_DRIFT, "seed": 3},
        switches=[{"step": e["step"], "to": e["best"]} for e in switched],
        applied=[[at, _plan_label(pl)] for at, pl in applied],
        replan_host_ms=replan_ms, events=len(tr.autotune_events),
        schemes={k: {**v, "step_ms_median": statistics.median(v["step_ms"]),
                     "coded_fraction": v["coded_fraction"][0]}
                 for k, v in schemes.items()},
        losses=[m["loss"] for m in logs],
        modeled_wait_s=[m["modeled_wait_s"] for m in logs],
        cached_schemes=cached1, launches=counts, launches_by_kernel_path=paths,
        peak_memory_bytes=peak, beta_rel_err_vs_plain_twin=beta_err,
        pipelined_swap={"plan": _plan_label(plan_b),
                        "swap_launches": swap_launches,
                        "losses": [m["loss"] for m in plog],
                        "beta_rel_err_vs_plain_twin": pipe_err},
        forced_families=families, coding_kernels_at_scheme_shapes=at_shapes,
        seconds_counted_run_and_twin=run_a_s,
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


# ------------------------------------------------------------ elastic path
EL_CODE = (8, 3, 1, 2)         # (n, d, s, m): the elastic trainer's home
EL_BATCH = 448                 # rows a step: 8 * 56, splits over 8 and 7
EL_LR = 1e-6                   # NAG step of the elastic runs
EL_LADDER = ([(3, "leave", 7), (9, "join", 7)], 14)   # (trace, steps) of (a)
EL_BURST = ([(3, "preempt", 6), (3, "preempt", 7)], 8)  # of (b)
EL_PIPE = ([(3, "leave", 7)], 8)                      # of (c)
EL_POLICY_A = ElasticPolicy(replan_after=1, resize_after=3, prewarm=(7,))
EL_POLICY_B = ElasticPolicy(replan_after=1, resize_after=0)   # of (b), (c)
EL_DEGRADED_LOADS = (5, 5, 5, 5, 4, 4, 4, 0)
EL_BURST_LOADS = (7, 7, 7, 7, 6, 6, 0, 0)


def _state_tensors(tr):
    """A trainer's parameters and optimizer-state tensors, by name."""
    out = {f"params/{k}": v for k, v in tr.params.items()}
    for k, v in tr.opt_state.items():
        if isinstance(v, dict):
            out.update((f"opt_state/{k}/{n}", t) for n, t in v.items())
        elif torch.is_tensor(v):
            out[f"opt_state/{k}"] = v
    return out


def _same_bytes(a, b):
    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


class _ObservedElastic(ElasticTrainer):
    """``ElasticTrainer`` with its prewarm and resize timed and its ladder's
    launches recorded; each resize's state is cloned just before it and
    held bitwise (and in place) just after it."""

    def __init__(self, *a, **kw):
        self.prewarms, self.resizes, self.ladder_launches = [], [], []
        super().__init__(*a, **kw)

    def prewarm(self, new_n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().prewarm(new_n)
        torch.cuda.synchronize()
        self.prewarms.append({"n": new_n, "ms": (time.perf_counter() - t0) * 1e3})
        return out

    def resize(self, new_n, step=None, plan=None):
        before = {k: (v.clone(), v.data_ptr())
                  for k, v in _state_tensors(self).items()}
        built0 = len(self._comm_caches.get(new_n, (None, {}))[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super().resize(new_n, step=step, plan=plan)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = _state_tensors(self)
        self.resizes.append({
            "step": self._step_count, "to": new_n, "ms": ms,
            "checkpoint": self._ckpt is not None,
            "artifacts_built": len(self._arts_cache) - built0,
            "state_bitwise": set(after) == set(before) and all(
                _same_bytes(after[k], v) for k, (v, _) in before.items()),
            "state_in_place": all(after[k].data_ptr() == p
                                  for k, (_, p) in before.items())})

    def _maybe_ladder(self):
        c0 = ops.launch_counts()
        super()._maybe_ladder()
        self.ladder_launches.append(_launch_delta(c0, ops.launch_counts()))


def _el_label(code):
    fam = "hetero" if isinstance(code, HeteroCode) else "uniform"
    return f"{fam}({code.n},{code.d},{code.s},{code.m})"


def _el_trainer(cfg, backend, trace, policy, pipelined=False, **kw):
    opt = sgd_momentum(PIPE_LR, 0.9) if pipelined else nag(EL_LR)
    spec = coding.SchemeSpec(backend=backend, pipelined=pipelined,
                             fuse_apply=pipelined or None)
    return _ObservedElastic(cfg, make_code(*EL_CODE), opt, spec=spec,
                            straggler_source=NoStragglers(),
                            churn=MembershipTrace(trace), elastic=policy,
                            seed=0, **kw)


def _el_run(tr, batch, steps, label):
    """``steps`` steps counted from 0; each step's launches, kernel paths
    and wall filed under the scheme it ran under."""
    schemes, logs = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(steps):
        c0, p0 = ops.launch_counts(), ops.path_counts()
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        m["wall_ms"] = (time.perf_counter() - t0) * 1e3
        m["scheme"] = _el_label(tr.code)
        m["launches"] = _launch_delta(c0, ops.launch_counts())
        m["workers"] = [tr.arts.comm.workers.start, tr.arts.comm.workers.stop]
        logs.append(m)
        _record_scheme(schemes, m["scheme"], m["launches"],
                       _path_delta(p0, ops.path_counts()), wall_ms=m["wall_ms"])
    drained = tr.drain()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _note_paths(label, require_vector=True)
    for sc in schemes.values():
        sc["step_ms_median"] = statistics.median(sc["wall_ms"])
    return logs, drained, schemes, counts


def _el_record(tr, logs, drained):
    """What the dist phase's part (e) holds a rank to: the ladder log, each
    step's loss and grad_norm as bytes, its launches and worker block, the
    drained update's metrics and the state digest."""
    from repro_torch.launch.train import state_digest
    return {"events": tr.elastic_events,
            "metrics": [[np.float64(m[k]).tobytes().hex()
                         for k in ("loss", "grad_norm")] for m in logs],
            "launches": [m["launches"] for m in logs],
            "workers": [m["workers"] for m in logs],
            "drained": drained,
            "digest": state_digest(tr.params, tr.opt_state)}


def _el_twin(cfg, batch, trace, policy, steps, tr, what, pipelined=False):
    """The plain-backend twin on the same trace: its ladder log, and beta
    within rtol 1e-4 (atol 1e-4 of its largest element)."""
    twin = _el_trainer(cfg, "ref", trace, policy, pipelined=pipelined)
    for _ in range(steps):
        twin.step(batch)
    twin.drain()
    torch.cuda.synchronize()
    if twin.elastic_events != tr.elastic_events:
        fail(f"elastic ({what}): the plain twin's ladder {twin.elastic_events} "
             f"!= {tr.elastic_events}")
    b_k, b_p = tr.params["beta"], twin.params["beta"]
    err = _rel_err(b_k, b_p)
    if not torch.allclose(b_k, b_p, rtol=1e-4, atol=1e-4 * b_p.abs().max().item()):
        fail(f"elastic ({what}): beta against the plain twin {err:.3e} relative")
    return err


def _el_check_steps(what, logs, want):
    """Each step's launches against ``want(step, m)``."""
    for t, m in enumerate(logs):
        if m["launches"] != want(t, m):
            fail(f"elastic ({what}): step {t} under {m['scheme']} launched "
                 f"{m['launches']}, expected {want(t, m)}")


def run_elastic(args):
    """``ElasticTrainer`` on logistic-paper at full width, home code
    (8, 3, 1, 2), NAG, no stragglers, one seeded batch of 448 rows.

    (a) the ladder: a leave at step 3 and a join at step 9 walk prewarm 7,
    the zero-load re-plan, a resize to 7 and back to 8 (each state bitwise
    through its resize, the return to 8 bitwise the home code); (b) a burst
    of two preemptions fails over to partial decode for one step and then
    re-plans to s = 3; (c) a pipelined fused trainer re-plans with an update
    in flight (one ``coded_decode_apply`` in the swap); (d) a tuner plan with
    ``resize_to`` goes through resize, and is skipped when the batch does not
    split.  Each run is counted from 0 and held against its plain twin."""
    cfg = get_config("logistic-paper")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in
             make_synthetic_batch(rng, cfg, EL_BATCH).items()}
    home = make_code(*EL_CODE)
    n, d = home.n, home.d
    # subset gradients (one 2D encode each) a step: every worker walks all
    # d slots of its code, padded slots of a zero-load worker included
    enc_per_step = {f"uniform({n},3,1,2)": n * d, f"uniform({n - 1},3,1,2)": (n - 1) * d,
                    f"hetero({n},5,2,2)": n * 5, f"hetero({n},7,3,2)": n * 7}
    counts, out = {}, {}

    # ---- (a) the ladder, counted from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    policy_a = EL_POLICY_A
    trace_a, steps_a = EL_LADDER
    ops.reset_launch_counts()
    tr = _el_trainer(cfg, "auto", trace_a, policy_a)
    if tr.arts.codec.backend.name != "hopper":
        fail(f"elastic: backend {tr.arts.codec.backend.name!r}, not the kernels")
    logs_a, _, schemes_a, counts_a = _el_run(tr, batch, steps_a,
                                             "logistic-paper ElasticTrainer.step")
    peak_a = torch.cuda.max_memory_allocated()
    counts["logistic-paper ElasticTrainer.step"] = counts_a
    # held against the dist phase's ranks (part (e))
    refs = {"a": _el_record(tr, logs_a, None)}
    ev = tr.elastic_events
    want_ev = [{"step": 0, "action": "prewarm", "n": 7},
               {"step": 4, "action": "replan-degraded", "departed": (7,),
                "loads": EL_DEGRADED_LOADS, "s": 2},
               {"step": 6, "action": "resize", "n": 7, "warm": True},
               {"step": 9, "action": "resize", "n": 8, "warm": True}]
    if ev != want_ev:
        fail(f"elastic (a): ladder {ev}, expected {want_ev}")
    W_home = coding.make_step_inputs(home, ())["W"]
    W_now = coding.make_step_inputs(tr.code, ())["W"]
    if not (np.array_equal(np.asarray(tr.code.C), np.asarray(home.C))
            and np.array_equal(W_now, W_home)
            and np.asarray(tr.code.C).tobytes() == np.asarray(home.C).tobytes()):
        fail("elastic (a): the code after the return to 8 is not the home "
             "code bitwise")
    if [r["to"] for r in tr.resizes] != [7, 8] or not all(
            r["state_bitwise"] and r["state_in_place"] for r in tr.resizes):
        fail(f"elastic (a): resizes {tr.resizes}")
    if [r["artifacts_built"] for r in tr.resizes] != [0, 0]:
        fail(f"elastic (a): a resize built artifacts {tr.resizes}")
    sync_step = lambda t, m: {"coded_encode_2d": enc_per_step[m["scheme"]],
                              "coded_decode_2d": 1}
    _el_check_steps("a", logs_a, sync_step)
    want_schemes = {f"uniform({n},3,1,2)": 4 + 5, f"hetero({n},5,2,2)": 2,
                    f"uniform({n - 1},3,1,2)": 3}
    if {k: v["steps"] for k, v in schemes_a.items()} != want_schemes:
        fail(f"elastic (a): steps by scheme {list(schemes_a)}")
    if any(tr.ladder_launches):
        fail(f"elastic (a): the ladder launched {tr.ladder_launches}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in logs_a):
        fail(f"elastic (a): non-finite metrics {logs_a}")
    err_a = _el_twin(cfg, batch, trace_a, policy_a, steps_a, tr, "a")
    out["ladder"] = {"trace": trace_a, "steps": steps_a,
                     "policy": dataclasses.asdict(policy_a),
                     "events": ev, "losses": [m["loss"] for m in logs_a],
                     "step_scheme": [m["scheme"] for m in logs_a],
                     "schemes": schemes_a, "launches": counts_a,
                     "resizes": tr.resizes, "prewarms": tr.prewarms,
                     "return_is_home_code_bitwise": True,
                     "beta_rel_err_vs_plain_twin": err_a,
                     "peak_memory_bytes": peak_a}
    bucket = {tr.code.n: tr.arts.pack_plan.buckets[0].size}
    del tr

    # ---- (b) the burst, counted from 0
    policy_b = EL_POLICY_B
    trace_b, steps_b = EL_BURST
    tb = _el_trainer(cfg, "auto", trace_b, policy_b)
    logs_b, _, schemes_b, counts_b = _el_run(
        tb, batch, steps_b, "logistic-paper ElasticTrainer.step (burst)")
    counts["logistic-paper ElasticTrainer.step (burst)"] = counts_b
    ev = tb.elastic_events
    want_ev = [{"step": 3, "action": "partial-failover", "stragglers": (6, 7),
                "s": 1},
               {"step": 4, "action": "replan-degraded", "departed": (6, 7),
                "loads": EL_BURST_LOADS, "s": 3}]
    if ev != want_ev:
        fail(f"elastic (b): ladder {ev}, expected {want_ev}")
    if not np.isfinite(logs_b[3].get("decode_err_bound", np.nan)):
        fail(f"elastic (b): the failover step reports no finite error bound: "
             f"{logs_b[3]}")
    if any("decode_err_bound" in m for m in logs_b[4:]):
        fail("elastic (b): the re-planned steps decode approximately")
    _el_check_steps("b", logs_b, sync_step)
    if {k: v["steps"] for k, v in schemes_b.items()} != {
            f"uniform({n},3,1,2)": 4, f"hetero({n},7,3,2)": steps_b - 4}:
        fail(f"elastic (b): steps by scheme {list(schemes_b)}")
    if not all(np.isfinite(m["loss"]) for m in logs_b):
        fail(f"elastic (b): non-finite losses {logs_b}")
    err_b = _el_twin(cfg, batch, trace_b, policy_b, steps_b, tb, "b")
    out["burst"] = {"trace": trace_b, "steps": steps_b, "events": ev,
                    "losses": [m["loss"] for m in logs_b],
                    "decode_err_bound_step_3": logs_b[3]["decode_err_bound"],
                    "step_scheme": [m["scheme"] for m in logs_b],
                    "schemes": schemes_b, "launches": counts_b,
                    "beta_rel_err_vs_plain_twin": err_b}
    del tb

    # ---- (c) the pipelined fused trainer re-plans with an update in flight
    trace_c, steps_c = EL_PIPE
    tc_ = _el_trainer(cfg, "auto", trace_c, policy_b, pipelined=True)
    logs_c, drained, schemes_c, counts_c = _el_run(
        tc_, batch, steps_c, "logistic-paper pipelined ElasticTrainer.step")
    counts["logistic-paper pipelined ElasticTrainer.step"] = counts_c
    refs["c"] = _el_record(tc_, logs_c, drained)
    swaps = [(t, dl) for t, dl in enumerate(tc_.ladder_launches) if dl]
    if swaps != [(4, {"coded_decode_apply": 1})]:
        fail(f"elastic (c): the ladder launched {swaps}; the re-plan's drain "
             f"under the outgoing code should launch one coded_decode_apply")
    if [e["action"] for e in tc_.elastic_events] != ["replan-degraded"] or \
            tc_.pipelined or drained is not None:
        fail(f"elastic (c): {tc_.elastic_events}, pipelined {tc_.pipelined}")
    fills = [t for t, m in enumerate(logs_c) if np.isnan(m["loss"])]
    if fills != [0]:
        fail(f"elastic (c): fills at steps {fills}")

    def pipe_step(t, m):
        if t < 4:    # the fill, then steady steps that retire an update
            return {"coded_encode_acc_2d": n * d,
                    **({"coded_decode_apply": 1} if t else {})}
        # the swap's drain, then synchronous steps under the degraded code
        return {**sync_step(t, m), **({"coded_decode_apply": 1} if t == 4 else {})}
    _el_check_steps("c", logs_c, pipe_step)
    err_c = _el_twin(cfg, batch, trace_c, policy_b, steps_c, tc_, "c",
                     pipelined=True)
    out["pipelined"] = {"trace": trace_c, "steps": steps_c,
                        "events": tc_.elastic_events,
                        "losses": [m["loss"] for m in logs_c],
                        "ladder_launches": {t: dl for t, dl in swaps},
                        "step_scheme": [m["scheme"] for m in logs_c],
                        "schemes": schemes_c, "launches": counts_c,
                        "beta_rel_err_vs_plain_twin": err_c}
    del tc_

    # ---- (d) a tuner's resize, with checkpoints into a temporary directory
    plan = _forced_plan("uniform", 3, 1, 2, n - 1, resize_to=n - 1)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        ops.reset_launch_counts()
        td = _el_trainer(cfg, "auto", [], ElasticPolicy(),
                         checkpoint_dir=ckpt_dir)
        td.step(batch)
        td._apply_plan(plan)
        m7 = td.step(batch)
        bucket[td.code.n] = td.arts.pack_plan.buckets[0].size
        td.resize(n)
        td.step(batch)
        torch.cuda.synchronize()
        counts_d = ops.launch_counts()
        _note_paths("logistic-paper ElasticTrainer tuner resize")
        counts["logistic-paper ElasticTrainer tuner resize"] = counts_d
        snapshots = len(td._ckpt.steps())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if [e["action"] for e in td.elastic_events] != ["resize", "resize"] or \
            [r["to"] for r in td.resizes] != [n - 1, n] or not all(
                r["state_bitwise"] for r in td.resizes) or not np.isfinite(m7["loss"]):
        fail(f"elastic (d): {td.elastic_events} {td.resizes}")
    if counts_d != _expect(coded_encode_2d=2 * n * d + (n - 1) * d,
                           coded_decode_2d=3):
        fail(f"elastic (d): launches {counts_d}")
    ts = _el_trainer(cfg, "auto", [], ElasticPolicy())
    ts.step({k: torch.from_numpy(v).to(DEV) for k, v in make_synthetic_batch(
        np.random.default_rng(SEED), cfg, args.global_batch).items()})
    ts._apply_plan(plan)
    want_skip = [{"step": 1, "action": "resize-skipped", "to": n - 1,
                  "reason": "infeasible"}]
    if args.global_batch % (n - 1) == 0 or ts.elastic_events != want_skip:
        fail(f"elastic (d): a {args.global_batch}-row batch over {n - 1} "
             f"workers: {ts.elastic_events}")
    out["tuner_resize"] = {"plan": _plan_label(plan), "resize_to": n - 1,
                           "events": td.elastic_events, "resizes": td.resizes,
                           "snapshots": snapshots, "launches": counts_d,
                           "skipped_at_global_batch": args.global_batch,
                           "skipped_events": ts.elastic_events}
    del td, ts

    # ---- the 2D decode at both cluster sizes' buckets, in one call (a
    # bucket pads l / m to a multiple of lcm(128, n): 171776 at 8, 172032 at 7)
    decode_times = {f"F({k},{L})": measure("decode", (k, L), m=2)
                    for k, L in sorted(bucket.items())}
    say(phase="elastic", model=cfg.name, l=cfg.d_model, home_code=list(EL_CODE),
        global_batch=EL_BATCH, optimizer="nag", lr=EL_LR, schedule="gather",
        packed=True, wire="float32", **out, decode_2d_by_cluster_size=decode_times,
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts, refs


EX_LOGISTIC = dict(samples=512, iters=10, n=8)   # logistic_amazon at l = 343474
EX_LOGISTIC_CUT = {
    "samples": "512, cut from 8192 (the host draws 1.9-3.7 s per 512 rows "
               "at l = 343474): 384 training rows, 128 test rows",
    "iters": "10, cut from 40: each scheme runs twice (the plain backend's "
             "betas)"}
EX_BETA_RTOL = 1e-4            # each scheme's beta against its plain-backend run
EX_SCHEME_GAP = 1e-3           # each coded scheme's beta against the naive one's
EX_LM_STEPS = 3                # train_lm_coded --full-100m steps, cut from 40


def _example(name):
    """``examples/<name>_torch.py``, imported by its path."""
    import importlib.util
    path = HERE / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counted(label, fn, require_vector=True):
    """Run ``fn()`` with the launch counts set to 0 just before it and read
    just after; file them under ``label``."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _note_paths(label, require_vector=require_vector)
    return out, counts


def _coding(launches):
    return {k: v for k, v in launches.items() if v and k.startswith("coded_")}


def run_examples(args):
    """The four twins of ``examples/`` through their ``run()``, on the card,
    each counted from 0.  ``logistic_amazon`` at l = 343474 (n = 8, the
    three schemes), again on the plain backend for the final betas;
    ``serve_batched`` on qwen3-1.7b at full width and depth, its first
    token against ``make_forward``; ``train_lm_coded`` on the ``--full-100m``
    config; ``quickstart`` at its own sizes.  One line a twin."""
    t_phase = time.perf_counter()
    counts = {}

    # ---- logistic_amazon: the paper's Section V at its width
    la = _example("logistic_amazon")
    dim = get_config("logistic-paper").d_model
    t0 = time.perf_counter()
    data = synthetic_logistic_dataset(EX_LOGISTIC["samples"], dim, seed=0)[:2]
    draw_s = time.perf_counter() - t0
    label = "examples/logistic_amazon_torch.py run()"
    t0 = time.perf_counter()
    res, counts[label] = _counted(label, lambda: la.run(
        data=data, device=DEV, out=None, **EX_LOGISTIC))
    run_s = time.perf_counter() - t0
    plain = la.run(data=data, device=DEV, out=None, backend="ref",
                   **EX_LOGISTIC)
    schemes, naive = {}, res["schemes"]["naive"]["beta"]
    for name, sc in res["schemes"].items():
        want = plain["schemes"][name]["beta"]
        ms = sc["step_ms"]
        schemes[name] = {
            "describe": sc["describe"], "coded_fraction": sc["coded_fraction"],
            "final_auc": res["results"][name]["auc"][-1],
            "sim_time_to_target_s": res["time_to_target"][name],
            "sim_time_s": res["results"][name]["cum_time"][-1],
            "ms_per_step_median": statistics.median(ms[1:]),
            "ms_first_step": ms[0], "launches": _coding(sc["launches"]),
            "paths": {k: v for k, v in sc["paths"].items()
                      if v["vector"] or v["scalar"]},
            "beta_rel_err_vs_plain_backend": _rel_err(
                torch.from_numpy(sc["beta"]), torch.from_numpy(want)),
            "beta_rel_gap_vs_naive": _rel_err(torch.from_numpy(sc["beta"]),
                                              torch.from_numpy(naive))}
    for name, row in schemes.items():
        sc = res["schemes"][name]
        if row["beta_rel_err_vs_plain_backend"] > EX_BETA_RTOL:
            fail(f"examples: logistic_amazon {name}: beta "
                 f"{row['beta_rel_err_vs_plain_backend']:.3g} from the plain "
                 f"backend's")
        if row["beta_rel_gap_vs_naive"] > EX_SCHEME_GAP:
            fail(f"examples: logistic_amazon {name}: beta "
                 f"{row['beta_rel_gap_vs_naive']:.3g} from the naive "
                 f"scheme's")
        if name == "naive":
            continue
        # beta (l = 343474 = 2 * 171737) is coded where m divides l: an
        # m = 3 scheme sums it by its straggler-aware weights, uncoded
        n, d, _, m = sc["code"]
        coded = dim % m == 0
        want = (_expect(coded_encode_2d=EX_LOGISTIC["iters"] * n * d,
                        coded_decode_2d=EX_LOGISTIC["iters"])
                if coded else _expect())
        if sc["launches"] != want or row["coded_fraction"] != float(coded):
            fail(f"examples: logistic_amazon {name}: coded fraction "
                 f"{row['coded_fraction']}, launches {sc['launches']}, "
                 f"not {want}")
        if any(v["scalar"] for v in sc["paths"].values()):
            fail(f"examples: logistic_amazon {name}: scalar path "
                 f"{sc['paths']}")
    say(phase="examples", example="logistic_amazon", model="logistic-paper",
        l=dim, **EX_LOGISTIC, reduced=EX_LOGISTIC_CUT,
        triples=res["triples"], auc_target=res["target"], schemes=schemes,
        launches=counts[label], data_draw_s=draw_s, run_s=run_s,
        beta_rtol=EX_BETA_RTOL, scheme_gap_limit=EX_SCHEME_GAP,
        nvidia_smi=nvidia_smi_line())
    del data, res, plain

    # ---- serve_batched on qwen3-1.7b at full width and depth
    sb = _example("serve_batched")
    cfg = get_config("qwen3-1.7b")
    label = "examples/serve_batched_torch.py run()"
    res, counts[label] = _counted(label, lambda: sb.run(cfg, device=DEV))
    with torch.no_grad():
        logits = model_api.make_forward(cfg)(
            res["params"], {"tokens": torch.from_numpy(res["prompts"]).to(DEV)})
    first = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
    if not np.array_equal(first, res["tokens"][:, 0]):
        fail(f"examples: serve_batched's first tokens {res['tokens'][:, 0]} "
             f"are not make_forward's argmax {first}")
    if counts[label] != _expect():
        fail(f"examples: serve_batched launched {counts[label]} (32-token "
             f"prompts run no flash kernel)")
    batch, new = res["tokens"].shape
    say(phase="examples", example="serve_batched", model=cfg.name,
        n_layers=cfg.n_layers, d_model=cfg.d_model, batch=batch,
        prompt_len=res["prompts"].shape[1], max_new=new,
        reduced={"weights": "random, seeded"},
        wall_s=res["wall_s"], tok_per_s=res["tok_per_s"],
        ms_per_token=res["wall_s"] / new * 1e3,
        first_token_is_make_forward_argmax=True,
        tokens_head=res["tokens"][:2].tolist(), launches=counts[label],
        nvidia_smi=nvidia_smi_line())
    del res, logits

    # ---- train_lm_coded --full-100m
    tl = _example("train_lm_coded")
    cfg = tl.full_100m_config()
    label = "examples/train_lm_coded_torch.py run() --full-100m"
    res, counts[label] = _counted(
        label, lambda: tl.run(cfg, steps=EX_LM_STEPS, log=None, log_every=0,
                              device=DEV), require_vector=False)
    losses = [m["loss"] for m in res["logs"]]
    coding = _coding(counts[label])
    if not all(np.isfinite(losses)):
        fail(f"examples: train_lm_coded losses {losses}")
    if not (coding.get("coded_encode_3d") and coding.get("coded_decode_2d")):
        fail(f"examples: train_lm_coded launched {counts[label]}")
    step_ms = [m["step_time_s"] * 1e3 for m in res["logs"]]
    say(phase="examples", example="train_lm_coded", model=cfg.name,
        n_params=res["n_params"], code=res["describe"], steps=EX_LM_STEPS,
        reduced={"steps": f"{EX_LM_STEPS}, cut from 40"}, losses=losses,
        step_ms=step_ms, ms_per_step_median=statistics.median(step_ms[1:]),
        launches=coding, paths=KERNEL_PATHS[label],
        nvidia_smi=nvidia_smi_line())
    del res

    # ---- quickstart at its own sizes
    qs = _example("quickstart")
    label = "examples/quickstart_torch.py run()"
    t0 = time.perf_counter()
    res, counts[label] = _counted(label, lambda: qs.run(device=DEV,
                                                        log_every=0),
                                  require_vector=False)
    qs_s = time.perf_counter() - t0
    a, p = res["autotune"], res["partial"]["metrics"]
    losses = [m["loss"] for part in ("uniform", "hetero", "autotune")
              for m in res[part]["logs"]] + [p["loss"]]
    if a["switches"] < 1:
        fail(f"examples: quickstart's tuner never switched: {a['events']}")
    if not (np.isfinite(p["decode_err_bound"]) and all(np.isfinite(losses))):
        fail(f"examples: quickstart partial bound {p['decode_err_bound']}, "
             f"losses {losses}")
    say(phase="examples", example="quickstart",
        uniform={"code": res["uniform"]["describe"],
                 "coded_fraction": res["uniform"]["coded_fraction"],
                 "loss": [res["uniform"]["logs"][0]["loss"],
                          res["uniform"]["logs"][-1]["loss"]]},
        hetero={"loads": res["hetero"]["loads"],
                "loss": [res["hetero"]["logs"][0]["loss"],
                         res["hetero"]["logs"][-1]["loss"]]},
        partial={"loss": p["loss"], "decode_err_bound": p["decode_err_bound"]},
        autotune={"code": a["code"], "switches": a["switches"],
                  "cached_schemes": a["cached_schemes"],
                  "events": [(e["step"], e["switched"], e["best"])
                             for e in a["events"]]},
        launches=_coding(counts[label]), seconds=qs_s,
        nvidia_smi=nvidia_smi_line())
    say(phase="examples", part="done", seconds=time.perf_counter() - t_phase)
    return counts


# 32 rows a subset (256 a step; 64 until the examples phase came in): the
# host draws 1.4 MB a row at l = 343474, in the launcher and in each rank
LAUNCH_CUT = {"batch_per_subset": "32 (256 rows a step), cut from 64 for the "
                                  "script's time (phase examples): the host "
                                  "draws each step's batch"}
LAUNCH_ARGV = ["--arch", "logistic-paper", "--full", "--n-data", "8", "--d",
               "4", "--s", "2", "--m", "2", "--batch-per-subset", "32",
               "--steps", "5", "--optimizer", "nag", "--lr", "1e-6",
               "--stragglers", "random"]
# ``python -m repro_torch.launch.train`` as runpy runs it, then the kernel
# launch counts and the library it loaded, and every rank's report
# (``launch.train.last_run``: one for --nproc 1), as one JSON line
_LAUNCH_RUNNER = """
import json, runpy, sys
from repro_torch.kernels import _build, ops
g = runpy.run_module("repro_torch.launch.train", run_name="__main__",
                     alter_sys=True)
print(json.dumps({"launches": ops.launch_counts(), "paths": ops.path_counts(),
                  "library": _build.last_build, "reports": g["last_run"]}))
"""


def run_launch(coded_fraction):
    """The training launcher as a subprocess (``PYTHONPATH=src``): exit 0, a
    finite final loss, the main path's coded fraction, the library phase
    ``build`` made, and its launches.  Returns the counts and the run's
    report (``launch.train.run_job``), phase ``dist``'s single-process
    reference."""
    env = {**os.environ, "PYTHONPATH": str(HERE / "src")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _LAUNCH_RUNNER, *LAUNCH_ARGV],
                         capture_output=True, text=True, env=env, cwd=HERE,
                         timeout=300)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"launch: exit {res.returncode}: {res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    final = re.fullmatch(r"final loss (\S+) \(coded fraction (\S+)\)", lines[-2])
    info = json.loads(lines[-1])
    if final is None or not np.isfinite(float(final.group(1))):
        fail(f"launch: no finite final loss in {lines[-3:]}")
    if float(final.group(2)) != round(coded_fraction, 3):
        fail(f"launch: coded fraction {final.group(2)}, the main path's is "
             f"{coded_fraction}")
    if info["library"]["built"] or info["library"]["lib"] != _build.last_build["lib"]:
        fail(f"launch: did not load phase build's library: {info['library']}")
    steps, n, d = 5, 8, 4
    if info["launches"] != _expect(coded_encode_2d=steps * n * d,
                                   coded_decode_2d=steps):
        fail(f"launch: launches {info['launches']}")
    scalar = {k: v["scalar"] for k, v in info["paths"].items() if v["scalar"]}
    if scalar:
        fail(f"launch: kernels took the scalar path {scalar}")
    label = "python -m repro_torch.launch.train"
    KERNEL_PATHS[label] = {k: v for k, v in info["paths"].items()
                           if v["vector"] or v["scalar"]}
    say(phase="launch", argv=LAUNCH_ARGV, reduced=LAUNCH_CUT,
        exit_code=res.returncode,
        final_line=lines[-2], step_lines=lines[:-2], launches=info["launches"],
        library=info["library"], seconds=wall, nvidia_smi=nvidia_smi_line())
    return {label: info["launches"]}, info["reports"][0]


DIST_NPROC = 2                 # ranks of the dist phase, on the one card
DIST_BACKEND = "gloo"          # NCCL refuses two ranks on one device
DIST_LM_LAYERS = 2             # of qwen3-1.7b's 28, as the other phases cut
DIST_LM_SEQ = 512              # tokens a sequence: below flash's 2048
DIST_LM_CODE = (4, 3, 1, 2)    # one sequence a subset
DIST_TIMEOUT = 300             # seconds a subprocess or group of the phase
#                                may take
DIST_PIPE_STEPS = 2            # steps of the pipelined logistic-paper run:
#                                a fill and a steady step, then a drain
# (c): coded serving of qwen3-1.7b at full width and depth on the group, a
# batch a straggler pattern: the first with none, the second with one
DIST_SERVE_STRAGGLERS = ((), (1,))
DIST_TUNED_STEPS = AT_STEPS    # (d): steps of the autotuned trainer
DIST_CKPT_CUT = 4              # (d): the first group's checkpointed run stops
#                                here; a fresh group resumes to CKPT_STEPS
COLLECTIVES = ("all_gather", "all_to_all", "psum")


def _run_group_cmd(cmd, what):
    """Run a command that starts ranks, in a session of its own: past
    DIST_TIMEOUT the whole session is killed, ranks included."""
    env = {**os.environ, "PYTHONPATH": str(HERE / "src")}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=HERE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"dist: {what} took more than {DIST_TIMEOUT} s")
    if proc.returncode != 0:
        fail(f"dist: {what}: exit {proc.returncode}: {err[-4000:]}")
    return out.strip().splitlines()


def _step_ms(logs):
    """Median wall of a run's steps after its first, in ms."""
    walls = [m["step_time_s"] for m in logs[1:]] or \
        [m["step_time_s"] for m in logs]
    return statistics.median(walls) * 1e3


def _time_collectives(comm):
    """Time ``comm``'s collectives from here (the package's ``DistComm``
    runs untimed): each call of ``all_gather``, ``all_to_all`` and ``psum``
    is bracketed by device syncs, and its host seconds go, by kind, to the
    last entry of the returned list.  Every ``comm.reset_counts``
    (``run_job`` calls it before each step and before the drain) opens a
    new entry, so entry ``k + 1`` holds step ``k``'s seconds."""
    steps = [dict.fromkeys(COLLECTIVES, 0.0)]
    reset = comm.reset_counts

    def new_step():
        reset()
        steps.append(dict.fromkeys(COLLECTIVES, 0.0))

    def timed(kind, fn):
        def call(x):
            torch.cuda.synchronize(comm.device)
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize(comm.device)
            steps[-1][kind] += time.perf_counter() - t0
            return out
        return call

    for kind in COLLECTIVES:
        setattr(comm, kind, timed(kind, getattr(comm, kind)))
    comm.reset_counts = new_step
    return steps


def _dist_rank(rank, nproc, device, jobs, ckpt_dir):
    """One rank of the dist phase's group (spawned by ``run_ranks``: it
    imports this script as a module first): each of ``jobs`` over a
    ``DistComm`` whose collectives ``_time_collectives`` times, with its
    kernel launches and peak memory counted from 0 and the replicas' state
    digests compared after it; then part (c), the coded server, part (f),
    generation on (c)'s weights, part (d), the autotuned trainer and the
    first checkpointed runs into ``ckpt_dir``, and part (e), the elastic
    trainer.  Returns the jobs' reports and the parts'."""
    from repro_torch.comm import make_dist_comm
    from repro_torch.launch import train as launch_train
    reports = []
    for job in jobs:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(device)
        comm = make_dist_comm(job.code[0], device=device)
        seconds = _time_collectives(comm)
        rep = launch_train.run_job(job, device, comm)
        comm.check_same("the replicas' state digest", rep["digest"])
        rep.update(rank=rank, transport=comm.transport,
                   collective_s=seconds[1:])
        reports.append(rep)
        del comm
        gc.collect()
        torch.cuda.empty_cache()
    comm = make_dist_comm(SERVE_CODE[0], device=device)
    seconds = _time_collectives(comm)
    params = _serve_params(device)
    serve = _dist_serve(device, comm, params)
    serve.update(rank=rank, collective_s=seconds[1:])
    generate = _dist_generate(device, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    comm = make_dist_comm(AT_CODE[0], device=device)
    tuned = _dist_tuned(device, comm)
    ckpt = {"uninterrupted": _dist_ckpt(device, comm, CKPT_STEPS),
            "cut": _dist_ckpt(device, comm, DIST_CKPT_CUT, ckpt_dir)}
    elastic = _dist_elastic(device)
    return {"jobs": reports, "serve": serve, "tuned": tuned, "ckpt": ckpt,
            "elastic": elastic, "generate": generate, "rank": rank}


def _dist_resume_rank(rank, nproc, device, ckpt_dir):
    """One rank of the fresh group of part (d): resume the cut run from
    ``ckpt_dir`` to CKPT_STEPS, its launches counted from 0."""
    from repro_torch.comm import make_dist_comm
    comm = make_dist_comm(AT_CODE[0], device=device)
    ops.reset_launch_counts()
    out = _dist_ckpt(device, comm, CKPT_STEPS, ckpt_dir)
    out.update(rank=rank, launches=ops.launch_counts())
    return out


def _serve_params(device):
    """qwen3-1.7b's weights at full width and depth, drawn on ``device``
    from SEED as the serve phase draws them."""
    return model_api.init(get_config("qwen3-1.7b"), device,
                          torch.Generator(device=device).manual_seed(SEED))


def _dist_serve(device, comm=None, params=None):
    """Part (c) in this process (``comm`` None: ``LocalComm``) or in a rank:
    ``CodedServer`` on ``qwen3-1.7b`` at full width and depth (``params``,
    default ``_serve_params``), code SERVE_CODE, one 4096-token prompt a
    subset, a batch for each of DIST_SERVE_STRAGGLERS; launch counts set to
    0 just before the first batch and read after each.  Returns each
    batch's outputs, walls, launches and collectives, and the peak
    memory."""
    cfg = get_config("qwen3-1.7b")
    code = make_code(*SERVE_CODE)
    k = code.num_subsets
    t0 = time.perf_counter()
    if params is None:
        params = _serve_params(device)
    requests = _requests(np.random.default_rng(SEED), cfg,
                         len(DIST_SERVE_STRAGGLERS) * k)
    srv = CodedServer(cfg, code, params, batch_per_subset=1,
                      seq_len=SERVE_SEQ, device=device, comm=comm)
    group = srv.artifacts.comm
    if srv.artifacts.codec.backend.name != "hopper":
        fail(f"dist: serve backend {srv.artifacts.codec.backend.name!r}, "
             f"not the kernels")
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    batches = []
    for j, stragglers in enumerate(DIST_SERVE_STRAGGLERS):
        group.reset_counts()
        c0 = ops.launch_counts()
        t0 = time.perf_counter()
        res = srv.serve_batch({key: v[j * k:(j + 1) * k]
                               for key, v in requests.items()},
                              stragglers=stragglers)
        step_s = time.perf_counter() - t0
        batches.append({
            "outputs": res.outputs, "stragglers": list(res.stragglers),
            "failed_rows": list(res.failed_rows), "wall_s": res.wall_s,
            "step_s": step_s,
            "launches": _launch_delta(c0, ops.launch_counts()),
            "counts": dict(group.counts), "bytes": dict(group.bytes)})
    out = {"batches": batches, "launches": ops.launch_counts(),
           "paths": ops.path_counts(), "init_s": init_s,
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "workers": [group.workers.start, group.workers.stop]}
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_generate(device, params):
    """Part (f), in a rank: ``BatchedEngine.generate`` on qwen3-1.7b at full
    width and depth (``params``: part (c)'s weights) with the generate
    phase's prompts over a ``DistComm`` of the group's ranks, counted as
    ``_generate_counted`` counts the generate phase (28 flash launches in
    the prefill, on this rank's rows).  Returns the run's record, the
    engine's split and this rank's rows of the prefill logits."""
    from repro_torch.comm import make_dist_comm
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH,
                        seq_len=GEN_PROMPT + GEN_NEW, device=device,
                        comm=make_dist_comm(DIST_NPROC, device=device))
    run, kept = _generate_counted("dist (f)", eng, _gen_prompts(cfg),
                                  GEN_NEW, keep=(-1,))
    run.pop("median_ms")
    return {**run, "prefill_logits": kept[-1].cpu().numpy(),
            "rows_per_rank": eng.rows_per_rank,
            "rows": [eng.rows.start, eng.rows.stop],
            "gather_bytes": dict(eng.group.bytes),
            "seconds": time.perf_counter() - t0}


def _dist_elastic(device):
    """Part (e), in a rank: the elastic phase's (a), the ladder, and (c),
    the fused pipelined re-plan with an update in flight, over a
    ``DistComm`` of EL_CODE's 8 workers (a resize re-splits them over the
    group), counted from 0 each.  Returns what ``_el_record`` keeps, with
    each run's launches, resizes and wall."""
    from repro_torch.comm import make_dist_comm
    cfg = get_config("logistic-paper")
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             make_synthetic_batch(rng, cfg, EL_BATCH).items()}
    out = {}
    for part, (trace, steps), policy, pipelined in (
            ("a", EL_LADDER, EL_POLICY_A, False),
            ("c", EL_PIPE, EL_POLICY_B, True)):
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        tr = _el_trainer(cfg, "auto", trace, policy, pipelined=pipelined,
                         device=device,
                         comm=make_dist_comm(EL_CODE[0], device=device))
        logs, drained, schemes, counts = _el_run(
            tr, batch, steps, f"dist (e{part}) ElasticTrainer.step")
        out[part] = {**_el_record(tr, logs, drained), "launches_run": counts,
                     "paths": ops.path_counts(),
                     "backend": tr.arts.codec.backend.name,
                     "resizes": tr.resizes, "prewarms": tr.prewarms,
                     "step_ms_median": {k: v["step_ms_median"]
                                        for k, v in schemes.items()},
                     "seconds": time.perf_counter() - t0}
        del tr
    return out


def _dist_tuned(device, comm):
    """Part (d), in a rank: the autotune_train phase's trainer
    (logistic-paper at full width from AT_CODE, its policy and drift, one
    512-row batch drawn on the card from SEED) for DIST_TUNED_STEPS steps:
    the plan after each step, the steps that switched, the state digest."""
    from repro_torch.launch.train import state_digest
    cfg = get_config("logistic-paper")
    batch = _device_batch(torch.Generator(device=device).manual_seed(SEED),
                          512, cfg.d_model)
    policy = _at_policy()
    tr = Trainer(cfg, make_code(*AT_CODE), optimizer=nag(1e-6),
                 straggler_source=_drift(AT_CODE[0], 6, 3), autotune=policy,
                 seed=0, device=device, comm=comm)
    ops.reset_launch_counts()
    plans, step_s = [], []
    for _ in range(DIST_TUNED_STEPS):
        m = tr.step(batch)
        plans.append(_plan_label(tr._current_plan()))
        step_s.append(m["step_time_s"])
    return {"plans": plans, "events": repr(tr.autotune_events),
            "switched_at": [e["step"] for e in tr.autotune_events
                            if e["switched"]],
            "digest": state_digest(tr.params, tr.opt_state),
            "launches": ops.launch_counts(), "step_s": step_s}


def _dist_ckpt(device, comm, steps, directory=None):
    """Part (d): the checkpoint phase's trainer (logistic-paper at full
    width, code AT_CODE, NAG, random stragglers, CKPT_BATCH-row batches
    drawn on the card) run to ``steps`` over ``comm`` (``None``:
    ``LocalComm``), with a snapshot every CKPT_EVERY steps into
    ``directory`` when one is given, resumed from it when it holds one (the
    data and the straggler streams replayed to the cursor).  Returns the
    state digest, the step restored and the steps this process saved."""
    from repro_torch.launch.train import state_digest
    cfg = get_config("logistic-paper")
    code = make_code(*AT_CODE)
    source = RandomStragglers(seed=1)
    tr = Trainer(cfg, code, optimizer=nag(1e-6), seed=0, device=device,
                 straggler_source=source, checkpoint_dir=directory,
                 checkpoint_every=CKPT_EVERY if directory else 0, comm=comm)
    saved = []
    if tr._ckpt is not None:
        save = tr._ckpt.save
        tr._ckpt.save = lambda step, *a: saved.append(step) or save(step, *a)
    restored = tr._step_count
    for i in range(restored):
        source.draw(i, code)

    def stream():
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        while True:
            yield _device_batch(gen, CKPT_BATCH, cfg.d_model)

    batches = tr.skip_to_cursor(stream())
    losses = [tr.step(next(batches))["loss"] for _ in range(steps - restored)]
    return {"digest": state_digest(tr.params, tr.opt_state),
            "restored": restored, "steps": tr._step_count, "saved": saved,
            "losses": losses}


def _dist_compare(what, single, ranks, launches):
    """Hold every rank's report against the single-process one: the state
    digest and each step's loss and grad_norm bitwise, the collectives'
    counts and bytes, and each kernel's launches at ``launches(single
    count)``; print what the ranks did."""
    def bits(logs):
        return [[np.float64(m[k]).tobytes().hex() for k in ("loss",
                                                           "grad_norm")]
                for m in logs]
    for rep in ranks:
        r = rep["rank"]
        if rep["digest"] != single["digest"]:
            fail(f"dist: {what}: rank {r}'s parameters and optimizer state "
                 f"differ from the single-process run's")
        if bits(rep["logs"]) != bits(single["logs"]):
            fail(f"dist: {what}: rank {r}'s metrics differ: "
                 f"{[m['loss'] for m in rep['logs']]} against "
                 f"{[m['loss'] for m in single['logs']]}")
        if rep["collectives"] != single["collectives"]:
            fail(f"dist: {what}: rank {r}'s collectives "
                 f"{rep['collectives']} against {single['collectives']}")
        want = {k: launches(k, v) for k, v in single["launches"].items()}
        if rep["launches"] != want:
            fail(f"dist: {what}: rank {r} launched {rep['launches']}, "
                 f"expected {want}")
        paths = {k: {p: launches(k, c) for p, c in v.items()}
                 for k, v in single["paths"].items()}
        if rep["paths"] != paths:
            fail(f"dist: {what}: rank {r}'s kernel paths {rep['paths']}, "
                 f"expected {paths}")
    timed = "collective_s" in ranks[0]
    return {
        "transport": {"backend": DIST_BACKEND,
                      "rank_transport": ranks[0]["transport"],
                      "staged_in_DistComm": False},
        "bitwise": True,
        "launches_single": {k: v for k, v in single["launches"].items() if v},
        "launches_by_rank": [{k: v for k, v in rep["launches"].items() if v}
                             for rep in ranks],
        "paths_by_rank": [{k: v for k, v in rep["paths"].items()
                           if any(v.values())} for rep in ranks],
        "workers_by_rank": [rep["workers"] for rep in ranks],
        "bytes_by_step_and_rank": [[c["bytes"] for c in rep["collectives"]]
                                   for rep in ranks],
        "collective_s_by_step_and_rank": (
            [rep["collective_s"] for rep in ranks] if timed else
            "not measured: the launcher's ranks run DistComm untimed (the "
            "pipelined run times the same gathers)"),
        "step_ms_median": {"single": _step_ms(single["logs"]),
                           "by_rank": [_step_ms(rep["logs"])
                                       for rep in ranks]},
        "step_s": {"single": [m["step_time_s"] for m in single["logs"]],
                   "by_rank": [[m["step_time_s"] for m in rep["logs"]]
                               for rep in ranks]},
        "peak_bytes": {"single": single["peak_bytes"],
                       "by_rank": [rep["peak_bytes"] for rep in ranks]},
        "loss": [m["loss"] for m in single["logs"]]}


def _dist_check_launches(what, ranks, want, counts, label):
    """Every rank's launches must be ``want``; they go to ``counts`` under
    ``label`` and the rank."""
    for rep in ranks:
        if {k: v for k, v in rep["launches"].items() if v} != want:
            fail(f"dist: {what}: rank {rep['rank']} launched "
                 f"{rep['launches']}, expected {want}")
        counts[f"{label} rank {rep['rank']}"] = rep["launches"]


def run_dist(launch_report, elastic_ref, generate_ref):
    """The coded train step across processes, on the one card, each rank
    held bitwise against the single-process run: parameters and optimizer
    state by digest, each step's loss and grad_norm, each step's
    collectives.  (a) logistic-paper at full width: the launcher with
    ``--nproc 2 --dist-backend gloo`` on LAUNCH_ARGV, synchronous, against
    the launch phase's run of the same flags (each rank half the encodes
    and every decode); then the launcher's pipelined job (``--optimizer
    sgd --pipelined --steps DIST_PIPE_STEPS``) on 2 ranks of this script's
    group, against ``run_job`` in this process.  (b) one synchronous step
    of qwen3-1.7b at full width and DIST_LM_LAYERS layers, DIST_LM_SEQ
    tokens, code (4, 3, 1, 2), on the same group against ``LocalComm`` in
    this process: the 3D and 2D encodes halved, the decode whole, no flash
    launch.  (c) coded serving of full-width, full-depth qwen3-1.7b on the
    same group against the single-process server (``_dist_serve``); (d)
    the autotuned and the checkpointed logistic-paper trainers on the same
    group, then a fresh group that resumes the checkpointed run
    (``_dist_part_d``); (e) the elastic phase's ladder and pipelined
    re-plan on the same group against that phase's runs (``elastic_ref``,
    ``_dist_part_e``); (f) generation on the same group against the
    generate phase's tokens and prefill logits (``generate_ref``,
    ``_dist_part_f``).  The group (``run_ranks`` with ``_dist_rank``)
    times its collectives; the launcher's ranks run as a user runs
    them."""
    from repro_torch.launch import ranks as launch_ranks
    from repro_torch.launch import train as launch_train
    t_phase = time.perf_counter()
    counts = {}
    half = lambda k, v: v // DIST_NPROC if k.startswith("coded_encode") else v
    flags = ["--nproc", str(DIST_NPROC), "--dist-backend", DIST_BACKEND]
    argv = LAUNCH_ARGV + ["--device", "cuda"]
    # (a), synchronous: the launcher
    t0 = time.perf_counter()
    lines = _run_group_cmd([sys.executable, "-c", _LAUNCH_RUNNER, *argv,
                            *flags], f"launch.train --nproc {DIST_NPROC}")
    wall = time.perf_counter() - t0
    ranks = json.loads(lines[-1])["reports"]
    final = re.fullmatch(r"final loss (\S+) \(coded fraction (\S+)\)",
                         lines[-2])
    if final is None or not lines[0].startswith(f"ranks {DIST_NPROC} "):
        fail(f"dist: launcher output {lines[:2]} ... {lines[-2:-1]}")
    out = _dist_compare("launch.train sync", launch_report, ranks, half)
    _dist_check_launches("sync", ranks,
                         {"coded_encode_2d": STEPS * 8 * 4 // DIST_NPROC,
                          "coded_decode_2d": STEPS}, counts,
                         f"launch.train --nproc {DIST_NPROC} sync")
    say(phase="dist", part="a", mode="sync", model="logistic-paper",
        argv=argv + flags, rank_map=lines[0], final_line=lines[-2], **out,
        launcher_wall_s=wall, reduced=LAUNCH_CUT,
        nvidia_smi=nvidia_smi_line())
    # (a), pipelined, and (b): single-process runs here, then both jobs on
    # one group of ranks
    pipe_argv = argv + ["--optimizer", "sgd", "--pipelined", "--steps",
                        str(DIST_PIPE_STEPS)]
    pipe_job = launch_train.make_job(launch_train.parse_args(pipe_argv))
    lm_job = launch_train.TrainJob(
        cfg=dataclasses.replace(get_config("qwen3-1.7b"),
                                n_layers=DIST_LM_LAYERS),
        code=DIST_LM_CODE, optimizer="nag", lr=LM_NAG_LR,
        spec=coding.SchemeSpec(schedule="gather"),
        stragglers=RandomStragglers(seed=1), steps=1,
        global_batch=DIST_LM_CODE[0], seq=DIST_LM_SEQ)
    singles, single_s = [], []
    for job in (pipe_job, lm_job):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        singles.append(launch_train.run_job(job, DEV))
        single_s.append(time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    # (c) and (d): their single-process runs here, then the group
    t0 = time.perf_counter()
    serve_single = _dist_serve(DEV)
    serve_single["seconds"] = time.perf_counter() - t0
    ckpt_single = _dist_ckpt(DEV, None, CKPT_STEPS)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_ckpt_")
    try:
        t0 = time.perf_counter()
        group = launch_ranks.run_ranks(
            _dist_rank, DIST_NPROC, args=([pipe_job, lm_job], ckpt_dir),
            device="cuda", backend=DIST_BACKEND, timeout=DIST_TIMEOUT)
        group_s = time.perf_counter() - t0
        first_files = sorted(os.listdir(ckpt_dir))
        t0 = time.perf_counter()
        resumed = launch_ranks.run_ranks(
            _dist_resume_rank, DIST_NPROC, args=(ckpt_dir,), device="cuda",
            backend=DIST_BACKEND, timeout=DIST_TIMEOUT)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    jobs = [r["jobs"] for r in group]
    out = _dist_compare("pipelined", singles[0], [r[0] for r in jobs], half)
    _dist_check_launches(
        "pipelined", [r[0] for r in jobs],
        {"coded_encode_acc_2d": DIST_PIPE_STEPS * 8 * 4 // DIST_NPROC,
         "coded_decode_apply": DIST_PIPE_STEPS}, counts,
        f"logistic-paper pipelined on {DIST_NPROC} ranks")
    wall = {"single_s": single_s[0], "group_s_both_jobs": group_s}
    say(phase="dist", part="a", mode="pipelined", model="logistic-paper",
        argv=pipe_argv + flags, started_by="run_ranks in this script, the "
        "launcher's job (launch.train.make_job of argv)", **out, wall=wall,
        reduced={"steps": f"{DIST_PIPE_STEPS} and a drain, not {STEPS}: "
                          f"for the script's time", **LAUNCH_CUT},
        nvidia_smi=nvidia_smi_line())
    lm_ranks = [r[1] for r in jobs]
    out = _dist_compare("qwen3-1.7b", singles[1], lm_ranks, half)
    lm = out["launches_single"]
    if (not lm.get("coded_encode_3d") or not lm.get("coded_decode_2d")
            or lm.get("flash_attention") or lm.get("flash_attention_bwd")):
        fail(f"dist: qwen3-1.7b launched {lm}: the 3D encode and the decode, "
             f"and no flash, were expected")
    _dist_check_launches("qwen3-1.7b", lm_ranks, {
        k: half(k, v) for k, v in lm.items()}, counts,
        f"qwen3-1.7b {DIST_LM_LAYERS} layers on {DIST_NPROC} ranks")
    wall = {"single_s": single_s[1], "group_s_both_jobs": group_s}
    say(phase="dist", part="b", model="qwen3-1.7b", n_layers=DIST_LM_LAYERS,
        seq=DIST_LM_SEQ, code=list(DIST_LM_CODE), steps=1, schedule="gather",
        optimizer="nag", **out, wall=wall,
        reduced={"n_layers": f"{DIST_LM_LAYERS} of 28, as the other phases "
                             f"cut depth", "seq": f"{DIST_LM_SEQ} tokens",
                 "weights": "random, seeded"},
        nvidia_smi=nvidia_smi_line())
    _dist_serve_check(serve_single, [r["serve"] for r in group], counts,
                      group_s)
    _dist_part_d(ckpt_single, group, resumed, first_files, counts,
                 {"group_s_all_parts": group_s, "resume_group_s": resume_s})
    _dist_part_e(elastic_ref, [r["elastic"] for r in group], counts, group_s)
    _dist_part_f(generate_ref, [r["generate"] for r in group], counts,
                 group_s)
    say(phase="dist", part="done", seconds=time.perf_counter() - t_phase)
    return counts


def _dist_part_e(refs, ranks, counts, group_s):
    """Part (e): each rank's ladder log, each step's loss and grad_norm,
    drained update and state digest bitwise the elastic phase's runs (a)
    and (c); each step ran on the rank's block of that step's workers and
    launched that block's share of the encodes and every decode and fused
    decode-apply."""
    out = {}
    for part, label in (("a", "logistic-paper ElasticTrainer.step"),
                        ("c", "logistic-paper pipelined ElasticTrainer.step")):
        ref = refs[part]
        for r, rep in enumerate(ranks):
            got = rep[part]
            if got["backend"] != "hopper":
                fail(f"dist (e{part}): rank {r} ran backend {got['backend']!r}")
            for key in ("events", "metrics", "drained", "digest"):
                if got[key] != ref[key]:
                    fail(f"dist (e{part}): rank {r}'s {key} {got[key]} "
                         f"against the elastic phase's {ref[key]}")
            for t, (lo_hi, whole, got_l, want_l) in enumerate(zip(
                    got["workers"], ref["workers"], got["launches"],
                    ref["launches"], strict=True)):
                n = whole[1]
                w = len(range(r * n // DIST_NPROC, (r + 1) * n // DIST_NPROC))
                want = {k: v * w // n if k.startswith("coded_encode") else v
                        for k, v in want_l.items()}
                if lo_hi != [r * n // DIST_NPROC, (r + 1) * n // DIST_NPROC] \
                        or got_l != want:
                    fail(f"dist (e{part}): rank {r} step {t} on workers "
                         f"{lo_hi} of {n} launched {got_l}, expected {want}")
            counts[f"{label} on {DIST_NPROC} ranks rank {r}"] = got["launches_run"]
        blocks = sorted({tuple(tuple(rep[part]["workers"][t])
                               for rep in ranks)
                         for t in range(len(ref["workers"]))})
        out[part] = {
            "events": [e["action"] for e in ref["events"]],
            "steps": len(ref["metrics"]), "bitwise": True,
            "blocks_by_rank": blocks,
            "launches_by_rank": [{k: v for k, v in rep[part]["launches_run"]
                                  .items() if v} for rep in ranks],
            "paths_by_rank": [{k: v for k, v in rep[part]["paths"].items()
                               if any(v.values())} for rep in ranks],
            "step_ms_median_by_scheme_and_rank": [rep[part]["step_ms_median"]
                                                  for rep in ranks],
            "resizes_ms_by_rank": [[x["ms"] for x in rep[part]["resizes"]]
                                   for rep in ranks],
            "prewarms_ms_by_rank": [[x["ms"] for x in rep[part]["prewarms"]]
                                    for rep in ranks],
            "seconds_by_rank": [rep[part]["seconds"] for rep in ranks]}
    say(phase="dist", part="e", model="logistic-paper",
        code=list(EL_CODE), global_batch=EL_BATCH, ladder=out["a"],
        pipelined=out["c"], group_s_all_parts=group_s,
        against="the elastic phase's runs (a) and (c), bitwise",
        nvidia_smi=nvidia_smi_line())


def _dist_part_f(ref, ranks, counts, group_s):
    """Part (f): every rank's tokens exactly the generate phase's, its rows
    of the prefill logits within GEN_TOL of it (the largest difference
    printed), 2 rows a rank, the flash forward launched once a layer in
    each rank's prefill."""
    cfg = get_config("qwen3-1.7b")
    per_rank = GEN_BATCH // DIST_NPROC
    diffs = []
    for r, rep in enumerate(ranks):
        if rep["rows_per_rank"] != per_rank or \
                rep["rows"] != [r * per_rank, (r + 1) * per_rank]:
            fail(f"dist (f): rank {r} ran rows {rep['rows']}, expected "
                 f"{per_rank} of them from {r * per_rank}")
        if not np.array_equal(rep["tokens"], ref["tokens"]):
            fail(f"dist (f): rank {r}'s tokens differ from the generate "
                 f"phase's at {np.argwhere(rep['tokens'] != ref['tokens'])[:8]}")
        want = ref["prefill_logits"][r * per_rank:(r + 1) * per_rank]
        err = np.abs(rep["prefill_logits"] - want)
        diffs.append(float(err.max()))
        if not (err - GEN_TOL * np.abs(want)).max() <= GEN_TOL:
            fail(f"dist (f): rank {r}'s prefill logits are {diffs[-1]:.3e} "
                 f"from the generate phase's, past rtol = atol = {GEN_TOL}")
        if rep["flash_launches_prefill"] != attention_layers(cfg):
            fail(f"dist (f): rank {r} launched flash "
                 f"{rep['flash_launches_prefill']} times in its prefill")
        counts[f"qwen3-1.7b BatchedEngine.generate on {DIST_NPROC} ranks "
               f"rank {r}"] = rep["launches"]
    say(phase="dist", part="f", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
        max_new=GEN_NEW, rows_per_rank=per_rank,
        rows_by_rank=[rep["rows"] for rep in ranks],
        tokens_equal_generate_phase=True,
        prefill_logits_max_abs_diff_by_rank=diffs, tolerance=GEN_TOL,
        launches_by_rank=[{k: v for k, v in rep["launches"].items() if v}
                          for rep in ranks],
        prefill_s_by_rank=[rep["prefill_s"] for rep in ranks],
        decode_step_ms_median_by_rank=[
            rep[f"decode_step_ms_median_2_to_{GEN_NEW - 1}"] for rep in ranks],
        generate_wall_s_by_rank=[rep["generate_wall_s"] for rep in ranks],
        seconds_by_rank=[rep["seconds"] for rep in ranks],
        peak_memory_bytes_by_rank=[rep["peak_memory_bytes"] for rep in ranks],
        gather_bytes_by_rank=[rep["gather_bytes"] for rep in ranks],
        group_s_all_parts=group_s,
        weights="part (c)'s, random from a seed (the serve phase's)",
        nvidia_smi=nvidia_smi_line())


def _dist_serve_check(single, ranks, counts, group_s):
    """Part (c): every rank's outputs, batch by batch, bitwise the single
    process's; a rank's launches a batch half the encodes and flash
    launches and the whole decode; the collectives' counts and bytes the
    single process's."""
    cfg = get_config("qwen3-1.7b")
    code = make_code(*SERVE_CODE)
    per_rank = code.n * code.d // DIST_NPROC
    want = {"flash_attention": per_rank * flash_layers(cfg, SERVE_SEQ),
            "coded_encode_2d": per_rank, "coded_decode_2d": 1}
    want_single = {k: v * DIST_NPROC if k != "coded_decode_2d" else v
                   for k, v in want.items()}
    if any(b["launches"] != want_single for b in single["batches"]):
        fail(f"dist (c): the single process launched "
             f"{[b['launches'] for b in single['batches']]} a batch, "
             f"expected {want_single}")
    for b in single["batches"]:
        if (b["outputs"].shape != (code.num_subsets, cfg.vocab)
                or not np.isfinite(b["outputs"]).all() or b["failed_rows"]):
            fail(f"dist (c): served outputs {b['outputs'].shape}, finite "
                 f"{np.isfinite(b['outputs']).all()}, failed rows "
                 f"{b['failed_rows']}")
    for rep in ranks:
        r = rep["rank"]
        for j, (got, ref) in enumerate(zip(rep["batches"], single["batches"],
                                           strict=True)):
            if got["outputs"].tobytes() != ref["outputs"].tobytes():
                fail(f"dist (c): rank {r}'s batch {j} differs from the "
                     f"single process's by "
                     f"{float(np.abs(got['outputs'] - ref['outputs']).max())}")
            if got["launches"] != want:
                fail(f"dist (c): rank {r} launched {got['launches']} in "
                     f"batch {j}, expected {want}")
            if (got["counts"], got["bytes"]) != (ref["counts"], ref["bytes"]):
                fail(f"dist (c): rank {r}'s collectives {got['counts']} "
                     f"{got['bytes']} against {ref['counts']} {ref['bytes']}")
            if got["stragglers"] != list(DIST_SERVE_STRAGGLERS[j]):
                fail(f"dist (c): rank {r} served batch {j} with stragglers "
                     f"{got['stragglers']}")
        counts[f"qwen3-1.7b CodedServer on {DIST_NPROC} ranks rank {r}"] = \
            rep["launches"]
    say(phase="dist", part="c", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, seq_len=SERVE_SEQ, code=list(SERVE_CODE),
        schedule="gather", batches=len(DIST_SERVE_STRAGGLERS),
        stragglers=[list(p) for p in DIST_SERVE_STRAGGLERS], bitwise=True,
        workers_by_rank=[rep["workers"] for rep in ranks],
        launches_per_batch={"single": want_single, "rank": want},
        launches_by_rank=[rep["launches"] for rep in ranks],
        paths_by_rank=[{k: v for k, v in rep["paths"].items()
                        if any(v.values())} for rep in ranks],
        bytes_by_batch={"single": [b["bytes"] for b in single["batches"]],
                        "by_rank": [[b["bytes"] for b in rep["batches"]]
                                    for rep in ranks]},
        collective_s_by_batch_and_rank=[rep["collective_s"] for rep in ranks],
        wall_s={"single": [b["wall_s"] for b in single["batches"]],
                "by_rank": [[b["wall_s"] for b in rep["batches"]]
                            for rep in ranks]},
        step_s={"single": [b["step_s"] for b in single["batches"]],
                "by_rank": [[b["step_s"] for b in rep["batches"]]
                            for rep in ranks]},
        peak_bytes={"single": single["peak_bytes"],
                    "by_rank": [rep["peak_bytes"] for rep in ranks]},
        init_s={"single": single["init_s"],
                "by_rank": [rep["init_s"] for rep in ranks]},
        single_s=single["seconds"], group_s_all_parts=group_s,
        reduced={"weights": "random, seeded",
                 "batches": f"{len(DIST_SERVE_STRAGGLERS)}"},
        nvidia_smi=nvidia_smi_line())


def _dist_part_d(single, group, resumed, first_files, counts, wall):
    """Part (d): the autotuned trainer's plans, events and state alike on
    every rank, with a switch; the checkpointed runs: only rank 0 saved,
    the first group left the cut run's snapshots, the fresh group restored
    DIST_CKPT_CUT and ended with the uninterrupted run's state on both
    ranks and the single process's, with a rank's share of the launches."""
    code = make_code(*AT_CODE)
    tuned = [r["tuned"] for r in group]
    ref = tuned[0]
    for t in tuned[1:]:
        if (t["plans"], t["events"], t["digest"]) != (ref["plans"],
                                                       ref["events"],
                                                       ref["digest"]):
            fail(f"dist (d): the tuned ranks differ: plans "
                 f"{[x['plans'] for x in tuned]}")
    if not ref["switched_at"]:
        fail(f"dist (d): the tuner never switched: {ref['plans']}")
    for r, t in enumerate(tuned):
        if not (t["launches"].get("coded_encode_2d")
                and t["launches"].get("coded_decode_2d")):
            fail(f"dist (d): tuned rank {r} launched {t['launches']}")
        counts[f"logistic-paper autotuned Trainer on {DIST_NPROC} ranks "
               f"rank {r}"] = t["launches"]
    snaps = [f"ckpt_{s:08d}.npz" for s in range(CKPT_EVERY, DIST_CKPT_CUT + 1,
                                                  CKPT_EVERY)]
    first = [r["ckpt"] for r in group]
    if first_files != snaps:
        fail(f"dist (d): the first group left {first_files}, not {snaps}")
    want_saved = [int(f[5:13]) for f in snaps]
    if [c["cut"]["saved"] for c in first] != \
            [want_saved] + [[]] * (DIST_NPROC - 1):
        fail(f"dist (d): saves by rank {[c['cut']['saved'] for c in first]}")
    w = code.n // DIST_NPROC
    want = {"coded_encode_2d": (CKPT_STEPS - DIST_CKPT_CUT) * w * code.d,
            "coded_decode_2d": CKPT_STEPS - DIST_CKPT_CUT}
    for rep in resumed:
        r = rep["rank"]
        if (rep["restored"], rep["steps"]) != (DIST_CKPT_CUT, CKPT_STEPS):
            fail(f"dist (d): rank {r} restored {rep['restored']} and ended "
                 f"at {rep['steps']}")
        digests = {rep["digest"], single["digest"]} | {
            c["uninterrupted"]["digest"] for c in first}
        if len(digests) != 1:
            fail(f"dist (d): rank {r}'s resumed state differs from the "
                 f"uninterrupted runs'")
        if {k: v for k, v in rep["launches"].items() if v} != want:
            fail(f"dist (d): resumed rank {r} launched {rep['launches']}, "
                 f"expected {want}")
        if rep["saved"] != ([CKPT_STEPS] if r == 0 else []):
            fail(f"dist (d): resumed rank {r} saved {rep['saved']}")
        counts[f"logistic-paper Trainer resumed on {DIST_NPROC} ranks rank "
               f"{r}"] = rep["launches"]
    say(phase="dist", part="d", model="logistic-paper", code=list(AT_CODE),
        tuned={"steps": DIST_TUNED_STEPS, "plans": ref["plans"],
               "switched_at": ref["switched_at"], "same_on_every_rank": True,
               "step_s_by_rank": [t["step_s"] for t in tuned],
               "launches_by_rank": [t["launches"] for t in tuned]},
        checkpoint={"global_batch": CKPT_BATCH, "every": CKPT_EVERY,
                    "first_group_steps": DIST_CKPT_CUT,
                    "snapshots": first_files,
                    "saved_by_rank": [c["cut"]["saved"] for c in first],
                    "resumed_at": DIST_CKPT_CUT, "steps": CKPT_STEPS,
                    "bitwise_with": ["the uninterrupted 2-rank run",
                                     "the single process"],
                    "resumed_launches_by_rank": [r["launches"]
                                                 for r in resumed],
                    "losses": single["losses"]},
        wall=wall, reduced={"global_batch": f"{CKPT_BATCH} rows for the "
                                            f"checkpointed runs, 512 for the "
                                            f"tuned one, as the checkpoint "
                                            f"and autotune_train phases",
                            "batches": "drawn on the card from a seed"},
        nvidia_smi=nvidia_smi_line())


def run_autotune_serve(args, params):
    """The autotuned ``CodedServer`` on qwen3-1.7b at full width (the serve
    phase's weights), 4096-token prompts, from code (4, 3, 1, 2) under a
    drifting timed source.

    Counted window: the launch counts are set to 0 just before the 10
    batches are submitted and read just after the last is stepped; each
    batch's launches go to the scheme it was served under.  Outside it:
    the first batch under every scheme against the uncoded forward of its
    prompts, one traced batch a scheme for its device idle share, and the
    coding kernels at each scheme's shapes on both kernel paths."""
    from repro_torch.tune import PoissonArrivals, ServingPolicy
    cfg = get_config("qwen3-1.7b")
    n = AT_SERVE_CODE[0]
    t_phase = time.perf_counter()
    policy = ServingPolicy(arrivals=PoissonArrivals(rate_rps=0.01),
                           interval=3, window=6, min_samples=3,
                           schedules=("gather",), wait_draws=200,
                           n_requests=800)
    srv = CodedServer(cfg, make_code(*AT_SERVE_CODE), params,
                      batch_per_subset=1, seq_len=SERVE_SEQ,
                      straggler_source=_drift(n, 4, 3), autotune=policy,
                      device=DEV)
    k = srv.batch_requests
    prompts = np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab, (AT_SERVE_BATCHES * k, SERVE_SEQ), dtype=np.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    for row in prompts:
        srv.submit({"tokens": row})
    schemes, firsts, results = {}, {}, []
    while True:
        code = srv.code
        label = f"uniform({code.d},{code.s},{code.m})"
        torch.cuda.reset_peak_memory_stats()
        c0, p0 = ops.launch_counts(), ops.path_counts()
        res = srv.step()
        if res is None:
            break
        torch.cuda.synchronize()
        launches = _launch_delta(c0, ops.launch_counts())
        want = code.n * code.d * cfg.n_layers
        if launches.get("flash_attention", 0) != want:
            fail(f"autotune_serve: batch {len(results)} under {label} "
                 f"launched flash {launches.get('flash_attention', 0)} "
                 f"times, expected {want}")
        if res.outputs.shape != (k, cfg.vocab) or \
                not np.isfinite(res.outputs).all() or res.failed_rows:
            fail(f"autotune_serve: batch {len(results)}: outputs "
                 f"{res.outputs.shape}, failed rows {res.failed_rows}")
        _record_scheme(schemes, label, launches,
                       _path_delta(p0, ops.path_counts()),
                       wall_ms=res.wall_s * 1e3,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
        firsts.setdefault(label, (len(results), res.outputs,
                                  [r.req_id - 1 for r in res.requests],
                                  (code.d, code.s, code.m)))
        results.append(res)
    counts = ops.launch_counts()
    label_s = "qwen3-1.7b autotuned CodedServer.step"
    paths = _note_paths(label_s, require_vector=False)
    plain_calls = flash_attn.PLAIN_CALLS["flash_attention"]
    switched = [e for e in srv._tuner.events if e["switched"]]
    # the serving tuner starts with no plan of its own, so its first adopted
    # plan counts as a switch even where it is the server's code: require a
    # change of code
    if len(results) != AT_SERVE_BATCHES or plain_calls or len(firsts) < 2:
        fail(f"autotune_serve: {len(results)} batches, {plain_calls} plain "
             f"flash calls, schemes served {list(firsts)}")
    ids = [r.req_id for res in results for r in res.requests]
    if ids != list(range(1, len(prompts) + 1)):
        fail(f"autotune_serve: requests served out of order: {ids}")
    # ---- outside the window: each scheme's first batch against the
    # uncoded forward of its prompts, then one traced batch a scheme
    fwd = model_api.make_forward(cfg)
    for label, (b, out, rows, dsm) in firsts.items():
        with torch.no_grad():
            direct = fwd(params, {"tokens": torch.from_numpy(
                prompts[rows]).to(DEV)}).cpu().numpy()
        scale = float(np.abs(direct).max())
        err = float(np.abs(out - direct).max())
        schemes[label].update(first_batch=b, max_abs_err_vs_uncoded=err,
                              max_abs_logit=scale)
        if err > SERVE_REL_TOL * max(1.0, scale):
            fail(f"autotune_serve: {label}, batch {b}: decoded logits "
                 f"{err:.3e} from the uncoded forward (max |logit| "
                 f"{scale:.3e}, tolerance {SERVE_REL_TOL} of it)")
    for label, (b, _, rows, (d, s_, mm)) in firsts.items():
        srv._apply_plan(dataclasses.replace(srv._tuner.current, d=d, s=s_,
                                            m=mm, loads=(d,) * n))
        batch_rows = {"tokens": prompts[rows]}
        schemes[label]["device_idle_share"] = profile_steps(
            lambda: srv.serve_batch(batch_rows, stragglers=()),
            statistics.median(schemes[label]["wall_ms"]),
            f"autotuned serve batch {label}", steps=1)
    at_shapes = {label: _coding_times(*_serve_codec_shapes((n,) + dsm))
                 for label, (_, _, _, dsm) in firsts.items()}
    say(phase="autotune_serve", model=cfg.name, start_code=list(AT_SERVE_CODE),
        seq_len=SERVE_SEQ, batches=len(results),
        reduced={"batches": f"{AT_SERVE_BATCHES}, cut from 10 for the "
                            f"script's time (phase dist); the code "
                            f"changed at batch 6"},
        policy={"rate_rps": 0.01, "interval": 3, "window": 6,
                "min_samples": 3, "schedules": ["gather"], "wait_draws": 200,
                "n_requests": 800},
        drift={"at_batch": 4, "params": AT_DRIFT, "seed": 3},
        switches=[{"batch": e["step"], "to": e["best"]} for e in switched],
        stragglers=[list(r.stragglers) for r in results],
        schemes={k: {**v, "wall_ms_median": statistics.median(v["wall_ms"]),
                     "flash_launches_per_batch":
                         v["launches"].get("flash_attention", 0) / v["steps"]}
                 for k, v in schemes.items()},
        launches=counts, launches_by_kernel_path=paths,
        plain_flash_calls=plain_calls, coding_kernels_at_scheme_shapes=at_shapes,
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


class materialized_attention:
    """Within it, the dense LM's attention is the materialized f32 softmax
    at every length (the reference's branch up to 2048 tokens), never the
    flash kernel."""

    def __enter__(self):
        self.old = model_common.CHUNK_THRESHOLD
        model_common.CHUNK_THRESHOLD = 1 << 40

    def __exit__(self, *exc):
        model_common.CHUNK_THRESHOLD = self.old


def _generate_counted(phase, eng, prompts, new, keep=(), flash=None):
    """``eng.generate(prompts, new)`` counted from 0: the launch counts and
    the plain flash version's calls are set to 0 just before it and read at
    its prefill's logits and after it.  The prefill must launch the flash
    forward once a layer (an SSM model never), the decode never, and
    nothing else (``flash``: the prefill's and a decode step's flash
    launches instead, an encoder-decoder's); the tokens
    must lie in the vocabulary and every step's logits be finite.  Returns
    the run's record (the prefill's seconds and each decode step's ms from
    CUDA events, the median of steps 2 on) and the logits of the steps in
    ``keep`` (-1: the prefill's)."""
    cfg = eng.cfg
    events, flash_at, finite, kept = {}, {}, [], {}

    def on_logits(t, logits):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[t] = ev
        flash_at[t] = ops.launch_counts()["flash_attention"]
        finite.append(torch.isfinite(logits).all())
        if t in keep:
            kept[t] = logits

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, new, on_logits=on_logits)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plain = flash_attn.PLAIN_CALLS["flash_attention"]
    prefill_flash = flash_at[-1]
    decode_flash = counts["flash_attention"] - prefill_flash
    want_flash, per_step = flash or (attention_layers(cfg), 0)
    if plain or prefill_flash != want_flash or \
            decode_flash != per_step * new:
        fail(f"{phase}: flash launches {prefill_flash} in the prefill and "
             f"{decode_flash} in the decode, plain calls {plain}; expected "
             f"{want_flash}, {per_step * new} and 0")
    want = _expect(flash_attention=want_flash + per_step * new)
    if counts != want:
        fail(f"{phase}: kernel launches {counts}, expected {want}")
    if tokens.shape != (len(prompts), new) or tokens.dtype != np.int32 or \
            not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        fail(f"{phase}: tokens of shape {tokens.shape}, type {tokens.dtype} "
             f"or out of [0, {cfg.vocab})")
    bad = [t for t, f in zip(range(-1, new), finite) if not bool(f)]
    if bad or len(finite) != new + 1:
        fail(f"{phase}: non-finite logits at steps {bad}")
    step_ms = [events[t - 1].elapsed_time(events[t]) for t in range(new)]
    median_ms = statistics.median(step_ms[2:])
    return {"tokens": tokens, "flash_launches_prefill": prefill_flash,
            "flash_launches_decode": decode_flash, "launches": counts,
            "plain_flash_calls": plain, "generate_wall_s": wall_s,
            "prefill_s": start.elapsed_time(events[-1]) / 1e3,
            "decode_step_ms": step_ms,
            f"decode_step_ms_median_2_to_{new - 1}": median_ms,
            "median_ms": median_ms,
            "tokens_per_s": len(prompts) * 1e3 / median_ms,
            "memory_at_start_bytes": at_start, "peak_memory_bytes": peak}, kept


def _decode_bound(eng, params):
    """A decode step's byte bound: every weight but the input embedding
    (of which it reads B rows) and the KV cache, read once; an SSM model's
    recurrent state read once and written once; a hybrid's KV caches read
    once, its SSM states and conv rings read once and written once; an
    encoder-decoder's decoder weights and unembedding (not its encoder's,
    nor the position rows of which it reads one), its self-KV ring and
    cross-KV read once."""
    if eng.cfg.family == "encdec":
        def read(k):
            return k.startswith("dec_layers/") or k in ("ln_f", "unembed")
    else:
        def read(k):
            return k != "embed"
    weight_bytes = sum(v.numel() * v.element_size() for k, v in params.items()
                       if read(k))
    nbytes = {k: math.prod(shape) * torch.empty((), dtype=dt).element_size()
              for k, (shape, dt) in eng.arts.cache_shapes.items()}
    cache_bytes = sum(nbytes.values())
    if eng.cfg.family == "ssm":
        state = {"decode_bytes_state_read_and_written": 2 * cache_bytes}
    elif eng.cfg.family == "hybrid":
        state = {"decode_bytes_kv_cache": nbytes["k"] + nbytes["v"],
                 "decode_bytes_state_read_and_written":
                     2 * (nbytes["ssm"] + nbytes["conv"])}
    elif eng.cfg.family == "encdec":
        state = {"decode_bytes_kv_cache": nbytes["k"] + nbytes["v"],
                 "decode_bytes_cross_kv": nbytes["xk"] + nbytes["xv"]}
    else:
        state = {"decode_bytes_kv_cache": cache_bytes}
    return {"decode_bytes_weights": weight_bytes, **state,
            "decode_step_bound_ms": (weight_bytes + sum(state.values()))
            / HBM_BYTES_PER_S * 1e3, "decode_step_bound_by": "bytes"}


def run_generate_path(args, params):
    """``BatchedEngine.generate`` on qwen3-1.7b at full width and depth
    (the serve phase's seeded weights, f32): 4 prompts of 4096 tokens, 32
    greedy tokens against a dense cache of 4128 positions, counted as
    ``_generate_counted`` says.  Outside the window: decode steps 0, 1 and
    31 against the full-prompt forward of the prompt and the tokens fed so
    far, with the materialized softmax (the decode's own attention math);
    the distance to the forward through the flash kernel is printed beside
    it."""
    cfg = get_config("qwen3-1.7b")
    t_phase = time.perf_counter()
    seq_len = GEN_PROMPT + GEN_NEW
    prompts = _gen_prompts(cfg)
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH, seq_len=seq_len,
                        device=DEV)
    run, kept = _generate_counted("generate", eng, prompts, GEN_NEW,
                                  keep=(-1, *GEN_CHECKED))
    tokens = run.pop("tokens")
    # held against the dist phase's ranks (part (f))
    ref = {"tokens": tokens, "prefill_logits": kept.pop(-1).cpu().numpy()}

    # ---- outside the window: decode logits against the full forward
    errs = {}
    t1 = time.perf_counter()
    toks = torch.from_numpy(np.concatenate([prompts, tokens], axis=1)).to(DEV)
    forward = model_api.make_forward(cfg)
    for t in GEN_CHECKED:
        batch = {"tokens": toks[:, :GEN_PROMPT + t + 1]}
        with torch.no_grad(), materialized_attention():
            want_l = forward(eng.params, batch)
        with torch.no_grad():
            flash_l = forward(eng.params, batch)
        err = (kept[t] - want_l).abs()
        excess = (err - GEN_TOL * want_l.abs()).max().item()
        errs[str(t)] = {
            "max_abs_err": err.max().item(),
            "max_abs_logit": want_l.abs().max().item(),
            "max_abs_err_vs_flash_forward": (kept[t] - flash_l).abs().max().item(),
            "flash_forward_vs_materialized": (flash_l - want_l).abs().max().item()}
        del want_l, flash_l
        if not excess <= GEN_TOL:
            fail(f"generate: decode step {t}'s logits differ from the "
                 f"full-prompt forward past rtol = atol = {GEN_TOL}: "
                 f"{errs[str(t)]}")
        # the greedy token fed next is the decode's own argmax
        if t + 1 < GEN_NEW and not torch.equal(
                kept[t].argmax(-1).cpu(),
                torch.from_numpy(tokens[:, t + 1]).long()):
            fail(f"generate: token {t + 1} is not step {t}'s argmax")
    check_s = time.perf_counter() - t1
    bound = _decode_bound(eng, params)
    median_ms = run.pop("median_ms")
    if args.profile:
        with torch.no_grad():
            _, cache = eng.arts.prefill(eng.params,
                                        {"tokens": toks[:, :GEN_PROMPT]})
        tok = toks[:, GEN_PROMPT].to(torch.int32)

        def one_step():
            nonlocal cache
            _, cache = eng.arts.decode(eng.params, cache, tok)

        one_step()                     # warm; 3 traced steps after it
        profile_steps(one_step, median_ms, "qwen3-1.7b BatchedEngine decode step",
                      steps=3)
        del cache
    say(phase="generate", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
        max_new=GEN_NEW, seq_len=seq_len, window=0, dtype="float32",
        weights="the serve phase's, random from a seed", **run, **bound,
        decode_step_over_bound=median_ms / bound["decode_step_bound_ms"],
        logits_vs_forward=errs, tolerance=GEN_TOL,
        check_s=check_s, tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return run["launches"], ref


def _gen_prompts(cfg):
    """The generate phase's GEN_BATCH prompts of GEN_PROMPT tokens."""
    return np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)


def run_generate_moe(args, params):
    """``BatchedEngine.generate`` on olmoe-1b-7b at full width and depth
    (serve_moe's seeded weights, f32): 4 prompts of 4096 tokens, 16 greedy
    tokens against a dense cache of 4112 positions, counted as
    ``_generate_counted`` says.

    A decode step's capacity counts its 4 tokens (``C = 1`` an expert), so
    picks that collide drop and a step's logits are not the full forward's
    (the reference's semantics): they are not held against it.  Outside the
    window: the prefill's logits against ``last_logits`` of the same
    prompts, and two decodes of one step from clones of one cache, both
    bitwise; the share of picks a decode step drops, by layer."""
    cfg = get_config(MOE_ARCH)
    t_phase = time.perf_counter()
    seq_len = GEN_PROMPT + MOE_GEN_NEW
    prompts = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH, seq_len=seq_len,
                        device=DEV)
    run, kept = _generate_counted("generate_moe", eng, prompts, MOE_GEN_NEW,
                                  keep=(-1,))
    tokens = run.pop("tokens")

    # ---- outside the window
    t1 = time.perf_counter()
    toks = torch.from_numpy(prompts).to(DEV)
    with torch.no_grad():
        last = model_api.make_forward(cfg)(eng.params, {"tokens": toks})
    if not torch.equal(last, kept[-1]):
        fail("generate_moe: the prefill's logits are not last_logits' bits")
    del last, kept
    _, cache = eng.arts.prefill(eng.params, {"tokens": toks})
    tok = torch.from_numpy(tokens[:, 0]).to(DEV)
    repeats = []
    for _ in range(2):
        c = {k: v.clone() for k, v in cache.items()}
        lg, c = eng.arts.decode(eng.params, c, tok)
        repeats.append((_digest([lg]), _digest([c["k"], c["v"]])))
        del c, lg
    if repeats[0] != repeats[1]:
        fail("generate_moe: two decodes from clones of one cache differ")
    drop_share = _moe_dropped_share(lambda: eng.arts.decode(
        eng.params, {k: v.clone() for k, v in cache.items()}, tok))
    check_s = time.perf_counter() - t1
    bound = _decode_bound(eng, params)
    median_ms = run.pop("median_ms")
    if args.profile:
        def one_step():
            eng.arts.decode(eng.params, cache, tok)   # writes slot 4096 again

        one_step()                     # warm; 3 traced steps after it
        profile_steps(one_step, median_ms,
                      f"{cfg.name} BatchedEngine decode step", steps=3)
    del cache
    say(phase="generate_moe", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        batch=GEN_BATCH, prompt_len=GEN_PROMPT, max_new=MOE_GEN_NEW,
        seq_len=seq_len, window=0, dtype="float32",
        weights="serve_moe's, random from a seed",
        decode_capacity=moe.capacity(cfg, GEN_BATCH),
        prefill_capacity=moe.capacity(cfg, GEN_BATCH * GEN_PROMPT),
        **run, **bound,
        decode_step_over_bound=median_ms / bound["decode_step_bound_ms"],
        prefill_logits_equal_last_logits=True, decode_repeats_bits=True,
        decode_dropped_pick_share_by_layer=drop_share,
        check_s=check_s, tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return run["launches"]


def run_generate_vlm(args, params):
    """``BatchedEngine.generate`` on internvl2-26b at full width and
    serve_vlm's depth cut (its seeded weights, f32): 4 prompts of 4096
    tokens after 256 zero patch embeddings (the reference engine's), 16
    greedy tokens against a dense cache of 256 + 4096 + 16 positions,
    counted as ``_generate_counted`` says.  Outside the window: the
    prefill's logits against ``last_logits`` of the same batch, bitwise;
    decode step 0 against the full forward of each prompt and its first
    greedy token (one prompt at a time) with the materialized softmax, the
    decode's own attention math, and the distance to the forward through
    the flash kernel beside it."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_SERVE_LAYERS)
    t_phase = time.perf_counter()
    P = cfg.n_frontend_tokens
    seq_len = P + GEN_PROMPT + VLM_GEN_NEW
    prompts = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH, seq_len=seq_len,
                        device=DEV)
    run, kept = _generate_counted("generate_vlm", eng, prompts, VLM_GEN_NEW,
                                  keep=(-1, 0))
    tokens = run.pop("tokens")

    # ---- outside the window
    t1 = time.perf_counter()
    toks = torch.from_numpy(np.concatenate([prompts, tokens[:, :1]],
                                           axis=1)).to(DEV)
    zeros = torch.zeros((GEN_BATCH, P, cfg.d_model), device=DEV)
    forward = model_api.make_forward(cfg)
    with torch.no_grad():
        last = forward(eng.params, {"tokens": toks[:, :GEN_PROMPT],
                                    "embeds": zeros})
    if not torch.equal(last, kept[-1]):
        fail("generate_vlm: the prefill's logits are not last_logits' bits")
    del last
    step0 = {"max_abs_err": 0.0, "max_abs_logit": 0.0,
             "max_abs_err_vs_flash_forward": 0.0,
             "flash_forward_vs_materialized": 0.0}
    for j in range(GEN_BATCH):
        one = {"tokens": toks[j:j + 1], "embeds": zeros[j:j + 1]}
        with torch.no_grad(), materialized_attention():
            want_l = forward(eng.params, one)[0]
        with torch.no_grad():
            flash_l = forward(eng.params, one)[0]
        err = (kept[0][j] - want_l).abs()
        excess = (err - GEN_TOL * want_l.abs()).max().item()
        for key, x in (("max_abs_err", err.max()),
                       ("max_abs_logit", want_l.abs().max()),
                       ("max_abs_err_vs_flash_forward",
                        (kept[0][j] - flash_l).abs().max()),
                       ("flash_forward_vs_materialized",
                        (flash_l - want_l).abs().max())):
            step0[key] = max(step0[key], x.item())
        del want_l, flash_l
        if not excess <= GEN_TOL:
            fail(f"generate_vlm: decode step 0's logits of prompt {j} differ "
                 f"from the full forward past rtol = atol = {GEN_TOL}: {step0}")
    if not torch.equal(kept[0].argmax(-1).cpu(),
                       torch.from_numpy(tokens[:, 1]).long()):
        fail("generate_vlm: token 1 is not decode step 0's argmax")
    del kept
    check_s = time.perf_counter() - t1
    bound = _decode_bound(eng, params)
    median_ms = run.pop("median_ms")
    if args.profile:
        with torch.no_grad():
            _, cache = eng.arts.prefill(eng.params, {
                "tokens": toks[:, :GEN_PROMPT], "embeds": zeros})
        tok = toks[:, GEN_PROMPT].to(torch.int32)

        def one_step():
            eng.arts.decode(eng.params, cache, tok)   # writes one slot again

        one_step()                     # warm; 3 traced steps after it
        profile_steps(one_step, median_ms,
                      f"{cfg.name} BatchedEngine decode step", steps=3)
        del cache
    say(phase="generate_vlm", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        batch=GEN_BATCH, patches=P, prompt_len=GEN_PROMPT,
        max_new=VLM_GEN_NEW, seq_len=seq_len, window=0, dtype="float32",
        weights="serve_vlm's, random from a seed; zero patches",
        reduced={"n_layers": f"{VLM_SERVE_LAYERS} of 48 (serve_vlm's weights)"},
        **run, **bound,
        decode_step_over_bound=median_ms / bound["decode_step_bound_ms"],
        prefill_logits_equal_last_logits=True, step0_vs_forward=step0,
        tolerance=GEN_TOL, check_s=check_s,
        tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return run["launches"]


def _decode_vs_forward(cfg, params, toks, kept, tol, what,
                       phase="generate_ssm", prompt=SSM_SERVE_SEQ,
                       checked=SSM_GEN_CHECKED):
    """Decode steps ``checked`` (their logits in ``kept``) against the
    chunked forward over the ``prompt`` tokens and the tokens fed so far,
    each within ``tol`` of the largest logit; at the last step the same
    forward at half the chunk beside it (the model's own f32 spread).
    Returns the gaps."""
    errs = {}
    half = dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2)
    for t in checked:
        seq = {"tokens": toks[:, :prompt + t + 1]}
        with torch.no_grad():
            want_l = model_api.make_forward(cfg)(params, seq)
        scale = want_l.abs().max().item()
        err = (kept[t] - want_l).abs().max().item()
        errs[str(t)] = {"max_abs_err": err, "max_abs_logit": scale,
                        "rel_err": err / scale}
        if t == checked[-1]:
            with torch.no_grad():
                other = model_api.make_forward(half)(params, seq)
            errs[str(t)]["half_chunk_forward_rel_err"] = \
                (other - want_l).abs().max().item() / scale
        if not err <= tol * scale:
            fail(f"{phase}: {what} decode step {t}'s logits differ from "
                 f"the chunked forward past {tol} of the largest logit: "
                 f"{errs[str(t)]}")
    return errs


def run_generate_ssm(args, params):
    """``BatchedEngine.generate`` on xlstm-350m at full width and depth
    (serve_ssm's seeded weights, f32): 4 prompts of SSM_SERVE_SEQ tokens,
    16 greedy tokens from the recurrent state, counted as
    ``_generate_counted`` says (no flash launch anywhere).  The state left
    by the prefill must have ``pos == SSM_SERVE_SEQ``.  Outside the window:
    decode steps 0, 1 and 15 (the recurrent form) against the chunked
    forward over the prompt and the tokens fed so far, within
    SSM_GEN_REL_TOL_FULL of the largest logit; the same over the first
    SSM_GEN_CHECK_LAYERS layers of the same weights (a prefill, then the
    full depth's tokens fed), within SSM_GEN_REL_TOL; a decode step's
    median ms against its byte bound, and the device's idle share over 3
    traced decode steps."""
    cfg = get_config(SSM_ARCH)
    t_phase = time.perf_counter()
    prompts = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (GEN_BATCH, SSM_SERVE_SEQ), dtype=np.int32)
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH, seq_len=SSM_SERVE_SEQ,
                        device=DEV)
    prefill, seen = eng.arts.prefill, []

    def prefill_kept(p, batch):
        logits, state = prefill(p, batch)
        seen.append(state["pos"])       # a device tensor: read after the run
        return logits, state

    eng.arts = dataclasses.replace(eng.arts, prefill=prefill_kept)
    run, kept = _generate_counted("generate_ssm", eng, prompts, SSM_GEN_NEW,
                                  keep=SSM_GEN_CHECKED)
    tokens = run.pop("tokens")
    if [int(p) for p in seen] != [SSM_SERVE_SEQ]:
        fail(f"generate_ssm: the prefill's state has pos "
             f"{[int(p) for p in seen]}, not {SSM_SERVE_SEQ}")

    # ---- outside the window: decode logits against the chunked forward
    t1 = time.perf_counter()
    toks = torch.from_numpy(np.concatenate([prompts, tokens], axis=1)).to(DEV)
    for t in SSM_GEN_CHECKED:
        if t + 1 < SSM_GEN_NEW and not torch.equal(
                kept[t].argmax(-1).cpu(),
                torch.from_numpy(tokens[:, t + 1]).long()):
            fail(f"generate_ssm: token {t + 1} is not step {t}'s argmax")
    errs = {str(cfg.n_layers): _decode_vs_forward(
        cfg, eng.params, toks, kept, SSM_GEN_REL_TOL_FULL,
        f"{cfg.n_layers}-layer")}
    del kept
    L = SSM_GEN_CHECK_LAYERS
    short = dataclasses.replace(cfg, n_layers=L)
    p_short = {k: (v[:L // 2] if k.startswith("pairs/") else v)
               for k, v in eng.params.items()}
    with torch.no_grad():
        _, state = model_api.make_prefill(short, 0)(
            p_short, {"tokens": toks[:, :SSM_SERVE_SEQ]})
        kept = {}
        for t in range(SSM_GEN_NEW):
            kept[t], state = model_api.make_decode(short)(
                p_short, state, toks[:, SSM_SERVE_SEQ + t])
    errs[str(L)] = _decode_vs_forward(short, p_short, toks, kept,
                                          SSM_GEN_REL_TOL, f"{L}-layer")
    del kept, state
    check_s = time.perf_counter() - t1
    bound = _decode_bound(eng, params)
    median_ms = run.pop("median_ms")
    with torch.no_grad():
        _, state = eng.arts.prefill(eng.params,
                                    {"tokens": toks[:, :SSM_SERVE_SEQ]})
    tok = toks[:, SSM_SERVE_SEQ].to(torch.int32)

    def one_step():
        nonlocal state
        _, state = eng.arts.decode(eng.params, state, tok)

    one_step()                     # warm; 3 traced steps after it
    busy_s, n_launch = _device_busy_s(lambda: [one_step() for _ in range(3)])
    del state
    say(phase="generate_ssm", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, batch=GEN_BATCH, prompt_len=SSM_SERVE_SEQ,
        max_new=SSM_GEN_NEW, seq_len=SSM_SERVE_SEQ, dtype="float32",
        weights="serve_ssm's, random from a seed",
        reduced={"prompt_len": f"{SSM_SERVE_SEQ} tokens, not 4096 (the "
                               f"sLSTM is host-paced: a 4096-token forward "
                               f"takes 7.8-9.6 s on the card)"},
        **run, **bound,
        decode_step_over_bound=median_ms / bound["decode_step_bound_ms"],
        decode_device_busy_ms=busy_s * 1e3 / 3,
        decode_launches=n_launch / 3,
        decode_device_idle_share=1.0 - busy_s * 1e3 / 3 / median_ms,
        state_pos_after_prefill=SSM_SERVE_SEQ,
        logits_vs_chunked_forward_by_depth=errs,
        rel_tolerance_by_depth={str(cfg.n_layers): SSM_GEN_REL_TOL_FULL,
                                str(L): SSM_GEN_REL_TOL},
        check_s=check_s, tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return run["launches"]


def run_generate_hybrid(args, params):
    """``BatchedEngine.generate`` on zamba2-1.2b at full width and depth
    (serve_hybrid's seeded weights, f32): 4 prompts of 4096 tokens, 16
    greedy tokens against the SSM states, conv rings and the shared
    block's 7 dense KV caches of 4112 positions, counted as
    ``_generate_counted`` says (7 flash launches in the prefill, none in
    the decode).  The state left by the prefill must have ``pos ==
    4096``.  Outside the window: decode steps HYBRID_GEN_CHECKED against
    the chunked forward over the prompt and the tokens fed so far (the
    forward at half the chunk beside the last), within HYBRID_GEN_REL_TOL
    of the largest logit; a decode step's median ms against its byte
    bound, and the device's idle share over 3 traced decode steps."""
    cfg = get_config(HYBRID_ARCH)
    t_phase = time.perf_counter()
    P, new = GEN_PROMPT, HYBRID_GEN_NEW
    prompts = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (GEN_BATCH, P), dtype=np.int32)
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH, seq_len=P + new,
                        device=DEV)
    prefill, seen = eng.arts.prefill, []

    def prefill_kept(p, batch):
        logits, state = prefill(p, batch)
        seen.append(state["pos"])       # a device tensor: read after the run
        return logits, state

    eng.arts = dataclasses.replace(eng.arts, prefill=prefill_kept)
    run, kept = _generate_counted("generate_hybrid", eng, prompts, new,
                                  keep=HYBRID_GEN_CHECKED)
    tokens = run.pop("tokens")
    if [int(p) for p in seen] != [P]:
        fail(f"generate_hybrid: the prefill's state has pos "
             f"{[int(p) for p in seen]}, not {P}")

    # ---- outside the window: decode logits against the chunked forward
    t1 = time.perf_counter()
    toks = torch.from_numpy(np.concatenate([prompts, tokens], axis=1)).to(DEV)
    for t in HYBRID_GEN_CHECKED:
        if not torch.equal(kept[t].argmax(-1).cpu(),
                           torch.from_numpy(tokens[:, t + 1]).long()):
            fail(f"generate_hybrid: token {t + 1} is not step {t}'s argmax")
    errs = _decode_vs_forward(cfg, eng.params, toks, kept,
                              HYBRID_GEN_REL_TOL, f"{cfg.n_layers}-layer",
                              phase="generate_hybrid", prompt=P,
                              checked=HYBRID_GEN_CHECKED)
    del kept
    check_s = time.perf_counter() - t1
    bound = _decode_bound(eng, params)
    median_ms = run.pop("median_ms")
    with torch.no_grad():
        _, state = eng.arts.prefill(eng.params, {"tokens": toks[:, :P]})
    tok = toks[:, P].to(torch.int32)

    def one_step():
        nonlocal state
        _, state = eng.arts.decode(eng.params, state, tok)

    one_step()                     # warm; 3 traced steps after it
    busy_s, n_launch = _device_busy_s(lambda: [one_step() for _ in range(3)])
    del state
    say(phase="generate_hybrid", model=cfg.name, n_layers=cfg.n_layers,
        shared_block_applications=attention_layers(cfg),
        d_model=cfg.d_model, batch=GEN_BATCH, prompt_len=P, max_new=new,
        seq_len=P + new, window=0, dtype="float32",
        weights="serve_hybrid's, random from a seed",
        reduced={"max_new": f"{new} tokens", "weights": "random, seeded"},
        **run, **bound,
        decode_step_over_bound=median_ms / bound["decode_step_bound_ms"],
        decode_device_busy_ms=busy_s * 1e3 / 3,
        decode_launches=n_launch / 3,
        decode_device_idle_share=1.0 - busy_s * 1e3 / 3 / median_ms,
        state_pos_after_prefill=P,
        checked_forward_lengths=[P + t + 1 for t in HYBRID_GEN_CHECKED],
        logits_vs_chunked_forward=errs, rel_tolerance=HYBRID_GEN_REL_TOL,
        check_s=check_s, tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return run["launches"]

def run_generate_encdec(args, params, frames=None, new=ENCDEC_GEN_NEW,
                        checked=ENCDEC_GEN_CHECKED, phase="generate_encdec",
                        into=None):
    """``BatchedEngine.generate`` on whisper-tiny at full width and depth
    (the serve phase's seeded weights, f32): a batch of 4 on ``frames``
    (default ENCDEC_FRAMES) zero frames (the reference engine's; the prompts fix only the batch),
    ``new`` greedy tokens against the self-KV ring of 448 slots and the
    cross-KV of every layer, counted as ``_generate_counted`` says: the
    flash kernel in the prefill once an encoder layer and a decoder layer
    (its one decode step's cross-attention) and once a decoder layer a
    decode step, above ``CHUNK_THRESHOLD`` frames only, else never.  The
    prefill's cache must have ``pos == 1``.  Outside the window: the
    prefill and decode steps ``checked`` against the unrolled chain of the
    port's own ``prefill`` and ``decode_step`` on the generated tokens
    (the reference's decode semantics, decode against decode), within
    GEN_TOL of the largest logit; the decode against the teacher-forced
    ``decode_train`` over the same tokens at positions 0 and 7, printed
    (ROADMAP C.7: the decode does not rotate q and k; 7 or, with fewer
    tokens, the last); a decode step's median ms against its byte bound,
    and the device's idle share over 3 traced decode steps.  With ``into`` a dict, the phase line goes there
    instead of to the output."""
    cfg = get_config(ENCDEC_ARCH)
    frames = frames or ENCDEC_FRAMES
    t_phase = time.perf_counter()
    B = GEN_BATCH
    prompts = np.zeros((B, 1), np.int32)
    eng = BatchedEngine(cfg, params, batch=B, seq_len=frames, device=DEV)
    prefill, seen = eng.arts.prefill, []

    def prefill_kept(p, batch):
        logits, cache = prefill(p, batch)
        seen.append(cache["pos"])       # a device tensor: read after the run
        return logits, cache

    eng.arts = dataclasses.replace(eng.arts, prefill=prefill_kept)
    # a decode step's cross-attention: the flash kernel above the threshold
    per_step = cfg.n_layers if frames > model_common.CHUNK_THRESHOLD else 0
    c7 = min(7, new - 1)           # the C.7 position beside position 0
    run, kept = _generate_counted(phase, eng, prompts, new,
                                  keep=(-1, c7 - 1, *checked),
                                  flash=(flash_layers(cfg, frames), per_step))
    tokens = run.pop("tokens")
    if [int(p) for p in seen] != [1]:
        fail(f"{phase}: the prefill's cache has pos "
             f"{[int(p) for p in seen]}, not 1")

    # ---- outside the window: the unrolled chain, decode against decode
    t1 = time.perf_counter()
    zeros = torch.zeros((B, frames, cfg.d_model), device=DEV)
    toks = torch.from_numpy(tokens).to(DEV)
    for t in checked:
        if t + 1 < new and not torch.equal(
                kept[t].argmax(-1).cpu(),
                torch.from_numpy(tokens[:, t + 1]).long()):
            fail(f"{phase}: token {t + 1} is not step {t}'s argmax")
    with torch.no_grad():
        logits, cache = model_api.make_prefill(cfg, frames)(
            eng.params, {"embeds": zeros})
        chain = {-1: logits}
        decode = model_api.make_decode(cfg)
        for t in range(max(checked) + 1):
            logits, cache = decode(eng.params, cache, toks[:, t])
            if t in checked:
                chain[t] = logits
    del cache
    chain_errs, bitwise = {}, True
    for t in (-1, *checked):
        scale = chain[t].abs().max().item()
        err = (kept[t] - chain[t]).abs().max().item()
        bitwise = bitwise and torch.equal(kept[t], chain[t])
        chain_errs[str(t)] = {"max_abs_err": err, "max_abs_logit": scale}
        if not err <= GEN_TOL * scale:
            fail(f"{phase}: decode step {t} differs from the unrolled chain "
                 f"past {GEN_TOL} of the largest logit: {chain_errs[str(t)]}")
    # ROADMAP C.7 on the card: the teacher-forced decoder over token 0 and
    # the first c7 greedy tokens, at positions 0 (the prefill's logits) and
    # c7 (decode step c7 - 1's)
    forced = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=DEV),
                        toks[:, :c7]], dim=1)
    with torch.no_grad():
        enc = encdec.encode(eng.params, cfg, zeros)
        train = encdec.decode_train(eng.params, cfg, enc, forced)
    scale = train.abs().max().item()
    c7 = {f"position_{p}": (kept[p - 1] - train[:, p]).abs().max().item()
          / scale for p in (0, c7)}
    if not c7["position_0"] <= GEN_TOL:
        fail(f"{phase}: the prefill's logits are not decode_train's at "
             f"position 0, where RoPE is the identity: {c7}")
    del kept, chain, enc, train
    check_s = time.perf_counter() - t1
    bound = _decode_bound(eng, params)
    median_ms = run.pop("median_ms")
    with torch.no_grad():
        _, cache = eng.arts.prefill(eng.params, {"embeds": zeros})
    tok = toks[:, 0]

    def one_step():
        nonlocal cache
        _, cache = eng.arts.decode(eng.params, cache, tok)

    one_step()                     # warm; 3 traced steps after it
    busy_s, n_launch = _device_busy_s(lambda: [one_step() for _ in range(3)])
    del cache
    line = dict(
        phase=phase, model=cfg.name, n_layers=cfg.n_layers,
        enc_layers=cfg.enc_layers, d_model=cfg.d_model, batch=B,
        frames=frames, max_new=new, dec_ctx=cfg.dec_ctx, dtype="float32",
        weights="serve_encdec's, random from a seed; zero frames",
        reduced={"weights": "random, seeded", "max_new": f"{new} tokens"},
        **run, **bound,
        decode_step_over_bound=median_ms / bound["decode_step_bound_ms"],
        decode_device_busy_ms=busy_s * 1e3 / 3,
        decode_launches=n_launch / 3,
        decode_device_idle_share=1.0 - busy_s * 1e3 / 3 / median_ms,
        cache_pos_after_prefill=1, decode_vs_unrolled_chain=chain_errs,
        decode_equals_unrolled_chain_bitwise=bitwise, tolerance=GEN_TOL,
        decode_vs_decode_train_rel_err=c7, check_s=check_s,
        tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    if into is None:
        say(**line)
    else:
        into.update(line)
    return run["launches"]


# ----------------------------------------------------- LM training path
def _digest(tensors):
    """Exact fingerprint of f32 tensors' bits: per tensor, the sum of its
    words and their sum weighted by position (mod 8191), in int64 (equal
    bits give equal digests; other bits almost surely do not)."""
    out = []
    for t in tensors:
        words = t.detach().reshape(-1).view(torch.int32)
        plain = weighted = 0
        for lo in range(0, words.numel(), 1 << 24):
            w = words[lo:lo + (1 << 24)].to(torch.int64)
            pos = torch.arange(lo, lo + w.numel(), device=w.device) % 8191 + 1
            plain += int(w.sum())
            weighted += int((w * pos).sum())
        out.append((plain, weighted))
    return out


def _lm_expected(tr, steps, pipelined, frames=None):
    """Launch counts ``steps`` calls of a Trainer on the LM issue: flash
    forward twice a layer and subset (the checkpoint recomputes it), its
    backward once (an encoder-decoder on ``frames``: ``flash_layers``),
    one encode a coded leaf and subset (2D for a 1-D leaf, 3D for the
    others), one 2D decode (or fused decode-apply) a bucket and retired
    update."""
    cfg, code = tr.cfg, tr.code
    subsets = code.n * code.d
    layers = flash_layers(cfg, frames)
    coded = [k for k, pl in tr.arts.plans.items() if pl.coded]
    one_d = sum(1 for k in coded if tr.params[k].ndim == 1)
    buckets = len(tr.arts.pack_plan.buckets)
    enc = "coded_encode_acc" if pipelined else "coded_encode"
    want = {"flash_attention": 2 * layers * subsets * steps,
            "flash_attention_bwd": layers * subsets * steps,
            f"{enc}_2d": one_d * subsets * steps,
            f"{enc}_3d": (len(coded) - one_d) * subsets * steps,
            ("coded_decode_apply" if pipelined else "coded_decode_2d"):
                buckets * steps}
    return _expect(**{k: v for k, v in want.items() if v})


def _lm_scalar_leaves(tr):
    """Coded leaves whose 3D encode operand would leave the 16-byte vector
    path by its shape: R (the trailing elements after the grouping dim) not
    a whole number of f32 vectors."""
    out = []
    for k, pl in tr.arts.plans.items():
        if pl.coded and tr.params[k].ndim > 1:
            shape = list(tr.params[k].shape)
            del shape[pl.group_dim]
            if math.prod(shape) % 4:
                out.append(k)
    return out


def _lm_check_paths(label, tr, paths, pipelined, steps=LM_STEPS):
    """Every encode and decode of an LM path on the vector path, but the 3D
    encodes of the leaves whose shape leaves it (``_lm_scalar_leaves``),
    which take the scalar path each subset and step."""
    enc = "coded_encode_acc_3d" if pipelined else "coded_encode_3d"
    n = len(_lm_scalar_leaves(tr)) * tr.code.n * tr.code.d * steps
    want = {enc: n} if n else {}
    scalar = {k: v["scalar"] for k, v in paths.items() if v["scalar"]}
    if scalar != want:
        fail(f"{label}: scalar-path launches {scalar}, the leaves' shapes "
             f"imply {want}")


def _lm_batches(cfg, code, seq=LM_SEQ, steps=LM_STEPS):
    rng = np.random.default_rng(SEED)
    return [{k: torch.from_numpy(v).to(DEV) for k, v in
             make_synthetic_batch(rng, cfg, code.num_subsets, seq).items()}
            for _ in range(steps)]


def _lm_run(tr, batches, label, drain=False):
    """The Trainer's steps over ``batches`` (and a drain), counted from 0;
    returns the logs, counts, paths and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    logs = [_timed_steps(tr, b, 1)[0] for b in batches]
    if drain:
        t0 = time.perf_counter()
        m = tr.drain()
        torch.cuda.synchronize()
        m["wall_ms"] = (time.perf_counter() - t0) * 1e3
        logs.append(m)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    paths = _note_paths(label, require_vector=False)
    plain = flash_attn.PLAIN_CALLS["flash_attention"]
    if plain:
        fail(f"{label}: the plain flash version ran {plain} times")
    return logs, counts, paths, torch.cuda.max_memory_allocated()


def _lm_check_run(label, tr, logs, counts, want, steps=LM_STEPS):
    if tr.arts.codec.backend.name != "hopper":
        fail(f"{label}: backend {tr.arts.codec.backend.name!r}, not the kernels")
    if tr.arts.coded_fraction != 1.0:
        fail(f"{label}: coded fraction {tr.arts.coded_fraction}")
    for m in logs[-steps:]:             # a pipeline's fill retires nothing
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            fail(f"{label}: non-finite metrics {logs}")
    if counts != want:
        fail(f"{label}: kernel launches {counts}, the code implies {want}")
    bad = [k for k, v in tr.params.items() if not torch.isfinite(v).all()]
    if bad:
        fail(f"{label}: non-finite parameters {bad[:4]}")


def _lm_grad_check(tr, batch):
    """The decoded gradient with one straggler against the uncoded gradient
    of the same batch: the mean over its sequences of each one's gradient,
    one sequence at a time.  Returns the relative error norm."""
    arts, code, cfg = tr.arts, tr.code, tr.cfg
    placed = CodedBatcher(code).place(batch)
    inp = arts.step_inputs((1,))
    dec, _ = arts.aggregate(tr.params, placed, inp["W"], inp["mask"], inp["rho"])
    del placed
    loss_fn = model_api.make_loss(cfg)
    names = list(tr.params)
    p = {k: v.detach().requires_grad_(True) for k, v in tr.params.items()}
    k_sub = code.num_subsets
    num = den = 0.0
    unc = None
    for j in range(k_sub):
        sub = {key: v[j:j + 1] for key, v in batch.items()}
        g = torch.autograd.grad(loss_fn(p, sub), [p[n] for n in names])
        if unc is None:
            unc = [x / k_sub for x in g]
        else:
            for u, x in zip(unc, g):
                u.add_(x / k_sub)
        del g
    for name, u in zip(names, unc):
        num += float(torch.sum((dec[name] - u) ** 2))
        den += float(torch.sum(u * u))
    rel = math.sqrt(num / den)
    if not rel <= LM_GRAD_REL_TOL:
        fail(f"the decoded LM gradient with a straggler is {rel:.3e} from the "
             f"uncoded one (relative norm), past {LM_GRAD_REL_TOL}")
    return rel


def _lm_uncoded_grad(tr, batch):
    """The uncoded gradient of ``batch`` at the trainer's parameters (the
    mean over its sequences of each one's gradient, one sequence at a
    time), and whether the first sequence's gradient, computed once more,
    repeats its bits (compared through exact digests)."""
    loss_fn = model_api.make_loss(tr.cfg)
    names = list(tr.params)
    p = {k: v.detach().requires_grad_(True) for k, v in tr.params.items()}
    k_sub = tr.code.num_subsets
    unc, first = None, None
    for j in (*range(k_sub), 0):
        sub = {key: v[j:j + 1] for key, v in batch.items()}
        lval = loss_fn(p, sub)
        g = torch.autograd.grad(lval, [p[n] for n in names])
        digest = (_digest([lval.detach().reshape(1)]), _digest(g))
        if first is None:
            first = digest
        elif j == 0:
            return dict(zip(names, unc)), digest == first
        if unc is None:
            unc = [x / k_sub for x in g]
        else:
            for u, x in zip(unc, g):
                u.add_(x / k_sub)
        del g, lval


def _recording(opt):
    """``opt`` with its first update's gradients kept in the returned list:
    the decoded gradient the Trainer's first step applies."""
    seen = []

    def update(grads, state, params):
        if not seen:
            seen.append(grads)
        return opt.update(grads, state, params)

    return dataclasses.replace(opt, update=update), seen


def _rel_norm(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every leaf, summed in float64; fails
    naming the leaves where either side is not finite."""
    bad = [k for k in want if not (torch.isfinite(got[k]).all()
                                   and torch.isfinite(want[k]).all())]
    if bad:
        fail(f"non-finite gradients at {bad[:6]}")
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2))
              for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return math.sqrt(num / den)


def _lm_fill_drain_check(tr, batch):
    """Fill + drain against the synchronous step (the same SGD-momentum, the
    pipelined Trainer's own artifacts) from the Trainer's state, bit for
    bit: params, momentum and loss, compared through exact digests so that
    the two results never share the card."""
    arts = tr.arts
    placed = CodedBatcher(tr.code).place(batch)
    inp = arts.step_inputs((2,))
    a = (inp["W"], inp["mask"], inp["rho"])
    names = list(tr.params)
    ps, ss, ms = arts.step(tr.params, tr.opt_state, placed, *a)
    want = _digest([ps[k] for k in names] + [ss["mu"][k] for k in names])
    want_loss = float(ms["loss"])
    del ps, ss, ms
    drv = PipelineDriver(arts)
    pp, sp, mp = drv.step(tr.params, tr.opt_state, placed, *a)
    if mp is not None:
        fail("the LM pipeline's fill retired an update")
    pp, sp, mp = drv.drain(pp, sp)
    got = _digest([pp[k] for k in names] + [sp["mu"][k] for k in names])
    if got != want or float(mp["loss"]) != want_loss:
        fail("LM fill + drain differs from the synchronous step")
    return True


def checkpoint_lm(tr):
    """Checkpoint phase (b): the synchronous LM trainer's parameters and
    NAG state saved with ``maybe_checkpoint(force=True)`` and restored onto
    the host into a tree of the same structure (``like`` leaves of
    ``torch.empty`` on the CPU), then compared leaf by leaf, bitwise, one
    leaf on the host at a time: no second copy on the card."""
    t_phase = time.perf_counter()
    d = tr._ckpt.dir
    state = [*tr.params.values(), *tr.opt_state["x_prev"].values(),
             tr.opt_state["lam"]]
    nbytes = sum(v.numel() * v.element_size() for v in state)
    free = shutil.disk_usage(d).free
    if free < nbytes * 1.01:
        fail(f"checkpoint: {d} has {free} bytes free, the snapshot needs "
             f"{nbytes}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.maybe_checkpoint(force=True)
    save_s = time.perf_counter() - t0
    path = tr._ckpt._step_path(tr._step_count)
    file_bytes = path.stat().st_size

    def host(t):
        return torch.empty(t.shape, dtype=t.dtype, device="cpu")

    like = {"params": convert.unflatten({k: host(v) for k, v in tr.params.items()}),
            "opt_state": {"x_prev": convert.unflatten(
                {k: host(v) for k, v in tr.opt_state["x_prev"].items()}),
                "lam": host(tr.opt_state["lam"])}}
    t0 = time.perf_counter()
    got, meta = tr._ckpt.restore_latest(like)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = convert.flatten(got["params"])
    x_prev = convert.flatten(got["opt_state"]["x_prev"])
    bad = [k for k, v in tr.params.items() if not _bitwise(v, params[k])]
    bad += [f"x_prev/{k}" for k, v in tr.opt_state["x_prev"].items()
            if not _bitwise(v, x_prev[k])]
    if not _bitwise(tr.opt_state["lam"], got["opt_state"]["lam"]):
        bad.append("lam")
    compare_s = time.perf_counter() - t0
    if bad or meta.get("step") != tr._step_count:
        fail(f"checkpoint: the restored LM state differs at {bad[:4]} "
             f"(step {meta.get('step')})")
    del got, params, x_prev, like
    say(phase="checkpoint", part="b", model=tr.cfg.name,
        n_layers=tr.cfg.n_layers, step=tr._step_count,
        leaves=len(state), state_bytes=nbytes, file_bytes=file_bytes,
        free_bytes_before=free, save_s=save_s,
        save_gb_per_s=nbytes / save_s / 1e9, restore_s=restore_s,
        restore_gb_per_s=nbytes / restore_s / 1e9, compare_s=compare_s,
        bitwise=True, metadata={k: meta[k] for k in ("arch", "data_cursor",
                                                     "seed", "step")},
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())


def run_train_lm_path(args):
    """Coded training of qwen3-1.7b at full width on 4096-token sequences.

    Synchronous: ``Trainer`` with NAG over all 28 layers, code (4, 3, 1, 2),
    random stragglers, one sequence a subset, LM_STEPS steps, counted from 0;
    then, outside the window, the decoded gradient with a straggler against
    the uncoded one.  Pipelined: ``SchemeSpec(pipelined=True,
    fuse_apply=True)`` with SGD-momentum, also over 28 layers, LM_STEPS
    steps and a drain, counted
    from 0; then fill + drain against the synchronous step, bitwise.
    Weights are random from a seeded CUDA generator (the Trainer's)."""
    full = get_config("qwen3-1.7b")
    code = make_code(*LM_CODE)
    batches = _lm_batches(full, code)
    res = {}
    for label, opt, spec in (
            ("qwen3-1.7b Trainer.step", nag(LM_NAG_LR), None),
            # the pipelined step's peak is about 8.4 P + 11 GB (P the
            # parameters' bytes: old and new params and momentum, two
            # wires, one subset's gradients; the activations): 79 GB of the
            # card's 85 at full depth
            ("qwen3-1.7b pipelined Trainer.step",
             sgd_momentum(LM_SGD_LR, 0.9),
             coding.SchemeSpec(pipelined=True, fuse_apply=True))):
        res[label] = _train_lm(args, label, full, code, opt, spec, batches,
                               checkpoint=spec is None, reduced=LM_STEPS_CUT)
    return res


def run_train_moe(args):
    """Coded training of olmoe-1b-7b at full width, 4 of its 16 layers, on
    4096-token sequences: ``Trainer`` with NAG, code (4, 3, 1, 2), random
    stragglers, one sequence a subset, LM_STEPS steps counted from 0;
    outside the window the decoded gradient with a straggler against the
    uncoded one, and one subset's gradient twice, bitwise."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    code = make_code(*LM_CODE)
    label = f"{MOE_ARCH} Trainer.step"
    return {label: _train_lm(
        args, label, cfg, code, nag(LM_NAG_LR), None, _lm_batches(cfg, code),
        phase="train_moe",
        reduced={"n_layers": f"{MOE_TRAIN_LAYERS} of 16 (the f32 trainer "
                             f"at full depth needs about 6.7 x 27.7 GB)",
                 **LM_STEPS_CUT})}


def run_train_vlm(args):
    """Coded training of internvl2-26b at full width, 2 of its 48 layers,
    on sequences of 256 patch embeddings and 4096 tokens: ``Trainer`` with
    NAG, code (4, 3, 1, 2), random stragglers, one sequence a subset,
    LM_STEPS steps counted from 0; outside the window the decoded gradient
    with a straggler against the uncoded one, and one subset's gradient
    twice, bitwise."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS)
    code = make_code(*LM_CODE)
    label = f"{VLM_ARCH} Trainer.step"
    return {label: _train_lm(
        args, label, cfg, code, nag(LM_NAG_LR), None, _lm_batches(cfg, code),
        phase="train_vlm",
        reduced={"n_layers": f"{VLM_TRAIN_LAYERS} of 48 (the f32 trainer "
                             f"needs about 6.7 x its weights: 7.67 GB at 2 "
                             f"layers, 79.4 GB at 48)",
                 **LM_STEPS_CUT})}


def run_train_ssm(args):
    """Coded training of xlstm-350m at full width and SSM_TRAIN_LAYERS of
    its 24 layers on sequences of SSM_TRAIN_SEQ tokens: ``Trainer`` with NAG,
    code (4, 3, 1, 2), random stragglers, one sequence a subset,
    SSM_TRAIN_STEPS steps counted from 0 (every leaf coded: a 2D encode for
    ``ln_f``, 3D for the
    24 others, the stacked vectors on the scalar path (R = 3 at 6
    layers), one decode a step; no
    flash launch); outside the window the
    decoded gradient with a straggler against the uncoded one, and one
    subset's gradient twice, bitwise."""
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_TRAIN_LAYERS)
    code = make_code(*LM_CODE)
    label = f"{SSM_ARCH} Trainer.step"
    return {label: _train_lm(
        args, label, cfg, code, nag(LM_NAG_LR), None,
        _lm_batches(cfg, code, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS),
        phase="train_ssm", check_first_step=True,
        reduced={"seq_len": f"{SSM_TRAIN_SEQ} tokens, not 4096 (the sLSTM "
                            f"is host-paced: a 4096-token forward takes "
                            f"7.8-9.6 s on the card)",
                 "n_layers": f"{SSM_TRAIN_LAYERS} of 24 (with the hybrid "
                             f"phases the script took 928.1 and 974.8 s on "
                             f"the card at 24 layers, with the encdec "
                             f"phases 938.9 s at 12; its limit is 900 s)"})}


def run_train_hybrid(args):
    """Coded training of zamba2-1.2b at full width and full depth (38
    Mamba2 layers, 7 applications of the shared block) on sequences of
    HYBRID_TRAIN_SEQ tokens: ``Trainer`` with NAG, code (4, 3, 1, 2),
    random stragglers, one sequence a subset, HYBRID_TRAIN_STEPS steps
    counted from 0: per step 36 2D encodes (``ln_f``, ``shared_attn/ln1``,
    ``ln2``), 216 3D
    (72 of them on the scalar path: the six stacked vectors, R = 38), 1
    decode, 168 flash forwards (a checkpointed application runs its
    forward twice) and 84 backwards; step 0's decoded gradient (a
    straggler) against the uncoded one taken before the window, the
    shared block's leaves named, and one subset's gradient twice,
    bitwise."""
    cfg = get_config(HYBRID_ARCH)
    code = make_code(*LM_CODE)
    label = f"{HYBRID_ARCH} Trainer.step"
    return {label: _train_lm(
        args, label, cfg, code, nag(LM_NAG_LR), None,
        _lm_batches(cfg, code, HYBRID_TRAIN_SEQ, HYBRID_TRAIN_STEPS),
        phase="train_hybrid", check_first_step=True,
        reduced={"seq_len": f"{HYBRID_TRAIN_SEQ} tokens, not 4096 (at 4096 "
                            f"the three hybrid phases took 131.9 s on the "
                            f"card, past their 90 s; at 2304 the script "
                            f"took 928.1-974.8 s, past its 900 s)"})}


def run_train_encdec(args):
    """Coded training of whisper-tiny at full width and full depth (4 + 4
    layers) on sequences of 1500 frames and ENCDEC_TRAIN_TOKENS decoder
    tokens: ``Trainer`` with NAG, code (4, 3, 1, 2), random stragglers, one
    sequence a subset, 2 steps counted from 0: per step 24 2D encodes
    (``enc_ln_f``, ``ln_f``), 324 3D (24 of them on the scalar path:
    ``embed`` and ``unembed``, rows of the odd vocabulary 51865), 1 decode
    and no flash launch (1500 frames: the materialized softmax); step 0's
    decoded gradient (a straggler) against the uncoded one taken before
    the window, and one subset's gradient twice, bitwise."""
    cfg = get_config(ENCDEC_ARCH)
    code = make_code(*LM_CODE)
    label = f"{ENCDEC_ARCH} Trainer.step"
    return {label: _train_lm(
        args, label, cfg, code, nag(LM_NAG_LR), None,
        _lm_batches(cfg, code, ENCDEC_TRAIN_TOKENS, ENCDEC_TRAIN_STEPS),
        phase="train_encdec", check_first_step=True)}


def run_long_encdec(args):
    """whisper-tiny at ENCDEC_LONG_FRAMES = 3000 frames (60 s of audio,
    ``enc_pos`` tiled twice), above ``CHUNK_THRESHOLD``: the encoder's
    self-attention and every cross-attention run the flash kernels with
    the full mask, forward and backward.  One served batch (96 flash
    launches: 4 encoder and 4 cross at Sq = 1 a prefill; each subset
    against its uncoded forward), ENCDEC_LONG_GEN_NEW generated tokens (8
    flash launches in the prefill, 4 a decode step; the unrolled chain),
    one training step on 448 tokens (16 flash forwards a subset, the
    checkpoint recomputing each, and 8 backwards; the decoded gradient
    against the uncoded one), each counted from 0 by its own function;
    the plain flash version is never called over the phase.  One line,
    the three parts' lines inside it."""
    cfg = get_config(ENCDEC_ARCH)
    F = ENCDEC_LONG_FRAMES
    t0 = time.perf_counter()
    parts, counts = {}, {}
    # every call of the plain flash version over the phase, outside the
    # parts' counted windows too (each part resets PLAIN_CALLS at its own)
    plain_fn, plain = flash_attn.flash_attention_gqa_plain, [0]

    def counted_plain(*a, **kw):
        plain[0] += 1
        return plain_fn(*a, **kw)

    flash_attn.flash_attention_gqa_plain = counted_plain
    try:
        _long_encdec_parts(args, cfg, F, parts, counts)
    finally:
        flash_attn.flash_attention_gqa_plain = plain_fn
    if plain[0]:
        fail(f"long_encdec: the plain flash version ran {plain[0]} times")
    flash = {label: {k: c[k] for k in ("flash_attention",
                                        "flash_attention_bwd")}
             for label, c in counts.items()}
    say(phase="long_encdec", model=cfg.name, frames=F,
        reduced={"max_new": f"{ENCDEC_LONG_GEN_NEW} tokens, cut from 8 "
                            f"(0.13 s) when the script took 938.9 s"},
        flash_launches_by_path=flash, plain_flash_calls=plain[0],
        **parts, seconds=time.perf_counter() - t0,
        nvidia_smi=nvidia_smi_line())
    return counts


def _long_encdec_parts(args, cfg, F, parts, counts):
    """``run_long_encdec``'s three parts: their lines into ``parts``, their
    launch counts into ``counts`` by path."""
    serve_label = f"{ENCDEC_ARCH} CodedServer.step at {F} frames"
    parts["serve"] = {}
    counts[serve_label], _, params = run_serve_path(
        args, ENCDEC_ARCH, 1, phase="long_encdec", seq=F, hedge=False,
        label=serve_label, into=parts["serve"],
        reduced={"weights": "random, seeded", "batches": 1})
    parts["generate"] = {}
    counts[f"{ENCDEC_ARCH} BatchedEngine.generate at {F} frames"] = \
        run_generate_encdec(args, params, F, ENCDEC_LONG_GEN_NEW,
                            ENCDEC_LONG_GEN_CHECKED, phase="long_encdec",
                            into=parts["generate"])
    del params
    code = make_code(*LM_CODE)
    batches = _lm_batches(cfg, code, ENCDEC_TRAIN_TOKENS, 1)
    batches[0]["embeds"] = torch.randn(
        (code.num_subsets, F, cfg.d_model),
        generator=torch.Generator(device=DEV).manual_seed(SEED + 29),
        device=DEV)
    train_label = f"{ENCDEC_ARCH} Trainer.step at {F} frames"
    parts["train"] = {}
    counts[train_label] = _train_lm(
        args, train_label, cfg, code, nag(LM_NAG_LR), None, batches,
        phase="long_encdec", check_first_step=True, into=parts["train"],
        reduced={"steps": "1 (the flash kernels' training modes, once)"})


def _subset_grad_repeats(tr, batch):
    """One subset's gradient computed twice gives the same bits (compared
    through exact digests, one gradient on the card at a time)."""
    loss_fn = model_api.make_loss(tr.cfg)
    sub = {key: v[:1] for key, v in batch.items()}
    digests = []
    for _ in range(2):
        p = {k: v.detach().requires_grad_(True) for k, v in tr.params.items()}
        lval = loss_fn(p, sub)
        g = torch.autograd.grad(lval, list(p.values()))
        digests.append((_digest([lval.detach().reshape(1)]), _digest(g)))
        del g, lval
    if digests[0] != digests[1]:
        fail(f"{tr.cfg.name}: one subset's gradient differs between two calls")
    return True


def _train_lm(args, label, cfg, code, opt, spec, batches, phase="train_lm",
              checkpoint=False, reduced=None, check_first_step=False,
              into=None):
    """One LM training path: build the ``Trainer``, its steps counted from
    0, the checks outside the window, the phase line; returns the counts.

    ``check_first_step``: the synchronous path's decoded gradient is the
    one its first step applies (kept by the optimizer, read after the
    window; that step's straggler set must not be empty), held against
    the uncoded gradient of the same batch at the same parameters, taken
    before the window; a second call of one sequence's gradient reuses
    that loop.  Otherwise the decoded gradient is an extra coded aggregate
    with straggler 1 after the steps.  With ``into`` a dict, the phase line
    goes there instead of to the output."""
    pipelined = spec is not None
    steps, seq = len(batches), batches[0]["tokens"].shape[1]
    frames = (batches[0]["embeds"].shape[1] if cfg.family == "encdec"
              else None)
    gc.collect()           # the last path's trainer, and any cycles
    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_") \
        if checkpoint else None
    if check_first_step:
        opt, first_grads = _recording(opt)
        first_stragglers = RandomStragglers(seed=3).draw(0, code).stragglers
        if not first_stragglers:
            fail(f"{label}: the first step has no straggler to decode past")
    tr = Trainer(cfg, code, opt, spec=spec, seed=SEED, device=DEV,
                 straggler_source=RandomStragglers(seed=3),
                 checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if check_first_step:
        t1 = time.perf_counter()
        unc, repeats = _lm_uncoded_grad(tr, batches[0])
        torch.cuda.synchronize()
        uncoded_s = time.perf_counter() - t1
    logs, counts, paths, peak = _lm_run(tr, batches, label, drain=pipelined)
    want = _lm_expected(tr, steps, pipelined, frames)
    _lm_check_run(label, tr, logs, counts, want, steps)
    _lm_check_paths(label, tr, paths, pipelined, steps)
    steps_ms = [m["wall_ms"] for m in logs[:steps]]
    t0 = time.perf_counter()
    if pipelined:
        check = {"fill_drain_equals_sync_bitwise":
                 _lm_fill_drain_check(tr, batches[0])}
    elif check_first_step:
        rel = _rel_norm(first_grads[0], unc)
        # the shared block's leaves (a hybrid's) one by one: each sums its
        # applications' contributions
        shared = {k: _rel_norm({k: first_grads[0][k]}, {k: unc[k]})
                  for k in unc if k.startswith("shared_attn/")}
        del first_grads[:], unc
        bad = {k: v for k, v in shared.items() if not v <= LM_GRAD_REL_TOL}
        if bad:
            fail(f"{label}: the shared block's decoded gradient leaves {bad} "
                 f"are past {LM_GRAD_REL_TOL} of the uncoded ones")
        if not repeats:
            fail(f"{cfg.name}: one subset's gradient differs between two "
                 f"calls")
        if not rel <= LM_GRAD_REL_TOL:
            fail(f"{label}: the decoded gradient of step 0 (stragglers "
                 f"{list(first_stragglers)}) is {rel:.3e} from the uncoded "
                 f"one (relative norm), past {LM_GRAD_REL_TOL}")
        check = {"decoded_vs_uncoded_grad_rel_norm": rel,
                 "tolerance": LM_GRAD_REL_TOL,
                 "decoded_gradient": f"step 0's, stragglers "
                                     f"{list(first_stragglers)}",
                 "subset_grad_repeats_bits": True,
                 "uncoded_before_window_s": uncoded_s,
                 **({"shared_attn_rel_norm_by_leaf": shared} if shared
                    else {})}
    else:
        check = {"decoded_vs_uncoded_grad_rel_norm":
                 _lm_grad_check(tr, batches[0]),
                 "tolerance": LM_GRAD_REL_TOL}
    if cfg.family in ("moe", "vlm") and not check_first_step:
        check["subset_grad_repeats_bits"] = _subset_grad_repeats(tr, batches[0])
    torch.cuda.synchronize()
    check["seconds"] = time.perf_counter() - t0
    check["check_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    after_first = statistics.median(steps_ms[1:]) if steps > 1 else None
    if args.profile and not pipelined and after_first is not None:
        profile_steps(lambda: tr.step(batches[0]), after_first, label,
                      steps=1)
    n_params = sum(v.numel() for v in tr.params.values())
    line = dict(
        phase=phase, path=label, model=cfg.name,
        n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
        seq_len=seq, **({"frames": frames} if frames else {}),
        code=[code.n, code.d, code.s, code.m],
        global_batch=code.num_subsets, steps=steps,
        optimizer="sgd_momentum" if pipelined else "nag",
        lr=LM_SGD_LR if pipelined else LM_NAG_LR,
        schedule="gather", packed=True, wire="float32",
        pipelined=pipelined, fuse_apply=pipelined,
        reduced={"global_batch": f"{code.num_subsets} sequences, not "
                                 f"train_4k's 256",
                 "steps": steps, "weights": "random, seeded",
                 **(reduced or {})},
        build_s=build_s,
        losses=[m["loss"] for m in logs],
        grad_norm=[m["grad_norm"] for m in logs],
        step_ms=[m["wall_ms"] for m in logs],
        step_ms_median_after_first=after_first,
        launches=counts, launches_expected=want,
        launches_per_step={k: v / steps for k, v in counts.items() if v},
        launches_by_kernel_path=paths,
        scalar_path_leaves_by_shape=_lm_scalar_leaves(tr),
        plain_flash_calls=0, memory_at_start_bytes=at_start,
        peak_memory_bytes=peak,
        memory_limit_bytes=torch.cuda.get_device_properties(0).total_memory,
        nvidia_smi=nvidia_smi_line(), **check)
    if into is None:
        say(**line)
    else:
        into.update(line)
    if ckpt_dir is not None:
        try:
            checkpoint_lm(tr)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr, logs
    return counts


# -------------------------------------------------------------------- bench
BENCH_SHAPE = (1, 171737, 2)   # the main path's 2D encode: G (d, V, m)
BENCH_POLICY = TimerPolicy(warmup=5, reps=25)
BENCH_FLOOR = 0.9              # a synchronised call's wall against time_ms
BENCH_GATED = {"share_of_bound": "max"}


def _bench_result(name, meas, env, stats=None):
    """One ``BenchResult`` of a kernel at its main-path shape, from
    ``measure``'s numbers (and ``time_callable``'s, where it was timed so)."""
    metrics = {k: float(meas[k]) for k in (
        "ms", "ms_l2_warm", "plain_ms", "library_ms", "bound_ms",
        "share_of_bound", "achieved_GBps", "achieved_TFLOPps",
        "ms_per_launch_run", "host_us_per_call") if meas.get(k) is not None}
    timing = {"device": "CUDA events behind a spin kernel, median",
              "reps": 25, "warmup": 5, "plain_reps": meas["plain_reps"]}
    if stats is not None:
        metrics["wall_ms_per_synced_call"] = stats.mean_s * 1e3
        timing["time_callable"] = stats.to_dict()
    return BenchResult(
        name=f"kernels/{name}", metrics=metrics,
        params={k: meas[k] for k in ("shape", "dtype", "out_dtype", "bound_by",
                                     "bytes", "flops", "input_copies")},
        env=env, timing=timing, gates=dict(BENCH_GATED))


def run_bench(main_shapes, smi):
    """The benchmark harness of ``repro_torch.bench`` on the card: the main
    path's 2D encode and in-place 2D encode-acc timed by ``time_callable``
    (a synchronised call's wall, which cannot be shorter than the card's
    own time, ``kernels_check``'s ``time_ms``; each timed call drops the
    kernel's result and returns nothing, as an in-place caller may, so only
    the default sync's wait for the device puts the kernel on the clock);
    one ``BenchResult`` a kernel at its main-path shape,
    written with ``write_results`` into a temporary directory and loaded
    back; the gate against a baseline written from this run (no failure)
    and against one doctored to a higher ``share_of_bound`` (a failure)."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    stats, walls = {}, {}
    for name, kind in (("coded_encode_2d", "encode"),
                       ("coded_encode_acc_2d", "encode_acc")):
        make, kernel, *_ = _operands(kind, BENCH_SHAPE, None, F32, F32, gen)

        def call(o, kernel=kernel):
            kernel(o)       # returns nothing: the sync must wait for the card

        stats[name] = time_callable(call, make(), policy=BENCH_POLICY)
        walls[name] = {"wall_ms_mean": stats[name].mean_s * 1e3,
                       "wall_ms_min": stats[name].min_s * 1e3,
                       "wall_ms_max": stats[name].max_s * 1e3,
                       "time_ms": main_shapes[name]["ms"]}
        if stats[name].mean_s * 1e3 < BENCH_FLOOR * main_shapes[name]["ms"]:
            fail(f"bench: time_callable's {name} {stats[name].mean_s * 1e3} "
                 f"ms a synchronised call is under {BENCH_FLOOR} x the card's "
                 f"own time {main_shapes[name]['ms']} ms: the sync did not "
                 f"wait for the card")
    env = capture_env(device="cuda")
    results = [_bench_result(name, meas, env, stats.get(name))
               for name, meas in main_shapes.items()]
    with tempfile.TemporaryDirectory() as tmp:
        path = write_results(results, "chip_smoke_kernels", tmp)
        loaded = load_results(path)
        if [(r["name"], r["metrics"]) for r in loaded] != \
                [(r.name, r.metrics) for r in results]:
            fail(f"bench: {path.name} did not load back as written")
        observed = bench_gate.collect_gated(tmp)
        base_path = pathlib.Path(tmp) / "baseline.json"
        bench_gate.write_baseline(observed, base_path)
        baseline = json.loads(base_path.read_text())
        clean = bench_gate.check(observed, baseline)
        doctored_name = "kernels/coded_encode_2d"
        baseline["benches"][doctored_name]["share_of_bound"] *= 2
        doctored = bench_gate.check(observed, baseline)
        file_bytes = path.stat().st_size
    if clean:
        fail(f"bench: the gate fails against this run's own baseline: {clean}")
    if len(doctored) != 1 or not doctored[0].startswith(
            f"{doctored_name}.share_of_bound") or "regressed" not in doctored[0]:
        fail(f"bench: the gate missed a doctored baseline: {doctored}")
    say(phase="bench", shape=list(BENCH_SHAPE),
        policy=dataclasses.asdict(BENCH_POLICY), floor=BENCH_FLOOR,
        time_callable=walls, results=len(results), results_file_bytes=file_bytes,
        gated=BENCH_GATED, gate_clean_failures=clean,
        gate_doctored_failures=doctored, env=env, nvidia_smi=smi)


# --------------------------------------------------------------------- main
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--global-batch", type=int, default=512,
                    help="samples per step (divisible by 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 3 train steps with torch.profiler")
    ap.add_argument("--out", default=None,
                    help="also write the kernel report to this JSON file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    env = capture_env(device="cuda")
    smi = env["nvidia_smi"]
    say(phase="env", **env)

    lib = _build.load()
    flash_ptxas = flash_kernels_ptxas(_build.ptxas_report())
    flash_smem = {f"{t}_hd{hd}": lib.flash_attention_smem_bytes(code, hd)
                  for t, code in (("f32", 0), ("bf16", 1)) for hd in (32, 64, 128)}
    bwd_smem = {f"{t}_hd{hd}": lib.flash_attention_bwd_smem_bytes(code, hd)
                for t, code in (("f32", 0), ("bf16", 1)) for hd in (32, 64, 128)}
    say(phase="build", **_build.last_build,
        sources=[str(p.relative_to(HERE)) for p in _build.sources()],
        flash_kernel_ptxas=flash_ptxas, flash_kernel_smem_bytes=flash_smem,
        flash_bwd_smem_bytes=bwd_smem)
    spilled = {k: v for k, v in flash_ptxas.items()
               if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    if spilled:
        fail(f"flash kernels spill registers: {spilled}")

    t_checks = time.perf_counter()
    errs = check_kernels()
    t_bwd = time.perf_counter()
    errs["flash_attention_bwd"] = check_flash_bwd(torch.Generator().manual_seed(5))
    t_measures = time.perf_counter()
    main_shapes = {
        "coded_encode_2d": measure("encode", (1, 171737, 2)),
        "coded_encode_3d": measure("encode", (1, 3072, 2, 2048)),
        "coded_decode_2d": measure("decode", (8, 171776), m=2),
        "coded_decode_3d": measure("decode", (8, 3072, 2048), m=2),
        "coded_encode_acc_2d": measure("encode_acc", (1, 171737, 2)),
        "coded_encode_acc_3d": measure("encode_acc", (1, 3072, 2, 2048)),
        "coded_decode_apply": measure("decode_apply", (8, 171776), m=2),
        "flash_attention": measure("flash", (1, SERVE_SEQ, 16, 8, 128)),
        "flash_attention_bwd": measure("flash_bwd", (1, LM_SEQ, 16, 8, 128)),
    }
    other_shapes = {
        "flash_attention": [measure("flash", (1, SERVE_SEQ, 16, 8, 128),
                                    dtype=torch.bfloat16,
                                    out_dtype=torch.bfloat16),
                            measure("flash", (1, VLM_SEQ, 48, 8, 128)),
                            measure("flash", (1, SERVE_SEQ, 32, 32, 64)),
                            measure("flash", (GEN_BATCH, GEN_PROMPT, 32, 32,
                                              64)),
                            measure("flash", FLASH_CROSS[0]),
                            measure("flash", FLASH_CROSS[1])],
        "flash_attention_bwd": [measure("flash_bwd", (1, LM_SEQ, 16, 8, 128),
                                        dtype=torch.bfloat16,
                                        out_dtype=torch.bfloat16),
                                measure("flash_bwd", (1, VLM_SEQ, 48, 8, 128)),
                                measure("flash_bwd", (1, LM_SEQ, 32, 32, 64)),
                                measure("flash_bwd", FLASH_CROSS[1])],
        "coded_encode_2d": [measure("encode", (4, 4194304, 2)),
                            measure("encode", (1, 171737, 2), dtype=torch.bfloat16,
                                    out_dtype=torch.bfloat16),
                            measure("encode", MOE_ENC),
                            measure("encode", VLM_ENC),
                            measure("encode", HYBRID_ENC),
                            measure("encode", ENCDEC_ENC)],
        "coded_encode_3d": [measure("encode", (4, 3072, 2, 2048)),
                            measure("encode", VLM_UNEMBED_ENC),
                            measure("encode", SSM_ENC3D[0]),
                            measure("encode", HYBRID_ENC3D[0]),
                            measure("encode", HYBRID_ENC3D[1]),
                            measure("encode", ENCDEC_VOCAB_ENC)],
        "coded_decode_2d": [measure("decode", (8, 4194304), m=2),
                            measure("decode", (8, 4194304), m=2,
                                    dtype=torch.bfloat16),
                            measure("decode", MOE_DEC[:2], m=MOE_DEC[2]),
                            measure("decode", VLM_DEC[:2], m=VLM_DEC[2]),
                            measure("decode", HYBRID_DEC[:2],
                                    m=HYBRID_DEC[2]),
                            measure("decode", ENCDEC_DEC[:2],
                                    m=ENCDEC_DEC[2])],
        "coded_decode_3d": [measure("decode", (8, 3072, 2048), m=2,
                                    dtype=torch.bfloat16)],
    }
    floor = measure_launch_floor()
    say(phase="kernels_check", tolerance={"f32": 2e-5, "bf16": 2e-2},
        reduced={"plain_reps": f"the plain flash versions timed over "
                               f"{PLAIN_FLASH_REPS} calls after 1, not 25 "
                               f"after 5, for the script's time (phase "
                               f"examples)",
                 "operands": KERNELS_CHECK_CUT},
        seconds_by_part={"checks": t_bwd - t_checks,
                         "flash_bwd_checks": t_measures - t_bwd,
                         "timings": time.perf_counter() - t_measures},
        errors=errs, launch_floor=floor, at_main_path_shapes=main_shapes,
        at_other_shapes=other_shapes)
    run_bench(main_shapes, smi)
    check_packed_per_leaf_small()

    counts = run_main_path(args)
    counts["logistic-paper autotuned Trainer.step"] = run_autotune_train(args)
    elastic_counts, elastic_ref = run_elastic(args)
    counts.update(elastic_counts)
    serve_path = "qwen3-1.7b CodedServer.step"
    counts[serve_path], n_batches, params = run_serve_path(
        args, reduced={"batches": f"{SERVE_BATCHES}, cut from 3 for the "
                                  f"script's time (phase dist)"})
    counts["qwen3-1.7b autotuned CodedServer.step"] = \
        run_autotune_serve(args, params)
    gen_path = "qwen3-1.7b BatchedEngine.generate"
    counts[gen_path], generate_ref = run_generate_path(args, params)
    del params
    counts["logistic-paper Trainer resumed from a checkpoint"] = \
        run_checkpoint_resume(args)
    counts.update(run_train_lm_path(args))
    # the MoE phases, after train_lm has freed its trainer
    # serve_moe and serve_vlm re-run no hedge (qwen3's serve phase holds
    # it): with the hybrid phases the script took 928.1 s on the card, of
    # which the two phases' hedges (three coded batches each) were about
    # 10 and 31.5 s
    no_hedge = ("the hedge is not re-run (three coded batches; qwen3's "
                "serve phase holds it): with it the script took 928.1 s")
    counts[f"{MOE_ARCH} CodedServer.step"], _, params = run_serve_path(
        args, MOE_ARCH, MOE_SERVE_BATCHES, phase="serve_moe", hedge=False,
        reduced={"weights": "random, seeded", "hedge": no_hedge})
    counts[f"{MOE_ARCH} BatchedEngine.generate"] = run_generate_moe(args, params)
    del params
    counts.update(run_train_moe(args))
    # the VLM phases, each at a depth cut of internvl2-26b
    counts[f"{VLM_ARCH} CodedServer.step"], _, params = run_serve_path(
        args, VLM_ARCH, VLM_SERVE_BATCHES, phase="serve_vlm",
        n_layers=VLM_SERVE_LAYERS,
        reduced={"n_layers": f"{VLM_SERVE_LAYERS} of 48 (the f32 weights at "
                             f"full depth are 79.4 GB of the card's 85.0)",
                 "weights": "random, seeded", "patches": "random, seeded",
                 "hedge": no_hedge},
        hedge=False)
    counts[f"{VLM_ARCH} BatchedEngine.generate"] = run_generate_vlm(args, params)
    del params
    counts.update(run_train_vlm(args))
    # the SSM phases, xlstm-350m at full width and depth
    t_ssm = time.perf_counter()
    counts[f"{SSM_ARCH} CodedServer.step"], _, params = run_serve_path(
        args, SSM_ARCH, SSM_SERVE_BATCHES, phase="serve_ssm",
        seq=SSM_SERVE_SEQ, hedge=False,
        reduced={"seq_len": f"{SSM_SERVE_SEQ} tokens, not 4096 (the sLSTM "
                            f"is host-paced: a 4096-token forward takes "
                            f"7.8-9.6 s on the card)",
                 "weights": "random, seeded",
                 "batches": f"{SSM_SERVE_BATCHES}; the hedge is not re-run "
                            f"(three more coded batches)"})
    counts[f"{SSM_ARCH} BatchedEngine.generate"] = run_generate_ssm(args, params)
    del params
    counts.update(run_train_ssm(args))
    say(phase="ssm_phases", seconds=time.perf_counter() - t_ssm)
    # the hybrid phases, zamba2-1.2b at full width and depth
    t_hybrid = time.perf_counter()
    counts[f"{HYBRID_ARCH} CodedServer.step"], _, params = run_serve_path(
        args, HYBRID_ARCH, HYBRID_SERVE_BATCHES, phase="serve_hybrid",
        hedge=False,
        reduced={"weights": "random, seeded",
                 "batches": f"{HYBRID_SERVE_BATCHES}; the hedge is not "
                            f"re-run (qwen3's serve phase holds it)"})
    counts[f"{HYBRID_ARCH} BatchedEngine.generate"] = run_generate_hybrid(
        args, params)
    del params
    counts.update(run_train_hybrid(args))
    say(phase="hybrid_phases", seconds=time.perf_counter() - t_hybrid)
    # the encoder-decoder phases, whisper-tiny at full width and depth
    t_encdec = time.perf_counter()
    counts[f"{ENCDEC_ARCH} CodedServer.step"], _, params = run_serve_path(
        args, ENCDEC_ARCH, ENCDEC_SERVE_BATCHES, phase="serve_encdec",
        seq=ENCDEC_FRAMES, hedge=False,
        reduced={"weights": "random, seeded",
                 "frames": "random, seeded (the feature extractor is a "
                           "stub, as in the reference)",
                 "batches": f"{ENCDEC_SERVE_BATCHES}; the hedge is not "
                            f"re-run (qwen3's serve phase holds it)"})
    counts[f"{ENCDEC_ARCH} BatchedEngine.generate"] = run_generate_encdec(
        args, params)
    del params
    counts.update(run_train_encdec(args))
    counts.update(run_long_encdec(args))
    say(phase="encdec_phases", seconds=time.perf_counter() - t_encdec)
    # the examples' twins, through their run()
    counts.update(run_examples(args))
    # last, launch and dist: once other processes have used the card, a
    # torch.profiler session of this process that traces the device alone
    # loses kernel events (all of them after dist's ranks), and the phases
    # above read their idle shares that way
    launched, launch_report = run_launch(coded_fraction=1.0)   # held to 1.0
    counts.update(launched)
    counts.update(run_dist(launch_report, elastic_ref, generate_ref))
    lm_path = "qwen3-1.7b Trainer.step"
    # each kernel's launches are those of the path that runs it: the 2D pair
    # on logistic-paper (one flat leaf), the fused 2D pair on its pipelined
    # run, the 3D variants on the MLP's matrices, flash attention on the
    # serving path (which also runs the 2D pair, counted there too)
    trainer_path, pipe_path, mlp_path = list(counts)[:3]
    path_of = {"coded_encode_2d": trainer_path, "coded_decode_2d": trainer_path,
               "coded_encode_3d": mlp_path, "coded_decode_3d": mlp_path,
               "coded_encode_acc_2d": pipe_path, "coded_decode_apply": pipe_path,
               "coded_encode_acc_3d": mlp_path, "flash_attention": serve_path,
               "flash_attention_bwd": lm_path}

    replaces = {"coded_encode_2d": "src/repro/kernels/coded_encode.py:76",
                "coded_encode_3d": "src/repro/kernels/coded_encode.py:93",
                "coded_decode_2d": "src/repro/kernels/coded_decode.py:59",
                "coded_decode_3d": "src/repro/kernels/coded_decode.py:73",
                "coded_encode_acc_2d": "src/repro/kernels/coded_encode.py:143",
                "coded_encode_acc_3d": "src/repro/kernels/coded_encode.py:159",
                "coded_decode_apply": "src/repro/kernels/coded_decode.py:134",
                "flash_attention": "src/repro/kernels/flash_attn.py:99",
                # no TPU kernel: the reference differentiates its
                # online_attention with XLA's autodiff
                "flash_attention_bwd": "src/repro/models/common.py:154"}
    kernels = []
    for name, meas in main_shapes.items():
        stem = ("flash_attn_bwd" if name == "flash_attention_bwd" else
                "flash_attn" if name == "flash_attention" else
                "coded_encode" if name.startswith("coded_encode") else
                "coded_decode")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
            "replaces": replaces[name], "path": path_of[name],
            "launches": counts[path_of[name]][name],
            "max_abs_err": errs[name]["max_abs_err"],
            "ms": meas["ms"], "plain_ms": meas["plain_ms"],
            "bound_ms": meas["bound_ms"], "bound_by": meas["bound_by"],
            "library_ms": meas["library_ms"], "shape": meas["shape"],
            "dtype": meas["dtype"], "ms_l2_warm": meas["ms_l2_warm"],
            # every counted path that launched it (the elastic runs and the
            # launcher run the 2D pair and the fused pair too)
            "launches_by_path": {p: c[name] for p, c in counts.items()
                                 if c.get(name)}})
        if name == "flash_attention":
            kernels[-1]["launches_per_batch"] = kernels[-1]["launches"] / n_batches
            kernels[-1]["launches_generate_prefill"] = \
                counts[gen_path]["flash_attention"]
        if name == "flash_attention_bwd":
            kernels[-1]["launches_per_step"] = kernels[-1]["launches"] / LM_STEPS
            kernels[-1]["max_rel_norm_err"] = errs[name]["max_rel_norm_err"]
        if name.startswith("flash"):
            kernels[-1]["bound_ms_f32_cuda_cores"] = meas["bound_ms_f32_cuda_cores"]
        else:
            kernels[-1].update(
                ms_per_launch_run=meas["ms_per_launch_run"],
                launch_floor_ms=floor["ms"],
                launch_floor_ms_per_launch_run=floor["ms_per_launch_run"],
                host_us_per_call=meas["host_us_per_call"])
        if name in ops.path_counts():
            kernels[-1].update(
                path_at_timed_shape=meas["path"],
                launches_by_kernel_path=KERNEL_PATHS[path_of[name]][name])
        if name.startswith("flash"):
            bf16 = other_shapes[name][0]
            kernels[-1]["bf16"] = {k: bf16[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if kernels[-1]["launches"] == 0:
            fail(f"kernel {name} was not launched on its path, {path_of[name]}")
    report = {"kernels": kernels, "launches_by_path": counts,
              "launches_by_kernel_path": KERNEL_PATHS}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {**report, "nvidia_smi": smi, "errors": errs,
             "at_other_shapes": other_shapes}, indent=1))
    say(phase="done", seconds=time.perf_counter() - t_start,
        seconds_by_phase=SECONDS_BY_PHASE)
    say(**report)
    print(nvidia_smi_line(), flush=True)
    say(ok=True, device={"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
