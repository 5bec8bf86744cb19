#!/usr/bin/env python3
"""An earlier ``coded_encode.cu`` against the package's, on one NVIDIA GPU
(written for an H100), in one call:

    git show <commit>:src/repro_torch/kernels/csrc/coded_encode.cu > build/old_encode.cu
    python3 tools/encode_ab.py build/old_encode.cu [--rounds 2] [--out report.json]

The old source must have the C interface of the one-thread-per-element
kernels: ``coded_encode_launch(G, C, out, d, V, m, R, rank3, in_dtype,
out_dtype, stream)`` and ``coded_encode_acc_launch(G, C, acc, d, V, m, R,
rank3, in_dtype, stream)``.  It is built beside the package's
``common.cuh`` into its own library under ``build/encode_ab/`` (git-ignored).
Then, on the card:

  bitwise  every output of the old kernels against the package's wrappers
           at the encode sweeps of ``chip_smoke.py`` (f32 and bf16 in, the
           input's type and f32 out; the fused fold on f32 acc), on the
           vector path and on the scalar path (G one element off an aligned
           base); any difference ends the run with exit code 1
  timing   the main path's shapes and the LM-leaf sizes, old and new in turns
           (old, new, new, old for each of ``--rounds``), each as
           ``chip_smoke.py`` times a kernel: one launch behind a spin kernel
           and a run of back-to-back launches, operands rotated past the L2

Prints one JSON line per phase and round, then the card's name and power
limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits with code 2 without a card)
import torch  # noqa: E402
from repro_torch.kernels import _build, _launch  # noqa: E402

TIMED = [("encode", (1, 171737, 2)), ("encode", (1, 3072, 2, 2048)),
         ("encode_acc", (1, 171737, 2)), ("encode_acc", (1, 3072, 2, 2048)),
         ("encode", (4, 3072, 2, 2048)), ("encode", (4, 4194304, 2))]


def build_old(src: pathlib.Path) -> ctypes.CDLL:
    """Compile ``src`` with the package's flags and headers; bind its two
    entry points."""
    out = ROOT / "build" / "encode_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libencode_old.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(_build.csrc_dir()), str(src), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {src}:\n{res.stdout}{res.stderr}")
    old = ctypes.CDLL(str(lib))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old.coded_encode_launch.argtypes = [ptr, ptr, ptr, i32, i64, i32, i64, i32,
                                        i32, i32, ptr]
    old.coded_encode_acc_launch.argtypes = [ptr, ptr, ptr, i32, i64, i32, i64,
                                            i32, i32, ptr]
    old.coded_encode_launch.restype = old.coded_encode_acc_launch.restype = i32
    return old


def old_wrappers(old):
    """The old kernels behind the package's wrapper signatures."""
    def check(rc):
        if rc != 0:
            cs.fail(f"an old kernel was refused or failed: {rc}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def encode(G, C, *, out_dtype=None):
        out_dtype = out_dtype or G.dtype
        d, V, m = G.shape[:3]
        R = G.shape[3] if G.ndim == 4 else 1
        out = torch.empty((V, R) if G.ndim == 4 else (V,), dtype=out_dtype,
                          device=G.device)
        coef = C.float().contiguous()
        check(old.coded_encode_launch(
            G.data_ptr(), coef.data_ptr(), out.data_ptr(), d, V, m, R,
            int(G.ndim == 4), _launch.DTYPE_CODES[G.dtype],
            _launch.DTYPE_CODES[out_dtype], stream()))
        return out

    def encode_acc(acc, G, C):
        d, V, m = G.shape[:3]
        R = G.shape[3] if G.ndim == 4 else 1
        coef = C.float().contiguous()
        check(old.coded_encode_acc_launch(
            G.data_ptr(), coef.data_ptr(), acc.data_ptr(), d, V, m, R,
            int(G.ndim == 4), _launch.DTYPE_CODES[G.dtype], stream()))
        return acc
    return encode, encode_acc


def bitwise(old_encode, old_acc):
    """Old and new outputs bit for bit, on both of the new kernel's paths."""
    gen = torch.Generator().manual_seed(7)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cs.ENC2D + cs.ENC3D:
            G = cs._randn(gen, shape, dtype)
            C = cs._randn(gen, (shape[0], shape[2]), torch.float32)
            for out_dtype in (None, torch.float32):
                want = old_encode(G, C, out_dtype=out_dtype)
                for G_ in (G, cs._offset_copy(G)):
                    if not torch.equal(cs.coded_encode(G_, C, out_dtype=out_dtype), want):
                        cs.fail(f"coded_encode{shape} {dtype}: old and new differ "
                                f"on the {cs.encode_path(G_, want)} path")
                    cases += 1
        for shape in cs.ACC2D + cs.ACC3D:
            G = cs._randn(gen, shape, dtype)
            C = cs._randn(gen, (shape[0], shape[2]), torch.float32)
            acc0 = cs._randn(gen, (shape[1], shape[3]) if len(shape) == 4
                             else (shape[1],), torch.float32)
            want = old_acc(acc0.clone(), G, C)
            for G_, acc_ in ((G, acc0.clone()), (cs._offset_copy(G), acc0.clone()),
                             (G, cs._offset_copy(acc0))):
                if not torch.equal(cs.coded_encode_acc(acc_, G_, C), want):
                    cs.fail(f"coded_encode_acc{shape} {dtype}: old and new differ "
                            f"on the {cs.encode_path(G_, acc_)} path")
                cases += 1
    torch.cuda.synchronize()
    return cases


def timed(kind, shape, fn_new, fn_old):
    """One launch and a run of launches of the old and the new kernel, in
    turns old, new, new, old, on the same rotating operands."""
    gen = torch.Generator().manual_seed(1)
    make, kernel, _, _, nbytes, flops = cs._operands(kind, shape, None,
                                                     torch.float32,
                                                     torch.float32, gen)
    first = make()
    per_copy = sum(x.numel() * x.element_size() for x in first)
    copies = max(2, int(2 * cs.L2_BYTES // per_copy) + 1)
    sets = [first] + [make() for _ in range(copies - 1)]
    coef = cs._randn(gen, (shape[0], shape[2]), torch.float32)
    fns = {"new": (lambda o: fn_new(o, coef)), "old": (lambda o: fn_old(o, coef))}
    row = {"kind": kind, "shape": list(shape), "bound_ms": cs._bound(nbytes, flops)[0]}
    for who in ("old", "new", "new", "old"):
        f = fns[who]
        row.setdefault(f"{who}_ms", []).append(cs.time_ms(lambda i: f(sets[i % copies])))
        row.setdefault(f"{who}_ms_per_launch_run", []).append(
            cs.time_run_ms(lambda i: f(sets[i % copies])))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=pathlib.Path, help="the earlier coded_encode.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args()
    old = build_old(args.old.resolve())
    _build.load()
    old_encode, old_acc = old_wrappers(old)
    cs.say(phase="bitwise", old=str(args.old), cases=bitwise(old_encode, old_acc),
           equal=True)
    rows = []
    for rnd in range(args.rounds):
        for kind, shape in TIMED:
            if kind == "encode":
                fn_new = lambda o, c: cs.coded_encode(o[0], c)          # noqa: E731
                fn_old = lambda o, c: old_encode(o[0], c)               # noqa: E731
            else:
                fn_new = lambda o, c: cs.coded_encode_acc(o[1], o[0], c)  # noqa: E731
                fn_old = lambda o, c: old_acc(o[1], o[0], c)              # noqa: E731
            row = timed(kind, shape, fn_new, fn_old)
            row["round"] = rnd
            for k in ("old_ms", "new_ms", "old_ms_per_launch_run", "new_ms_per_launch_run"):
                row[k + "_median"] = statistics.median(row[k])
            cs.say(phase="timing", **row)
            rows.append(row)
    floor = cs.measure_launch_floor()
    cs.say(phase="launch_floor", **floor)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "launch_floor": floor, "nvidia_smi": cs.nvidia_smi_line()},
            indent=1))
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
