#!/usr/bin/env python3
"""An earlier ``coded_decode.cu`` against the package's, on one NVIDIA GPU
(written for an H100), in one call:

    git show <commit>:src/repro_torch/kernels/csrc/coded_decode.cu > build/old_decode.cu
    python3 tools/decode_ab.py build/old_decode.cu [--rounds 2] [--variants a,b]
                               [--out report.json]

The old source must have the C interface of the one-thread-per-element
kernels: ``coded_decode_launch(F, W, out, n, V, m, R, rank3, in_dtype,
out_dtype, stream)`` and ``coded_decode_apply_launch(F, W, P, MU, partials,
ss, n, V, m, lr, momentum, scale, in_dtype, num_partials, stream)`` (two
launches: the fused pass, then the sum of the partials).  It is built
beside the package's ``common.cuh`` into its own library under
``build/decode_ab/`` (git-ignored).  Then, on the card:

  bitwise  every output of the old kernels against the package's wrappers
           at the decode and decode-apply sweeps of ``chip_smoke.py`` (f32
           and bf16 in, the input's type and f32 out), on the vector path
           and on the scalar path (F, P or MU one element off an aligned
           base): any difference in a decoded element, p' or mu' ends the
           run with exit code 1, and so does a sum g^2 more than 1e-6
           relative from the old kernel's or one that differs between two
           calls; the largest relative difference of sum g^2 is reported
  timing   the main path's shapes and the LM-leaf sizes, old and new in turns
           (old, new, new, old for each of ``--rounds``), each as
           ``chip_smoke.py`` times a kernel: one launch behind a spin kernel
           and a run of back-to-back launches, operands rotated past the L2;
           with ``--variants``, copies of the package's ``coded_decode.cu``
           with one design choice changed (``VARIANTS``, each built alone
           under ``build/decode_ab/<name>/``) are timed in the same turns
           (old, new, a, b, b, a, new, old): their outputs are not checked,
           only their times mean something

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

import torch  # noqa: E402
from repro_torch.kernels import _build, _launch  # noqa: E402
from repro_torch.kernels.coded_decode import THREADS, apply_path  # noqa: E402

cs = None   # chip_smoke, imported by main() (it exits with code 2 without a card)
KERNEL = _build.csrc_dir() / "coded_decode.cu"
F32, BF16 = torch.float32, torch.bfloat16
# (kind, shape, m, input dtype): the training and pipelined paths' bucket
# (f32, and a bf16 wire), sizes between it and the LM leaves, the LM-leaf
# size in f32 and bf16, and the 3D decode as the control
TIMED = [("decode", (8, 171776), 2, F32), ("decode_apply", (8, 171776), 2, F32),
         ("decode", (8, 171776), 2, BF16), ("decode", (8, 524288), 2, BF16),
         ("decode", (8, 1048576), 2, BF16), ("decode", (8, 524288), 2, F32),
         ("decode", (8, 1048576), 2, F32), ("decode", (8, 2097152), 2, BF16),
         ("decode", (8, 4194304), 2, F32), ("decode", (8, 4194304), 2, BF16),
         ("decode", (8, 3072, 2048), 2, F32)]
SS_REL_TOL = 1e-6

_CS = "  const int cs = (long long)n * V * (long long)sizeof(TI) <= cg::l2_bytes();"
# variant -> [(text of the kernel source, what replaces it)]: one design
# choice of the 2D kernel changed, the choices that the kernel's note
# gives its measurements for
VARIANTS = {
    # a grid of at most what fits on the card at once, each thread looping
    # over items (the grid-stride form)
    "grid_capped": [("  const long long grid = blocks_of(work, threads);",
                     "  static int per_sm = 0;\n  const long long grid = std::min(blocks_of(work, "
                     "threads), (long long)cg::grid_for(decode2d_kernel<TI, TO, M, NR, APPLY>, "
                     "per_sm, 1LL << 40, NR == 0 ? (size_t)n * m * sizeof(float) : 0));")],
    # blocks of 256 threads at every size
    "blocks256": [("  while (!APPLY && threads > kMinThreads &&",
                   "  while (false && threads > kMinThreads &&")],
    # a thread owns 16 bytes of F a row whatever its type (8 v of bf16)
    "lanes16B": [("template <typename TI> constexpr int kLanes = 4;",
                  "template <typename TI> constexpr int kLanes = 16 / sizeof(TI);")],
    # a thread owns 8 bytes of F a row whatever its type (2 v of f32)
    "lanes8B": [("template <typename TI> constexpr int kLanes = 4;",
                 "template <typename TI> constexpr int kLanes = 8 / sizeof(TI);")],
    # W in shared memory at every n*m
    "coef_shared": [("  const bool reg = n * m <= kRegTerms;", "  const bool reg = false;")],
    # F read evict-first, or with the default policy, at every size
    "always_evict_first": [(_CS, "  const int cs = 1;")],
    "never_evict_first": [(_CS, "  const int cs = 0;")],
    # the fused update without the cross-block sum of g^2 (what the
    # one-launch reduction costs; sum g^2 is wrong)
    "no_block_sum": [("  if constexpr (APPLY) sum_g2(ss, a);",
                      "  if constexpr (APPLY) if (ss == -1.f) *a.ss = ss;")],
}


def ablated_source(source: str, edits) -> str:
    """``source`` with each edit applied; raises if a text is not in it
    exactly once (the kernel changed under the tool)."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"variant text found {source.count(old)} times "
                             f"in {KERNEL.name}: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_all(old_src: pathlib.Path, variants) -> dict:
    """Compile the old source and each variant of the package's source with
    the package's flags and headers, all ``nvcc`` runs at once; the loaded
    libraries by name ("old" and the variants')."""
    out = ROOT / "build" / "decode_ab"
    out.mkdir(parents=True, exist_ok=True)
    srcs = {"old": old_src}
    for name in variants:
        (out / name).mkdir(exist_ok=True)
        srcs[name] = out / name / "coded_decode.cu"
        srcs[name].write_text(ablated_source(KERNEL.read_text(), VARIANTS[name]))
    procs = {}
    for name, src in srcs.items():
        lib = out / f"libdecode_{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.csrc_dir()), str(src), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        (out / f"nvcc_{name}.log").write_text(text)      # -Xptxas -v
        if p.returncode != 0:
            cs.fail(f"nvcc {srcs[name]}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    for name in variants:
        _build.bind(libs[name])
    return libs


def bind_old(old: ctypes.CDLL) -> ctypes.CDLL:
    """Bind the two entry points of the old C interface."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    old.coded_decode_launch.argtypes = [ptr, ptr, ptr, i32, i64, i32, i64, i32,
                                        i32, i32, ptr]
    old.coded_decode_apply_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                              i64, i32, f32, f32, f32, i32, i64,
                                              ptr]
    old.coded_decode_launch.restype = old.coded_decode_apply_launch.restype = i32
    return old


def old_wrappers(old):
    """The old kernels behind the package's wrapper signatures."""
    def check(rc):
        if rc != 0:
            cs.fail(f"an old kernel was refused or failed: {rc}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def decode(F, W, *, out_dtype=None):
        out_dtype = out_dtype or F.dtype
        n, V = F.shape[:2]
        m = W.shape[1]
        rank3 = F.ndim == 3
        R = F.shape[2] if rank3 else 1
        out = torch.empty((V, m, R) if rank3 else (V, m), dtype=out_dtype,
                          device=F.device)
        wts = W.float().contiguous()
        check(old.coded_decode_launch(
            F.data_ptr(), wts.data_ptr(), out.data_ptr(), n, V, m, R, int(rank3),
            _launch.DTYPE_CODES[F.dtype], _launch.DTYPE_CODES[out_dtype], stream()))
        return out

    def decode_apply(F, W, P, MU, *, lr, momentum, scale):
        n, L = F.shape
        m = W.shape[1]
        wts = W.float().contiguous()
        blocks = -(-L // THREADS)
        partials = torch.empty((blocks,), dtype=F32, device=F.device)
        ss = torch.empty((), dtype=F32, device=F.device)
        check(old.coded_decode_apply_launch(
            F.data_ptr(), wts.data_ptr(), P.data_ptr(), MU.data_ptr(),
            partials.data_ptr(), ss.data_ptr(), n, L, m, float(lr),
            float(momentum), float(scale), _launch.DTYPE_CODES[F.dtype], blocks,
            stream()))
        return P, MU, ss
    return decode, decode_apply


def _dec_cases():
    """(F shape, m) of chip_smoke.py's decode sweeps."""
    return ([(s[:2], s[2]) for s in cs.DEC2D] +
            [((s[0], s[1], s[3]), s[2]) if len(s) == 4 else (s, 2) for s in cs.DEC3D])


def bitwise(old_decode, old_apply):
    """Old and new outputs bit for bit, on both of the new kernel's paths;
    returns the case count and sum g^2's largest relative difference."""
    gen = torch.Generator().manual_seed(7)
    cases, ss_rel = 0, 0.0
    for dtype in (F32, BF16):
        for shape, m in _dec_cases():
            F = cs._randn(gen, shape, dtype)
            W = cs._randn(gen, (shape[0], m), F32)
            for out_dtype in (None, F32):
                want = old_decode(F, W, out_dtype=out_dtype)
                for F_ in (F, cs._offset_copy(F)):
                    got = cs.coded_decode(F_, W, out_dtype=out_dtype)
                    if not torch.equal(got, want):
                        path = cs.decode_path(F_, got) if F.ndim == 2 else "3D"
                        cs.fail(f"coded_decode{shape} m={m} {dtype}: old and new "
                                f"differ on the {path} path")
                    cases += 1
        for n, L, m in cs.APPLY:
            F = cs._randn(gen, (n, L), dtype)
            W = cs._randn(gen, (n, m), F32)
            P0, MU0 = cs._randn(gen, (L, m), F32), cs._randn(gen, (L, m), F32)
            wp, wmu, wss = old_apply(F, W, P0.clone(), MU0.clone(), **cs.HYPER)
            for F_, P_, MU_ in ((F, P0.clone(), MU0.clone()),
                                (cs._offset_copy(F), P0.clone(), MU0.clone()),
                                (F, cs._offset_copy(P0), MU0.clone()),
                                (F, P0.clone(), cs._offset_copy(MU0))):
                path = apply_path(F_, P_, MU_)
                keep = P_.clone(), MU_.clone()
                pn, mun, ss = cs.coded_decode_apply(F_, W, P_, MU_, **cs.HYPER)
                torch.cuda.synchronize()
                what = f"coded_decode_apply{(n, L, m)} {dtype} on the {path} path"
                if not (torch.equal(pn, wp) and torch.equal(mun, wmu)):
                    cs.fail(f"{what}: old and new p' or mu' differ")
                rel = abs(ss.item() - wss.item()) / max(abs(wss.item()), 1e-30)
                if rel > SS_REL_TOL:
                    cs.fail(f"{what}: sum g^2 {ss.item()} vs old {wss.item()} "
                            f"(rel {rel:.3e} > {SS_REL_TOL})")
                P_.copy_(keep[0])          # the same operands, at the same bases
                MU_.copy_(keep[1])
                again = cs.coded_decode_apply(F_, W, P_, MU_, **cs.HYPER)[2]
                if not torch.equal(again, ss):
                    cs.fail(f"{what}: sum g^2 differs between two calls")
                ss_rel = max(ss_rel, rel)
                cases += 1
    torch.cuda.synchronize()
    return cases, ss_rel


def timed(kind, shape, m, dtype, fns, order):
    """One launch and a run of launches of each of ``order`` (the old
    kernel, the new, the variants), in turns forward then backward, on the
    same rotating operands."""
    gen = torch.Generator().manual_seed(1)
    make, _, _, _, nbytes, flops = cs._operands(kind, shape, m, dtype, F32, gen)
    first = make()
    per_copy = sum(x.numel() * x.element_size() for x in first)
    copies = max(2, int(2 * cs.L2_BYTES // per_copy) + 1)
    sets = [first] + [make() for _ in range(copies - 1)]
    W = cs._randn(gen, (shape[0], m), F32)
    rate = cs.BF16_FLOP_PER_S if dtype == BF16 else cs.F32_FLOP_PER_S
    row = {"kind": kind, "shape": list(shape) + [m], "dtype": str(dtype).split(".")[-1],
           "bound_ms": cs._bound(nbytes, flops, rate)[0]}
    for who in order + order[::-1]:
        f = fns(who)
        row.setdefault(f"{who}_ms", []).append(
            cs.time_ms(lambda i: f(sets[i % copies], W)))
        row.setdefault(f"{who}_ms_per_launch_run", []).append(
            cs.time_run_ms(lambda i: f(sets[i % copies], W)))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=pathlib.Path, help="the earlier coded_decode.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args()
    global cs
    import chip_smoke as cs   # exits with code 2 without a card
    variants = [v for v in args.variants.split(",") if v]
    for v in variants:
        if v not in VARIANTS:
            ap.error(f"unknown variant {v!r}")
    libs = build_all(args.old.resolve(), variants)
    package = _build.load()
    old_decode, old_apply = old_wrappers(bind_old(libs["old"]))
    cases, ss_rel = bitwise(old_decode, old_apply)
    cs.say(phase="bitwise", old=str(args.old), cases=cases, equal=True,
           max_rel_diff_sum_g2=ss_rel, sum_g2_tolerance=SS_REL_TOL)
    hy = {"lr": cs.PIPE_LR, "momentum": 0.9, "scale": 1.0}
    order = ["old", "new", *variants]
    rows = []
    for rnd in range(args.rounds):
        for kind, shape, m, dtype in TIMED:
            def fns(who, apply=kind == "decode_apply"):
                if who == "old":
                    return ((lambda o, W: old_apply(o[0], W, o[1], o[2], **hy)) if apply
                            else (lambda o, W: old_decode(o[0], W, out_dtype=F32)))
                # the package's wrappers, launching from this library
                _build._lib = package if who == "new" else libs[who]
                return ((lambda o, W: cs.coded_decode_apply(o[0], W, o[1], o[2], **hy))
                        if apply else (lambda o, W: cs.coded_decode(o[0], W, out_dtype=F32)))
            row = timed(kind, shape, m, dtype, fns, order)
            _build._lib = package
            row["round"] = rnd
            for who in order:
                for k in (f"{who}_ms", f"{who}_ms_per_launch_run"):
                    row[k + "_median"] = statistics.median(row[k])
            cs.say(phase="timing", **row)
            rows.append(row)
    floor = cs.measure_launch_floor()
    cs.say(phase="launch_floor", **floor)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "launch_floor": floor, "max_rel_diff_sum_g2": ss_rel,
             "nvidia_smi": cs.nvidia_smi_line()}, indent=1))
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
