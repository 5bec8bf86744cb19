#!/usr/bin/env python3
"""An earlier ``flash_attn_bwd.cu`` against the package's, on one NVIDIA GPU
(written for an H100), in one call:

    git show <commit>:src/repro_torch/kernels/csrc/flash_attn_bwd.cu > build/old_flash_bwd.cu
    python3 tools/flash_bwd_ab.py build/old_flash_bwd.cu [--rounds 2]
        [--variants a,b] [--old-forward build/old_flash_fwd.cu] [--out report.json]

The old source must have the package's C interface of the backward,
``flash_attention_bwd_launch`` (the same symbol, so it is built beside the
package's headers into a library of its own under ``build/flash_bwd_ab/``,
git-ignored).  Then, on the card:

  forward  with ``--old-forward`` (an earlier ``flash_attn.cu``, built the
           same way): its output and log-sum-exp against the package's
           forward, bit for bit, at the sweep below, f32 and bf16, with and
           without the residual; any difference ends the run with exit code 1

  check    both backwards against the plain version's autograd (TF32 off)
           at the backward sweep of ``chip_smoke.py`` (FLASH, FLASH_BWD_EDGES
           and the fused projection), f32 and bf16, on the package's forward
           output and residual: relative error norm within 1e-5 (f32) and
           2e-2 (bf16), f32 max |err| within 1e-4 of max |plain|; a failure
           of either source ends the run with exit code 1.  They cannot agree
           bit for bit: the two sum in other orders.
  timing   the causal 4096-token shape of qwen3-1.7b, (1, 4096, 16, 8, 128),
           f32 and bf16: old, new and any ``--variants`` (copies of the
           package's source with one part removed, ``VARIANTS``, each built
           alone under ``build/flash_bwd_ab/<name>/``; their gradients are
           wrong and only their times mean something) in turns (old, new, a,
           b, b, a, new, old for each of ``--rounds``), each as
           ``chip_smoke.py`` times a kernel (one call behind a spin kernel,
           operands rotated past the L2), beside the backward of
           ``scaled_dot_product_attention`` (the yardstick; the port never
           calls it); and each source's device time a call by kernel (dot,
           dkdv, dq) from ``torch.profiler``.

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
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from repro_torch.kernels import _build, flash_attn  # noqa: E402

cs = None   # chip_smoke, imported by main() (it exits with code 2 without a card)
KERNEL = _build.csrc_dir() / "flash_attn_bwd.cu"
ENTRY = "flash_attention_bwd_launch"
F32, BF16 = torch.float32, torch.bfloat16
SHAPE = (1, 4096, 16, 8, 128)      # causal, the qwen3-1.7b training sequence

_SPLIT = ("        split_tile(raw, smem + C::OFF_LO, C::T_BYTES, sid);\n"
          "        split_tile(raw + C::T_BYTES, smem + C::OFF_LO + C::T_BYTES, C::T_BYTES, sid);\n")
_TRANSPOSE = ("          transpose_tile<HD>(raw + t * C::T_BYTES, smem + C::OFF_T + 2 * t * C::T_BYTES, sid);\n"
              "          transpose_tile<HD>(smem + C::OFF_LO + t * C::T_BYTES,\n"
              "                             smem + C::OFF_T + (2 * t + 1) * C::T_BYTES, sid);\n")
_SCORES = ("    mma_scores<C>(sc, k.sbase, 0, b1, k.sbase + C::OFF_LO, k.smem, row0, t4);\n"
           "    if constexpr (DO2)\n"
           "      mma_scores<C>(dp, k.sbase, C::R_BYTES, b2, k.sbase + C::OFF_LO + C::T_BYTES, k.smem,\n"
           "                    row0, t4);\n")
_ACC = ("      mma_acc<C, HD>(acc1, sc, C::F32 ? k.sbase + C::OFF_T + 2 * C::T_BYTES : b2);\n",
        "      mma_acc<C, HD>(acc2, dp, C::F32 ? k.sbase + C::OFF_T : b1);\n")
# variant -> [(text of the kernel source, what replaces it)]: one part of the
# work removed, so that the package's time less the variant's is what that
# part costs on the critical path
VARIANTS = {
    # f32: the splitter neither splits nor transposes (it still signals)
    "no_split": [(_SPLIT, ""), (_TRANSPOSE, "")],
    # only the split into hi / lo, no transposes
    "no_transpose": [(_TRANSPOSE, "")],
    # no S / dP products (the first pair)
    "no_scores": [(_SCORES, "")],
    # no accumulating products (the second pair)
    "no_acc": [(_ACC[0], ""), (_ACC[1], "")],
    # f32: the first pair as one TF32 pass (hi.hi) instead of three
    "scores_one_pass": [("        sm90::wgmma_tf32_rs_n32(x, hi[g % 2][j], dl, 1);\n"
                         "        sm90::wgmma_tf32_rs_n32(x, lo[g % 2][j], dh, 1);\n", "")],
    # every tile takes the per-element mask
    "mask_everywhere": [("    const bool edge =\n", "    const bool edge = true ||\n")],
    # f32: the resident A split 1 or 4 k steps at a time instead of 2
    "kg1": [("constexpr int FB_KG = 2;", "constexpr int FB_KG = 1;")],
    "kg4": [("constexpr int FB_KG = 2;", "constexpr int FB_KG = 4;")],
    # f32: partial sums flushed every 4 or 16 tiles instead of 8, or once
    "flush4": [("constexpr int FB_FLUSH = 8;", "constexpr int FB_FLUSH = 4;")],
    "flush16": [("constexpr int FB_FLUSH = 8;", "constexpr int FB_FLUSH = 16;")],
    "flush_once": [("constexpr int FB_FLUSH = 8;", "constexpr int FB_FLUSH = 1 << 30;")],
    # f32: the accumulating pair as one TF32 pass (hi.hi) instead of three
    "acc_one_pass": [("      mma_pv_tf32<HD>(acc, xh[kk], dl);\n"
                      "      mma_pv_tf32<HD>(acc, xl[kk], dh);\n", "")],
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


def check_old_source(text: str, entry: str = ENTRY) -> str:
    """The old source as it is, or ValueError when it does not define the C
    entry point ``entry`` (then it cannot stand in for the package's)."""
    if f'extern "C" int {entry}(' not in text:
        raise ValueError(f"the old source defines no extern \"C\" {entry}")
    return text


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=pathlib.Path, help="the earlier flash_attn_bwd.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--old-forward", type=pathlib.Path, default=None,
                    help="an earlier flash_attn.cu whose forward must give the same bits")
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    args.variants = [v for v in args.variants.split(",") if v]
    for v in args.variants:
        if v not in VARIANTS:
            ap.error(f"unknown variant {v!r}")
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")
    return args


def build_all(old_src: pathlib.Path, variants, old_forward=None) -> dict:
    """Compile the old source, the old forward if given ("old_forward") and
    each variant of the package's source with the package's flags and
    headers, all ``nvcc`` runs at once; the loaded and bound libraries by
    name ("old" and the variants')."""
    out = ROOT / "build" / "flash_bwd_ab"
    out.mkdir(parents=True, exist_ok=True)
    srcs = {"old": out / "old" / KERNEL.name}
    srcs["old"].parent.mkdir(exist_ok=True)
    srcs["old"].write_text(check_old_source(old_src.read_text()))
    if old_forward is not None:
        srcs["old_forward"] = out / "old_forward" / "flash_attn.cu"
        srcs["old_forward"].parent.mkdir(exist_ok=True)
        srcs["old_forward"].write_text(
            check_old_source(old_forward.read_text(), "flash_attention_launch"))
    for name in variants:
        (out / name).mkdir(exist_ok=True)
        srcs[name] = out / name / KERNEL.name
        srcs[name].write_text(ablated_source(KERNEL.read_text(), VARIANTS[name]))
    procs = {}
    for name, src in srcs.items():
        lib = out / f"libflash_bwd_{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.csrc_dir()), str(src), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        (out / f"nvcc_{name}.log").write_text(text)      # -Xptxas -v
        if p.returncode != 0:
            cs.fail(f"nvcc {srcs[name]}:\n{text[-6000:]}")
        libs[name] = _build.bind(ctypes.CDLL(str(lib)))
    return libs


def backward(lib, package):
    """The package's wrapper ``flash_attention_bwd``, launching from ``lib``
    (the package's own forward stays on ``package``)."""
    def run(q, k, v, out, lse, dout, **kw):
        _build._lib = lib
        try:
            return flash_attn.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        finally:
            _build._lib = package
    return run


def forward_bits(old, package):
    """The old forward's output and residual against the package's, bit for
    bit, over the sweep; the number of cases."""
    gen = torch.Generator().manual_seed(6)
    cases = cs.FLASH + cs.FLASH_BWD_EDGES + [cs.FLASH_FUSED]
    for dtype in (F32, BF16):
        for case in cases:
            q, k, v, (kind, w, p0) = cs._flash_inputs(gen, case, dtype)
            for residual in (False, True):
                got = []
                for lib in (package, old):
                    _build._lib = lib
                    try:
                        got.append(flash_attn._forward(q, k, v, kind, w, p0,
                                                       residual=residual))
                    finally:
                        _build._lib = package
                torch.cuda.synchronize()
                (a, la), (b, lb) = got
                if not torch.equal(a, b) or (residual and not torch.equal(la, lb)):
                    cs.fail(f"flash_attention{case} {dtype} residual={residual}: "
                            f"the old forward's bits differ")
    return len(cases) * 2 * 2


def check(fns):
    """Each of ``fns`` (name -> backward) against the plain version's
    autograd over the sweep; the largest errors by name and type."""
    gen = torch.Generator().manual_seed(5)
    worst = {}
    cases = cs.FLASH + cs.FLASH_BWD_EDGES + [cs.FLASH_FUSED]
    for dtype in (F32, BF16):
        for case in cases:
            q, k, v, (kind, w, p0) = cs._flash_inputs(gen, case, dtype)
            g = q.shape[2] // k.shape[2]
            dout = cs._randn(gen, tuple(q.shape), dtype)
            out, lse = flash_attn._forward(q, k, v, kind, w, p0, residual=True)
            want = cs._flash_grads(flash_attn.flash_attention_gqa_plain, q, k, v,
                                   dout, g, kind, w, p0)
            for who, fn in fns.items():
                got = fn(q, k, v, out, lse, dout, mask_kind=kind, window=w, kv_pos0=p0)
                torch.cuda.synchronize()
                row = worst.setdefault(f"{who}_{str(dtype)[6:]}",
                                       {"rel_norm": 0.0, "max_abs_of_max": 0.0})
                for name, a, b in zip(("dq", "dk", "dv"), got, want):
                    a, b = a.float(), b.float()
                    rel = ((a - b).norm() / b.norm()).item()
                    mx = ((a - b).abs().max() / b.abs().max()).item()
                    what = f"{who} flash_attention_bwd{case} {dtype} {name}"
                    if not torch.isfinite(a).all():
                        cs.fail(f"{what}: non-finite")
                    if rel > cs.FLASH_BWD_REL_NORM[dtype]:
                        cs.fail(f"{what}: relative error norm {rel:.3e}")
                    if dtype == F32 and mx > cs.FLASH_BWD_MAX_ABS_OF_MAX:
                        cs.fail(f"{what}: max abs err {mx:.3e} of max |plain|")
                    row["rel_norm"] = max(row["rel_norm"], rel)
                    row["max_abs_of_max"] = max(row["max_abs_of_max"], mx)
    return len(cases) * 2, worst


def kernel_split(fn, o):
    """Device milliseconds of one call of ``fn(o)`` by kernel, from
    ``torch.profiler``: dot, dkdv, dq."""
    from torch.profiler import ProfilerActivity, profile
    fn(o)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(o)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        name = ("dot" if "dot_kernel" in e.key else
                "dkdv" if "dkdv_kernel" in e.key or "true>" in e.key else
                "dq" if "dq_kernel" in e.key or "false>" in e.key else e.key[:40])
        out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / e.count
    return out


def timed(dtype, fns, order):
    """The backward at SHAPE by each of ``order``, in turns forward then
    backward, on the same rotating operands; SDPA's backward once a round."""
    gen = torch.Generator().manual_seed(1)
    isz = torch.empty((), dtype=dtype).element_size()
    make, kernel, _, library, nbytes, flops = cs._flash_bwd_operands(SHAPE, dtype, gen, isz)
    first = make()
    per_copy = sum(x.numel() * x.element_size() for x in first
                   if isinstance(x, torch.Tensor))
    copies = max(2, int(2 * cs.L2_BYTES // per_copy) + 1)
    sets = [first] + [make() for _ in range(copies - 1)]
    if dtype == F32:
        bound = cs._bound(nbytes, 3 * flops, cs.TF32_FLOP_PER_S)[0]
    else:
        bound = cs._bound(nbytes, flops, cs.BF16_FLOP_PER_S)[0]
    row = {"shape": list(SHAPE), "dtype": str(dtype)[6:], "bound_ms": bound,
           "bound_ms_7_products": bound * 7 / 5,
           "library_ms": cs.time_ms(lambda i: library(sets[i % copies]))}
    for who in order + order[::-1]:
        f = fns[who]
        row.setdefault(f"{who}_ms", []).append(
            cs.time_ms(lambda i: f(*sets[i % copies][:6])))
    for who in order:
        row[f"{who}_ms_median"] = statistics.median(row[f"{who}_ms"])
        row[f"{who}_split_ms"] = kernel_split(lambda o: fns[who](*o[:6]), sets[0])
    del sets, first
    return row


def main():
    args = parse_args()
    global cs
    import chip_smoke as cs   # exits with code 2 without a card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    package = _build.load()
    libs = build_all(args.old.resolve(), args.variants,
                     args.old_forward.resolve() if args.old_forward else None)
    if args.old_forward:
        cs.say(phase="forward", old=str(args.old_forward), equal=True,
               cases=forward_bits(libs["old_forward"], package))
    fns = {"old": backward(libs["old"], package), "new": backward(package, package)}
    cases, worst = check(fns)
    cs.say(phase="check", old=str(args.old), cases=cases, worst=worst,
           tolerance={"f32_rel_norm": cs.FLASH_BWD_REL_NORM[F32],
                      "f32_max_abs_of_max": cs.FLASH_BWD_MAX_ABS_OF_MAX,
                      "bf16_rel_norm": cs.FLASH_BWD_REL_NORM[BF16]})
    fns.update({name: backward(libs[name], package) for name in args.variants})
    order = ["old", "new", *args.variants]
    rows = []
    for rnd in range(args.rounds):
        for dtype in (F32, BF16):
            row = timed(dtype, fns, order)
            row["round"] = rnd
            cs.say(phase="timing", **row)
            rows.append(row)
            torch.cuda.empty_cache()
    smi = cs.nvidia_smi_line()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "check": worst, "nvidia_smi": smi}, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
