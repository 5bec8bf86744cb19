#!/usr/bin/env python3
"""Where the flash attention kernel's time goes, by ablation, on one NVIDIA
GPU (written for an H100):

    python3 tools/flash_ablation.py [--reps 2] [--out report.json]

Builds copies of ``src/repro_torch/kernels/csrc/flash_attn.cu`` with one
part of the work removed (the f32 K / V split, the mask, the softmax's
exponentials, one of the two products or their 3xTF32 extra passes), each
under ``build/flash_ablation/<variant>/`` (git-ignored), all ``nvcc`` runs at
once, and times every copy at the serve shape of ``qwen3-1.7b`` (causal,
q (1, 4096, 16, 128), k / v (1, 4096, 8, 128)) in f32 and bf16: CUDA events
around 10 calls, median of 5, ``--reps`` rounds in turn.  An ablated copy
computes wrong numbers; only its time means something: the base time less
a variant's is what that part costs on the critical path.  Prints one JSON
line per variant and round, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attn.cu"

_QK_F32 = ("        sm90::wgmma_tf32_ss_n32(sc, dq, dk, kk > 0);\n"
           "        sm90::wgmma_tf32_ss_n32(sc, dq, dkl, 1);\n"
           "        sm90::wgmma_tf32_ss_n32(sc, dql, dk, 1);\n")
_QK_BF16 = "        sm90::wgmma_bf16_ss_n64(sc, dq, dk, kk > 0);\n"
_PV_F32 = ("        mma_pv_tf32<HD>(o, ahi[kk], dh);\n"
           "        mma_pv_tf32<HD>(o, ahi[kk], dl);\n"
           "        mma_pv_tf32<HD>(o, alo[kk], dh);\n")
_PV_BF16 = "        mma_pv_bf16<HD>(o, a[kk], dv);\n"
_EDGE = "    const bool edge = k0 + BK > Sk ||"

# variant -> [(text of the kernel source, what replaces it)]
VARIANTS = {
    "base": [],
    "no_split": [("        split_tile(kraw, smem + C::klo(t), C::T_BYTES, sid);\n"
                  "        split_v_transposed<HD>(kraw + C::T_BYTES, smem + C::vthi(t), "
                  "smem + C::vtlo(t), sid);\n", "")],
    "no_mask": [(_EDGE, "    const bool edge = false && k0 + BK > Sk ||")],
    "no_mask_no_exp": [(_EDGE, "    const bool edge = false && k0 + BK > Sk ||"),
                       ("const float p = exp2f(sc[idx] - m_new);",
                        "const float p = sc[idx];")],
    "no_qk": [(_QK_F32, ""), (_QK_BF16, "")],
    "qk_one_pass": [(_QK_F32, "        sm90::wgmma_tf32_ss_n32(sc, dq, dk, kk > 0);\n")],
    "no_pv": [(_PV_F32, ""), (_PV_BF16, "")],
    "pv_one_pass": [(_PV_F32, "        mma_pv_tf32<HD>(o, ahi[kk], dh);\n")],
}

TIMER = r'''
import json, statistics, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels import flash_attn
out = {}
for dt in (torch.float32, torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 4096, 16, 128, device="cuda", generator=g).to(dt)
    k = torch.randn(1, 4096, 8, 128, device="cuda", generator=g).to(dt)
    v = torch.randn(1, 4096, 8, 128, device="cuda", generator=g).to(dt)
    for _ in range(3):
        flash_attn.flash_attention_gqa(q, k, v, 2)
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            flash_attn.flash_attention_gqa(q, k, v, 2)
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / 10)
    out[str(dt).split(".")[-1] + "_ms"] = statistics.median(ts)
print(json.dumps(out))
'''


def ablated_source(source: str, edits) -> str:
    """``source`` with each edit applied; raises if a text is not in it
    exactly once (the kernel changed under the tool)."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"ablation text found {source.count(old)} times "
                             f"in {KERNEL.name}: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    source = KERNEL.read_text()
    work = ROOT / "build" / "flash_ablation"
    builds = {}
    for name, edits in VARIANTS.items():
        d = work / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch", d / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (d / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attn.cu").write_text(
            ablated_source(source, edits))
        builds[name] = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
             "from repro_torch.kernels import _build; _build.load()"],
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in builds.items():
        text, _ = p.communicate()
        if p.returncode:
            sys.exit(f"flash_ablation: the {name} copy does not build:\n{text[-4000:]}")
    rows = []
    for rep in range(args.reps):
        for name in VARIANTS:
            r = subprocess.run([sys.executable, "-c", TIMER], cwd=work / name,
                               capture_output=True, text=True, timeout=300)
            if r.returncode:
                sys.exit(f"flash_ablation: {name} failed:\n{r.stderr[-4000:]}")
            row = {"variant": name, "round": rep, **json.loads(r.stdout.splitlines()[-1])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "nvidia_smi": smi.stdout.strip()}, indent=1))


if __name__ == "__main__":
    main()
