"""Build and load the CUDA kernels: ``nvcc`` by hand into one shared library
with a plain C interface, bound with ``ctypes``.

The sources under ``csrc/`` include no PyTorch header, so a build takes
seconds.  Each ``.cu`` is compiled to an object by its own ``nvcc`` process,
all started together, and the objects are linked into
``libkernels_<hash>.so``, where the hash is that of the sources: a changed
source builds anew, an unchanged one is loaded as it is.  The library goes
into ``build/repro_torch_kernels/`` at the root of the checkout; nothing is
built when the module is imported, only at the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
last_build: dict | None = None   # {"seconds", "lib", "built"} of the last load()


def csrc_dir() -> pathlib.Path:
    """Directory of the CUDA sources."""
    return pathlib.Path(__file__).resolve().parent / "csrc"


def build_dir() -> pathlib.Path:
    """Directory the library is built into (git-ignored)."""
    return (pathlib.Path(__file__).resolve().parents[3]
            / "build" / "repro_torch_kernels")


def sources() -> list[pathlib.Path]:
    """The ``.cu`` files, in a fixed order."""
    return sorted(csrc_dir().glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha1()
    for p in sorted(csrc_dir().glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def find_nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is not installed."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME / "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def build() -> pathlib.Path:
    """Compile every source in parallel, link, and return the library path.

    Raises ``RuntimeError`` with the compiler's output when a step fails.
    """
    nvcc = find_nvcc()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tag = _source_hash()
    lib = out / f"libkernels_{tag}.so"
    procs = []
    for src in sources():
        obj = out / f"{src.stem}_{tag}_{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"$ nvcc {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    (out / f"nvcc_{tag}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out / f"libkernels_{tag}_{os.getpid()}.so.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)       # atomic: a concurrent build sees old or new
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    return lib


def ptxas_report() -> dict[str, dict]:
    """Registers and spill bytes of each kernel, from the ``-Xptxas -v``
    lines of the last build's log (empty when this checkout has not built
    the library): ``{mangled name: {"registers", "spill_stores",
    "spill_loads"}}``."""
    log = build_dir() / f"nvcc_{_source_hash()}.log"
    if not log.exists():
        return {}
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of every entry point of a library
    built from these sources (or from a copy with the same C interface)."""
    # argtypes on every entry point: without them ctypes passes a Python int
    # as a 32-bit int (cutting pointers) and a Python float as a double
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    signatures = {
        # (G, C, out, d, V, m, R, rank3, in_dtype, out_dtype, vec, stream)
        "coded_encode_launch": [ptr, ptr, ptr, i32, i64, i32, i64, i32, i32,
                                i32, i32, ptr],
        # (F, W, out, n, V, m, R, rank3, in_dtype, out_dtype, vec, stream)
        "coded_decode_launch": [ptr, ptr, ptr, i32, i64, i32, i64, i32, i32,
                                i32, i32, ptr],
        # (G, C, acc, d, V, m, R, rank3, in_dtype, vec, stream)
        "coded_encode_acc_launch": [ptr, ptr, ptr, i32, i64, i32, i64, i32,
                                    i32, i32, ptr],
        # (F, W, P, MU, partials, done, ss, n, V, m, lr, momentum, scale,
        #  in_dtype, num_partials, vec, stream)
        "coded_decode_apply_launch": [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                      i64, i32, f32, f32, f32, i32, i64, i32,
                                      ptr],
        # (q, k, v, out, lse, B, Sq, Sk, H, Hkv, hd, q/k/v strides (b, s, h),
        #  mask_kind, window, q_pos0, scale, dtype, stream)
        "flash_attention_launch": [ptr, ptr, ptr, ptr, ptr, i32, i64, i64, i32,
                                   i32, i32] + [i64] * 9 + [i32, i64, i64, f32,
                                                            i32, ptr],
        # (q, k, v, out, dout, lse, dq, dk, dv, dsum, B, Sq, Sk, H, Hkv, hd,
        #  q/k/v strides (b, s, h), mask_kind, window, q_pos0, scale, dtype,
        #  stream)
        "flash_attention_bwd_launch": [ptr] * 10 + [i32, i64, i64, i32, i32,
                                                    i32] + [i64] * 9
                                      + [i32, i64, i64, f32, i32, ptr],
        "flash_attention_smem_bytes": [i32, i32],   # (dtype, hd)
        "flash_attention_bwd_smem_bytes": [i32, i32],   # (dtype, hd)
        "empty_kernel_launch": [ptr],               # (stream)
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = i32
    return lib


def build_once() -> pathlib.Path:
    """The library's path, built first when its sources have no build yet;
    nothing is loaded (so no CUDA context is made): a launcher calls it once
    before it starts ranks that each ``load`` the library."""
    lib_path = build_dir() / f"libkernels_{_source_hash()}.so"
    return lib_path if lib_path.exists() else build()


def load() -> ctypes.CDLL:
    """The loaded library, built first when its sources have no build yet."""
    global _lib, last_build
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    built = not (build_dir() / f"libkernels_{_source_hash()}.so").exists()
    lib_path = build_once()
    lib = bind(ctypes.CDLL(str(lib_path)))
    _lib = lib
    last_build = {"seconds": time.perf_counter() - t0, "lib": str(lib_path),
                  "built": built}
    return lib
