"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor the reference package, and no default-device entry point
runs on the CPU unless it is asked to."""
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch

torch.set_num_threads(1)

SRC = pathlib.Path(repro_torch.__file__).resolve().parents[1]


def _modules():
    root = pathlib.Path(repro_torch.__file__).parent
    out = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert len(mods) > 30 and "repro_torch.kernels._build" in mods
    assert {"repro_torch.core.approx", "repro_torch.core.stable",
            "repro_torch.core.stability", "repro_torch.core.runtime_model",
            "repro_torch.bench", "repro_torch.bench.straggler",
            "repro_torch.tune.estimator", "repro_torch.tune.planner",
            "repro_torch.tune.policy",
            "repro_torch.tune.arrivals"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "jaxlib"
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("imported", len({mods!r}))
    """)
    res = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


def test_no_source_line_imports_jax_or_the_reference():
    root = pathlib.Path(repro_torch.__file__).parent
    for p in root.rglob("*.py"):
        for ln in p.read_text().splitlines():
            s = ln.strip()
            if s.startswith(("import ", "from ")):
                assert not s.startswith(("import jax", "from jax",
                                         "import repro ", "import repro.",
                                         "from repro ", "from repro.")), \
                    f"{p}: {s}"


def _entry_points():
    from repro_torch import coding, comm
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.models import api
    from repro_torch.optim import nag
    from repro_torch.serving import (BatchedEngine, CodedServer,
                                     build_serve_artifacts,
                                     make_coded_forward)
    from repro_torch.train import Trainer, make_coded_train_step
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.tune import (AutotunePolicy, PoissonArrivals,
                                  ServingPolicy, ShiftedExpSampler)
    cfg, code = get_config("logistic-paper"), make_code(4, 3, 1, 2)
    lm = get_config("qwen3-1.7b").reduced()
    timed = ShiftedExpSampler(RuntimeParams(n=4, lambda1=1.0, lambda2=1.0,
                                            t1=1.0, t2=1.0))
    return {
        "Trainer": lambda: Trainer(cfg, code, nag(1e-3)),
        "Trainer(autotune)": lambda: Trainer(
            cfg, code, nag(1e-3), autotune=AutotunePolicy(),
            straggler_source=timed),
        "CodedServer(autotune)": lambda: CodedServer(
            lm, code, {}, straggler_source=timed,
            autotune=ServingPolicy(arrivals=PoissonArrivals(rate_rps=1.0))),
        "make_coded_train_step":
            lambda: make_coded_train_step(cfg, code, nag(1e-3)),
        "make_codec": lambda: coding.make_codec(code),
        "SchemeSpec.make_codec": lambda: coding.SchemeSpec().make_codec(code),
        "make_local_comm": lambda: comm.make_local_comm(4),
        "models.api.init": lambda: api.init(cfg),
        "models.api.init(dense)": lambda: api.init(lm),
        "CodedServer": lambda: CodedServer(lm, code, {}),
        "make_coded_forward": lambda: make_coded_forward(lm, code),
        "BatchedEngine": lambda: BatchedEngine(lm, {}, batch=2, seq_len=8),
        "build_serve_artifacts":
            lambda: build_serve_artifacts(lm, batch=2, seq_len=8),
        "models.api.init_cache": lambda: api.init_cache(lm, 2, 8),
    }


@pytest.mark.parametrize("name", ["Trainer", "Trainer(autotune)",
                                  "CodedServer(autotune)",
                                  "make_coded_train_step",
                                  "make_codec", "SchemeSpec.make_codec",
                                  "make_local_comm", "models.api.init",
                                  "models.api.init(dense)", "CodedServer",
                                  "make_coded_forward", "BatchedEngine",
                                  "build_serve_artifacts",
                                  "models.api.init_cache"])
def test_default_device_is_the_card_and_never_a_quiet_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_kernel_build_needs_nvcc_and_says_so(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    assert [p.name for p in _build.sources()] == ["coded_decode.cu",
                                                  "coded_encode.cu",
                                                  "flash_attn.cu",
                                                  "flash_attn_bwd.cu"]
    assert _build.build_dir() == SRC.parent / "build" / "repro_torch_kernels"
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
