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
            "repro_torch.bench.result", "repro_torch.bench.registry",
            "repro_torch.bench.gate", "repro_torch.bench.env",
            "repro_torch.bench.timing",
            "repro_torch.tune.estimator", "repro_torch.tune.planner",
            "repro_torch.tune.policy",
            "repro_torch.tune.arrivals", "repro_torch.elastic",
            "repro_torch.elastic.events", "repro_torch.elastic.tracker",
            "repro_torch.elastic.trainer", "repro_torch.launch",
            "repro_torch.launch.train", "repro_torch.launch.ranks",
            "repro_torch.models.moe",
            "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.configs.grok_1_314b", "repro_torch.models.vlm",
            "repro_torch.configs.internvl2_26b", "repro_torch.models.xlstm",
            "repro_torch.configs.xlstm_350m",
            "repro_torch.models.mamba_hybrid",
            "repro_torch.configs.zamba2_1p2b"} <= set(mods)
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


def test_vlm_imports_with_jax_absent():
    """``jax`` made unimportable: the VLM family and its config import,
    and the config is served by name."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import repro_torch.models.vlm, repro_torch.configs
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("internvl2-26b")
        assert api.get_module(cfg) is repro_torch.models.vlm
        print(cfg.family, cfg.n_frontend_tokens)
    """)
    res = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["vlm", "256"]


def test_xlstm_imports_with_jax_absent():
    """``jax`` made unimportable: the SSM family and its config import,
    and the config is served by name."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import repro_torch.models.xlstm, repro_torch.configs
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("xlstm-350m")
        assert api.get_module(cfg) is repro_torch.models.xlstm
        print(cfg.family, cfg.n_layers)
    """)
    res = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ssm", "24"]


def test_hybrid_imports_with_jax_absent():
    """``jax`` made unimportable: the hybrid family and its config import,
    and the config is served by name."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import repro_torch.models.mamba_hybrid, repro_torch.configs
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("zamba2-1.2b")
        assert api.get_module(cfg) is repro_torch.models.mamba_hybrid
        print(cfg.family, cfg.n_layers, cfg.attn_every)
    """)
    res = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["hybrid", "38", "6"]


def test_encdec_imports_with_jax_absent():
    """``jax`` made unimportable: the encoder-decoder and its config
    import, and the config is served by name."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import repro_torch.models.encdec, repro_torch.configs
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("whisper-tiny")
        assert api.get_module(cfg) is repro_torch.models.encdec
        print(cfg.family, cfg.enc_layers, cfg.n_layers, cfg.dec_ctx)
    """)
    res = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["encdec", "4", "4", "448"]


def test_no_source_line_imports_jax_or_the_reference():
    """Neither a statement nor a doctest line (``>>> import`` / ``>>>
    from``) of the package or of the examples' twins
    (``examples/*_torch.py``) imports JAX or the reference; nor does a
    twin import ``benchmarks``."""
    root = pathlib.Path(repro_torch.__file__).parent
    forbidden = ("import jax", "from jax", "import repro ", "import repro.",
                 "from repro ", "from repro.")
    twins = sorted((SRC.parent / "examples").glob("*_torch.py"))
    assert [p.name for p in twins] == [
        "logistic_amazon_torch.py", "quickstart_torch.py",
        "serve_batched_torch.py", "train_lm_coded_torch.py"]
    files = [(p, forbidden) for p in root.rglob("*.py")] + [
        (p, forbidden + ("import benchmarks", "from benchmarks"))
        for p in twins]
    for p, banned in files:
        for ln in p.read_text().splitlines():
            s = ln.strip()
            if s.startswith((">>> import ", ">>> from ")):
                s = s[len(">>> "):]
            if s.startswith(("import ", "from ")):
                assert not s.startswith(banned), f"{p}: {s}"


def test_example_twins_import_with_jax_and_the_reference_absent():
    """``jax``, the reference and ``benchmarks`` made unimportable: each
    twin of ``examples/`` imports and has its ``run`` and ``main``."""
    code = textwrap.dedent("""
        import importlib.util, pathlib, sys
        for name in ("jax", "repro", "benchmarks"):
            sys.modules[name] = None
        for p in sorted(pathlib.Path(sys.argv[1]).glob("*_torch.py")):
            spec = importlib.util.spec_from_file_location(p.stem, p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            assert callable(mod.run) and callable(mod.main)
            print(p.stem)
    """)
    res = subprocess.run([sys.executable, "-c", code,
                          str(SRC.parent / "examples")], text=True,
                         capture_output=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["logistic_amazon_torch", "quickstart_torch",
                                  "serve_batched_torch",
                                  "train_lm_coded_torch"]


def _entry_points():
    from repro_torch import coding, comm
    from repro_torch.bench import capture_env
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
    from repro_torch.coding.schedules import get_schedule
    from repro_torch.coding.backends import TorchRefBackend
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.launch import ranks as launch_ranks
    from repro_torch.launch import train as launch_train
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
        "make_dist_comm": lambda: comm.make_dist_comm(4),
        "launch.ranks.run_ranks":
            lambda: launch_ranks.run_ranks(launch_train.job_rank, 2),
        "models.api.init": lambda: api.init(cfg),
        "models.api.init(dense)": lambda: api.init(lm),
        "models.api.init(moe)":
            lambda: api.init(get_config("olmoe-1b-7b").reduced()),
        "models.api.init(vlm)":
            lambda: api.init(get_config("internvl2-26b").reduced()),
        "models.api.init(ssm)":
            lambda: api.init(get_config("xlstm-350m").reduced()),
        "models.api.init_cache(ssm)":
            lambda: api.init_cache(get_config("xlstm-350m").reduced(), 2, 8),
        "models.api.init(hybrid)":
            lambda: api.init(get_config("zamba2-1.2b").reduced()),
        "models.api.init_cache(hybrid)":
            lambda: api.init_cache(get_config("zamba2-1.2b").reduced(), 2, 8),
        "CodedServer": lambda: CodedServer(lm, code, {}),
        "make_coded_forward": lambda: make_coded_forward(lm, code),
        "BatchedEngine": lambda: BatchedEngine(lm, {}, batch=2, seq_len=8),
        "build_serve_artifacts":
            lambda: build_serve_artifacts(lm, batch=2, seq_len=8),
        "models.api.init_cache": lambda: api.init_cache(lm, 2, 8),
        "ElasticTrainer": lambda: ElasticTrainer(cfg, code, nag(1e-3)),
        "launch.train.main": lambda: launch_train.main(["--steps", "1"]),
        "launch.train.main(--nproc 2)": lambda: launch_train.main(
            ["--steps", "1", "--nproc", "2", "--dist-backend", "gloo"]),
        "capture_env": capture_env,
        "Codec": lambda: coding.Codec(code=code,
                                      schedule=get_schedule("gather"),
                                      backend=TorchRefBackend()),
    }


@pytest.mark.parametrize("name", ["Trainer", "Trainer(autotune)",
                                  "CodedServer(autotune)",
                                  "make_coded_train_step",
                                  "make_codec", "SchemeSpec.make_codec",
                                  "make_local_comm", "make_dist_comm",
                                  "launch.ranks.run_ranks",
                                  "models.api.init",
                                  "models.api.init(dense)",
                                  "models.api.init(moe)",
                                  "models.api.init(vlm)",
                                  "models.api.init(ssm)",
                                  "models.api.init_cache(ssm)",
                                  "models.api.init(hybrid)",
                                  "models.api.init_cache(hybrid)",
                                  "CodedServer",
                                  "make_coded_forward", "BatchedEngine",
                                  "build_serve_artifacts",
                                  "models.api.init_cache",
                                  "ElasticTrainer", "launch.train.main",
                                  "launch.train.main(--nproc 2)",
                                  "capture_env", "Codec"])
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
