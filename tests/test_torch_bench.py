"""The port's benchmark harness (``repro_torch.bench``) against the
reference's (``repro.bench``): the copied modules are pinned to their
sources, a ``BENCH_*.json`` written by either package loads under the
other's, and the gate (``collect_gated``, ``check``, the CLI) gives the same
answers, lines and exit codes on the same inputs.  Beside them: the port's
environment record on the CPU, its timers' counts and default sync, and the
interval union of its profiler measurement."""
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.bench as ref_bench
import repro.bench.gate as ref_gate
import repro.bench.result as ref_result
import repro_torch.bench as port_bench
import repro_torch.bench.gate as port_gate
import repro_torch.bench.result as port_result
from repro_torch.bench import (BenchResult, TimerPolicy, capture_env,
                               load_results, time_callable, time_sequence,
                               validate_result, write_results)
from repro_torch.bench import timing as port_timing
from repro_torch.bench.env import nvidia_smi_line
from repro_torch.bench.gate import check, collect_gated, write_baseline

torch.set_num_threads(1)

REF_DIR = pathlib.Path(ref_bench.__file__).parent
PORT_DIR = pathlib.Path(port_bench.__file__).parent

# The lines of gate.py that differ, all in its docstring: the reference
# names its baseline file and its benchmark driver, which are the JAX
# package's; the port's baseline file comes with the port's own benchmark,
# so its docstring names the CLI's arguments and its own module path.
GATE_REF_ONLY = [
    "Baseline format (`benchmarks/baseline.json`):",
    "    PYTHONPATH=src python -m benchmarks.run --quick --json-dir bench-out",
    "    PYTHONPATH=src python -m repro.bench.gate --results bench-out \\",
    "        --baseline benchmarks/baseline.json --update",
]
GATE_PORT_ONLY = [
    "Baseline format (a JSON file named by `--baseline`):",
    "    PYTHONPATH=src python -m repro_torch.bench.gate --results DIR \\",
    "        --baseline FILE --update",
]


def _body(path):
    """Source lines apart from import lines."""
    return [ln for ln in pathlib.Path(path).read_text().splitlines()
            if not ln.lstrip().startswith(("import ", "from "))]


@pytest.mark.parametrize("name", ["result", "registry"])
def test_copied_module_equals_source(name):
    assert _body(REF_DIR / f"{name}.py") == _body(PORT_DIR / f"{name}.py")


def test_gate_equals_source_but_its_docstring_lines():
    ref, port = _body(REF_DIR / "gate.py"), _body(PORT_DIR / "gate.py")
    assert [ln for ln in ref if ln not in port] == GATE_REF_ONLY
    assert [ln for ln in port if ln not in ref] == GATE_PORT_ONLY
    assert ([ln for ln in ref if ln not in GATE_REF_ONLY]
            == [ln for ln in port if ln not in GATE_PORT_ONLY])
    doc = port_gate.__doc__
    assert "repro_torch.bench.gate" in doc
    assert "benchmarks/baseline.json" not in doc
    assert doc.splitlines()[0] == ref_gate.__doc__.splitlines()[0]


def test_exports_equal_the_reference():
    assert port_bench.__all__ == ref_bench.__all__
    assert all(hasattr(port_bench, n) for n in port_bench.__all__)


def _record(pkg_result, name="k", **over):
    kw = dict(name=name,
              metrics={"ms": 0.0125, "share": 0.25, "count": 3},
              params={"shape": np.array([1, 171737, 2]),
                      "scale": np.float32(0.5), "gap": float("nan"),
                      "nested": {"t": (1, 2.5, np.int64(7))}},
              env={"backend": "cpu", "flag": False, "none": None},
              timing={"reps": 25, "warmup": 5},
              gates={"share": "max", "ms": "min"},
              extra={"inf": float("inf")})
    kw.update(over)
    return pkg_result.BenchResult(**kw)


@pytest.mark.parametrize("writer,reader", [(ref_result, port_result),
                                           (port_result, ref_result)])
def test_results_file_loads_under_the_other_package(writer, reader, tmp_path):
    results = [_record(writer, "a"), _record(writer, "b", timing=None,
                                             gates={})]
    path = writer.write_results(results, "x", tmp_path)
    assert path.name == "BENCH_x.json"
    theirs = reader.load_results(path)
    ours = writer.load_results(path)
    assert theirs == ours
    assert [r["name"] for r in theirs] == ["a", "b"]
    assert theirs[0]["params"]["gap"] == "nan"
    assert theirs[0]["params"]["shape"] == [1, 171737, 2]
    # the same records written by the other package give the same bytes
    other = [_record(reader, "a"), _record(reader, "b", timing=None,
                                           gates={})]
    path2 = reader.write_results(other, "x", tmp_path / "other")
    assert path2.read_bytes() == path.read_bytes()


def test_load_results_refuses_the_same_files(tmp_path):
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text(json.dumps({"results": [{"name": "x"}]}))
    for pkg in (ref_result, port_result):
        with pytest.raises(ValueError, match="invalid result"):
            pkg.load_results(bad)
    (tmp_path / "BENCH_nores.json").write_text("[]")
    for pkg in (ref_result, port_result):
        with pytest.raises(ValueError, match="not a BENCH results file"):
            pkg.load_results(tmp_path / "BENCH_nores.json")


def _gated_dir(tmp_path, rng):
    """A directory of several BENCH files with gated and ungated results."""
    for b in range(3):
        results = []
        for i in range(4):
            metrics = {f"m{j}": float(rng.normal()) for j in range(3)}
            gates = {m: str(rng.choice(["max", "min"])) for m in metrics
                     if rng.random() < 0.6}
            results.append(ref_result.BenchResult(
                name=f"b{b}/r{i}", metrics=metrics, gates=gates))
        ref_result.write_results(results, f"b{b}", tmp_path)
    return tmp_path


@pytest.mark.parametrize("seed", range(4))
def test_collect_gated_agrees(seed, tmp_path):
    d = _gated_dir(tmp_path, np.random.default_rng(seed))
    got = port_gate.collect_gated(d)
    assert got == ref_gate.collect_gated(d)
    assert got, "no gated result drawn"


def test_collect_gated_refuses_the_same_directories(tmp_path):
    for pkg in (ref_gate, port_gate):
        with pytest.raises(FileNotFoundError):
            pkg.collect_gated(tmp_path)
    r = ref_result.BenchResult(name="dup", metrics={"a": 1.0},
                               gates={"a": "max"})
    ref_result.write_results([r], "one", tmp_path)
    ref_result.write_results([r], "two", tmp_path)
    for pkg in (ref_gate, port_gate):
        with pytest.raises(ValueError, match="duplicate gated result name"):
            pkg.collect_gated(tmp_path)


def _pair(rng):
    """One observed/baseline pair: values at, inside and past the
    tolerance in either direction, zero and negative baselines, results
    and metrics missing from the run or from the baseline."""
    observed, benches = {}, {}
    for i in range(int(rng.integers(1, 4))):
        name = f"r{i}"
        obs, base = {}, {}
        for j in range(int(rng.integers(1, 5))):
            metric = f"m{j}"
            direction = str(rng.choice(["max", "min"]))
            b = float(rng.choice([0.0, 1.0, -2.5,
                                  float(rng.normal() * 10.0 ** rng.integers(-3, 4))]))
            value = float(rng.choice([
                b, b * 0.8, b * 1.2, b * (1 + rng.uniform(-0.6, 0.6)),
                b + float(rng.normal())]))
            base[metric] = b
            obs[metric] = (value, direction)
            u = rng.random()
            if u < 0.08:
                del obs[metric]                  # disappeared from the run
            elif u < 0.16:
                del base[metric]                 # no baseline entry
        if rng.random() < 0.1:
            benches[name] = base                 # the run lost the result
            continue
        observed[name] = obs
        if rng.random() < 0.1:
            continue                             # not in the baseline
        benches[name] = base
    baseline = {"schema_version": 1, "benches": benches}
    if rng.random() < 0.7:
        baseline["tolerance"] = float(rng.choice([0.0, 0.05, 0.2, 0.5]))
    tolerance = (None if rng.random() < 0.6
                 else float(rng.choice([0.0, 0.1, 0.2, 0.35])))
    return observed, baseline, tolerance


@pytest.mark.parametrize("seed", range(10))
def test_check_agrees_on_a_seeded_battery(seed):
    """25 pairs a seed, 250 in all."""
    rng = np.random.default_rng(1000 + seed)
    outcomes = []
    for _ in range(25):
        observed, baseline, tol = _pair(rng)
        want = ref_gate.check(observed, baseline, tol)
        got = port_gate.check(observed, baseline, tol)
        assert got == want, (observed, baseline, tol)
        outcomes.append(bool(got))
    assert any(outcomes) and not all(outcomes)


def _write_run():
    """BENCH files of a run into ``out``, gated metrics of both directions
    and an ungated one."""
    results = [
        ref_result.BenchResult(name="speed", metrics={"speedup": 2.0,
                                                      "raw_s": 0.5},
                               gates={"speedup": "max"}),
        ref_result.BenchResult(name="err", metrics={"max_err": 1e-6,
                                                    "ratio": 0.75},
                               gates={"max_err": "min", "ratio": "max"}),
    ]
    ref_result.write_results(results, "run", "out")


def _baseline(**over):
    payload = {"schema_version": 1, "tolerance": 0.2,
               "benches": {"speed": {"speedup": 2.0},
                           "err": {"max_err": 1e-6, "ratio": 0.75}}}
    payload.update(over)
    pathlib.Path("baseline.json").write_text(json.dumps(payload))


# each scenario: what is on disk before the CLI runs, and its arguments
SCENARIOS = {
    "update": (lambda: None, ["--update"]),
    "update_with_tolerance": (lambda: None, ["--update", "--tolerance", "0.05"]),
    "update_keeps_tolerance": (lambda: _baseline(tolerance=0.3), ["--update"]),
    "clean": (lambda: _baseline(), []),
    "doctored": (lambda: _baseline(benches={"speed": {"speedup": 4.0},
                                            "err": {"max_err": 1e-7,
                                                    "ratio": 0.75}}), []),
    "tolerance_flag": (lambda: _baseline(benches={
        "speed": {"speedup": 2.3}, "err": {"max_err": 1e-6, "ratio": 0.75}}),
        ["--tolerance", "0.1"]),
    "not_in_baseline": (lambda: _baseline(benches={"speed": {"speedup": 2.0}}),
                        []),
    "missing_baseline": (lambda: None, []),
}


def _run_cli(gate, scenario, where, monkeypatch, capsys):
    where.mkdir()
    monkeypatch.chdir(where)
    _write_run()
    setup, extra = SCENARIOS[scenario]
    setup()
    capsys.readouterr()
    rc = gate.main(["--results", "out", "--baseline", "baseline.json", *extra])
    cap = capsys.readouterr()
    base = pathlib.Path("baseline.json")
    return rc, cap.out, cap.err, base.read_text() if base.exists() else None


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_gate_cli_gives_the_reference_lines_and_codes(scenario, tmp_path,
                                                      monkeypatch, capsys):
    ref = _run_cli(ref_gate, scenario, tmp_path / "ref", monkeypatch, capsys)
    port = _run_cli(port_gate, scenario, tmp_path / "port", monkeypatch,
                    capsys)
    assert port == ref
    rc = port[0]
    assert rc == (1 if scenario in ("doctored", "tolerance_flag",
                                    "not_in_baseline", "missing_baseline")
                  else 0)


def test_gate_cli_help_is_the_reference_s(capsys):
    outs = []
    for gate in (ref_gate, port_gate):
        with pytest.raises(SystemExit) as e:
            gate.main(["--help"])
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


# twins of tests/test_bench_harness.py's harness tests, on the port


def test_validator_rejects_bad_results():
    good = BenchResult(name="x", metrics={"a": 1.0}, gates={"a": "max"})
    assert validate_result(good.to_dict()) == []
    bad = dict(good.to_dict(), metrics={"a": float("nan")})
    assert any("finite" in e for e in validate_result(bad))
    bad = dict(good.to_dict(), gates={"missing": "max"})
    assert any("names no metric" in e for e in validate_result(bad))
    bad = dict(good.to_dict(), schema_version=99)
    assert any("schema_version" in e for e in validate_result(bad))


def test_gate_roundtrip_and_regression(tmp_path):
    r = BenchResult(
        name="g", metrics={"speedup": 2.0, "raw_s": 0.5},
        gates={"speedup": "max"},
    )
    write_results([r], "g", tmp_path / "out")
    observed = collect_gated(tmp_path / "out")
    assert observed == {"g": {"speedup": (2.0, "max")}}  # raw_s not gated
    write_baseline(observed, tmp_path / "baseline.json")
    baseline = json.loads((tmp_path / "baseline.json").read_text())
    assert check(observed, baseline) == []
    # within tolerance: 2.0 -> 1.7 at 20% passes; 2.0 -> 1.5 fails
    assert check({"g": {"speedup": (1.7, "max")}}, baseline) == []
    failures = check({"g": {"speedup": (1.5, "max")}}, baseline)
    assert failures and "regressed" in failures[0]
    # a gated result vanishing from the run also fails
    assert check({}, baseline)
    # a newly gated metric with no baseline entry fails until --update runs
    failures = check({"g": {"speedup": (2.0, "max"), "extra": (1.0, "max")}},
                     baseline)
    assert any("no baseline entry" in f for f in failures)


def test_timer_policy_deterministic_counts():
    calls = []
    stats = time_callable(lambda: calls.append(0),
                          policy=TimerPolicy(warmup=2, reps=3),
                          sync=lambda _: None)
    assert len(calls) == 5 and stats.reps == 3 and stats.warmup == 2
    assert stats.min_s <= stats.mean_s <= stats.max_s


# the port's own: timing, environment, registry


def test_timing_counts_and_fields_match_the_reference():
    for pkg in (ref_bench, port_bench):
        calls = []
        out = pkg.time_sequence([lambda: calls.append(1)] * 4,
                                warmup=lambda: calls.append(0),
                                sync=lambda _: None)
        assert calls == [0, 1, 1, 1, 1] and len(out) == 4
    assert port_bench.TimerPolicy() == TimerPolicy(warmup=1, reps=10)
    assert (port_bench.TimerPolicy.__dataclass_fields__.keys()
            == ref_bench.TimerPolicy.__dataclass_fields__.keys())
    assert (port_bench.TimingStats.__dataclass_fields__.keys()
            == ref_bench.TimingStats.__dataclass_fields__.keys())
    stats = time_callable(lambda a, b: a + b, torch.ones(3), torch.ones(3),
                          policy=TimerPolicy(warmup=1, reps=4))
    assert stats.to_dict()["reps"] == 4 and stats.std_s >= 0.0


def test_default_sync_on_the_cpu_touches_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA may be initialised")
    for out in (None, torch.ones(2), (torch.ones(1), [torch.zeros(1)]),
                {"a": torch.ones(1)}):
        port_timing._sync(out)
    time_sequence([lambda: torch.ones(2)], warmup=lambda: None)
    assert not torch.cuda.is_initialized()


def test_default_sync_waits_for_the_card_when_a_call_returns_nothing(
        monkeypatch):
    """An in-place call (``coded_encode_acc``, ``coded_decode_apply``)
    may return nothing that is on the card: the default sync still waits
    for the current device."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    calls = []
    time_callable(lambda: calls.append(0), policy=TimerPolicy(warmup=1,
                                                              reps=2))
    assert calls == [0, 0, 0] and synced == [0, 0, 0]
    port_timing._sync((torch.ones(1), {"k": [torch.ones(1)]}))
    assert synced == [0, 0, 0, 0]


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),                # overlap
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 9.5)], 10.0),  # nesting
    ([(0.0, 1.0), (2.0, 3.0), (5.0, 5.5)], 2.5),    # gaps
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 2.0)], 3.0),    # unsorted
    ([(0.0, 1.0), (1.0, 2.0), (1.0, 2.0)], 2.0),    # touching, repeated
])
def test_union_of_intervals(intervals, want):
    assert port_timing._union_us(intervals) == want


def test_union_of_intervals_against_a_grid():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = rng.integers(0, 100, size=int(rng.integers(1, 12)))
        ivs = [(int(x), int(x + rng.integers(1, 30))) for x in a]
        grid = np.zeros(200, dtype=bool)
        for s, e in ivs:
            grid[s:e] = True
        assert port_timing._union_us(ivs) == grid.sum()


ENV_KEYS = {"python", "platform", "numpy", "backend", "device_count",
            "device_kind", "torch", "cuda", "matmul_allow_tf32",
            "cudnn_allow_tf32"}


def test_capture_env_on_the_cpu():
    env = capture_env(device="cpu")
    assert set(env) == ENV_KEYS
    assert env["backend"] == "cpu" and env["device_count"] == 1
    assert env["torch"] == torch.__version__ and env["numpy"] == np.__version__
    assert env["matmul_allow_tf32"] is torch.backends.cuda.matmul.allow_tf32
    assert "nvidia_smi" not in env
    json.dumps(env, allow_nan=False)
    r = BenchResult(name="e", metrics={"a": 1.0}, env=env)
    r.validate()
    assert validate_result(json.loads(json.dumps(r.to_dict()))) == []


def test_capture_env_records_the_worker_group(tmp_path):
    from repro_torch.comm import make_dist_comm, make_local_comm
    env = capture_env(device="cpu", comm=make_local_comm(4, "cpu"))
    assert env["comm"] == {"workers": 4, "ranks": 1, "comm_backend": "local"}
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        comm = make_dist_comm(6, device="cpu", backend="gloo",
                              init_method=f"file://{tmp_path / 'rdv'}",
                              rank=0, world_size=1)
        env = capture_env(device="cpu", comm=comm)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert env["comm"] == {"workers": 6, "ranks": 1, "comm_backend": "gloo"}
    assert set(env) == ENV_KEYS | {"comm"}


def test_capture_env_never_picks_the_cpu_quietly():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        capture_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        capture_env(device="cuda:0")


def test_nvidia_smi_line_raises_where_the_tool_fails(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        nvidia_smi_line()


def test_registry_round_trip():
    from repro_torch.bench import registry
    spec = registry.BenchSpec(name="zz_port_test", description="d",
                              fn=lambda quick: [])
    try:
        assert registry.register(spec) is spec
        assert registry.get_spec("zz_port_test") is spec
        assert "zz_port_test" in registry.names()
        assert spec in registry.all_specs()
        with pytest.raises(KeyError, match="unknown bench"):
            registry.get_spec("zz_not_there")
    finally:
        registry._REGISTRY.pop("zz_port_test", None)


def test_results_load_back_with_the_written_records(tmp_path):
    results = [BenchResult(name=f"n{i}", metrics={"v": float(i) + 0.125},
                           gates={"v": "min"}) for i in range(3)]
    path = write_results(results, "rt", tmp_path)
    loaded = load_results(path)
    assert [(r["name"], r["metrics"]) for r in loaded] == [
        (r.name, r.metrics) for r in results]
    assert json.loads(path.read_text())["bench"] == "rt"
