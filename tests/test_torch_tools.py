"""The port's measurement tools against the sources they edit: every
ablation of ``tools/flash_ablation.py`` and every variant of
``tools/decode_ab.py`` and ``tools/flash_bwd_ab.py`` applies to the kernel
as it is; the backward A/B tool's arguments and its check of the old
source; every ``chip_smoke`` name the tools use still resolves, and the
timers they reach through it live in ``repro_torch.bench``."""
import ast
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_ablation", ROOT / "tools" / "flash_ablation.py")
ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablation)


@pytest.mark.parametrize("variant", sorted(ablation.VARIANTS))
def test_flash_ablation_edits_match_the_kernel_source(variant):
    source = ablation.KERNEL.read_text()
    edited = ablation.ablated_source(source, ablation.VARIANTS[variant])
    assert (edited == source) == (variant == "base")


def test_flash_ablation_refuses_a_text_the_kernel_lacks():
    with pytest.raises(ValueError, match="found 0 times"):
        ablation.ablated_source("int x;", [("not in the source", "")])


_spec_ab = importlib.util.spec_from_file_location(
    "decode_ab", ROOT / "tools" / "decode_ab.py")
decode_ab = importlib.util.module_from_spec(_spec_ab)
_spec_ab.loader.exec_module(decode_ab)


@pytest.mark.parametrize("variant", sorted(decode_ab.VARIANTS))
def test_decode_variants_edit_the_kernel_source(variant):
    source = decode_ab.KERNEL.read_text()
    edited = decode_ab.ablated_source(source, decode_ab.VARIANTS[variant])
    assert edited != source


def test_decode_variants_refuse_a_text_the_kernel_lacks():
    with pytest.raises(ValueError, match="found 0 times"):
        decode_ab.ablated_source("int x;", [("not in the source", "")])


_spec_fb = importlib.util.spec_from_file_location(
    "flash_bwd_ab", ROOT / "tools" / "flash_bwd_ab.py")
flash_bwd_ab = importlib.util.module_from_spec(_spec_fb)
_spec_fb.loader.exec_module(flash_bwd_ab)


@pytest.mark.parametrize("variant", sorted(flash_bwd_ab.VARIANTS))
def test_flash_bwd_variants_edit_the_kernel_source(variant):
    source = flash_bwd_ab.KERNEL.read_text()
    edited = flash_bwd_ab.ablated_source(source, flash_bwd_ab.VARIANTS[variant])
    assert edited != source


def test_flash_bwd_variants_refuse_a_text_the_kernel_lacks():
    with pytest.raises(ValueError, match="found 0 times"):
        flash_bwd_ab.ablated_source("int x;", [("not in the source", "")])


def test_flash_bwd_ab_takes_a_source_with_the_entry_point_only():
    source = flash_bwd_ab.KERNEL.read_text()
    assert flash_bwd_ab.check_old_source(source) == source
    with pytest.raises(ValueError, match="flash_attention_bwd_launch"):
        flash_bwd_ab.check_old_source(
            source.replace('extern "C" int flash_attention_bwd_launch(',
                           'extern "C" int some_other_launch('))
    forward = (flash_bwd_ab.KERNEL.parent / "flash_attn.cu").read_text()
    assert flash_bwd_ab.check_old_source(forward, "flash_attention_launch") == forward
    with pytest.raises(ValueError, match="flash_attention_launch"):
        flash_bwd_ab.check_old_source(source, "flash_attention_launch")


def test_flash_bwd_ab_parses_its_arguments():
    args = flash_bwd_ab.parse_args(["old.cu", "--variants", "no_split,kg1",
                                    "--rounds", "3", "--out", "r.json",
                                    "--old-forward", "fwd.cu"])
    assert (str(args.old), args.variants, args.rounds, args.out,
            str(args.old_forward)) == ("old.cu", ["no_split", "kg1"], 3,
                                       "r.json", "fwd.cu")
    plain = flash_bwd_ab.parse_args(["old.cu"])
    assert plain.variants == [] and plain.old_forward is None
    for bad in (["old.cu", "--variants", "no_such"], ["old.cu", "--rounds", "0"],
                []):
        with pytest.raises(SystemExit):
            flash_bwd_ab.parse_args(bad)


def _top_level_names(tree):
    """Names a module defines or imports at its top level (its ``try``
    blocks included)."""
    names = set()
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Try, ast.If)):
            stack.extend(node.body + node.orelse)
            stack.extend(b for h in getattr(node, "handlers", ()) for b in h.body)
            stack.extend(getattr(node, "finalbody", ()))
    return names


CHIP_SMOKE = ast.parse((ROOT / "chip_smoke.py").read_text())
MOVED = {"time_ms", "time_run_ms", "host_us_per_call", "_union_us",
         "nvidia_smi_line"}


def test_every_chip_smoke_name_the_tools_use_resolves():
    """``import chip_smoke as cs`` exits without a card, so both sides are
    read with ``ast``: every ``cs.<name>`` under ``tools/`` is a name that
    chip_smoke.py defines or imports."""
    have = _top_level_names(CHIP_SMOKE)
    used = {}
    for p in sorted((ROOT / "tools").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "cs"):
                used.setdefault(node.attr, []).append(p.name)
    assert {"time_ms", "time_run_ms", "nvidia_smi_line",
            "measure_launch_floor"} <= set(used)
    missing = {k: v for k, v in used.items() if k not in have}
    assert not missing, missing


def test_chip_smoke_takes_its_timers_from_the_package():
    """The timers and the environment line live in ``repro_torch.bench``;
    chip_smoke.py imports them and defines no copy of its own."""
    defined = {n.name for n in CHIP_SMOKE.body if isinstance(n, ast.FunctionDef)}
    assert not MOVED & defined
    imported = {a.asname or a.name for node in ast.walk(CHIP_SMOKE)
                if isinstance(node, ast.ImportFrom)
                and (node.module or "").startswith("repro_torch.bench")
                for a in node.names}
    assert MOVED | {"profile_device", "RUN_LAUNCHES"} <= imported
    assert "measure_launch_floor" in defined and "profile_steps" in defined
    mods = {a.name.split(".")[0] for node in ast.walk(CHIP_SMOKE)
            if isinstance(node, ast.Import) for a in node.names}
    mods |= {(node.module or "").split(".")[0] for node in ast.walk(CHIP_SMOKE)
             if isinstance(node, ast.ImportFrom) and not node.level}
    assert not mods & {"jax", "jaxlib", "repro", "benchmarks"}
