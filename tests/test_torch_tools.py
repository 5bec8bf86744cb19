"""The port's measurement tools against the sources they edit: every
ablation of ``tools/flash_ablation.py`` applies to the kernel as it is."""
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
