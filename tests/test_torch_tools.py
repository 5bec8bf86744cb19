"""The port's measurement tools against the sources they edit: every
ablation of ``tools/flash_ablation.py`` and every variant of
``tools/decode_ab.py`` applies to the kernel as it is."""
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
