"""tools/torch_bwd_ablation.py on the CPU: each variant's edits still
match the training backwards' sources (with their headers inlined), so
that the tool builds on the card what its names say."""
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_bwd_ablation", ROOT / "tools" / "torch_bwd_ablation.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


@pytest.mark.parametrize("kind", sorted(tool.SOURCES))
def test_inlined_source_includes_no_kernel_header(kind):
    text = tool.inline_headers(tool.SOURCES[kind].read_text())
    assert not re.search(r'#include "\w+\.cuh"', text)
    assert "#pragma once" not in text
    # each helper defined once
    for helper in ("smem_addr", "cp_async16", "mma_3xtf32", "mma_3xtf32_rn",
                   "split_tf32"):
        assert len(re.findall(rf"__forceinline__ \w+ {helper}\(", text)) == 1, helper


@pytest.mark.parametrize("kind,name", sorted(
    (kind, name) for kind, variants in tool.VARIANTS.items() for name in variants))
def test_variant_edits_match_the_source(kind, name):
    text = tool.inline_headers(tool.SOURCES[kind].read_text())
    edited = tool.variant_source(text, tool.VARIANTS[kind][name])
    assert edited != text
    # the accumulation variants move calls between mma_3xtf32 and
    # mma_3xtf32_rn (defined once, in tf32_mma.cuh)
    calls = text.count("mma_3xtf32_rn(")
    if name == "rn_accum":
        assert edited.count("mma_3xtf32_rn(") > calls
    if name == "tc_accum":
        assert edited.count("mma_3xtf32_rn(") == calls - 2
    assert edited.count("void mma_3xtf32_rn(") == 1


@pytest.mark.parametrize("kind", sorted(tool.SOURCES))
def test_right_variants_exist(kind):
    """Every variant held to the plain backward is one the tool builds."""
    names = set(tool.VARIANTS[kind]) | {"kernel", "baseline"}
    assert set(tool.RIGHT[kind]) <= names
