"""The planted-fault tools of the port's kernels (``tools/*_fault_check.py``
over ``tools/fault_check.py``) against the current kernel sources.

The tools run on the card; here only their tables are checked: every
fault's anchor text is found in its source at its occurrence (a stale
anchor would otherwise plant nothing and pass as "caught"), a missing
anchor raises before anything is built, and every fault names the groups
it must fail.
"""
import importlib
import pathlib
import sys

import pytest

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
CSRC = TOOLS.parent / "paddle_tpu_torch" / "ops" / "csrc"
SOURCES = {"flash_fault_check": "flash_attention.cu",
           "rpa_quant_fault_check": "ragged_paged_attention.cu",
           "bsa_fault_check": "block_sparse_attention.cu"}


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, str(TOOLS))
    try:
        yield {name: importlib.import_module(name) for name in SOURCES}, \
            importlib.import_module("fault_check")
    finally:
        sys.path.remove(str(TOOLS))


@pytest.mark.parametrize("tool", sorted(SOURCES))
def test_every_fault_plants_on_the_current_source(tools, tool):
    mods, fc = tools
    faults = mods[tool].FAULTS
    assert faults["none"] is None and len(faults) > 1
    text = (CSRC / SOURCES[tool]).read_text()
    for name, fault in faults.items():
        if fault is None:
            continue
        planted = fc.plant(text, fault)
        assert planted != text, name
        for old, new, _ in fc._as_fault(fault).sites:
            assert new in planted, name


def test_a_stale_anchor_raises(tools):
    _, fc = tools
    with pytest.raises(RuntimeError, match="not found"):
        fc.plant("int x = 1;\n", ("int y = 1;", "int y = 2;", 0))
    with pytest.raises(RuntimeError, match="not found"):      # occurrence 1
        fc.plant("int x = 1;\n", ("int x = 1;", "int x = 2;", 1))
    two = fc.Fault(sites=(("a = 1", "a = 2", 0), ("b = 1", "b = 2", 0)))
    assert fc.plant("a = 1; b = 1;", two) == "a = 2; b = 2;"


def test_tile_kernel_faults_land_in_the_tile_kernel(tools):
    """The tile path's faults are planted inside ``rpa_tile_kernel`` (an
    anchor that is also a substring of a line of ``rpa_kernel`` would
    plant there and pass on decode cases) and are each held to the bf16
    groups and the prefill/suffix cases that run the tile kernel."""
    mods, fc = tools
    rpa = mods["rpa_quant_fault_check"].FAULTS
    src = (CSRC / SOURCES["rpa_quant_fault_check"]).read_text()
    start = src.index("rpa_tile_kernel(const __nv_bfloat16*")
    end = src.index("int launch_tile(", start)
    for name in ("tile_last_page", "tile_last_tile", "tile_row0_scale"):
        fault = rpa[name]
        assert fault.must_fail and fault.cases, name
        assert all("bfloat16" in g for g in fault.must_fail), name
        for old, _, which in fault.sites:
            at = -1
            for _ in range(which + 1):
                at = src.index(old, at + 1)
            assert start < at < end, name
    sites = mods["flash_fault_check"].FAULTS["fwd_tile"].sites
    assert any("kTile" in old for old, _, _ in sites)   # the Hopper core's
    assert fc.CATCH_FACTOR >= 10
