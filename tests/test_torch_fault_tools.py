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


def _site_offsets(src, fault):
    """Where each site of ``fault`` lands in ``src``."""
    out = []
    for old, _, which in fault.sites:
        at = -1
        for _ in range(which + 1):
            at = src.index(old, at + 1)
        out.append(at)
    return out


def test_backward_and_split_faults_land_in_their_kernels(tools):
    """The bf16 backward's faults (``bwd_dq_pair``, ``bwd_last_q``) are
    planted inside ``flash_bwd_kernel`` and held to the bf16 outputs they
    name (``bwd_last_q`` to each of dq, dk and dv); the f32 split's faults
    to f32. The decode split's faults (``merge_last``, ``chunk_gap``) and
    the re-anchored ``row0_scale`` and ``last_page`` are planted inside
    ``rpa_kernel`` and are held to cases where it splits the keys."""
    mods, fc = tools
    flash = mods["flash_fault_check"].FAULTS
    src = (CSRC / SOURCES["flash_fault_check"]).read_text()
    start = src.index("flash_bwd_kernel(const __grid_constant__")
    end = src.index("flash_bwd_prep_kernel(", start)
    for name in ("bwd_dq_pair", "bwd_last_q"):
        fault = flash[name]
        assert fault.must_fail == ("bfloat16",), name
        assert all(start < at < end for at in _site_offsets(src, fault)), name
    assert flash["bwd_last_q"].every_case
    assert set(flash["bwd_last_q"].cases) == {"dq", "dk", "dv"}
    for name in ("dq_tile", "dkv_tile"):
        assert flash[name].must_fail == ("float32",), name
    rpa = mods["rpa_quant_fault_check"].FAULTS
    src = (CSRC / SOURCES["rpa_quant_fault_check"]).read_text()
    start = src.index("rpa_kernel(const T* __restrict__ q")
    end = src.index("rpa_tile_kernel(const __nv_bfloat16*", start)
    for name in ("merge_last", "chunk_gap", "row0_scale", "last_page"):
        fault = fc._as_fault(rpa[name])
        assert all(start < at < end for at in _site_offsets(src, fault)), name
    for name in ("merge_last", "chunk_gap"):
        assert rpa[name].cases == ("decode",), name


def test_every_case_needs_each_named_case(tools):
    """A fault counts as caught in a group when some case it names fails
    by CATCH_FACTOR; with ``every_case``, only when each case it names
    does (``fault_check.group_caught``)."""
    _, fc = tools
    big, small = 2 * fc.CATCH_FACTOR, 0.5
    cases = {"dq": [1.0, big, ""], "dk": [1.0, small, ""],
             "dv": [1.0, float("nan"), ""]}
    any_case = fc.Fault(sites=(), cases=("dq", "dk"))
    each = fc.Fault(sites=(), cases=("dq", "dk"), every_case=True)
    assert fc.group_caught(any_case, cases)
    assert not fc.group_caught(each, cases)
    assert fc.group_caught(fc.Fault(sites=(), cases=("dq", "dv"),
                                    every_case=True), cases)
    assert not fc.group_caught(fc.Fault(sites=(), cases=("dk",)), cases)
    assert fc.group_caught(fc.Fault(sites=()), cases)


def test_variant_tool_plants_on_the_current_source(tools):
    """``tools/flash_bwd_variants.py``'s timing variants each plant in the
    current ``flash_attention.cu`` (a stale anchor would time the base
    kernel under a variant's name)."""
    _, fc = tools
    sys.path.insert(0, str(TOOLS))
    try:
        var = importlib.import_module("flash_bwd_variants")
    finally:
        sys.path.remove(str(TOOLS))
    text = (CSRC / "flash_attention.cu").read_text()
    assert var.VARIANTS["base"] is None and len(var.VARIANTS) > 1
    for name, variant in var.VARIANTS.items():
        if variant is not None:
            assert fc.plant(text, variant) != text, name


def _kernel_span(src, signature, end):
    start = src.index(signature)
    return start, src.index(end, start)


def test_block_sparse_faults_land_in_their_kernels(tools):
    """The bf16 block-sparse faults are planted inside the kernel they
    name (``bsa_bwd_kernel``, and ``bsa_fwd_kernel`` for the forward's
    and the order's) and held to bf16 and the outputs they must fail
    (``empty_no_store`` to dk and dv of the pattern whose key block has
    an empty list); ``ds_unscaled`` sits in ``ds_of``, which both
    backwards call, and must fail both dtypes; the f32 faults are held to
    f32."""
    mods, fc = tools
    bsa = mods["bsa_fault_check"].FAULTS
    src = (CSRC / SOURCES["bsa_fault_check"]).read_text()
    bwd = _kernel_span(src, "bsa_bwd_kernel(const __grid_constant__",
                       "bsa_bwd_prep_kernel(")
    fwd = _kernel_span(src, "bsa_fwd_kernel(const __grid_constant__",
                       "bsa_bwd_kernel(const __grid_constant__")
    for name, spans in (("bwd_last_dq", [bwd]), ("bwd_mixed_as_full", [bwd]),
                        ("empty_no_store", [bwd]),
                        ("fwd_mixed_as_full", [fwd]),
                        ("order_skip", [fwd, bwd])):
        fault = bsa[name]
        assert fault.must_fail == ("bfloat16",) and fault.cases, name
        at = _site_offsets(src, fault)
        assert len(at) == len(spans), name
        assert all(s < a < e for a, (s, e) in zip(at, spans)), name
    assert bsa["empty_no_store"].every_case
    assert set(bsa["empty_no_store"].cases) == {"T=256 dk", "T=256 dv"}
    assert bsa["order_skip"].every_case
    ds = bsa["ds_unscaled"]
    assert ds.must_fail == () and set(ds.cases) == {"dq", "dk"}
    assert "ds_of(" in src[bwd[0]:bwd[1]]
    for name in ("mixed_as_full", "last_k_tile", "dkv_q_tile"):
        assert bsa[name].must_fail == ("float32",), name
    assert len(bsa) == 10


def test_bsa_variant_tool_plants_on_the_current_source(tools):
    """``tools/bsa_variants.py``'s source variants each plant in the
    current ``block_sparse_attention.cu``, inside ``bsa_bwd_kernel`` or
    its launcher (a stale anchor would time the base kernels under a
    variant's name), and its plan variants are the two it documents."""
    _, fc = tools
    sys.path.insert(0, str(TOOLS))
    try:
        var = importlib.import_module("bsa_variants")
    finally:
        sys.path.remove(str(TOOLS))
    text = (CSRC / "block_sparse_attention.cu").read_text()
    start = text.index("bsa_bwd_kernel(const __grid_constant__")
    assert var.VARIANTS["base"] is None and len(var.VARIANTS) > 1
    for name, variant in var.VARIANTS.items():
        if variant is not None:
            assert fc.plant(text, variant) != text, name
            assert all(at > start for at in _site_offsets(
                text, fc._as_fault(variant))), name
    assert var.PLAN_VARIANTS == ("reversed", "pole_cut")


PACKAGE = TOOLS.parent / "paddle_tpu_torch"
# the checks that count kernel launches: on the CPU the wrappers take
# their plain versions and count none, so these fail there by design
LAUNCH_CHECKS = ("launches", "verify launches", "draft prefill")
REHEARSAL = """
import dataclasses, json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from paddle_tpu_torch.models import llama as tl
torch.set_num_threads(1)
cfg = tl.LlamaConfig.tiny(num_hidden_layers=2, hidden_size=128,
                          num_attention_heads=1, num_key_value_heads=1,
                          dtype=torch.bfloat16)
params = tl.init_params(cfg, seed=0, device="cpu")
cs.SHALLOW_DRAFT = 1           # the two-layer model's truncated draft
res = cs.fault_legs(cfg, {k: v.float() for k, v in params.items()},
                    device="cpu")
print(json.dumps({g.replace("1-layer", "16-layer"): c
                  for g, c in res.items()}))
"""


@pytest.fixture(scope="module")
def serve_tool():
    sys.path.insert(0, str(TOOLS))
    try:
        yield importlib.import_module("serve_fault_check")
    finally:
        sys.path.remove(str(TOOLS))


def test_serve_faults_plant_on_the_current_modules(tools, serve_tool):
    """Every fault of ``tools/serve_fault_check.py`` plants in the current
    module it names and names the runs and checks it must fail."""
    _, fc = tools
    faults = serve_tool.FAULTS
    assert faults["none"] is None and len(faults) == 7
    for name, fault in faults.items():
        if fault is None:
            continue
        module, spec = fault
        text = (PACKAGE / module).read_text()
        assert fc.plant(text, spec) != text, name
        assert spec.must_fail and spec.cases, name


@pytest.mark.parametrize("fault", ["none", "verify_kv_len", "cow_skipped",
                                   "rewind_kept", "insert_at_admit",
                                   "decode_wrong_row", "page_freed_early"])
def test_serve_faults_caught_by_phase9_checks_on_cpu(serve_tool, fault,
                                                     tmp_path):
    """The fault runs (``chip_smoke.fault_legs``: phase 9's, and phase
    11's gather run) at a tiny size on the CPU, in a planted copy as the
    tool makes it: the unmodified engine passes every check but the launch
    counts, and each planted fault fails a check it names by at least
    CATCH_FACTOR (the gather faults in the gather run's tokens)."""
    import json
    import subprocess
    copy = serve_tool.planted_copy(str(TOOLS.parent),
                                   serve_tool.FAULTS[fault])
    try:
        script = tmp_path / "rehearse.py"
        script.write_text(REHEARSAL)
        proc = subprocess.run([sys.executable, str(script), copy],
                              capture_output=True, text=True, timeout=600)
    finally:
        import shutil
        shutil.rmtree(copy, ignore_errors=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for cases in res.values():
        for case in LAUNCH_CHECKS:
            if case in cases:
                assert cases.pop(case)[0] == 0, case
    caught = serve_tool.verdict({fault: serve_tool.FAULTS[fault]},
                                {fault: res})[fault]
    if fault == "none":
        assert not any(caught.values()), res
    else:
        assert caught and all(caught.values()), res
