"""The fused megakernels' launch plan (``kernels/fused_chain.py``:
``launch_plan``), the host-side half of ``csrc/fused_chain.cu``: every
stage runs in a phase after every stage it reads (lhs, rhs and
residual), the stages of one dependency level share a phase, each
stage's work items cover each output exactly once with k splits on
whole slabs, the fp32 workspace holds each level's split partials and
softmax rows without overlap, the table layout and the slab depth agree
with the CUDA source, and scratch buffers start on 16-byte boundaries.
CPU only: nothing here compiles or launches a kernel."""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tiling import ArrayConfig  # noqa: E402
from repro_torch.graph import from_model, plan_graph  # noqa: E402
from repro_torch.kernels import fused_chain as fc  # noqa: E402

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"
D = fc.DagStage


def _danube_layer(l=512):
    plan = plan_graph(from_model.layer_graph_from_config(
        get_config("h2o-danube-1.8b"), l=l),
        cfg=ArrayConfig(strip_budget_bytes=512 << 20))
    (group,) = [g for g in plan.groups if g.dag]
    return group.dag


def _mixed():
    """A DAG whose reads reach back past the previous stage, through a
    residual only, and into a batched stage's output."""
    return (D(40, 24, 36, lhs=("ext", 0), rhs=("ext", 1)),
            D(40, 24, 36, lhs=("ext", 0), rhs=("ext", 2), tap=0),
            D(40, 36, 36, lhs=("ext", 3), rhs=("ext", 4), res=("scr", 1)),
            D(40, 36, 40, lhs=("scr", 0), rhs=("scr", 2),
              epilogue=("softmax",)),
            D(40, 24, 36, kind="batched", lhs=("ext", 5), rhs=("ext", 6)),
            D(40, 40, 36, lhs=("scr", 3), rhs=("ext", 7), res=("scr", 4)))


def _cases():
    chain = (fc.ChainStage(2560, 6912, ("bias", "gelu"), True),
             fc.ChainStage(6912, 2560))
    small = (fc.ChainStage(96, 160, ("bias", "gelu"), True),
             fc.ChainStage(160, 72, ("scale:0.1", "softmax")),
             fc.ChainStage(72, 130, ("relu",)))
    return {"danube layer l=512": _danube_layer(),
            "danube layer l=64": _danube_layer(64),
            "danube MLP chain": fc.chain_as_dag(chain, 512),
            "small chain": fc.chain_as_dag(small, 200),
            "mixed": _mixed()}


CASES = _cases()


def _reads(st):
    return [src[1] for src in (st.lhs, st.rhs, st.res)
            if src is not None and src[0] == "scr"]


@pytest.mark.parametrize("sms", [132, 16, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_every_stage_runs_after_what_it_reads(case, sms):
    stages = CASES[case]
    plan = fc.launch_plan(stages, sms)
    phase_of = {}
    for p, (first, end, _, _) in enumerate(plan.phases):
        for j in plan.order[first:end]:
            phase_of[j] = p
    assert sorted(phase_of) == list(range(len(stages)))
    for j, st in enumerate(stages):
        assert phase_of[j] == plan.stages[j].level
        for i in _reads(st):
            assert phase_of[i] < phase_of[j], (i, j)
        # the first phase after the last one it reads
        assert plan.stages[j].level == 1 + max(
            (plan.stages[i].level for i in _reads(st)), default=-1)


def test_a_residual_alone_orders_a_stage():
    levels = fc.dependency_levels(_mixed())
    assert levels == (0, 0, 1, 2, 0, 3)


def test_danube_layer_shares_level_zero():
    plan = fc.launch_plan(CASES["danube layer l=512"], 132, 1)
    assert plan.grid == 132
    assert [sp.level for sp in plan.stages] == [0, 0, 0, 1, 2, 3, 4, 5]
    assert len(plan.phases) == 6
    first, end, items, post = plan.phases[0]
    assert (end - first, items, post) == (3, 240, 0)
    # scores' softmax rows follow their level's sync
    assert plan.phases[1][3] == 1 and plan.stages[3].part >= 0


def _coverage(st, sp, m_fast):
    """Per output, the k extents its items sum (the kernel's numbering:
    split-major, then the tile raster)."""
    tile = sp.tile
    tiles_m, tiles_n = -(-st.m // tile), -(-st.n // tile)
    got = np.zeros((st.m, st.n), np.int64)
    hits = np.zeros((st.m, st.n), np.int64)
    for item in range(sp.items):
        split, w = divmod(item, tiles_m * tiles_n)
        tm, tn = ((w % tiles_m, w // tiles_m) if m_fast
                  else (w // tiles_n, w % tiles_n))
        kb = split * sp.k_chunk
        ke = min(st.k, kb + sp.k_chunk)
        assert kb < ke
        got[tm * tile:(tm + 1) * tile, tn * tile:(tn + 1) * tile] += ke - kb
        hits[tm * tile:(tm + 1) * tile, tn * tile:(tn + 1) * tile] += 1
    return got, hits


@pytest.mark.parametrize("m_fast", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_items_cover_each_output_once(case, m_fast):
    stages = CASES[case]
    plan = fc.launch_plan(stages, 132)
    for first, end, items, _ in plan.phases:
        rows = [plan.stages[j] for j in plan.order[first:end]]
        dots = [sp for sp in rows if sp.tile]
        assert [sp.item0 for sp in dots] == list(
            np.cumsum([0] + [sp.items for sp in dots])[:-1])
        assert items == sum(sp.items for sp in dots)
        # batched rows follow the dot rows and hold no item
        assert all(sp.items == 0 and sp.item0 == items
                   for sp in rows[len(dots):])
    for st, sp in zip(stages, plan.stages):
        if st.kind == "batched":
            assert sp.tile == 0
            continue
        assert sp.tile in fc.TILES
        assert sp.items == sp.split * -(-st.m // sp.tile) * -(-st.n //
                                                             sp.tile)
        k_sum, hits = _coverage(st, sp, m_fast)
        assert (k_sum == st.k).all() and (hits == sp.split).all()


@pytest.mark.parametrize("case", list(CASES))
def test_splits_fall_on_slabs_and_the_workspace_holds_every_part(case):
    stages = CASES[case]
    plan = fc.launch_plan(stages, 132)
    spans = {}
    for st, sp in zip(stages, plan.stages):
        assert sp.k_chunk % fc.SLAB_K == 0
        assert (sp.split - 1) * sp.k_chunk < st.k <= sp.split * sp.k_chunk
        assert 1 <= sp.split <= fc.MAX_SPLIT
        needs = sp.split > 1 or fc._ep.has_softmax(st.epilogue)
        assert (sp.part >= 0) == needs
        if needs:
            plane = -(-st.m * st.n // 4) * 4
            assert sp.part % 4 == 0
            spans.setdefault(sp.level, []).append(
                (sp.part, sp.part + sp.split * plane))
    # a level's parts are dead after its grid sync: no overlap within a
    # level, and each level's start at 0
    for level in spans.values():
        level.sort()
        assert level[0][0] == 0
        assert all(a[1] <= b[0] for a, b in zip(level, level[1:]))
    assert plan.ws_elems == max((level[-1][1] for level in spans.values()),
                                default=0)
    # post phases exactly where a sum or a softmax row waits
    for first, end, _, post in plan.phases:
        assert post == int(any(plan.stages[j].part >= 0
                               for j in plan.order[first:end]))


def test_wide_levels_keep_whole_tiles_and_narrow_ones_split():
    plan = fc.launch_plan(CASES["danube MLP chain"], 132)
    up, down = plan.stages
    assert (up.tile, up.split) == (128, 1)         # 216 tiles: a wave
    assert down.split > 1                          # 80 tiles: under one
    # one SM: every level fills its wave, nothing splits
    plan = fc.launch_plan(CASES["danube layer l=512"], 1)
    assert all((sp.tile, sp.split) == (128, 1) for sp in plan.stages)


def test_plan_is_cached_per_stage_list():
    stages = CASES["danube layer l=512"]
    assert fc._cached_plan(stages, 132, 1) is fc._cached_plan(
        tuple(stages), 132, 1)
    assert fc._cached_plan(stages, 132, 1) == fc.launch_plan(stages, 132, 1)


def test_describe_names_every_stage():
    text = fc.launch_plan(CASES["mixed"], 132).describe()
    assert text.startswith("grid 132 CTAs, 4 phases")
    for j in range(len(CASES["mixed"])):
        assert f"s{j} " in text
    assert "s4 batched" in text


# ---------------------------------------------------------------------------
# the host-side layout against csrc/
# ---------------------------------------------------------------------------

def _enum(name, path="fused_chain.cu"):
    src = (CSRC / path).read_text()
    body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
    return re.sub(r"//[^\n]*", "", body)


def test_stage_table_fields_match_the_kernel():
    names = re.findall(r"\bF_(\w+)", _enum("Field"))
    words = names[:names.index("NOPS") + 1]
    assert [w.lower().replace("_", "") for w in words] == [
        f.replace("_", "") for f in fc.FIELDS]
    phase = re.findall(r"\bP_(\w+)", _enum("PhaseField"))
    assert phase == ["FIRST", "END", "ITEMS", "POST"]
    assert fc.PHASE_WORDS == len(phase)


def test_slab_depth_matches_simt_tile():
    src = (CSRC / "simt_tile.cuh").read_text()
    assert int(re.search(r"constexpr int SLAB_K = (\d+);", src).group(1)) \
        == fc.SLAB_K


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_scratch_buffers_start_on_16_bytes(dtype):
    shapes = [(3, 5), (7, 3), (2, 2), (1, 1), (4, 6)]
    views = fc._scratch(shapes, dtype, "cpu")
    assert [tuple(v.shape) for v in views] == shapes
    ends = []
    for v in views:
        assert v.data_ptr() % fc.SCRATCH_ALIGN == 0
        assert v.is_contiguous()
        ends.append((v.data_ptr(), v.data_ptr() + v.numel()
                     * v.element_size()))
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
