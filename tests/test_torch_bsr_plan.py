"""The BSR kernel's launch plan (``kernels/bsr_gemm.launch_plan``): the
tile and grid at the main path's sparse shapes, the work order (a
permutation of every (block-row, sub-tile) item, heaviest block-row
first, stable, empty rows last), sub-tiles inside their block-row, the
staging rule for slabs that start at block offsets, and what the wrapper
hands the kernel.  CPU only: pure Python, no kernel is built."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core.algebra import Sparsity  # noqa: E402
from repro_torch.kernels import _build, bsr_gemm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: chip_smoke.py's sparse cases -> (tile, sub-tiles, CTAs)
MAIN_PATH = {"gemm A d=0.25": (128, 1, 1024), "gemm A d=1.0": (128, 1, 1024),
             "gemm B d=0.25": (128, 1, 1024),
             "conv2d B d=0.25": (64, 1, 16),
             "mttkrp A d=0.25": (64, 2, 256)}


def _main_path_pattern(label):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    (_, name, tensor, shape, block, density), = (
        c for c in chip_smoke.SPARSE if c[0] == label)
    acc = repro_torch.generate(
        name, "output_stationary", bounds=chip_smoke.SIZES[name],
        sparsity={tensor: Sparsity.random(shape, block, density, seed=0)},
        device="cpu", validate=False)
    return chip_smoke.bsr_pattern(acc.kernel)


@pytest.mark.parametrize("label", sorted(MAIN_PATH))
def test_main_path_tiles_and_grids(label):
    coords, bm, bk, m, n = _main_path_pattern(label)
    plan = bsr_gemm.launch_plan(coords, bm, bk, m, n)
    assert (plan.tile, plan.subtiles, plan.ctas) == MAIN_PATH[label]
    # every main-path operand keeps 16-byte staging loads
    assert plan.k_vec and plan.m_vec


def _random_coords(rows, cols, seed, empty=()):
    rng = np.random.default_rng(seed)
    return bsr_gemm.sort_coords(
        (r, c) for r in range(rows) if r not in empty
        for c in range(cols) if rng.random() < rng.random())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bm", [16, 64, 128, 256, 320])
def test_order_is_a_stable_heaviest_first_permutation(bm, seed):
    rows, cols = 9, 7
    coords = _random_coords(rows, cols, seed, empty={1, 4 + seed % 3})
    plan = bsr_gemm.launch_plan(coords, bm, 32, rows * bm, 300)
    items = rows * plan.subtiles
    assert sorted(plan.order) == list(range(items))
    nnz = [sum(1 for r, _ in coords if r == row) for row in range(rows)]
    assert list(plan.row_nnz) == nnz
    keys = [(-nnz[i // plan.subtiles], i) for i in plan.order]
    assert keys == sorted(keys)          # by count, ties in raster order
    empty = [i for i in plan.order if nnz[i // plan.subtiles] == 0]
    assert plan.order[len(plan.order) - len(empty):] == tuple(empty)
    assert len(empty) >= 2 * plan.subtiles


def test_raster_order_and_unknown_orders():
    coords = _random_coords(5, 4, 0)
    plan = bsr_gemm.launch_plan(coords, 128, 64, 640, 256, order="raster")
    assert plan.order == tuple(range(5 * plan.subtiles))
    with pytest.raises(ValueError, match="order"):
        bsr_gemm.launch_plan(coords, 128, 64, 640, 256, order="lightest")


@pytest.mark.parametrize("bm", [4, 6, 64, 96, 128, 192, 384])
def test_sub_tiles_never_straddle_a_block_row(bm):
    rows, n = 3, 64
    plan = bsr_gemm.launch_plan(_random_coords(rows, 2, bm), bm, 8,
                                rows * bm, n)
    assert plan.subtiles * plan.tile >= bm > (plan.subtiles - 1) * plan.tile
    for i in plan.order:
        brow, sub = divmod(i, plan.subtiles)
        first = brow * bm + sub * plan.tile
        assert brow * bm <= first < (brow + 1) * bm


@pytest.mark.parametrize("rows, n, tile", [
    (12, 1408, 128),   # 12 x 11 = 132 CTAs: one wave of the card
    (12, 1280, 64),    # 12 x 10 = 120: under a wave
    (1, 16896, 128),   # 132 n tiles of one block-row
])
def test_wide_tile_takes_a_wave(rows, n, tile):
    plan = bsr_gemm.launch_plan(_random_coords(rows, 3, 1), 128, 64,
                                rows * 128, n)
    assert plan.tile == tile
    assert plan.ctas == rows * (128 // tile) * -(-n // tile)


@pytest.mark.parametrize("bm", [192, 64, 32, 8])
def test_narrow_tile_where_128_does_not_divide_the_block(bm):
    # 40 block-rows x 12 n tiles would fill the card at 128
    plan = bsr_gemm.launch_plan(_random_coords(40, 2, 2), bm, 64, 40 * bm,
                                1536)
    assert plan.tile == 64
    assert plan.subtiles == -(-bm // 64)


@pytest.mark.parametrize("bm, bk, k_vec, m_vec", [
    (128, 128, True, True), (64, 144, True, True), (64, 18, False, True),
    (4, 16, True, True), (6, 16, True, False), (6, 18, False, False),
])
def test_staging_rule_folds_in_the_block_offsets(bm, bk, k_vec, m_vec):
    # a slab of block c starts at k = c * bk, a block-row at m = r * bm:
    # 16-byte loads along an axis need its block edge in whole 4-steps
    plan = bsr_gemm.launch_plan(((0, 0), (1, 1)), bm, bk, 2 * bm, 64)
    assert (plan.k_vec, plan.m_vec) == (k_vec, m_vec)


def test_describe_names_tile_grid_and_order_head():
    coords = bsr_gemm.sort_coords([(0, 0), (2, 0), (2, 1), (2, 3)])
    text = bsr_gemm.launch_plan(coords, 64, 32, 256, 100).describe()
    assert text.startswith("tile 64, 8 CTAs (4 items x 2 n tiles)")
    assert "order head r2:3 r0:1 r1:0 r3:0" in text


def test_wrapper_hands_the_kernel_the_plan_and_a_cached_order(monkeypatch):
    # the launch on a card, with the library and the card stubbed: the
    # plan's tile and staging flags, and one order array for every call
    calls = []

    class FakeLib:
        def bsr_launch(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(_build, "library", lambda stem: FakeLib())
    monkeypatch.setattr(bsr_gemm, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(bsr_gemm, "_stream", lambda: 0)
    m, k, n, bm, bk = 256, 108, 40, 64, 18
    coords = _random_coords(m // bm, k // bk, 3)
    sparse, dense = torch.zeros((m, k)), torch.zeros((k, n))
    csr = bsr_gemm.csr_arrays(coords, m // bm, sparse.device)
    for _ in range(2):
        bsr_gemm.bsr_matmul(sparse, dense, coords=coords, bm=bm, bk=bk,
                            bn=128, csr=csr)
    plan = bsr_gemm.launch_plan(coords, bm, bk, m, n)
    order = bsr_gemm._order_array(plan, sparse.device)
    assert order.dtype == torch.int32 and tuple(order.tolist()) == plan.order
    assert len(calls) == 2
    for args in calls:
        assert len(args) == len(_build.SIGNATURES["bsr_gemm"]["bsr_launch"])
        assert args[10] == order.data_ptr()
        assert args[11:18] == (m, n, bm, bk, plan.tile, 0, 1)
