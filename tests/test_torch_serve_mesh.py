"""Serving over a mesh on the CPU: page pools placed by the partition
solver (``serve.pages.solve_page_placement`` / ``place_pools``) and the
slot engine decoding over them.

``solve_page_placement``'s strategy and spec equal the reference's for
reduced granite-8b at 2x4, 4x2 and 2x2 (the reference's solver needs no
devices: it runs in this process).  One world of 8 gloo ranks on a 2x4
``("x", "y")`` mesh (``dist.serve_selftest.battery``) runs the
selftest's drive — two requests, an eviction mid-flight, then insert /
evict churn — which must be bit-identical to the unsharded engine with
the decode step built once, and gathers a cache with NaN and -0.0 in
its pools through placements over each axis, fp32 and bf16: the
assembled views must equal the unplaced gather byte for byte, each rank
holding only its block of pages (padded page axis, scratch page kept)
plus its zero and sink pages.
"""
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.serve import solve_page_placement as ref_solve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import serve_selftest, spawn  # noqa: E402
from repro_torch.serve import solve_page_placement  # noqa: E402

LAYOUT = types.SimpleNamespace(capacity=4, seq_len=32)


@pytest.fixture(scope="module")
def world():
    return spawn.run_ranks(serve_selftest.battery, 8, device="cpu",
                           timeout=240)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2)])
def test_page_placement_matches_the_reference(shape):
    sol, spec = solve_page_placement(get_config("granite-8b").reduced(),
                                     LAYOUT, axes=("x", "y"), shape=shape,
                                     device="cpu")
    rsol, rspec = ref_solve(ref_config("granite-8b").reduced(), LAYOUT,
                            axes=("x", "y"), shape=shape)
    assert sol.strategy == rsol.strategy
    assert str(spec) == str(rspec)
    assert tuple(spec) == tuple(rspec)
    assert spec[0] in ("x", "y") and spec[1] is None and spec[2] is None


def test_selftest_decode_over_placed_pools_is_bit_identical(world):
    lines = world[0]["lines"]
    assert lines[-1] == "serve placement selftest OK"
    assert any(ln.startswith("sharded continuous decode bit-matches")
               for ln in lines)
    assert "compiles stable at 1" in lines[-2]
    assert all(rec["lines"] == lines for rec in world)


@pytest.mark.parametrize("key", [f"{a}/{d}" for a in ("x", "y")
                                 for d in ("torch.float32",
                                           "torch.bfloat16")])
def test_placed_gather_is_a_byte_copy(world, key):
    for rec in world:
        g = rec["gather"][key]
        assert g["equal"], (rec["coord"], key)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_place_pools_pads_and_keeps_the_rank_block(world, axis):
    n = {"x": 2, "y": 4}[axis]
    pages = 3 * 4 + 1                       # capacity x pages a slot + scratch
    per = -(-pages // n)
    los = set()
    for rec in world:
        g = rec["gather"][f"{axis}/torch.float32"]
        assert g["shards"] == n and g["pages"] == per
        assert g["lo"] == rec["coord"][axis] * per
        assert g["pool"][0] == per + 2      # the block, zero and sink pages
        assert g["block_equal"] and g["spare_zero"]
        los.add(g["lo"])
    # the blocks tile the padded page axis, which keeps the scratch page
    assert sorted(los) == [i * per for i in range(n)]
    assert n * per >= pages and (n * per) % n == 0


def test_placement_needs_its_mesh_and_is_exact_per_rank(world):
    # every rank of the mesh reports the same drive
    assert len(world) == 8
    assert {tuple(sorted(r["coord"].items())) for r in world} == {
        (("x", i), ("y", j)) for i in range(2) for j in range(4)}
