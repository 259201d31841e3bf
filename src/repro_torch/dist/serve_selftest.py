"""Paged-cache mesh placement selftest over gloo ranks on the CPU.

    PYTHONPATH=src python -m repro_torch.dist.serve_selftest

The port of the reference's ``dist/serve_selftest.py``.  Checks, on 8
ranks as a 2x4 ``("x", "y")`` mesh:
  * ``solve_page_placement`` routes the decode-attention algebra
    (batched_gemv) through the partition solver and yields a page-axis
    spec on the batch-carrying mesh axis;
  * ``place_pools`` places every page pool over that axis (page axis
    padded to the axis size, scratch page kept): each rank keeps its
    block of pages;
  * continuous decode over the PLACED pools stays bit-identical to the
    unsharded slot engine, insert/evict churn included, and the engine
    is not rebuilt.
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

SHAPE = (2, 4)
AXES = ("x", "y")


def _drive(eng, prompts, steps=6):
    """Insert two requests, decode, evict one mid-flight, decode on —
    returns the packed per-step results."""
    out = []
    eng.insert(prompts[0], max_new_tokens=steps + 1)
    eng.insert(prompts[1], max_new_tokens=steps + 1)
    for t in range(steps):
        out.append(np.asarray(eng.step().data))
        if t == steps // 2:
            eng.evict(1)                   # churn: no drain, no rebuild
    return out


def churn(eng, prompts, want, steps=6):
    """Evict every live slot, then drive again: the results must repeat
    ``want`` and the engine must build no new decode step.  Returns the
    step builds after the drive."""
    for slot in eng.live_slots():
        eng.evict(slot)
    steady = eng.decode_compiles
    got = _drive(eng, prompts, steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.decode_compiles == steady, (steady, eng.decode_compiles)
    return steady


def ranks(arch: str = "granite-8b") -> list:
    """Every rank: the unsharded engine's drive, then the placed engine's
    and its churn; rank 0's lines."""
    from ..configs import get_config
    from ..launch.mesh import make_mesh
    from ..models import init_params
    from ..serve import SlotEngine, place_pools, solve_page_placement

    lines = []
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (s,)).astype(np.int32)
               for s in (9, 14)]

    def build():
        return SlotEngine(params, cfg, capacity=4, max_context=32,
                          page_size=8, device="cpu")

    want = _drive(build(), prompts)

    eng = build()
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    sol, spec = solve_page_placement(cfg, eng.cache.layout, axes=AXES,
                                     shape=SHAPE, device="cpu")
    assert spec[0] in AXES and spec[1] is None and spec[2] is None, spec
    lines.append(f"page placement: strategy={sol.strategy} spec={spec}")

    total = eng.cache.layout.total_pages + 1
    place_pools(eng.cache, mesh, spec)
    pl = eng.cache.placement
    axis = dict(zip(AXES, SHAPE))[spec[0]]
    assert pl.shards == axis and pl.pages * axis >= total
    for path, pool in eng.cache.pools.items():
        # the rank's block, its zero page and its sink page
        assert pool.shape[0] == pl.pages + 2 < total, (path, pool.shape)
    lines.append(f"pools placed over '{spec[0]}' ({len(eng.cache.pools)} "
                 f"pools, page axis padded to x{axis}: {pl.pages} of "
                 f"{pl.pages * axis} pages a rank)")

    got = _drive(eng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lines.append(f"sharded continuous decode bit-matches unsharded "
                 f"({len(got)} steps)")

    steady = churn(eng, prompts, want)
    lines.append(f"insert/evict churn on the sharded engine: compiles "
                 f"stable at {steady}")
    # every rank got here with the same bits: one more all_gather says so
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, [g.tolist() for g in got])
    assert all(o == outs[0] for o in outs), "ranks decoded apart"
    lines.append("serve placement selftest OK")
    return lines


def placed_gather(spec_axis: str, dtype: torch.dtype) -> dict:
    """A random cache with NaN and -0.0 in its pools, placed over
    ``spec_axis`` of the 2x4 mesh: its gathered views against the
    unplaced gather's, as raw bytes, and the rank's pool geometry."""
    from ..dist.comm_engine import Spec
    from ..launch.mesh import make_mesh
    from ..serve.pages import PagedKVCache, place_pools

    template = {"self": {"k": torch.zeros((2, 3, 16, 6), dtype=dtype),
                         "v": torch.zeros((2, 3, 16, 6), dtype=dtype)}}
    cache = PagedKVCache(template, capacity=3, page_size=4, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for pool in cache.pools.values():
        pool.copy_(torch.randn(pool.shape, generator=gen).to(dtype))
        pool[2, 0, 0] = -0.0
        pool[5, 1, 1] = float("nan")
    pages = cache.layout.total_pages + 1
    table = torch.randint(0, pages, (3, 4), generator=gen,
                          dtype=torch.int32)
    whole = {k: v.clone() for k, v in cache.pools.items()}
    want = cache.layout.gather_views(whole, table)
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    place_pools(cache, mesh, Spec(spec_axis, None, None))
    got = cache.gather_views(table)
    pl = cache.placement
    return {"equal": all(torch.equal(got[k].contiguous().view(torch.uint8),
                                      want[k].contiguous().view(torch.uint8))
                         for k in want),
            "pages": pl.pages, "shards": pl.shards, "lo": pl.lo,
            "pool": tuple(next(iter(cache.pools.values())).shape),
            "block_equal": all(torch.equal(
                cache.pools[k][:max(0, min(pl.pages, pages - pl.lo))].view(
                    torch.uint8),
                whole[k][pl.lo:pl.lo + pl.pages].view(torch.uint8))
                for k in whole),
            "spare_zero": all(not cache.pools[k][
                max(0, min(pl.pages, pages - pl.lo)):].any() for k in whole)}


def battery() -> dict:
    """The test world: the selftest's drive (:func:`ranks`) and
    :func:`placed_gather` over each axis in fp32 and bf16; every rank's
    records on rank 0."""
    rec = {"lines": ranks(), "gather": {}}
    for axis in AXES:
        for dtype in (torch.float32, torch.bfloat16):
            rec["gather"][f"{axis}/{dtype}"] = placed_gather(axis, dtype)
    rec["coord"] = dict(zip(AXES, divmod(dist.get_rank(), SHAPE[1])))
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, rec)
    return outs


def main() -> int:
    from . import spawn
    for line in spawn.run_ranks(ranks, SHAPE[0] * SHAPE[1], device="cpu",
                                timeout=300):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
