"""The port's serving stack on the CPU: paged cache, slot engine, async
server, and the decode engine against the reference's.

The port's own copies of the reference's ``tests/test_serve.py`` cases
(mesh placement aside, which arrives with the mesh slice), run with
``device="cpu"``, where the paged gather runs its plain version; plus
greedy ``DecodeEngine.generate`` held token for token to the reference
engine on the same parameters (``convert.params_from_reference``).
Reduced configs (``.reduced()``: 2 layers (the hybrid and the vlm 4),
d=64, head_dim 16, SWA 16, SSM state 16, 4 experts, 16 frontend tokens);
the moe, encdec and vlm families are also served through the slot
engine and the server, each request with its own frontend array, and
their tokens held to the reference's ``DecodeEngine``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import split  # noqa: E402
from repro.serve import DecodeEngine as RefDecodeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import paged as paged_kernels  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import (ContinuousServer, DecodeEngine,  # noqa: E402
                               PagedKVCache, ServeConfig, SlotEngine,
                               place_pools, serve_entry,
                               solve_page_placement, validate_serve)
from repro_torch.serve.slots import ResultTokens  # noqa: E402

CPU = "cpu"
_PARAMS = {}
#: the families that route to experts or take a frontend
FAMILY_ARCHS = ["mixtral-8x22b", "whisper-small", "llama-3.2-vision-11b"]


def setup_arch(arch):
    """(port cfg, port fp32 params drawn from a seed; vlm gates opened to
    0.5, so the image matters)."""
    if arch not in _PARAMS:
        cfg = get_config(arch).reduced()
        params = init_params(torch.Generator().manual_seed(0), cfg)
        if cfg.family == "vlm":
            params["cross_layers"]["gate"].fill_(0.5)
        _PARAMS[arch] = (cfg, params)
    return _PARAMS[arch]


def make_frontends(cfg, n, seed=0):
    """One (F, D) frontend array a request (None where the family takes
    none)."""
    if not cfg.frontend_tokens:
        return [None] * n
    rng = np.random.default_rng(seed + 100)
    return [(0.1 * rng.standard_normal((cfg.frontend_tokens, cfg.d_model))
             ).astype(np.float32) for _ in range(n)]


def batch_frontend(fe):
    return None if fe is None else fe[None]


def make_prompts(cfg, reqs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (s,)).astype(np.int32)
            for s, _ in reqs]


# ---------------------------------------------------------------------------
# page pool accounting
# ---------------------------------------------------------------------------

def _tiny_cache(capacity=4, page_size=8, seq=32, total_pages=None):
    template = {
        "pos": 0,
        "self": {
            "k": torch.empty((2, capacity, seq, 16), device="meta"),
            "v": torch.empty((2, capacity, seq, 16), device="meta")},
    }
    return PagedKVCache(template, capacity=capacity, page_size=page_size,
                        total_pages=total_pages, device=CPU)


def test_page_pool_alloc_free_roundtrip():
    cache = _tiny_cache(total_pages=8)     # 4 slots x 4 pages/slot max
    assert cache.free_pages == 8
    assert cache.alloc(0, 9)               # 9 positions -> 2 pages
    assert cache.free_pages == 6
    assert (cache.table[0] != cache.layout.scratch_page).sum() == 2
    cache.free(0)
    assert cache.free_pages == 8
    assert (cache.table[0] == cache.layout.scratch_page).all()


def test_page_pool_oversubscription_refused():
    cache = _tiny_cache(total_pages=5)
    assert cache.alloc(0, 32)              # 4 pages
    assert not cache.alloc(1, 32)          # would need 4, only 1 left
    assert cache.alloc(1, 8)               # 1 page still fits
    assert cache.free_pages == 0
    assert not cache.can_alloc(1)
    cache.free(0)
    assert cache.can_alloc(32)


def test_page_pool_double_alloc_refused():
    cache = _tiny_cache()
    assert cache.alloc(0, 8)
    assert not cache.alloc(0, 8)           # slot already holds pages


def test_shared_pool_long_and_short():
    """Long + short sequences draw from one pool: two full-context slots
    would not fit, but one long + two short do."""
    cache = _tiny_cache(total_pages=6)
    assert cache.alloc(0, 32)              # 4 pages (long)
    assert not cache.alloc(1, 32)
    assert cache.alloc(1, 8)               # 1 page (short)
    assert cache.alloc(2, 8)
    assert cache.free_pages == 0


def test_pages_needed_rolling_view_takes_every_page():
    cache = _tiny_cache()
    assert cache.pages_needed(17) == 3
    assert cache.pages_needed(32) == 4
    assert cache.pages_needed(100) == 4    # a rolling view cycles pages


def test_pools_layout_and_device_table_is_a_copy():
    cache = _tiny_cache(total_pages=6)
    lay = cache.layout
    assert lay.pages_per_slot == 4 and lay.scratch_page == 6
    assert cache.pools[("self", "k")].shape == (7, 8, 32)
    assert cache.pools[("self", "k")].dtype == torch.float32
    assert cache.alloc(1, 16)
    table = cache.device_table()
    assert table.dtype == torch.int32 and table.shape == (4, 4)
    cache.free(1)
    assert (table[1, :2] != lay.scratch_page).all()


def test_insert_gather_and_scatter_round_trip():
    """insert -> gather_views gives the inserted dense cache back (the
    unmapped tail reads the scratch page); scatter_written writes only
    live slots' rows, inactive ones land on the scratch page."""
    cache = _tiny_cache(capacity=2, total_pages=6)
    lay = cache.layout
    rng = np.random.default_rng(0)
    leaf = {n: torch.as_tensor(rng.standard_normal((2, 1, 32, 16)).astype(
        np.float32)) for n in ("k", "v")}
    assert cache.alloc(1, 20)              # 3 pages
    cache.insert(1, {"pos": 20, "self": leaf})
    views = lay.gather_views(cache.pools, cache.device_table())
    v = views[("self", "k")]
    assert v.shape == (2, 2, 32, 16) and not v.is_contiguous()
    assert torch.equal(v[:, 1, :24], leaf["k"][:, 0, :24])
    new = {p: x.clone() for p, x in views.items()}
    for p in new:
        new[p][:, :, 21] = 7.0
    pos = torch.tensor([21, 21])
    active = torch.tensor([False, True])
    before = cache.pools[("self", "v")].clone()
    lay.scatter_written(cache.pools, cache.device_table(), new, pos, active)
    after = cache.pools[("self", "v")]
    pid = int(cache.table[1, 21 // 8])
    assert (after[pid, 21 % 8] == 7.0).all()
    changed = (after != before).any(dim=-1).nonzero().tolist()
    assert sorted(map(tuple, changed)) == [(pid, 5), (lay.scratch_page, 5)]


def test_insert_without_pages_raises():
    cache = _tiny_cache()
    with pytest.raises(ValueError, match="no pages"):
        cache.insert(0, {"self": {}})


def test_mesh_placement_arrives_with_the_mesh_slice():
    # the model-mesh slice has arrived: placement solves through the
    # partition solver, and pools placed on a one-rank mesh gather what
    # they gathered whole (``tests/test_torch_serve_mesh.py`` runs 8 ranks)
    from repro_torch.dist import spawn
    from repro_torch.launch.mesh import make_mesh
    cache = _tiny_cache()
    assert cache.alloc(0, 20) and cache.alloc(2, 9)
    gen = torch.Generator().manual_seed(5)
    for pool in cache.pools.values():
        pool.copy_(torch.randn(pool.shape, generator=gen))
    _, spec = solve_page_placement(get_config("granite-8b").reduced(),
                                   cache.layout, device="cpu")
    assert spec[0] in ("x", "y") and spec[1] is None and spec[2] is None
    table = cache.device_table()
    want = cache.gather_views(table)
    with spawn.single_rank(device="cpu"):
        place_pools(cache, make_mesh((1, 1), ("x", "y"), device="cpu"),
                    spec)
        got = cache.gather_views(table)
    assert cache.placement.shards == 1
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# decode engine: the reference's tokens, per-instance config
# ---------------------------------------------------------------------------

def ref_params(arch):
    """(reference cfg, its params as numpy, vlm gates opened to 0.5)."""
    cfg = ref_config(arch).reduced()
    jp = jax.tree.map(np.asarray, split(
        ref_init_params(jax.random.PRNGKey(0), cfg))[0])
    if cfg.family == "vlm":
        jp["cross_layers"]["gate"] = np.full_like(jp["cross_layers"]["gate"],
                                                  0.5)
    return cfg, jp


@pytest.mark.parametrize("arch", ["granite-8b", "h2o-danube-1.8b"]
                         + FAMILY_ARCHS)
def test_decode_engine_greedy_tokens_equal_reference(arch):
    cfg, jp = ref_params(arch)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    fe = (None if not cfg.frontend_tokens else
          np.stack(make_frontends(cfg, 2, seed=1)))
    want, wstats = RefDecodeEngine(jp, cfg).generate(prompts, frontend=fe,
                                                     max_new_tokens=10)
    eng = DecodeEngine(params_from_reference(jp, device=CPU),
                       get_config(arch).reduced(), device=CPU)
    got, stats = eng.generate(prompts, frontend=fe, max_new_tokens=10)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats


def test_serve_config_default_is_per_instance():
    cfg, params = setup_arch("granite-8b")
    a = DecodeEngine(params, cfg, device=CPU)
    b = DecodeEngine(params, cfg, device=CPU)
    a.serve_cfg.max_new_tokens = 3
    assert b.serve_cfg.max_new_tokens == ServeConfig().max_new_tokens
    assert a.serve_cfg is not b.serve_cfg


def test_decode_engine_eos_and_cache_len_checks():
    cfg, params = setup_arch("granite-8b")
    p = np.arange(6, dtype=np.int32)[None] % cfg.vocab
    first = DecodeEngine(params, cfg, device=CPU).generate(
        p, max_new_tokens=4)[0][0, 0]
    eng = DecodeEngine(params, cfg, ServeConfig(eos_id=int(first)),
                       device=CPU)
    out, stats = eng.generate(p, max_new_tokens=4)
    assert out.tolist() == [[int(first)]] and stats["generated"] == 1
    with pytest.raises(ValueError, match="cache_len"):
        eng.generate(p, max_new_tokens=4, cache_len=8)


def test_temperature_sampling_is_seeded():
    cfg, params = setup_arch("granite-8b")
    p = np.arange(6, dtype=np.int32)[None] % cfg.vocab
    runs = [DecodeEngine(params, cfg, ServeConfig(temperature=1.0, seed=s),
                         device=CPU).generate(p, max_new_tokens=8)[0]
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (1, 8)
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# slot engine: bit-exact continuous decode
# ---------------------------------------------------------------------------

PARITY_ARCHS = ["granite-8b", "h2o-danube-1.8b", "mamba2-370m",
                "zamba2-1.2b"]
REQS = [(8, 6), (12, 4), (5, 8), (9, 3), (11, 6)]


def drive_continuous(eng, prompts, reqs, frontends=None):
    """Queue -> insert/step/evict until every request finished; returns
    per-request token lists."""
    frontends = frontends or [None] * len(reqs)
    got = {}
    queue = list(range(len(reqs)))
    resident, left = {}, {}
    while queue or resident:
        while queue and eng.free_slots():
            i = queue[0]
            res = eng.insert(prompts[i], max_new_tokens=reqs[i][1],
                             frontend=frontends[i])
            if res is None:
                break
            queue.pop(0)
            slot, tok = res
            got[i] = [tok]
            if reqs[i][1] == 1:
                eng.evict(slot)
            else:
                resident[slot], left[slot] = i, reqs[i][1] - 1
        if not resident:
            continue
        r = eng.step()
        for slot, i in list(resident.items()):
            if not r.valid_at(slot):
                continue
            got[i].append(r.token_at(slot))
            left[slot] -= 1
            if left[slot] == 0:
                eng.evict(slot)
                del resident[slot], left[slot]
    return [np.asarray(got[i], np.int32) for i in range(len(reqs))]


@pytest.mark.parametrize("arch", PARITY_ARCHS + FAMILY_ARCHS)
def test_slot_engine_bit_parity(arch):
    cfg, params = setup_arch(arch)
    base = DecodeEngine(params, cfg, device=CPU)
    eng = SlotEngine(params, cfg, capacity=3, max_context=32, page_size=8,
                     device=CPU)
    prompts = make_prompts(cfg, REQS)
    fes = make_frontends(cfg, len(REQS))
    want = [base.generate(p[None], frontend=batch_frontend(fe),
                          max_new_tokens=t, cache_len=32)[0][0]
            for p, fe, (_, t) in zip(prompts, fes, REQS)]
    got = drive_continuous(eng, prompts, REQS, fes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the continuous-batching contract: insert/evict never rebuilt the step
    assert eng.decode_compiles == 1


def test_slot_engine_long_decode_past_the_rolling_window():
    """danube's 16-slot rolling view: 8 + 20 tokens wrap it."""
    cfg, params = setup_arch("h2o-danube-1.8b")
    reqs = [(8, 20), (10, 12)]
    prompts = make_prompts(cfg, reqs, seed=3)
    base = DecodeEngine(params, cfg, device=CPU)
    want = [base.generate(p[None], max_new_tokens=t, cache_len=32)[0][0]
            for p, (_, t) in zip(prompts, reqs)]
    eng = SlotEngine(params, cfg, capacity=2, max_context=32, page_size=8,
                     device=CPU)
    assert eng.cache.layout.seq_len == 16
    for g, w in zip(drive_continuous(eng, prompts, reqs), want):
        np.testing.assert_array_equal(g, w)


def test_slot_engine_no_recompile_across_churn():
    cfg, params = setup_arch("granite-8b")
    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    p = np.arange(5, dtype=np.int32) % cfg.vocab
    for _ in range(3):                     # churn: insert/step/evict cycles
        slot, _ = eng.insert(p, max_new_tokens=2)
        eng.step()
        eng.evict(slot)
    assert eng.decode_compiles == 1
    assert eng.prefill_compiles == 1       # one prompt length -> one entry
    assert eng.position(0) == 0 and not eng.live_slots()


def test_slot_engine_rejects_oversized_request():
    cfg, params = setup_arch("granite-8b")
    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    with pytest.raises(ValueError, match="max_context"):
        eng.insert(np.zeros((10,), np.int32), max_new_tokens=10)


def test_slot_engine_pool_exhaustion_returns_none():
    cfg, params = setup_arch("granite-8b")
    eng = SlotEngine(params, cfg, capacity=4, max_context=32, page_size=8,
                     total_pages=4, device=CPU)  # one full-length slot
    p = np.arange(8, dtype=np.int32) % cfg.vocab
    assert eng.insert(p, max_new_tokens=24) is not None   # takes all 4
    assert eng.insert(p, max_new_tokens=8) is None        # pool exhausted
    eng.evict(0)
    assert eng.insert(p, max_new_tokens=8) is not None    # pages recycled


def test_slot_engine_other_families_raise():
    """Every registry family serves (the cases below); a family no model
    has is refused when the engine is built."""
    import dataclasses
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                              family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        SlotEngine({}, cfg, device=CPU)


def test_result_tokens_packing():
    data = np.array([[7, 1, 12], [0, 0, 0]], np.int32)
    r = ResultTokens(data)
    assert r.token_at(0) == 7 and r.valid_at(0) and r.length_at(0) == 12
    assert not r.valid_at(1)


def test_step_packs_tokens_validity_and_lengths():
    cfg, params = setup_arch("granite-8b")
    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    slot, _ = eng.insert(np.arange(5, dtype=np.int32), max_new_tokens=4)
    r = eng.step()
    assert r.data.shape == (2, 3) and r.data.dtype == np.int32
    assert r.valid_at(slot) and not r.valid_at(1 - slot)
    assert r.length_at(slot) == 6 and eng.position(slot) == 6
    assert eng.occupancy == 0.5


# ---------------------------------------------------------------------------
# async server
# ---------------------------------------------------------------------------

def test_server_multithreaded_submit_bit_parity():
    cfg, params = setup_arch("granite-8b")
    base = DecodeEngine(params, cfg, device=CPU)
    reqs = [(8, 6), (12, 4), (5, 8), (9, 3), (11, 6), (6, 5)]
    prompts = make_prompts(cfg, reqs)
    want = [base.generate(p[None], max_new_tokens=t, cache_len=32)[0][0]
            for p, (_, t) in zip(prompts, reqs)]

    eng = SlotEngine(params, cfg, capacity=3, max_context=32, page_size=8,
                     device=CPU)
    futures = [None] * len(reqs)
    with ContinuousServer(eng, prefill_per_step=2) as server:
        def client(lo, hi):
            for i in range(lo, hi):
                futures[i] = server.submit(prompts[i],
                                           max_new_tokens=reqs[i][1])
        threads = [threading.Thread(target=client, args=(0, 3)),
                   threading.Thread(target=client, args=(3, 6))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        server.drain(timeout=300)
    for fut, w in zip(futures, want):
        np.testing.assert_array_equal(fut.result(timeout=5), w)
    assert eng.decode_compiles == 1
    assert server.stats["prefills"] == len(reqs)
    assert server.stats["evictions"] == len(reqs)


def test_server_eos_stops_request():
    """A request whose first decoded token is EOS finishes immediately
    with that single token (the slot never enters the decode batch)."""
    cfg, params = setup_arch("granite-8b")
    prompt = np.arange(7, dtype=np.int32) % cfg.vocab
    # learn what greedy emits first, then declare that token to be EOS
    probe = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                       device=CPU)
    _, first = probe.insert(prompt, max_new_tokens=4)

    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     serve_cfg=ServeConfig(eos_id=int(first)), device=CPU)
    with ContinuousServer(eng) as server:
        fut = server.submit(prompt, max_new_tokens=4)
        out = fut.result(timeout=300)
    assert out.tolist() == [int(first)]
    assert not eng.live_slots()            # slot was evicted on EOS


def test_server_rejects_oversized_request_via_future():
    cfg, params = setup_arch("granite-8b")
    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    with ContinuousServer(eng) as server:
        fut = server.submit(np.zeros((12,), np.int32), max_new_tokens=12)
        with pytest.raises(ValueError, match="max_context"):
            fut.result(timeout=300)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_server_serves_the_ssm_families(arch):
    """Two client threads through the server; every request's tokens
    equal ``DecodeEngine``'s at the engine's context budget."""
    cfg, params = setup_arch(arch)
    reqs = [(8, 6), (12, 4), (5, 8), (9, 3), (11, 6)]
    prompts = make_prompts(cfg, reqs, seed=2)
    base = DecodeEngine(params, cfg, device=CPU)
    want = [base.generate(p[None], max_new_tokens=t, cache_len=32)[0][0]
            for p, (_, t) in zip(prompts, reqs)]
    eng = SlotEngine(params, cfg, capacity=2, max_context=32, page_size=8,
                     device=CPU)
    futures = [None] * len(reqs)
    with ContinuousServer(eng) as server:
        def client(ids):
            for i in ids:
                futures[i] = server.submit(prompts[i],
                                           max_new_tokens=reqs[i][1])
        threads = [threading.Thread(target=client, args=(range(k, 5, 2),))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        server.drain(timeout=300)
    for fut, w in zip(futures, want):
        np.testing.assert_array_equal(fut.result(timeout=5), w)
    assert eng.decode_compiles == 1


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_server_serves_the_new_families_with_the_reference_tokens(arch):
    """Two client threads through the server, each request with its own
    frontend: every request's tokens equal the reference
    ``DecodeEngine``'s at the engine's context budget (the port's
    ``DecodeEngine`` is held to the same in ``test_slot_engine_bit_parity``),
    and the cross lanes are never copied by a step."""
    cfg, jp = ref_params(arch)
    reqs = [(8, 5), (11, 3), (6, 6), (9, 4)]
    prompts = make_prompts(cfg, reqs, seed=4)
    fes = make_frontends(cfg, len(reqs), seed=4)
    ref_eng = RefDecodeEngine(jp, cfg)
    want = [ref_eng.generate(p[None], frontend=batch_frontend(fe),
                             max_new_tokens=t, cache_len=32)[0][0]
            for p, fe, (_, t) in zip(prompts, fes, reqs)]
    eng = SlotEngine(params_from_reference(jp, device=CPU),
                     get_config(arch).reduced(), capacity=2, max_context=32,
                     page_size=8, device=CPU)
    static = {p: eng.cache.lanes[p] for p in eng.cache.lanes
              if p[0] == "cross"}
    assert len(static) == (0 if cfg.family == "moe" else 2)
    futures = [None] * len(reqs)
    with ContinuousServer(eng) as server:
        def client(ids):
            for i in ids:
                futures[i] = server.submit(prompts[i],
                                           max_new_tokens=reqs[i][1],
                                           frontend=fes[i])
        threads = [threading.Thread(target=client, args=(range(k, 4, 2),))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        server.drain(timeout=300)
    for fut, w in zip(futures, want):
        np.testing.assert_array_equal(fut.result(timeout=5), w)
    assert eng.decode_compiles == 1
    for path, lane in static.items():
        assert eng.cache.lanes[path] is lane
        assert lane.dtype == torch.bfloat16 and lane.shape[2] == 16


def test_encdec_insert_without_frontend_fails_the_request():
    cfg, params = setup_arch("whisper-small")
    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    with ContinuousServer(eng) as server:
        fut = server.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
        with pytest.raises(ValueError, match="frontend"):
            fut.result(timeout=300)
        # the refused request gave its pages back: a good one is served
        ok = server.submit(np.arange(4, dtype=np.int32), max_new_tokens=2,
                           frontend=make_frontends(cfg, 1)[0])
        assert ok.result(timeout=300).shape == (2,)
    assert eng.cache.free_pages == eng.cache.layout.total_pages


def test_server_waits_on_the_free_list():
    """More pages asked than the pool holds at once: admission stalls and
    resumes as slots evict, and every request still finishes right."""
    cfg, params = setup_arch("h2o-danube-1.8b")
    reqs = [(10, 6), (9, 7), (12, 4), (8, 5)]
    prompts = make_prompts(cfg, reqs, seed=5)
    base = DecodeEngine(params, cfg, device=CPU)
    want = [base.generate(p[None], max_new_tokens=t, cache_len=32)[0][0]
            for p, (_, t) in zip(prompts, reqs)]
    eng = SlotEngine(params, cfg, capacity=4, max_context=32, page_size=8,
                     total_pages=4, device=CPU)
    with ContinuousServer(eng) as server:
        futs = [server.submit(p, max_new_tokens=t)
                for p, (_, t) in zip(prompts, reqs)]
        server.drain(timeout=300)
    for f, w in zip(futs, want):
        np.testing.assert_array_equal(f.result(timeout=5), w)
    assert server.stats["admission_stalls"] > 0


def test_serve_report_schema_roundtrip():
    assert callable(serve_entry) and callable(validate_serve)
    errors = validate_serve({"version": 1})
    assert errors


def test_gather_runs_the_plain_version_on_the_cpu():
    cfg, params = setup_arch("granite-8b")
    eng = SlotEngine(params, cfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    paged_kernels.reset_launches()
    eng.insert(np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.step()
    assert paged_kernels.launches["paged_gather"] == 0
