"""Decode on a cache placed by ``launch.specs.cache_shardings``, against
the reference's ``models.decode.prefill`` / ``decode_step``.

The reference's decode cells place the cache with features over
``model`` (``cache_shardings``: K/V columns, conv channels, state
heads).  One reference subprocess (JAX, one CPU device) runs prefill
and 8 greedy decode steps of each case with its own seeded parameters;
then one world of 8 gloo ranks (``dist.decode_cases``) runs every case
on its ``("data", "model")`` mesh with the same weights
(``convert.params_from_reference``):

* ``placed``: the reference's prefill cache cut to each rank's blocks by
  ``cache_shardings``, decoded with the reference's tokens (before the
  fix this raised: danube's ``expanded size``, the SSM conv windows'
  concatenation);
* ``own``: prefill on the mesh (its cache leaves the rank's blocks, each
  a copy), then greedy decode on them;
* ``init``: ``init_cache`` on the mesh gives the blocks' shapes.

Cases: reduced granite-8b (2 kv heads x 16: part of one head a rank on
``model`` 4 and 8), mixtral-8x22b (moe, a 16-slot rolling cache decoded
past its window), mamba2-370m (ssm), zamba2-1.2b (hybrid), whisper-small
(encdec, cross cache) and llama-3.2-vision-11b (vlm, gates opened to
0.5) on 2x4 and 1x8; granite on 2x2 (whole heads: 16 columns, one
head); granite with 3 kv heads of 8 on 2x2 (12 columns a rank: a block
across a head boundary); granite in bf16 on 2x4.

Each mesh run is held to two yardsticks:

* the port's own run of the same three paths on one device: logits
  within 1e-5 x max|logit| in fp32 and 2e-3 in bf16
  (``tests/test_torch_explicit_tp.py``'s mesh tolerance), greedy tokens
  equal, every rank the same logits, the cache blocks assembled over the
  ranks within the same.  whisper-small's greedy decode is held there
  to one device's decode from one device's prefill cache with the cross
  K/V leaves the mesh's (:data:`MESH_CROSS`): the mesh reduces its
  encoder's row-parallel products over ``model`` in another order than
  one device's matmul, so the bf16 cross K/V rounded from the encoder
  output fall a few elements one bf16 ulp apart, as the prefill check
  allows, and those move whisper's logits ~8e-5 x max|logit|.  Beside
  it the mesh's greedy tokens equal one device's own end to end, and
  the reference's yardstick holds whisper end to end;
* the reference's, for the fp32 cases: greedy tokens equal, logits and
  caches within 1e-5 x max.  whisper-small is held within 1e-4 there:
  its bf16 cross cache rounds a few elements one bf16 ulp apart from
  the reference's, which moves the port's logits on one device 8.7e-5 x
  max|logit| off.  In bf16 the port on one device already reads ~1e-2 x
  max|logit| from the reference (its bf16 roundings fall elsewhere), so
  the bf16 case has only the first yardstick.

A bf16 cache leaf (the cross K/V, the bf16 case's K/V) may round one bf16
ulp apart on top of the tolerance.

Then ``explicit_tp.feature_block`` against ``cache_shardings`` for every
leaf of every serving cell's cache in ``launch.specs`` on fake 2x4, 2x2x2
and 16x16 worlds, at the first, a middle and the last rank.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import decode_cases as dc  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh, set_mesh  # noqa
from repro_torch.models import explicit_tp as etp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, MAX_LEN = 4, 12, 24
BF16 = (("dtype", "bfloat16"),)
CROSSING = (("n_kv_heads", 3), ("n_heads", 6), ("head_dim", 8))
FAMILIES = ("granite-8b", "mixtral-8x22b", "mamba2-370m", "zamba2-1.2b",
            "whisper-small", "llama-3.2-vision-11b")
CASES = tuple(
    [dc.DecodeCase(f"{a}/{m[0]}x{m[1]}", a, m)
     for a in FAMILIES for m in ((2, 4), (1, 8))]
    + [dc.DecodeCase("granite-8b/2x2 whole heads", "granite-8b", (2, 2)),
       dc.DecodeCase("granite-8b/2x2 crossing", "granite-8b", (2, 2),
                     CROSSING),
       dc.DecodeCase("granite-8b/2x4 bf16", "granite-8b", (2, 4), BF16)])
LABELS = [c.label for c in CASES]
TOKENS = np.random.default_rng(3).integers(0, 256, (B, S))

_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import decode, init_params, split

spec = json.load(open(sys.argv[1]))
toks = jnp.asarray(np.asarray(spec["tokens"], np.int32))
out = {}


def walk(prefix, tree):
    for k, v in tree.items():
        if k == "pos":
            continue
        if isinstance(v, dict):
            walk(prefix + k + "/", v)
        else:
            out[prefix + k] = np.asarray(jnp.asarray(v, jnp.float32))


for label, (arch, overrides) in spec["cases"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(overrides))
    params, _ = split(init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(np.asarray, params)
    if "cross_layers" in params:
        params["cross_layers"]["gate"] = np.full_like(
            params["cross_layers"]["gate"], 0.5)
    fe = None
    if cfg.frontend_tokens:
        fe = np.asarray(spec["frontends"][label], np.float32)
    logits, cache = jax.jit(decode.prefill, static_argnums=2,
                            static_argnames="max_len")(
        params, toks, cfg, frontend=None if fe is None else jnp.asarray(fe),
        max_len=spec["max_len"])
    walk(f"{label}/params/", params)
    walk(f"{label}/cache0/", cache)
    step = jax.jit(decode.decode_step, static_argnums=3)
    lg, tk = [np.asarray(logits)], []
    for _ in range(spec["steps"]):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tk.append(np.asarray(nxt))
        logits, cache = step(params, nxt, cache, cfg)
        lg.append(np.asarray(logits))
    walk(f"{label}/cache/", cache)
    out[f"{label}/logits"] = np.stack(lg)
    out[f"{label}/tokens"] = np.concatenate(tk, axis=1)
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
"""


def _frontends():
    out = {}
    for case in CASES:
        cfg = dc.case_config(case)
        if cfg.frontend_tokens:
            rng = np.random.default_rng(5)
            out[case.label] = (0.5 * rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def _part(flat_ref, label, part):
    pre = f"{label}/{part}/"
    return {k[len(pre):]: v for k, v in flat_ref.items()
            if k.startswith(pre)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placed_decode")
    fronts = _frontends()
    (tmp / "spec.json").write_text(json.dumps({
        "tokens": TOKENS.tolist(), "max_len": MAX_LEN, "steps": dc.STEPS,
        "cases": {c.label: [c.arch, [list(o) for o in c.overrides]]
                  for c in CASES},
        "frontends": {k: v.tolist() for k, v in fronts.items()}}))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "spec.json"),
         str(tmp / "ref.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-4000:]
    flat_ref = dict(np.load(tmp / "ref.npz"))
    refs = {c.label: {"params": dc.nest(_part(flat_ref, c.label, "params")),
                      "cache": _part(flat_ref, c.label, "cache0"),
                      "tokens": flat_ref[f"{c.label}/tokens"]}
            for c in CASES}
    port = spawn.run_ranks(dc.placed_battery, 8, device="cpu",
                           args=(CASES, TOKENS, fronts, refs, MAX_LEN),
                           timeout=240)
    one = {}
    for case in CASES:
        with torch.no_grad():
            one[case.label] = dc.run_case(case, None, TOKENS,
                                          fronts.get(case.label),
                                          refs[case.label], MAX_LEN)
            if case.arch in MESH_CROSS:
                one[case.label]["greedy"] = _greedy_from(
                    case, _mesh_cross(port[case.label], case,
                                      one[case.label]),
                    one[case.label], refs[case.label])
    return {"port": port, "one": one, "ref": flat_ref}


#: the archs whose one-device greedy decode starts from the mesh's cross
#: K/V (the module docstring)
MESH_CROSS = ("whisper-small",)


def _mesh_cross(recs, case, one):
    """One device's prefill cache with its cross K/V leaves the mesh's,
    assembled over the ranks (``test_prefill_on_the_mesh_returns_placed_
    copies`` holds them within one bf16 ulp of one device's)."""
    spec = dc.cache_specs(case, B, MAX_LEN)
    sizes = dict(zip(dc.AXES, case.mesh))
    return {k: (_assemble(recs, "prefill_cache", k, v.shape, spec[k], sizes)
                .astype(np.float32) if k.startswith("cross/") else v)
            for k, v in one["prefill_cache"].items()}


def _greedy_from(case, cache0, one, ref):
    """Greedy decode on one device from the prefill cache ``cache0``
    (leaves in ``one``'s dtypes) after ``one``'s prefill logits: {logits,
    tokens, cache}, as ``dc.run_case`` records them."""
    from repro_torch import convert
    from repro_torch.models import decode as dec
    cfg = dc.case_config(case)
    params = convert.params_from_reference(ref["params"], device="cpu")
    # copies: decode writes the K/V tensors in place
    cache = dict(dc.nest({k: torch.tensor(v, dtype=getattr(
        torch, one["dtypes"][k])) for k, v in cache0.items()}), pos=S)
    logits = torch.as_tensor(one["logits"][0])
    lg, tk = [one["logits"][0]], []
    with torch.no_grad():
        for _ in range(dc.STEPS):
            nxt = logits.argmax(-1)[:, None]
            tk.append(nxt.numpy())
            logits, cache = dec.decode_step(params, nxt, cache, cfg)
            lg.append(logits.float().numpy())
    return {"logits": np.stack(lg), "tokens": np.concatenate(tk, axis=1),
            "cache": {k: v.float().numpy().copy()
                      for k, v in dc.flat(cache).items()}}


def _case(label):
    return next(c for c in CASES if c.label == label)


def _tol(label):
    return 2e-3 if dc.case_config(_case(label)).dtype == "bfloat16" else 1e-5


#: the reference's yardstick where the port on one device is farther off
REF_TOL = {"whisper-small": 1e-4}
FP32 = [c.label for c in CASES if _tol(c.label) == 1e-5]


def _close(got, want, tol, bf16=False):
    """Within ``tol`` x max|want|; a bf16 leaf also one bf16 ulp
    (2^-7 of each element) apart."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    slack = 2.0 ** -7 * np.abs(want) if bf16 else 0.0
    excess = np.abs(got - want) - slack
    err = float(excess.max())
    assert err <= tol * scale, (err, scale, err / scale)


def _assemble(recs, part, leaf, shape, spec, sizes):
    """The global leaf from every rank's block, placed by its spec."""
    out = np.full(shape, np.nan)
    for rec in recs:
        idx = []
        for d, entry in enumerate(spec):
            n, i = 1, 0
            for a in dryrun._axes_of(entry):
                n, i = n * sizes[a], i * sizes[a] + rec["coord"][a]
            step = shape[d] // n
            idx.append(slice(i * step, (i + 1) * step))
        out[tuple(idx)] = rec[part][leaf]
    return out


def _check_cache(recs, label, part, want_flat, tol):
    case = _case(label)
    spec = dc.cache_specs(case, B, MAX_LEN)
    sizes = dict(zip(dc.AXES, case.mesh))
    assert set(recs[0][part]) == set(want_flat) == set(spec)
    for leaf, want in want_flat.items():
        for rec in recs:
            assert rec[part][leaf].shape == dryrun.shard_shape(
                want.shape, spec[leaf], sizes), leaf
        got = _assemble(recs, part, leaf, want.shape, spec[leaf], sizes)
        assert not np.isnan(got).any(), leaf
        _close(got, want, tol, recs[0]["dtypes"][leaf] == "bfloat16")


def _yardstick(both, label, which):
    """(want: logits, forced logits, tokens, prefill cache, final cache;
    tolerance) of the port on one device or of the reference."""
    if which == "one device":
        one = both["one"][label]
        g = one.get("greedy", one)
        return (g["logits"], one["forced"], g["tokens"],
                one["prefill_cache"], g["cache"]), _tol(label)
    ref = both["ref"]
    logits = ref[f"{label}/logits"]
    return ((logits, logits[1:], ref[f"{label}/tokens"],
             _part(ref, label, "cache0"), _part(ref, label, "cache")),
            REF_TOL.get(_case(label).arch, 1e-5))


YARDSTICKS = ([(lb, "one device") for lb in LABELS]
              + [(lb, "reference") for lb in FP32])


@pytest.mark.parametrize("label,which", YARDSTICKS)
def test_decode_on_a_placed_reference_cache(both, label, which):
    """The reference's prefill cache cut by ``cache_shardings``, decoded
    with the reference's greedy tokens."""
    recs = both["port"][label]
    (_, want, _, _, _), tol = _yardstick(both, label, which)
    for rec in recs:
        assert rec["forced"].shape == want.shape
        _close(rec["forced"], want, tol)
        np.testing.assert_array_equal(rec["forced"], recs[0]["forced"])


@pytest.mark.parametrize("label,which", YARDSTICKS)
def test_prefill_on_the_mesh_returns_placed_copies(both, label, which):
    recs = both["port"][label]
    (_, _, _, want, _), tol = _yardstick(both, label, which)
    assert all(rec["copies"] for rec in recs)
    _check_cache(recs, label, "prefill_cache", want, tol)


@pytest.mark.parametrize("label,which", YARDSTICKS)
def test_greedy_decode_on_the_mesh(both, label, which):
    recs = both["port"][label]
    (logits, _, tokens, _, cache), tol = _yardstick(both, label, which)
    for rec in recs:
        np.testing.assert_array_equal(rec["tokens"], tokens)
        _close(rec["logits"], logits, tol)
        # every rank returns the same (global) logits
        np.testing.assert_array_equal(rec["logits"], recs[0]["logits"])
    _check_cache(recs, label, "cache", cache, tol)
    one = both["one"][label]
    if which == "one device" and "greedy" in one:
        # end to end: the tokens of one device's own prefill and decode
        for rec in recs:
            np.testing.assert_array_equal(rec["tokens"], one["tokens"])


@pytest.mark.parametrize("label", LABELS)
def test_init_cache_on_the_mesh_builds_the_blocks(both, label):
    case = _case(label)
    spec = dc.cache_specs(case, B, MAX_LEN)
    sizes = dict(zip(dc.AXES, case.mesh))
    want = dc.flat(specs.cache_struct(dc.case_config(case), B, MAX_LEN))
    for rec in both["port"][label]:
        assert rec["init_shapes"] == {
            k: dryrun.shard_shape(v.shape, spec[k], sizes)
            for k, v in want.items()}


def test_the_cases_cover_whole_split_and_crossing_heads():
    """On its mesh, a rank's K/V block is whole heads (2x2), part of one
    head (2x4, 1x8) or across a head boundary (crossing)."""
    kinds = {}
    for case in CASES:
        cfg = dc.case_config(case)
        w = cfg.kv_dim // case.mesh[1]
        kinds[case.label] = ("whole" if w % cfg.head_dim == 0 else
                             "split" if cfg.head_dim % w == 0 else "crossing")
    assert kinds["granite-8b/2x2 whole heads"] == "whole"
    assert kinds["granite-8b/2x4"] == kinds["granite-8b/1x8"] == "split"
    assert kinds["granite-8b/2x2 crossing"] == "crossing"


# ---------------------------------------------------------------------------
# the rule against cache_shardings, every decode cell
# ---------------------------------------------------------------------------

MESHES = {"2x4": (2, 4), "2x2x2": (2, 2, 2), "16x16": (16, 16)}
SERVE_CELLS = [(a, s) for a, s in specs.all_cells()
               if specs.SHAPES[s].kind != "train"]


def _cache_and_spec(cell):
    """A serving cell's cache struct and its specs: a decode cell's
    argument, a prefill cell's output."""
    if cell.kind == "decode":
        return dc.flat(cell.args[2]), dc.flat(cell.in_shardings[2])
    struct = specs.cache_struct(cell.cfg, cell.shape.global_batch,
                                cell.shape.seq_len)
    return dc.flat(struct), dc.flat(cell.out_shardings[1])


def _rule_blocks(cache, mesh) -> dict:
    """{leaf: the rank's [start, stop) of every dim} by the models' rule:
    its batch rows where the batch axes divide the batch, and its
    ``feature_block`` of the K/V columns, conv channels and state
    heads."""
    out = {}
    with set_mesh(mesh) as rm:
        nb = etp.batch_shards()
        bd = tuple(a for a in ("pod", "data") if a in rm.sizes)
        for key, leaf in cache.items():
            shape = list(leaf.shape)
            blocks = [(0, n) for n in shape]
            b = shape[1]
            if nb > 1 and b % nb == 0:
                i, n = rm.shard_of(bd)
                blocks[1] = (i * b // n, (i + 1) * b // n)
            dim = 2 if key.endswith("state") else len(shape) - 1
            fb = etp.feature_block(shape[dim])
            if fb is not None:
                blocks[dim] = fb
            out[key] = blocks
    return out


def _spec_blocks(cache, spec, mesh, coord) -> dict:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = {}
    for key, leaf in cache.items():
        blocks = []
        for d, n in enumerate(leaf.shape):
            i, cnt = 0, 1
            for a in dryrun._axes_of(spec[key][d]):
                i, cnt = i * sizes[a] + coord[a], cnt * sizes[a]
            blocks.append((i * n // cnt, (i + 1) * n // cnt))
        out[key] = blocks
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_feature_block_equals_cache_shardings(mesh):
    """Every leaf of every serving cell's cache (a decode cell's
    argument, a prefill cell's output), at three ranks of each mesh."""
    shape = MESHES[mesh]
    world = int(np.prod(shape))
    for rank in sorted({0, world // 2 + 1, world - 1}):
        with fake_world(world, rank=rank):
            m = make_mesh(shape, dryrun.axes_of(shape))
            coord = dict(zip(m.mesh_dim_names, m.get_coordinate()))
            for arch, sname in SERVE_CELLS:
                cache, spec = _cache_and_spec(
                    specs.input_specs(arch, sname, m))
                assert _rule_blocks(cache, m) == _spec_blocks(
                    cache, spec, m, coord), (arch, sname, rank)


# ---------------------------------------------------------------------------
# the dry run's collective term
# ---------------------------------------------------------------------------

def test_the_dry_run_charges_the_decode_collectives():
    """granite-8b ``decode_32k`` at 2 layers: on 2x4 a rank's 256 K/V
    columns are 2 whole heads (the new token's q gathered over ``model``
    and the heads' output gathered back, a layer; the logits' over
    ``data``); on 1x16 its 64 columns split a head, so each layer also
    gathers the new token's k for its rope and swaps its head's (B, Hq /
    Hkv, S) fp32 partial scores with the one other rank that holds the
    head's columns (``explicit_tp.sum_head_partials``: a
    collective-permute).  Each
    layer all-reduces its two row-parallel products (``wo``, ``wd``: (B,
    1, d) fp32) over ``model``.  mamba2-370m gathers its conv output and
    ``y`` a layer.  Beside them run the placed parameters' collectives
    (``models.placed``): each leaf of a layer gathered over the batch
    axes above 1 its spec names, never over ``model`` (granite: the 2
    norms and the 7 projections over ``data``; mamba2 on 1x16: its mixer
    whole, ``in_proj``, ``conv_w``, ``conv_b``, ``norm_g``, ``out_proj``
    over ``model``), the final norm over ``data``, the tied table over
    ``data`` for the lookup and again for the output projection, the
    looked-up rows summed over ``model`` and the logits gathered over
    it; mamba2's vocab is whole (``model`` does not divide 50280)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    cut = dryrun.depth_cut("granite-8b", 2)
    whole = dryrun.run_cell("granite-8b", "decode_32k", overrides=cut,
                            mesh_shape=(2, 4))["hlo_stats"]
    params_2x4 = 2 * (2 + 7) + 1 + 2 + 1
    assert whole["collective_counts"] == {"all-gather": 2 * 2 + 1
                                          + params_2x4,
                                          "all-reduce": 1 + 2 * 2}
    split = dryrun.run_cell("granite-8b", "decode_32k", overrides=cut,
                            mesh_shape=(1, 16))["hlo_stats"]
    assert split["collective_counts"] == {"all-reduce": 1 + 2 * 2,
                                          "all-gather": 2 * 3 + 1,
                                          "collective-permute": 2}
    cfg, sh = get_config("granite-8b"), specs.SHAPES["decode_32k"]
    head = (sh.global_batch * (cfg.n_heads // cfg.n_kv_heads) * sh.seq_len
            * 4)
    rows = sh.global_batch * cfg.d_model * 2
    part = sh.global_batch * cfg.d_model * 4
    rule = op_analysis._WIRE_FACTOR["all-reduce"]
    assert split["wire_by_kind"]["all-reduce"] == rule(rows, 16) + \
        2 * 2 * rule(part, 16)
    assert split["wire_by_kind"]["collective-permute"] == 2 * head
    ssm = dryrun.run_cell("mamba2-370m", "decode_32k",
                          overrides=dryrun.depth_cut("mamba2-370m", 2),
                          mesh_shape=(1, 16))["hlo_stats"]
    assert ssm["collective_counts"] == {"all-gather": 4 + 2 * 5}
