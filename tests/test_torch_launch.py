"""The dry run (``launch.dryrun``, ``launch.op_analysis``) against the
reference's (``launch.dryrun``, ``launch.hlo_analysis``) and a real
world of ranks.

* **Rules.**  The wire factors and dtype bytes equal the reference's
  tables; the dot rule gives, on ``meta`` tensors, exactly the operations
  the reference's ``hlo_analysis.analyze`` reads from the compiled HLO
  of the ``jnp`` counterpart; a 3-layer loop counts 3x one layer; a toy
  program's ``peak_live_bytes`` is its known peak; each kernel's
  ``cost()`` is the formula PERF.md §6 states and gives the bounds
  printed before (0.0116 ms for row 8, 0.292 ms for row 9b).
* **Memory.**  One subprocess on 8 fake XLA devices builds every cell of
  the reference's ``launch.specs`` on 2x4 and 2x2x2.  A train cell's
  ``spec_argument_bytes`` and ``argument_bytes`` equal the reference's
  per-device sum over ``cell.args`` of ``prod(shard_shape) x itemsize``
  exactly; so do a serving cell's: the rank holds its parameter blocks
  under ``param_shardings`` (``models.placed``), the batch rows of
  tokens and frontend and, for a decode cell, the cache's blocks under
  its specs.  A decode cell's ``cache_bytes`` equals its
  ``spec_cache_bytes``.
* **Collectives.**  Reduced granite-8b, a ``train_4k``-shaped step cut to
  4 x 32 tokens, on 4 gloo CPU ranks (2x2) counted by ``OpAnalysis``
  equals the dry run on a fake 2x2 world standing for gloo, on the CPU's
  routes: collective counts, wire bytes by kind and dot operations,
  exactly.
* **Operations against the reference's HLO.**  granite-8b at 2 layers,
  ``train_4k``, ``prefill_32k`` and ``decode_32k`` at full width and
  batch, ``device="cpu"`` (the plain routes, the reference's XLA
  routes), on 1x1 and 2x4.  The port's per-device operations are held
  to ``analyze(compiled.as_text()).flops`` of the same cell after the
  named terms of the gap:

  - prefill projects the last position only to logits (the reference
    projects all ``S``): ``2 d V B (S - 1)`` fewer;
  - on a mesh the rank model computes its batch rows (``/ data``) and,
    over ``model``, only its block of every dot: q, k and v on its
    ``heads`` / ``kv`` columns, attention on its heads or cache columns,
    the MLP on its ``d_ff`` columns, the output projections on their row
    blocks and the logits (and a train step's loss) on its vocab block,
    the parameters gathered over the batch axes only
    (``models.placed``): the reference's one-device count over ``data x
    model``.  No dot of granite-8b runs whole over ``model``;
  - the port is held to that within 1e-9 on both meshes; the reference's
    own count on 2x4 exceeds its one-device count over 8 by 4.3–6.0% (in
    prefill: GSPMD computes the K and V projections whole on each
    ``model`` rank), held to at most 7%.

  ROADMAP Queue 3 records the same terms.
* **Every cell runs.**  Each of the 34 cells at 2 layers (one layer of
  each kind) on a fake 2x4 and a fake 2x2x2 world completes with the
  reference's record keys; the CLI writes ``_skips.json`` with 6 skips.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hopper  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, specs  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"2x4": (2, 4), "2x2x2": (2, 2, 2)}
CELLS = list(specs.all_cells())
TRAIN = [(m, a, s) for m in MESHES for a, s in CELLS
         if specs.SHAPES[s].kind == "train"]
SERVE = [(m, a, s) for m in MESHES for a, s in CELLS
         if specs.SHAPES[s].kind != "train"]
FLOP_CELLS = [(s, m) for s in ("train_4k", "prefill_32k", "decode_32k")
              for m in ("1x1", "2x4")]
#: the reference partitioner's per-device excess over its one-device count
REF_EXCESS = {"1x1": 0.0, "2x4": 0.07}
PARITY_ARCH = "granite-8b"
PARITY_LAYERS = 2

_REFERENCE = r"""
import json, math, os, sys
import jax
from repro import jax_compat
from repro.launch import hlo_analysis, specs
from repro.optim import adamw

spec = json.load(open(sys.argv[1]))


def leaves(tree, sh):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], sh[k])
    elif isinstance(tree, adamw.Q8):
        yield from leaves(tree.q, sh.q)
        yield from leaves(tree.scale, sh.scale)
    elif isinstance(tree, (tuple, list)):
        for x, s in zip(tree, sh):
            yield from leaves(x, s)
    elif tree is not None:
        yield tree, sh


def nbytes(leaf, sharding):
    return math.prod(sharding.shard_shape(leaf.shape)) * leaf.dtype.itemsize


out = {"bytes": {}, "flops": {}}
for name, (shape, axes) in spec["meshes"].items():
    mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
    for arch, sname in specs.all_cells():
        c = specs.input_specs(arch, sname, mesh)
        pairs = list(leaves(c.args, c.in_shardings))
        out["bytes"][f"{name}/{arch}/{sname}"] = {
            "spec": sum(nbytes(l, s) for l, s in pairs)}

for sname, mname in spec["flops"]:
    shape, axes = spec["flop_meshes"][mname]
    mesh = jax_compat.make_mesh(tuple(shape), tuple(axes))
    c = specs.input_specs(spec["arch"], sname, mesh,
                          overrides={"n_layers": spec["layers"]})
    with jax_compat.set_mesh(mesh):
        compiled = jax.jit(c.fn, in_shardings=c.in_shardings,
                           out_shardings=c.out_shardings,
                           donate_argnums=c.donate).lower(*c.args).compile()
    out["flops"][f"{sname}/{mname}"] = hlo_analysis.analyze(
        compiled.as_text()).flops
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's per-device argument bytes of every cell on 2x4 and
    2x2x2 and its HLO operations of the parity cells, from one subprocess
    on 8 fake XLA devices."""
    tmp = tmp_path_factory.mktemp("ref-launch")
    spec = {"meshes": {"2x4": [[2, 4], ["data", "model"]],
                       "2x2x2": [[2, 2, 2], ["pod", "data", "model"]]},
            "flop_meshes": {"1x1": [[1, 1], ["data", "model"]],
                            "2x4": [[2, 4], ["data", "model"]]},
            "flops": FLOP_CELLS, "arch": PARITY_ARCH,
            "layers": PARITY_LAYERS}
    (tmp / "spec.json").write_text(json.dumps(spec))
    (tmp / "ref.py").write_text(_REFERENCE)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    subprocess.run([sys.executable, str(tmp / "ref.py"),
                    str(tmp / "spec.json"), str(tmp / "out.json")],
                   check=True, env=env, cwd=ROOT, timeout=600)
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture(scope="module")
def port_bytes():
    """The port's per-device argument bytes of every cell on a fake 8-rank
    world: (spec_argument_bytes, argument_bytes)."""
    out = {}
    with fake_world(8):
        for name, shape in MESHES.items():
            mesh = make_mesh(shape, dryrun.axes_of(shape))
            for arch, sname in CELLS:
                cell = specs.input_specs(arch, sname, mesh)
                args, held = dryrun.rank_args(cell, mesh)
                out[f"{name}/{arch}/{sname}"] = (
                    dryrun.spec_argument_bytes(cell, mesh),
                    dryrun.argument_bytes(args, held, mesh),
                    dryrun.cache_memory(cell, args, None, mesh)
                    if cell.kind == "decode" else None)
    return out


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", hlo_analysis.COLLECTIVES)
def test_wire_factors_equal_the_reference(kind):
    assert op_analysis.COLLECTIVES == hlo_analysis.COLLECTIVES
    for b in (1, 4096, 3 << 20, 1e9):
        for g in (1, 2, 4, 8, 16, 256):
            assert (op_analysis._WIRE_FACTOR[kind](b, g)
                    == hlo_analysis._WIRE_FACTOR[kind](b, g))


def test_dtype_bytes_equal_the_reference():
    assert op_analysis._DTYPE_BYTES == hlo_analysis._DTYPE_BYTES
    for dt, name in op_analysis.HLO_NAMES.items():
        assert op_analysis.dtype_bytes(dt) == torch.empty(
            (), dtype=dt).element_size() == hlo_analysis._DTYPE_BYTES[name]


DOTS = {
    "matmul (64, 96) @ (96, 80)": ("ij,jk->ik", [(64, 96), (96, 80)]),
    "matvec (64, 96) @ (96,)": ("ij,j->i", [(64, 96), (96,)]),
    "bmm (8, 64, 32) @ (8, 32, 48)": ("bij,bjk->bik",
                                       [(8, 64, 32), (8, 32, 48)]),
    "batched 4-d (2, 4, 64, 16) @ (2, 4, 16, 64)": (
        "bhqd,bhkd->bhqk", [(2, 4, 64, 16), (2, 4, 64, 16)]),
    "broadcast (4, 64, 96) @ (96, 80)": ("bij,jk->bik",
                                          [(4, 64, 96), (96, 80)]),
    "einsum chain (32, 48) (48, 64) (64, 16)": (
        "ij,jk,kl->il", [(32, 48), (48, 64), (64, 16)]),
    "contraction over two dims (8, 16, 32) (16, 32, 24)": (
        "aij,ijb->ab", [(8, 16, 32), (16, 32, 24)]),
}


@pytest.mark.parametrize("case", sorted(DOTS))
def test_dot_flops_equal_the_reference_hlo(case):
    eq, shapes = DOTS[case]
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    text = jax.jit(lambda *xs: jnp.einsum(eq, *xs)).lower(
        *structs).compile().as_text()
    want = hlo_analysis.analyze(text).flops
    xs = [torch.empty(s, device="meta") for s in shapes]
    _, got = op_analysis.analyze(lambda *a: torch.einsum(eq, *a), *xs)
    assert got.flops == want
    assert got.dot_flops == want


def test_a_layer_loop_counts_every_layer():
    w = torch.empty(64, 64, device="meta")
    x = torch.empty(8, 64, device="meta")

    def layers(n):
        def run(x):
            for _ in range(n):
                x = torch.relu(x @ w)
            return x
        return run
    _, one = op_analysis.analyze(layers(1), x)
    _, three = op_analysis.analyze(layers(3), x)
    assert three.flops == 3 * one.flops == 3 * 2.0 * 8 * 64 * 64
    assert three.hbm_bytes == 3 * one.hbm_bytes


def test_peak_live_bytes_of_a_toy_program():
    """Arguments 4 KB; a (256,) fp32 temporary (1 KB) and a (512,) one
    (2 KB) live at once, a view of the second costing nothing, beside
    three 4-byte sums; all freed before a 1 KB output: the peak is 4 + 1
    + 2 KB and 12 bytes."""
    x = torch.empty(1024, device="meta")

    def prog(x):
        a = torch.ones(256, device="meta")
        b = torch.zeros(512, device="meta")
        v = b[:128].view(2, 64)
        s = a.sum() + v.sum()
        del a, b, v
        return torch.empty(256, device="meta") + s
    _, st = op_analysis.analyze(prog, x)
    assert st.peak_live_bytes == 4096 + 1024 + 2048 + 3 * 4


def test_kernel_costs_are_the_bound_formulas():
    """PERF.md §6's note: flash does 4 D operations a visible pair and q
    head, its backward 2.5x that; the SSD counts C B^T once per group,
    Q(Q+1)/2 P and 2 Q N P multiply-adds a chunk and head, its backward
    Q(Q+1)/2 2P + 4 Q N P a chunk and head and Q(Q+1)/2 3N a chunk and
    group; the bounds of rows 8 and 9b as printed before."""
    # row 8: q (1, 32, 1495, 80), k/v (1, 8, 1495, 80) bf16, causal
    flops, nbytes = fa.cost(1, 32, 8, 1495, 1495, 80, causal=True)
    pairs = 1495 * 1496 // 2
    assert flops == 4.0 * 80 * 32 * pairs
    assert nbytes == 2.0 * (2 * 32 * 1495 * 80 + 2 * 8 * 1495 * 80)
    roof = hopper.RooflineTerms("row 8", flops, nbytes, dtype="bfloat16")
    assert f"{roof.bound_s * 1e3:.4f}" == "0.0116"
    bf, _ = fa.cost(1, 32, 8, 1495, 1495, 80, causal=True, backward=True)
    assert bf == 2.5 * flops
    # q_offset and windows count the pairs the mask lets through
    rows = np.arange(256, 512)
    want = int(np.maximum(0, np.minimum(1024, rows + 1)
                          - np.maximum(0, rows - 64 + 1)).sum())
    assert fa.visible_pairs(256, 1024, True, 64, q_offset=256) == want
    # row 9b: mamba2 training, x (4, 2048, 32, 64), B/C (4, 2048, 1, 128)
    b, L, h, p, g, n, q = 4, 2048, 32, 64, 1, 128, 64
    nc, tri = L // q, q * (q + 1) // 2
    flops, _ = ssd_scan.cost(b, L, h, g, n, p, q, backward=True)
    macs = b * nc * (3 * g * tri * n + h * (2 * tri * p + 4 * q * n * p))
    assert flops == 2.0 * macs + b * L * h * (p + 1)
    roof = hopper.RooflineTerms("row 9b", *ssd_scan.cost(
        b, L, h, g, n, p, q, backward=True), dtype="float32")
    assert f"{roof.bound_s * 1e3:.3f}" == "0.292"
    fwd, _ = ssd_scan.cost(b, L, h, g, n, p, q)
    assert fwd == 2.0 * b * nc * (g * tri * n + h * (tri * p + 2 * q * n * p)
                                  ) + b * L * h * (p + 1)


def test_meta_kernels_count_and_charge_their_cost():
    """On ``meta`` (standing for the card) the flash and SSD wrappers,
    forward and backward through autograd, and the gather count their
    launches and charge their ``cost()``; their outputs have the plain
    versions' shapes and dtypes.  Standing for the CPU they take the plain
    routes and launch nothing."""
    from repro_torch.kernels import paged

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype,
                           requires_grad=dtype.is_floating_point)

    def prog():
        q, k, v = m(2, 8, 64, 32), m(2, 2, 64, 32), m(2, 2, 64, 32)
        out = fa.flash_attention(q, k, v, causal=True)
        x, dt, a = m(2, 64, 4, 8), m(2, 64, 4), m(4)
        b, c = m(2, 64, 1, 16), m(2, 64, 1, 16)
        y, _ = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=16)
        (out.sum() + y.sum()).backward()
        with torch.no_grad():
            view = paged.paged_gather(m(9, 4, 32),
                                      m(3, 2, dtype=torch.int32))
        return out, y, view
    (out, y, view), st = op_analysis.analyze(prog)
    assert st.kernel_launches == {"flash_attention": 1,
                                  "flash_attention_backward": 1,
                                  "ssd_scan": 1, "ssd_scan_backward": 1,
                                  "paged_gather": 1}
    want = [fa.cost(2, 8, 2, 64, 64, 32, causal=True, itemsize=4,
                    with_lse=True),
            fa.cost(2, 8, 2, 64, 64, 32, causal=True, itemsize=4,
                    backward=True),
            ssd_scan.cost(2, 64, 4, 1, 16, 8, 16),
            ssd_scan.cost(2, 64, 4, 1, 16, 8, 16, backward=True),
            paged.cost((9, 4, 32), (3, 2), 4)]
    assert st.kernel_flops == sum(f for f, _ in want)
    assert st.kernel_bytes == sum(b for _, b in want)
    assert (tuple(out.shape), tuple(y.shape), tuple(view.shape)) == (
        (2, 8, 64, 32), (2, 64, 4, 8), (3, 8, 32))
    _, plain = op_analysis.analyze(prog, device="cpu")
    assert plain.kernel_launches == {} and plain.kernel_flops == 0.0


# ---------------------------------------------------------------------------
# memory against the reference's specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,arch,shape", TRAIN)
def test_train_argument_bytes_equal_the_reference(reference, port_bytes,
                                                 mesh, arch, shape):
    key = f"{mesh}/{arch}/{shape}"
    spec_b, held_b, _ = port_bytes[key]
    assert spec_b == reference["bytes"][key]["spec"]
    assert held_b == reference["bytes"][key]["spec"]


@pytest.mark.parametrize("mesh,arch,shape", SERVE)
def test_serving_argument_bytes(reference, port_bytes, mesh, arch, shape):
    key = f"{mesh}/{arch}/{shape}"
    spec_b, held_b, _ = port_bytes[key]
    assert spec_b == reference["bytes"][key]["spec"]
    assert held_b == reference["bytes"][key]["spec"]


@pytest.mark.parametrize("mesh,arch,shape", [
    (m, a, s) for m, a, s in SERVE if specs.SHAPES[s].kind == "decode"])
def test_decode_cache_bytes_equal_the_specs(port_bytes, mesh, arch, shape):
    """The rank holds the cache as ``cache_shardings`` places it: its
    batch rows and its feature block over ``model``."""
    mem = port_bytes[f"{mesh}/{arch}/{shape}"][2]
    assert mem["cache_bytes"] == mem["spec_cache_bytes"] > 0


# ---------------------------------------------------------------------------
# collectives against a real world of ranks
# ---------------------------------------------------------------------------

def _reduced(arch):
    cfg = get_config(arch)
    red = cfg.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name" and getattr(red, f.name) != getattr(cfg,
                                                                     f.name)}


def test_meta_and_gloo_records_equal_on_2x2():
    ov = _reduced(PARITY_ARCH)
    cut = dict(overrides=ov, batch=4, seq_len=32)
    real = spawn.run_ranks(dryrun.real_cell, 4, device="cpu", backend="gloo",
                           args=(PARITY_ARCH, "train_4k", (2, 2), ov, 4, 32,
                                 "cpu"))
    meta = dryrun.run_cell(PARITY_ARCH, "train_4k", mesh_shape=(2, 2),
                           backend="gloo", device="cpu", **cut)
    got, want = meta["hlo_stats"], real["hlo_stats"]
    # gloo's reduce-scatter is an all_reduce and the rank's slice
    assert set(want["collective_counts"]) == {"all-gather", "all-reduce"}
    for key in ("collective_counts", "wire_by_kind", "dot_flops_by_name",
                "wire_bytes"):
        assert got[key] == want[key], key
    assert got["flops"] == want["flops"]
    assert meta["memory"]["argument_bytes"] == real["memory"][
        "argument_bytes"]


# ---------------------------------------------------------------------------
# operations against the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mesh", FLOP_CELLS)
def test_flops_against_the_reference_hlo(reference, shape, mesh):
    cfg = dataclasses.replace(get_config(PARITY_ARCH),
                              n_layers=PARITY_LAYERS)
    sh = specs.SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    data, model = (1, 1) if mesh == "1x1" else (2, 4)
    rec = dryrun.run_cell(PARITY_ARCH, shape, overrides={
        "n_layers": PARITY_LAYERS}, mesh_shape=(data, model), device="cpu")
    got = rec["hlo_stats"]["flops"]
    # the reference's count of the cell on one device, then the named terms
    base = reference["flops"][f"{shape}/1x1"]
    if sh.kind == "prefill":
        base -= 2.0 * cfg.d_model * cfg.vocab * b * (s - 1)
    # every dot on the rank's batch rows and its model block
    want = base / (data * model)
    assert abs(got - want) <= 1e-9 * want, (got, want)
    # the reference's own count on the mesh: its partitioner's excess
    excess = (reference["flops"][f"{shape}/{mesh}"] * data * model
              / reference["flops"][f"{shape}/1x1"] - 1.0)
    assert 0.0 <= excess <= REF_EXCESS[mesh], excess


# ---------------------------------------------------------------------------
# every cell runs
# ---------------------------------------------------------------------------

KEYS = {"arch", "shape", "mesh", "chips", "kind", "trace_s", "memory",
        "hlo_stats", "kernel_launches", "roofline"}
MEMORY = {"argument_bytes", "spec_argument_bytes", "output_bytes",
          "alias_bytes", "temp_bytes", "per_device_total", "fits_hbm"}
ROOF = {"compute_s", "memory_s", "collective_s", "bottleneck",
        "step_time_s", "useful_flops_ratio", "roofline_fraction"}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_cell_runs_at_two_layers(mesh, arch, shape):
    rec = dryrun.run_cell(arch, shape, overrides=dryrun.depth_cut(arch, 2),
                          mesh_shape=MESHES[mesh])
    assert KEYS <= set(rec) and MEMORY <= set(rec["memory"])
    assert ROOF <= set(rec["roofline"])
    st = rec["hlo_stats"]
    assert st["flops"] > 0 and st["hbm_bytes"] > 0
    assert rec["memory"]["per_device_total"] > rec["memory"][
        "argument_bytes"] > 0
    if rec["kind"] != "train":
        assert rec["memory"]["cache_bytes"] == rec["memory"][
            "spec_cache_bytes"] > 0
    cfg = get_config(arch)
    attends = cfg.family != "ssm" and rec["kind"] != "decode"
    if attends:
        assert rec["kernel_launches"].get("flash_attention", 0) > 0
    if cfg.family in ("ssm", "hybrid") and rec["kind"] != "decode":
        assert rec["kernel_launches"].get("ssd_scan", 0) > 0
    if rec["kind"] == "train":
        assert st["collective_counts"]["reduce-scatter"] > 0
    assert json.loads(json.dumps(rec)) == rec


def test_the_cli_writes_records_and_skips(tmp_path):
    dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(tmp_path)])
    skips = json.loads((tmp_path / "_skips.json").read_text())
    assert len(skips) == 6
    assert {(s["arch"], s["shape"]) for s in skips} == {
        (a, s) for a, s, _ in specs.skipped_cells()}
    rec = json.loads((tmp_path / "whisper-small_decode_32k_single.json")
                     .read_text())
    assert rec["chips"] == 256 and rec["mesh"] == "single"
    assert math.isfinite(rec["roofline"]["step_time_s"])
