"""Dry run: every (arch x shape x mesh) cell as one rank's program on
``meta`` tensors in a fake world of ranks.

The port of the reference's ``launch/dryrun.py``.  The reference lowers
and compiles each cell on 512 placeholder CPU devices and reads XLA's
memory and cost analyses; the port has no compiler between it and the
card, so it *runs* each cell's closure (``launch.specs``) as rank 0 of a
fake world of the mesh's size (``launch.mesh.fake_world``: collectives
move nothing, tensors are ``meta``, no memory is allocated) under
``launch.op_analysis.OpAnalysis``, which counts the rank's operations,
bytes, collective wire bytes, kernel launches and peak memory.  Each
cell opens a world of its own mesh's size (256 or 512 ranks) and closes
it, in one process.

Rank 0 takes its arguments as the rank program takes them:

* train cells: its blocks of the state (``trainer.place_state`` under
  the cell's specs) and the global batch, whose batch rows it keeps;
* prefill and decode cells: its blocks of the bf16 parameters as the
  cell's ``param_shardings`` place them (a ``models.placed.Placed``
  tree: the model gathers each layer over the batch axes while it
  runs and computes on its ``model`` block of each leaf) and the
  global tokens and frontend, whose batch rows it keeps;
* decode cells: its blocks of the cache as ``cache_shardings`` places
  them (batch rows, and over ``model`` the K/V columns, conv channels
  and state heads), with ``pos`` a 0-d CPU int32 holding ``seq_len - 1``
  (the decode step reads it on the host).

So the record's ``argument_bytes`` is what the rank holds and
``spec_argument_bytes`` what the cell's ``in_shardings`` place (the
reference's ``argument_size_in_bytes``): the two are equal for every
cell.  ``cache_bytes`` is the
cache the rank holds (a decode cell's argument, a prefill cell's
output; ``pos`` aside) and ``spec_cache_bytes`` its blocks under the
cell's cache specs: the two are equal.

Per cell this records (the reference's record, with ``lower_s`` and
``compile_s`` as ``trace_s`` and ``xla_cost_analysis`` and
``trip_counts`` as ``kernel_launches``):

  * ``memory``: ``argument_bytes``, ``spec_argument_bytes``,
    serving cells' ``cache_bytes`` and ``spec_cache_bytes``,
    ``output_bytes``, ``alias_bytes`` (donated arguments), ``temp_bytes``
    (the peak of live storage less what the rank was handed),
    ``per_device_total`` (the arguments plus ``temp_bytes``: the most the
    rank holds at once) and ``fits_hbm`` (below ``H100.hbm_bytes``),
  * ``hlo_stats``: ``OpStats.as_dict()``,
  * ``roofline``: ``core.hopper.CellRoofline``, predictions from H100
    data-sheet constants.

``device`` is the device a ``meta`` tensor stands for: ``"cuda"`` (the
default) takes the card's routes (the flash and SSD kernels, counted by
their ``cost()``), ``"cpu"`` the plain ones.  Neither needs a card.
``overrides`` and ``batch`` cut a cell (depth, batch) to fit one card;
the record says so under ``cut``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh both [--device cpu]
  ... --out results/dryrun  (JSON per cell; reused unless --force)
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..configs import get_config
from ..core.hopper import H100, CellRoofline
from ..dist.comm_engine import RankMesh, Spec, _axes_of
from ..models.placed import Placed
from ..optim import adamw
from ..train import trainer
from . import specs
from .mesh import fake_world, make_mesh
from .op_analysis import OpAnalysis, dtype_bytes

BATCH_AXES = ("pod", "data")


def mesh_shape_of(multi_pod: bool) -> Tuple[int, ...]:
    """``make_production_mesh``'s shape."""
    return (2, 16, 16) if multi_pod else (16, 16)


def axes_of(shape: Sequence[int]) -> Tuple[str, ...]:
    return (("data", "model") if len(shape) == 2
            else ("pod", "data", "model"))


def depth_cut(arch: str, n_layers: int) -> Dict[str, int]:
    """Overrides that cut ``arch`` to ``n_layers`` and keep a layer of
    each kind: a hybrid's shared block and a vision model's cross layer
    every ``n_layers`` layers, an encoder of at most ``n_layers``."""
    cfg = get_config(arch)
    out = {"n_layers": n_layers}
    if cfg.attn_every:
        out["attn_every"] = min(cfg.attn_every, n_layers)
    if cfg.cross_attn_every:
        out["cross_attn_every"] = min(cfg.cross_attn_every, n_layers)
    if cfg.n_enc_layers:
        out["n_enc_layers"] = min(cfg.n_enc_layers, n_layers)
    return out


# ---------------------------------------------------------------------------
# trees of arguments and specs
# ---------------------------------------------------------------------------

def pairs(tree, spec) -> Iterator[Tuple[torch.Tensor, Any]]:
    """(leaf, spec) over an argument tree and its spec tree (dicts,
    tuples, ``TrainState``s, ``Q8`` moments)."""
    if isinstance(tree, torch.Tensor):
        yield tree, spec
    elif isinstance(tree, dict):
        for k in tree:
            yield from pairs(tree[k], spec[k] if spec is not None else None)
    elif isinstance(tree, adamw.Q8):
        yield from pairs(tree.q, spec.q if spec is not None else None)
        yield from pairs(tree.scale, spec.scale if spec is not None
                         else None)
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from pairs(x, spec[i] if spec is not None else None)


def leaves(tree) -> list:
    return [t for t, _ in pairs(tree, None)]


def shard_shape(shape, spec: Optional[Spec], sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """A device's block of ``shape`` under ``spec`` (the reference's
    ``NamedSharding.shard_shape``)."""
    if spec is None:
        return tuple(shape)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes.get(a, 1) for a in _axes_of(entry))
        out[d] = shape[d] // n
    return tuple(out)


def block_bytes(tree, spec, sizes: Dict[str, int]) -> int:
    """Bytes of a device's blocks of every leaf of ``tree``."""
    return sum(math.prod(shard_shape(t.shape, s, sizes))
               * dtype_bytes(t.dtype) for t, s in pairs(tree, spec))


def storage_bytes(tree) -> int:
    """Bytes of the storages of a tree's tensors, each once."""
    seen, total = set(), 0
    for t in leaves(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _rows(spec: Spec) -> Spec:
    """The batch-axes part of a spec: the rank keeps its batch rows."""
    return Spec(*(e if e is not None and set(_axes_of(e)) <= set(BATCH_AXES)
                  else None for e in spec))


# ---------------------------------------------------------------------------
# the rank's arguments
# ---------------------------------------------------------------------------

def rank_args(cell, mesh, gen: Optional[torch.Generator] = None,
              device=None) -> Tuple[tuple, Any]:
    """(rank 0's arguments, the spec tree of what it holds of them):
    module docstring.  With ``gen`` the arguments are real tensors on
    ``device`` (:func:`realize`), for a real run of the cell."""
    vocab = cell.cfg.vocab

    def real(tree):
        return tree if gen is None else realize(tree, gen, device, vocab)
    if cell.kind == "train":
        state, batch = real(cell.args)
        st_sh, b_sh = cell.in_shardings
        placed = trainer.place_state(state, st_sh, mesh)
        del state
        return (placed, batch), (None, b_sh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    params = Placed(real(placed_struct(cell.args[0], cell.in_shardings[0],
                                       sizes)),
                    cell.in_shardings[0], RankMesh(mesh))
    held = [None, _rows(cell.in_shardings[1])]
    if cell.kind == "prefill":
        rest = real(cell.args[1:])
        if len(rest) > 1:
            held.append(_rows(cell.in_shardings[2]))
        return (params, *rest), tuple(held)
    toks = real(cell.args[1])
    cache = real(placed_struct(cell.args[2], cell.in_shardings[2], sizes))
    cache["pos"] = torch.tensor(cell.shape.seq_len - 1, dtype=torch.int32)
    return (params, toks, cache), (None, held[1], None)


def placed_struct(tree, spec, sizes: Dict[str, int]):
    """``meta`` stand-ins of a device's blocks of ``tree``'s leaves under
    ``spec`` (dicts of leaves)."""
    if isinstance(tree, dict):
        return {k: placed_struct(v, spec[k], sizes) for k, v in tree.items()}
    return specs._sds(shard_shape(tree.shape, spec, sizes), tree.dtype)


def _no_pos(tree):
    return {k: v for k, v in tree.items() if k != "pos"}


def cache_memory(cell, args, out, mesh) -> Dict[str, int]:
    """A serving cell's ``cache_bytes`` (what the rank holds of the
    cache: a decode cell's argument, a prefill cell's output) and
    ``spec_cache_bytes`` (the blocks the cell's cache specs place), ``pos``
    aside."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if cell.kind == "decode":
        held, struct, spec = args[2], cell.args[2], cell.in_shardings[2]
    else:
        held, spec = out[1], cell.out_shardings[1]
        struct = specs.cache_struct(cell.cfg, cell.shape.global_batch,
                                    cell.shape.seq_len)
    return {"cache_bytes": block_bytes(_no_pos(held), None, sizes),
            "spec_cache_bytes": block_bytes(_no_pos(struct), _no_pos(spec),
                                            sizes)}


def spec_argument_bytes(cell, mesh) -> int:
    """What the cell's ``in_shardings`` place on a device: the sum over
    its arguments of each leaf's block (the reference's
    ``argument_size_in_bytes``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return block_bytes(cell.args, cell.in_shardings, sizes)


def argument_bytes(args, held, mesh) -> int:
    """What the rank holds of its arguments: its blocks where ``held``
    names a spec, the whole leaf where it names none."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return block_bytes(args, held, sizes)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def analyze_cell(cell, mesh, args, held, *, device: str = "cuda"
                 ) -> Tuple[Any, Dict]:
    """Run ``cell.fn`` on ``args`` under :class:`OpAnalysis`: (its
    output, {stats, memory, trace_s}).  Runs on any world: meta in a fake
    one, real tensors on real ranks."""
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    handed = storage_bytes(args)
    mode = OpAnalysis(leaves(args), device=device)
    t0 = time.perf_counter()
    with grad, mode:
        out = cell.fn(*args)
    trace_s = time.perf_counter() - t0
    st = mode.stats
    arg_b = argument_bytes(args, held, mesh)
    temp = st.peak_live_bytes - handed
    alias = sum(argument_bytes(args[i], held[i], mesh) for i in cell.donate)
    total = arg_b + temp
    memory = {"argument_bytes": arg_b,
              "spec_argument_bytes": spec_argument_bytes(cell, mesh),
              "output_bytes": storage_bytes(out), "alias_bytes": alias,
              "temp_bytes": temp, "per_device_total": total,
              "fits_hbm": bool(total < H100.hbm_bytes)}
    if cell.kind != "train":
        memory.update(cache_memory(cell, args, out, mesh))
    return out, {"stats": st, "memory": memory, "trace_s": trace_s}


def _record(arch, shape_name, label, cell, mesh, res, device, cut) -> Dict:
    st = res["stats"]
    chips = math.prod(mesh.shape)
    roof = CellRoofline(
        cell=f"{arch}/{shape_name}/{label}", chips=chips,
        flops=st.flops * chips, bytes=st.hbm_bytes * chips,
        collective_bytes=st.wire_bytes * chips,
        model_flops=cell.model_flops,
        network_bytes=st.wire_by_link.get("network", 0.0) * chips)
    return {"arch": arch, "shape": shape_name, "mesh": label,
            "mesh_shape": list(mesh.shape), "chips": chips,
            "kind": cell.kind, "device": device, "cut": cut,
            "trace_s": round(res["trace_s"], 3), "memory": res["memory"],
            "hlo_stats": st.as_dict(),
            "kernel_launches": dict(st.kernel_launches),
            "roofline": roof.as_dict()}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             device: str = "cuda", overrides: Optional[Dict] = None,
             batch: Optional[int] = None, seq_len: Optional[int] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             backend: str = "nccl") -> Dict:
    """The dry run of one cell as rank 0 of a fake world: its record
    (module docstring).  ``mesh_shape`` replaces the production mesh
    (``(data, model)`` or ``(pod, data, model)``); ``backend`` is the one
    the fake world stands for; ``seq_len`` cuts the length as ``batch``
    cuts the batch."""
    shape = tuple(mesh_shape) if mesh_shape else mesh_shape_of(multi_pod)
    label = ("x".join(map(str, shape)) if mesh_shape
             else "multi" if multi_pod else "single")
    with fake_world(math.prod(shape), backend=backend):
        mesh = make_mesh(shape, axes_of(shape))
        cell = specs.input_specs(arch, shape_name, mesh, overrides=overrides,
                                 batch=batch, seq_len=seq_len)
        args, held = rank_args(cell, mesh)
        _, res = analyze_cell(cell, mesh, args, held, device=device)
        cut = ({"overrides": overrides or {}, "batch": batch,
                "seq_len": seq_len}
               if overrides or batch is not None or seq_len is not None
               else None)
        return _record(arch, shape_name, label, cell, mesh, res, device, cut)


def real_cell(arch: str, shape_name: str, mesh_shape: Sequence[int],
              overrides: Optional[Dict] = None, batch: Optional[int] = None,
              seq_len: Optional[int] = None, device=None, seed: int = 0
              ) -> Dict:
    """The same count of one cell on a real world of ranks (run in every
    rank of it), on real tensors of the cell's shapes drawn from
    ``seed``: this rank's record, to hold a dry run to."""
    from ..kernels.ops import resolve_device
    dev = resolve_device(device)
    shape = tuple(mesh_shape)
    mesh = make_mesh(shape, axes_of(shape), device=dev)
    cell = specs.input_specs(arch, shape_name, mesh, overrides=overrides,
                             batch=batch, seq_len=seq_len)
    gen = torch.Generator().manual_seed(seed)
    args, held = rank_args(cell, mesh, gen, dev)
    _, res = analyze_cell(cell, mesh, args, held, device=dev.type)
    return _record(arch, shape_name, "x".join(map(str, shape)), cell, mesh,
                   res, dev.type, {"overrides": overrides or {},
                                   "batch": batch, "seq_len": seq_len})


# ---------------------------------------------------------------------------
# real tensors of a cell's shapes (a real run to hold the dry run to)
# ---------------------------------------------------------------------------

def realize(tree, gen: torch.Generator, device, vocab: int):
    """Real tensors of ``tree``'s meta leaves' shapes and dtypes on
    ``device``, drawn on ``gen``'s device: floats N(0, 0.02^2), integers
    tokens below ``vocab`` (step counters and 8-bit moments 0), a CPU
    leaf as it is."""
    def one(t: torch.Tensor) -> torch.Tensor:
        if not t.is_meta:
            return t
        if t.dtype.is_floating_point:
            x = torch.randn(t.shape, generator=gen, device=gen.device)
            return x.mul_(0.02).to(device=device, dtype=t.dtype)
        if t.dim() >= 2 and t.dtype in (torch.int32, torch.int64):
            x = torch.randint(0, vocab, t.shape, generator=gen,
                              device=gen.device, dtype=t.dtype)
            return x.to(device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return one(x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, adamw.Q8):
            return adamw.Q8(walk(x.q), walk(x.scale), x.shape)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return x
    return walk(tree)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def roofline_line(rec: Dict) -> str:
    r, m = rec["roofline"], rec["memory"]
    return (f"bottleneck={r['bottleneck']} compute={r['compute_s']:.4g}s "
            f"memory={r['memory_s']:.4g}s "
            f"collective={r['collective_s']:.4g}s "
            f"roofline_fraction={r['roofline_fraction']:.3f} "
            f"per_device_total={m['per_device_total'] / 1e9:.3f}GB "
            f"fits_hbm={m['fits_hbm']}")


_SHORT = {"compute": "comp", "memory": "mem", "collective": "coll"}


def _total(rec: Dict) -> str:
    m = rec["memory"]
    return (f"{m['per_device_total'] / 1e9:.1f}"
            f"{'' if m['fits_hbm'] else ' (no)'}")


def _entry(rec: Dict) -> str:
    r = rec["roofline"]
    return (f"{_total(rec)} GB, {_SHORT[r['bottleneck']]} "
            f"{r['compute_s']:.3g}/{r['memory_s']:.3g}/"
            f"{r['collective_s']:.3g} s, {r['roofline_fraction']:.3f}")


def table(out_dir: str) -> str:
    """A markdown table of the records under ``out_dir``, a row an arch
    and a column a shape: on 16x16 (S) and 2x16x16 (M) the per-device
    total in GB (``(no)`` where it does not fit a card), the bottleneck,
    the compute / memory / collective terms and ``roofline_fraction``;
    then the per-device totals on one card (1x1) and four (2x2) where
    those records exist."""
    from ..configs import ARCH_IDS, SHAPES

    def load(arch, shape, tag):
        path = os.path.join(out_dir, f"{arch}_{shape}_{tag}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def cell(arch, shape):
        recs = {t: load(arch, shape, t)
                for t in ("single", "multi", "1x1", "2x2")}
        if recs["single"] is None:
            return "—"
        fit = " / ".join(_total(recs[t]) for t in ("1x1", "2x2")
                         if recs[t] is not None)
        out = f"S {_entry(recs['single'])}"
        if recs["multi"] is not None:
            out += f"; M {_entry(recs['multi'])}"
        return out + (f"; 1x1 / 2x2 {fit} GB" if fit else "")
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "| --- |" + " --- |" * len(SHAPES)]
    for arch in ARCH_IDS:
        lines.append(f"| {arch} | "
                     + " | ".join(cell(arch, s) for s in SHAPES) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    from ..configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch ids (comma-separated) or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"of {list(SHAPES)} (comma-separated) or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device a meta tensor stands for (the routes "
                         "taken); no card is needed")
    ap.add_argument("--mesh-shape", default=None,
                    help="a mesh such as 2x2 in place of the production "
                         "meshes (its records are tagged with it)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the records under "
                         "--out and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.mesh_shape:
        meshes = [tuple(int(n) for n in args.mesh_shape.split("x"))]
    os.makedirs(args.out, exist_ok=True)

    results, failures = [], []
    t_all = time.perf_counter()
    for arch, shape_name in specs.all_cells():
        if arch not in archs:
            continue
        if shape_name not in shapes:
            continue
        for multi in meshes:
            label = ("x".join(map(str, multi)) if isinstance(multi, tuple)
                     else "multi" if multi else "single")
            tag = f"{arch}_{shape_name}_{label}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {tag}")
                results.append(tag)
                continue
            print(f"[run] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape_name, multi is True,
                               device=args.device,
                               mesh_shape=(multi if isinstance(multi, tuple)
                                           else None))
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"  ok: trace={rec['trace_s']}s {roofline_line(rec)}",
                      flush=True)
                results.append(tag)
            except Exception as e:  # noqa: BLE001 - reported and counted
                failures.append((tag, repr(e)))
                print(f"  FAIL {tag}: {e}")
                traceback.print_exc()

    # note the assignment-mandated skips
    skips = [{"arch": a, "shape": s, "reason": r}
             for a, s, r in specs.skipped_cells()]
    with open(os.path.join(args.out, "_skips.json"), "w") as f:
        json.dump(skips, f, indent=1)
    print(f"\ndone: {len(results)} cells ok, {len(failures)} failed, "
          f"{len(skips)} skipped-by-assignment "
          f"({time.perf_counter() - t_all:.1f} s)")
    if failures:
        for tag, err in failures:
            print(f"  FAILED {tag}: {err}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
