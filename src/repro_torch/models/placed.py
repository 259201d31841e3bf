"""Parameters placed on a mesh: each rank holds its blocks, and a layer's
weights are gathered whole just before the layer runs.

The reference's serving and training cells place every parameter with
``launch.specs.param_shardings``: the rules of ``common.DEFAULT_RULES``
on ``transformer.param_axes`` (FSDP over ``data`` on the ``embed`` dim,
``model`` on heads, kv, mlp, vocab and ssm_inner, the divisibility
fallback replicating a dim its axes do not divide).  Here one process is
one mesh position (``models.explicit_tp``'s rank model):

* :func:`place_params` keeps the rank's block of every leaf under those
  specs (copies, on the mesh's device) in a :class:`Placed` tree, which
  carries the specs and the rank's mesh;
* the model entry points read a parameter tree only through the
  accessors below, which take a whole tree (a plain dict) or a
  :class:`Placed` one.  On a whole tree they return what the models
  read before (views); on a placed tree
  - :func:`layers` gathers layer ``i`` of a stacked subtree whole when
    it is asked for, each leaf over the axes its spec names, minor axis
    first, so the caller holds one gathered layer at a time;
  - :func:`whole` gathers an unstacked subtree or leaf (the final and
    encoder norms, the hybrid's shared block, once an application);
  - :func:`embed` looks the tokens up in the rank's vocab rows of the
    table gathered over its ``embed`` axes, zeros for the rows another
    rank holds, summed over the vocab axes: one value plus zeros, exact;
  - :func:`out_projection` is the rank's vocab block of the output
    projection (``unembed``, or ``embed.T`` under the transposed spec
    when embeddings are tied) gathered over its ``embed`` axes, and the
    axes its logits are gathered over (under autograd the whole
    projection).

Every accessor gathers through :class:`GatherLeaf`, whose backward
(the sharded train step, ``train.trainer``) is :func:`sum_block`: the
rank's block of the sum of every rank's whole cotangent.  So a layer's
gradient is summed onto the rank's blocks as soon as the layer's
backward ends, and no whole gradient outlives its layer.  Under
``no_grad`` (serving) the Function runs its forward alone, which is
:func:`gather`.  :data:`GATHERED` counts the gathered bytes alive on the rank
(the most at once since its ``reset``).

The leaf rules (:func:`local`, :func:`own`, :func:`gather`) serve
``train.trainer``'s placed train state, ``checkpoint.store`` and
``launch.specs`` too.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import weakref

import torch

from ..dist.comm_engine import RankMesh, Spec, _axes_of
from .common import DEFAULT_RULES
from .explicit_tp import _AllReduce


# ---------------------------------------------------------------------------
# blocks of leaves under specs
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, a ``RankMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, RankMesh):
        return dict(mesh.sizes)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rank_mesh(mesh) -> RankMesh:
    return mesh if isinstance(mesh, RankMesh) else RankMesh(mesh)


def axes_in(entry, rm: RankMesh) -> Tuple[str, ...]:
    """The mesh axes a spec entry names that the mesh has (an axis it
    lacks has size 1)."""
    return tuple(a for a in _axes_of(entry) if a in rm.sizes)


def local(x: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """This rank's block of the whole ``x`` (a view)."""
    for d, entry in enumerate(spec):
        idx, count = 0, 1
        for a in axes_in(entry, rm):
            idx, count = idx * rm.sizes[a] + rm.coord[a], count * rm.sizes[a]
        if count > 1:
            step = x.shape[d] // count
            x = x.narrow(d, idx * step, step)
    return x


def own(x: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """This rank's block of ``x`` as a tensor of its own, on the mesh's
    device."""
    return local(x, spec, rm).to(rm.device, copy=True).contiguous()


def gather(x: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """The whole leaf from every rank's block: each dimension gathered
    over the axes its entry names, minor axis first (``x`` itself where
    no axis above 1 splits it)."""
    for d, entry in enumerate(spec):
        for a in reversed(axes_in(entry, rm)):
            if rm.sizes[a] > 1:
                x = rm.all_gather(x, a, d)
    return x


def sum_block(g: torch.Tensor, spec: Spec, rm: RankMesh,
              keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's block of the sum of every rank's whole partial ``g``:
    a reduce-scatter over each axis the spec shards the leaf over (its
    dimensions in order, an entry's axes major to minor), then an
    all_reduce of the block over the mesh's other axes but ``keep`` (the
    axes that split a leaf gathered only in part: their ranks hold other
    blocks), in the mesh's order: one collective an axis, in a fixed
    order."""
    used = []
    for d, entry in enumerate(spec):
        for a in axes_in(entry, rm):
            used.append(a)
            g = rm.reduce_scatter(g, a, d)
    g = rm.psum(g, tuple(a for a in rm.axes if rm.sizes[a] > 1
                         and a not in used and a not in keep))
    return g.to(rm.device).contiguous()


class GatherLeaf(torch.autograd.Function):
    """:func:`gather` under autograd: forward the whole leaf from the
    rank's block ``x`` (over the axes ``spec`` names), backward
    :func:`sum_block` of the cotangent, the rank's block of every rank's
    partial summed.  The sharded step's loss shares add up to the global
    loss once (``train.trainer``), so that sum is the block of the
    one-device gradient.  ``keep``: the axes a partial gather leaves
    split (the embedding's vocab axes), whose ranks hold other blocks
    and are not summed over."""

    @staticmethod
    def forward(ctx, x, spec, rm, keep):
        ctx.spec, ctx.rm, ctx.keep = spec, rm, keep
        return gather(x, spec, rm)

    @staticmethod
    def backward(ctx, g):
        return sum_block(g, ctx.spec, ctx.rm, ctx.keep), None, None, None


class LiveBytes:
    """Bytes of the gathered leaves alive on this rank: ``bytes`` now,
    ``peak`` the most at once since :meth:`reset`; each storage counted
    from its gather to its release, as ``launch.op_analysis`` counts
    live storage."""

    def __init__(self):
        self.bytes = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def reset(self) -> None:
        self.peak = self.bytes

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = id(st), st.nbytes()
        if key in self._refs:
            return

        def gone(_, key=key, n=n):
            if self._refs.pop(key, None) is not None:
                self.bytes -= n
        self._refs[key] = weakref.ref(st, gone)
        self.bytes += n
        self.peak = max(self.peak, self.bytes)


#: the gathered weights alive on this rank (:class:`LiveBytes`)
GATHERED = LiveBytes()


def _gather(x: torch.Tensor, spec: Spec, rm: RankMesh,
            keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """An accessor's gather, through :class:`GatherLeaf` (under
    ``no_grad`` its forward alone: :func:`gather`); a gathered result is
    counted in :data:`GATHERED`."""
    out = GatherLeaf.apply(x, spec, rm, keep)
    if any(rm.sizes[a] > 1 for e in spec for a in axes_in(e, rm)):
        GATHERED.add(out)
    return out


def tree_map(fn, tree, specs):
    """``fn(tensor, spec)`` over a parameter tree; plain dicts out."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


# ---------------------------------------------------------------------------
# a placed parameter tree
# ---------------------------------------------------------------------------

class Placed(dict):
    """A rank's blocks of a parameter tree: the tree's keys, nested dicts
    of block tensors, with ``specs`` (the same keys, a ``Spec`` a leaf)
    and ``mesh`` (the rank's ``RankMesh`` the blocks are placed on)."""

    def __init__(self, blocks: Dict[str, Any], specs: Dict[str, Any],
                 mesh: RankMesh):
        super().__init__(blocks)
        self.specs = specs
        self.mesh = mesh

    def map(self, fn) -> "Placed":
        """``fn(key, block)`` over every leaf (``key`` the leaf's own
        name), the specs and mesh kept."""
        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else fn(k, v)
                    for k, v in tree.items()}
        return Placed(walk(self), self.specs, self.mesh)


def param_specs(params: Dict[str, Any], axes: Dict[str, Any], mesh
                ) -> Dict[str, Any]:
    """A ``Spec`` a parameter of ``params`` (whole leaves, or anything
    with their shapes) from its logical axes (``transformer.param_axes``)
    under ``common.DEFAULT_RULES``, whose "layers" map to no mesh axis
    (:func:`layers` gathers a layer's block of every other dim).
    ``launch.specs.param_shardings`` is this."""
    return DEFAULT_RULES.specs(axes, params, mesh_shape(mesh))


def place_params(params: Dict[str, Any], cfg, mesh) -> Placed:
    """This rank's blocks of the whole ``params`` under
    :func:`param_specs`, each a tensor of its own on the mesh's device
    (the whole tree can be freed after), with their specs and the rank's
    mesh.  ``mesh``: a ``DeviceMesh`` or this rank's ``RankMesh``."""
    from .transformer import param_axes
    rm = rank_mesh(mesh)
    specs = param_specs(params, param_axes(cfg), rm)
    return Placed(tree_map(lambda x, s: own(x, s, rm), params, specs),
                  specs, rm)


# ---------------------------------------------------------------------------
# the models' accessors
# ---------------------------------------------------------------------------

def _at(params, path):
    node = params
    for k in path:
        node = node[k]
    return node


def whole(params: Dict[str, Any], *path: str) -> Any:
    """The subtree or leaf at ``path``, whole: as it is in a whole tree,
    gathered from the ranks' blocks in a placed one (collective)."""
    node = _at(params, path)
    if not isinstance(params, Placed):
        return node
    rm = params.mesh
    return tree_map(lambda x, s: _gather(x, s, rm), node,
                    _at(params.specs, path))


def layer_params(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def unstack(stacked: Dict[str, Any]) -> list:
    """Every layer of a stacked parameter tree, as views from one
    ``unbind`` a leaf.  Under autograd a leaf's gradient is then one
    ``stack`` of its layers' gradients, where indexing it layer by layer
    (:func:`layer_params`) would add a zero-filled gradient of the whole
    stack for every layer."""
    def split(tree):
        return {k: (split(v) if isinstance(v, dict) else v.unbind(0))
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: (pick(v, i) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}
    parts = split(stacked)
    return [pick(parts, i) for i in range(_depth(stacked))]


def _depth(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


class _Gathered(Sequence):
    """The layers of a placed stacked subtree: item ``i`` is layer ``i``
    gathered whole, made when it is asked for and held by the caller
    alone.  The blocks are :func:`unstack`'s views, so under autograd a
    leaf's block gradient is one ``stack`` of its layers' summed
    blocks."""

    def __init__(self, params: Placed, path: Tuple[str, ...]):
        self.parts = unstack(_at(params, path))
        self.specs = _at(params.specs, path)
        self.mesh = params.mesh

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rm = self.mesh
        # the layer dim is never split ("layers" maps to no mesh axis)
        return tree_map(lambda x, s: _gather(x, Spec(*s[1:]), rm),
                        self.parts[i], self.specs)


def layers(params: Dict[str, Any], *path: str) -> Sequence:
    """The layers of the stacked subtree at ``path``, by index: a whole
    tree's are :func:`unstack`'s views; a placed tree's are gathered
    whole one at a time, when indexed (collective), so a loop that
    passes ``layers[i]`` straight to the block holds one gathered layer
    while it runs and drops it before the next is gathered."""
    if isinstance(params, Placed):
        return _Gathered(params, path)
    return unstack(_at(params, path))


def embed(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (int, any shape) in the table's
    dtype.  Placed: the rank's vocab rows of the table gathered over its
    ``embed`` axes, zeros for a token another rank's rows hold, summed
    over the vocab axes (one value plus zeros: exact)."""
    if not isinstance(params, Placed):
        return params["embed"][tokens]
    rm, (v_entry, e_entry) = params.mesh, params.specs["embed"]
    vocab = axes_in(v_entry, rm)
    table = _gather(params["embed"], Spec(None, e_entry), rm, keep=vocab)
    split = tuple(a for a in vocab if rm.sizes[a] > 1)
    if not split:
        return table[tokens]
    idx, _ = rm.shard_of(vocab)
    n = table.shape[0]
    t = tokens - idx * n
    inside = (t >= 0) & (t < n)
    rows = table[t.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return _AllReduce.apply(rows, rm, split)


def out_projection(params: Dict[str, Any], tie: bool
                   ) -> Tuple[torch.Tensor, RankMesh, Tuple[str, ...]]:
    """(the output projection ``(d, vocab block)`` as held, the mesh, the
    axes the logits' vocab dim is gathered over): ``unembed`` or, tied,
    ``embed.T``.  Whole trees: the whole leaf and no axes.  Placed: the
    rank's vocab block gathered over its ``embed`` axes; while autograd
    records, the whole leaf (no axes), so the logits' gradient reaches
    the hidden states through one product over the whole vocabulary, as
    on one device (``train.trainer``'s module docstring)."""
    if not isinstance(params, Placed):
        w = params["embed"].T if tie else params["unembed"]
        return w, None, ()
    rm = params.mesh
    if tie:
        v_entry, e_entry = params.specs["embed"]
        w = params["embed"].T
    else:
        e_entry, v_entry = params.specs["unembed"]
        w = params["unembed"]
    if torch.is_grad_enabled():
        return _gather(w, Spec(e_entry, v_entry), rm), rm, ()
    vocab = axes_in(v_entry, rm)
    w = _gather(w, Spec(e_entry, None), rm, keep=vocab)
    return w, rm, tuple(a for a in vocab if rm.sizes[a] > 1)
