"""Parameters placed on a mesh: each rank holds its blocks, and a layer's
weights are gathered over the batch axes just before the layer runs,
each leaf keeping the rank's ``model`` block.

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
  accessors below, after :func:`on_mesh` (once, at the outer entry
  points: ``models.transformer``'s docstring names them), which gives a
  whole tree under a mesh with a ``model`` axis above 1 the same route:
  a :class:`Placed` of its whole leaves (``whole=True``) whose ``model``
  blocks are views.  On one device, or where ``model`` is 1, a whole
  tree is read as it is.  On a placed tree
  - :func:`layers` gathers layer ``i`` of a stacked subtree when it is
    asked for, each leaf over the batch axes its spec names (minor axis
    first) and never over ``model``: the rank holds the leaf's ``model``
    block, whole over ``data`` and ``pod``, in a :class:`Layer` whose
    ``spans`` give each block's place in the whole leaf (:class:`Span`),
    so the caller holds one gathered layer at a time and computes on its
    blocks (``explicit_tp``'s rank model).  The SSM mixer's leaves
    (:data:`WHOLE_OVER_MODEL`) are the one exception, declared: they are
    gathered whole over ``model`` too;
  - :func:`whole` gathers an unstacked subtree or leaf the same way
    (the final and encoder norms, the hybrid's shared block, once an
    application);
  - :func:`embed` looks the tokens up in the rank's vocab rows of the
    table gathered over its ``embed`` axes, zeros for the rows another
    rank holds, summed over the vocab axes: one value plus zeros, exact;
  - :func:`out_projection` is the rank's vocab block of the output
    projection (``unembed``, or ``embed.T`` under the transposed spec
    when embeddings are tied) gathered over its ``embed`` axes, with the
    axes its vocab dim is split over and the block's first column, in
    serving and in training alike.

Every accessor gathers through :class:`GatherLeaf`, whose backward (the
sharded train step, ``train.trainer``) is :func:`sum_block` with
``keep`` the axes the gather leaves split: a reduce-scatter over the
batch axes the spec shards and no sum over ``model``, so a rank's block
gradient is its own.  A layer's gradient is summed onto the rank's
blocks as soon as the layer's backward ends, and no gathered gradient
outlives its layer.  Under ``no_grad`` (serving) the Function runs its
forward alone, which is :func:`gather`.  :data:`GATHERED` counts the
gathered bytes alive on the rank (the most at once since its
``reset``).

The leaf rules (:func:`local`, :func:`own`, :func:`gather`) serve
``train.trainer``'s placed train state, ``checkpoint.store`` and
``launch.specs`` too.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import weakref

import torch

from ..dist.comm_engine import RankMesh, Spec, _axes_of
from ..launch.mesh import current_mesh
from .common import DEFAULT_RULES
from .explicit_tp import MODEL, _AllReduce


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
    and ``mesh`` (the rank's ``RankMesh`` the blocks are placed on).
    ``whole``: the leaves are whole (:func:`on_mesh`), and the accessors
    take the rank's blocks of them as views, with no collective."""

    def __init__(self, blocks: Dict[str, Any], specs: Dict[str, Any],
                 mesh: RankMesh, whole: bool = False):
        super().__init__(blocks)
        self.specs = specs
        self.mesh = mesh
        self.whole = whole

    def map(self, fn) -> "Placed":
        """``fn(key, block)`` over every leaf (``key`` the leaf's own
        name), the specs and mesh kept."""
        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else fn(k, v)
                    for k, v in tree.items()}
        return Placed(walk(self), self.specs, self.mesh, self.whole)


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


def on_mesh(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The tree the entry points read: a placed tree as it is; a whole
    tree under a mesh (``launch.mesh.set_mesh``) with a ``model`` axis
    above 1 as a :class:`Placed` of its whole leaves under
    :func:`param_specs` (``whole=True``), whose accessors take the rank's
    ``model`` blocks as views, so a whole and a placed tree on one mesh
    run the same arithmetic; else the whole tree as it is."""
    if isinstance(params, Placed):
        return params
    rm = current_mesh()
    if rm is None or rm.sizes.get(MODEL, 1) <= 1:
        return params
    from .transformer import param_axes
    return Placed(params, param_specs(params, param_axes(cfg), rm), rm,
                  whole=True)


class Span(NamedTuple):
    """Where a rank's ``model`` block of a leaf sits along the leaf's
    ``model`` dim: columns (or rows) ``[start, stop)`` of ``extent``."""

    start: int
    stop: int
    extent: int


class Layer(dict):
    """A layer's (or an unstacked subtree's) leaves as the rank computes
    on them: nested dicts of tensors, each dict with ``spans`` ({leaf key:
    :class:`Span`}) for each of its leaves that is the rank's ``model``
    block; a leaf with no span is whole (``explicit_tp.span``)."""

    def __init__(self, leaves: Dict[str, Any], spans: Dict[str, Span]):
        super().__init__(leaves)
        self.spans = spans


#: the subtrees of a layer gathered whole over ``model`` too: the SSM
#: mixer, whose ``in_proj`` columns ``[z | x | B | C | dt]`` do not split
#: on head boundaries (ROADMAP Queue 1)
WHOLE_OVER_MODEL = ("ssm",)


def _model_split(spec: Spec, rm: RankMesh
                 ) -> Tuple[Spec, Tuple[str, ...], Optional[int]]:
    """(the spec without the ``model`` axis, the axes that keeps split,
    the dim ``model`` splits or None) of a leaf's spec on ``rm``; an
    entry that names ``model`` beside another axis above 1 is refused."""
    out, keep, dim = [], (), None
    for d, entry in enumerate(spec):
        axes = axes_in(entry, rm)
        if MODEL in axes and rm.sizes[MODEL] > 1:
            if any(rm.sizes[a] > 1 for a in axes if a != MODEL):
                raise ValueError(f"a spec entry {entry!r} splits one dim "
                                 f"over {MODEL!r} and another axis")
            out.append(None)
            keep, dim = (MODEL,), d
        else:
            out.append(entry)
    return Spec(*out), keep, dim


def _held(x: torch.Tensor, spec: Spec, params: Placed, model: bool = True
          ) -> Tuple[torch.Tensor, Optional[Span]]:
    """(the leaf as the rank computes on it, its :class:`Span` or None):
    of a placed tree's block, gathered over the spec's batch axes (and
    over ``model`` too where ``model`` is False); of a whole tree's leaf,
    the rank's ``model`` block as a view."""
    rm = params.mesh
    rest, keep, dim = _model_split(spec, rm)
    if not model:
        rest, keep, dim = spec, (), None
    if params.whole:
        if dim is None:
            return x, None
        n, i = rm.sizes[MODEL], rm.coord[MODEL]
        step = x.shape[dim] // n
        return (x.narrow(dim, i * step, step),
                Span(i * step, (i + 1) * step, x.shape[dim]))
    out = _gather(x, rest, rm, keep)
    if dim is None:
        return out, None
    n, i, step = rm.sizes[MODEL], rm.coord[MODEL], out.shape[dim]
    return out, Span(i * step, (i + 1) * step, n * step)


def _layer(node, specs, params: Placed, model: bool = True, drop: int = 0):
    """A subtree as the rank computes on it (:class:`Layer` dicts; a leaf
    alone as a tensor): every leaf through :func:`_held`, its spec's
    first ``drop`` entries cut (the layer dim); the subtrees of
    :data:`WHOLE_OVER_MODEL` whole over ``model``."""
    if not isinstance(node, dict):
        return _held(node, Spec(*specs[drop:]), params, model)[0]
    leaves, spans = {}, {}
    for k, v in node.items():
        if isinstance(v, dict):
            leaves[k] = _layer(v, specs[k], params,
                               model and k not in WHOLE_OVER_MODEL, drop)
        else:
            leaves[k], sp = _held(v, Spec(*specs[k][drop:]), params, model)
            if sp is not None:
                spans[k] = sp
    return Layer(leaves, spans)


def held_bytes(tree, specs, mesh, model: bool = True) -> int:
    """The bytes of a whole subtree (or leaf) ``tree`` as a rank computes
    on it under ``specs`` on ``mesh``: each leaf whole over the batch
    axes, the rank's ``model`` block of a leaf whose spec splits it over
    ``model`` (whole in :data:`WHOLE_OVER_MODEL`), i.e. what
    :func:`layers` and :func:`whole` gather of it."""
    rm = rank_mesh(mesh)
    if isinstance(tree, dict):
        return sum(held_bytes(v, specs[k], rm,
                              model and k not in WHOLE_OVER_MODEL)
                   for k, v in tree.items())
    n = tree.numel() * tree.element_size()
    if model and _model_split(specs, rm)[2] is not None:
        n //= rm.sizes[MODEL]
    return n


def whole(params: Dict[str, Any], *path: str) -> Any:
    """The unstacked subtree or leaf at ``path`` as the rank computes on
    it: as it is in a whole tree off a model mesh; in a placed tree
    gathered over the batch axes, each leaf keeping its ``model`` block
    (collective), a :class:`Layer` for a subtree."""
    node = _at(params, path)
    if not isinstance(params, Placed):
        return node
    return _layer(node, _at(params.specs, path), params)


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
    as the rank computes on it (a :class:`Layer`: gathered over the batch
    axes, each leaf its ``model`` block), made when it is asked for and
    held by the caller alone.  The blocks are :func:`unstack`'s views,
    so under autograd a leaf's block gradient is one ``stack`` of its
    layers' summed blocks."""

    def __init__(self, params: Placed, path: Tuple[str, ...]):
        self.parts = unstack(_at(params, path))
        self.specs = _at(params.specs, path)
        self.params = params
        self.model = not any(k in WHOLE_OVER_MODEL for k in path)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        # the layer dim is never split ("layers" maps to no mesh axis)
        return _layer(self.parts[i], self.specs, self.params, self.model,
                      drop=1)


def layers(params: Dict[str, Any], *path: str) -> Sequence:
    """The layers of the stacked subtree at ``path``, by index: a whole
    tree's are :func:`unstack`'s views; a placed tree's are gathered over
    the batch axes one at a time, when indexed (collective), each leaf
    keeping its ``model`` block, so a loop that passes ``layers[i]``
    straight to the block holds one gathered layer while it runs and
    drops it before the next is gathered."""
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
    if params.whole:
        table = local(params["embed"], Spec(v_entry, None), rm)
    else:
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
                   ) -> Tuple[torch.Tensor, Optional[RankMesh],
                              Tuple[str, ...], int]:
    """(the output projection ``(d, vocab block)`` as held, the mesh, the
    axes its vocab dim is split over, the block's first column):
    ``w_out`` where a serving engine prepared it, else ``unembed`` or,
    tied, ``embed.T``.  Whole trees off a model mesh: the whole leaf, no
    axes.  Placed: the rank's vocab block gathered over its ``embed``
    axes (a view of it in a whole tree on a model mesh), in serving and
    in training: the logits are the rank's vocab block, which serving
    gathers (``transformer.logits_from_hidden``) and training takes the
    loss on (``train.trainer.rank_loss``)."""
    if not isinstance(params, Placed):
        w = params.get("w_out")
        if w is None:
            w = params["embed"].T if tie else params["unembed"]
        return w, None, (), 0
    rm = params.mesh
    if tie:
        v_entry, e_entry = params.specs["embed"]
        w = params["embed"].T
    else:
        e_entry, v_entry = params.specs["unembed"]
        w = params["unembed"]
    vocab = axes_in(v_entry, rm)
    if params.whole:
        w = local(params.get("w_out", w), Spec(None, v_entry), rm)
    else:
        w = _gather(w, Spec(e_entry, None), rm, keep=vocab)
    split = tuple(a for a in vocab if rm.sizes[a] > 1)
    idx, _ = rm.shard_of(split)
    return w, rm, split, idx * w.shape[1]
