"""AdamW with the reference's own update (port of
``repro.training.optimizer``: ``AdamW``, ``AdamWState``,
``cosine_schedule``).

It differs from ``torch.optim.AdamW``'s defaults, so the port carries the
update itself: b2 = 0.95, a global-norm gradient clip before the moments,
f32 moments whatever the parameter dtype, weight decay added to the update
of matrices only (norms and biases exempt), and ``lr`` a float or a
function of the step (1 for the first update).

Two interfaces over one update:

* the reference's functional one over a parameter tree (nested dicts of
  tensors, as the model bundles hold them): ``state = opt.init(params)``,
  ``params, state, grad_norm = opt.update(grads, state, params)``. To keep
  one copy of the parameters and moments on the card, ``update`` writes the
  new values into the parameter and moment tensors it was given and
  returns those same tensors (the reference returns new arrays), a piece
  of at most ``UPDATE_ELEMS`` elements at a time (``_pieces``), so its f32
  temporaries stay a piece's and not a stacked leaf's;
* the torch one the ExpertMLP predictor trains with: ``AdamW(params,
  ...)``, ``zero_grad()``, ``step()`` from the parameters' ``.grad``.

``ZeRO1`` runs the functional update on a (data, model) mesh with the
moments sharded over the data axes (``launch/partition.py zero_specs``, the
reference dry-run's ZeRO-1): each rank keeps and updates only its slice of
each leaf's moments and parameters, then the parameters are all-gathered
over the data axes; under FSDP (``mesh_info["fsdp"]``, ZeRO-3) the
parameters themselves are the slices, their gradients arrive summed and
sliced (``collectives.gather_params``), and nothing is gathered.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Union

import torch

from repro_torch import collectives as C


# elements of one piece of the update: the f32 temporaries of a whole
# stacked leaf (every layer's w1 of a 90B model is 0.94 B elements) would
# take about 20 bytes an element beside the params and moments
UPDATE_ELEMS = 1 << 26


def _pieces(*ts):
    """Matching views of same-shaped tensors, cut along their leading dims
    into pieces of at most ``UPDATE_ELEMS`` elements (a vector whole)."""
    t0 = ts[0]
    if t0.numel() <= UPDATE_ELEMS or t0.ndim < 2:
        yield ts
        return
    per = t0.numel() // t0.shape[0]
    if per > UPDATE_ELEMS:
        for i in range(t0.shape[0]):
            yield from _pieces(*(t[i] for t in ts))
        return
    rows = UPDATE_ELEMS // per
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


class AdamWState(NamedTuple):
    step: int
    m: Dict
    v: Dict


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in ``jax.tree_util``'s order (sorted keys)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s keys whose leaves are ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


class AdamW:
    def __init__(self, params: Optional[Iterable[torch.Tensor]] = None,
                 lr: Union[float, Callable[[int], float]] = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.params: List[torch.Tensor] = list(params) if params is not None else []
        self.state = self.init(dict(enumerate(self.params)))

    # -- the reference's functional interface --------------------------------

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, grad_norm=None):
        """One AdamW step over matching trees; returns (params, state,
        global gradient norm before clipping), the tensors updated in
        place. ``grad_norm``: the global norm, where ``grads`` hold only a
        part of the gradient (``ZeRO1``)."""
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        g_leaves = tree_leaves(grads)
        gn = grad_norm if grad_norm is not None else torch.sqrt(
            sum((g.float() * g.float()).sum() for leaf in g_leaves for (g,) in _pieces(leaf)))
        scale = torch.clamp(self.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step
        for leaves in zip(tree_leaves(params), g_leaves, tree_leaves(state.m),
                          tree_leaves(state.v)):
            decay = leaves[0].ndim >= 2
            for p, g, m, v in _pieces(*leaves):
                g = g.float() * scale
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                if decay:
                    u = u + self.weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
        return params, AdamWState(step, state.m, state.v), gn

    # -- the torch interface (parameters with .grad) -------------------------

    @property
    def step_count(self) -> int:
        return self.state.step

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``; returns the
        global gradient norm (before clipping)."""
        grads = {i: p.grad if p.grad is not None else torch.zeros_like(p)
                 for i, p in enumerate(self.params)}
        _, self.state, gn = self.update(grads, self.state, dict(enumerate(self.params)))
        return gn


class ZeRO1:
    """``opt``'s update with the moments sharded over a mesh's data axes.

    ``pspecs`` / ``zspecs``: ``launch/partition.py``'s ``param_specs`` and
    ``zero_specs`` of the whole tree; the params this rank holds are its
    ``pspecs`` blocks. A leaf whose ZeRO spec adds the data axes to dim
    ``i`` keeps moments for this rank's block of dim ``i`` (``slices``);
    a leaf with no such dim keeps whole moments, updated alike on every
    data rank. ``reduce`` sums a gradient leaf over the data axes and keeps
    the slice; ``update`` takes the averaged slices
    (``training/train_loop.py``), updates each slice in place, and
    all-gathers the params over the data axes.

    Under FSDP (``mesh_info["fsdp"]`` not None: the tree of the leaves'
    data-axis dims, ``dims`` here) the params this rank holds are the
    slices themselves (``zero_specs``): a sliced leaf's gradient is already
    the sum over the data axes (the forward's gathers reduce-scatter it in
    f32 and autograd rounds it to the leaf's dtype), so ``reduce`` only
    casts it to f32, and ``update`` updates the slices in place and gathers
    nothing. A leaf with no data dim is whole on every data rank, reduced
    and updated as without FSDP."""

    def __init__(self, opt: AdamW, pspecs, zspecs, mesh_info: dict):
        self.opt = opt
        self.fsdp = mesh_info.get("fsdp") is not None
        mesh = mesh_info["mesh"]
        dp, tp = tuple(mesh_info["dp"]), mesh_info["tp"]
        self.dp = mesh.axis(dp)
        self.world = mesh.axis(mesh.axis_names)
        from repro_torch.launch.partition import data_dims
        self.dims, self.shares = tree_leaves(data_dims(pspecs, zspecs)), []
        for ps, dim in zip(tree_leaves(pspecs), self.dims):
            # ranks holding the same slice: the leaf's sum of squares counts once
            copies = (1 if dim is not None else self.dp.size) * (
                1 if any(e == tp or (isinstance(e, tuple) and tp in e) for e in ps)
                else mesh.size(tp))
            self.shares.append(1.0 / copies)

    def reduce(self, g: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i``'s gradient summed over the data axes in f32, this
        rank's slice of it (a new tensor): reduce-scattered where the leaf's
        moments are sliced, else all-reduced. The f32 copy of ``g`` is the
        only full-size tensor it makes. Under FSDP a sliced leaf's gradient
        is its slice already: cast to f32."""
        dim = self.dims[i]
        if dim is not None and self.fsdp:
            return g.float()
        if dim is None:
            return C.psum(g.to(torch.float32, memory_format=torch.contiguous_format),
                          self.dp, inplace=True)
        src = g.movedim(dim, 0).to(torch.float32, memory_format=torch.contiguous_format)
        return C.reduce_scatter(src, self.dp).movedim(0, dim).contiguous()

    def slices(self, tree) -> list:
        """This rank's slice (a view) of each leaf (``tree_leaves`` order);
        under FSDP the leaves themselves."""
        return [t if dim is None or self.fsdp else t.chunk(self.dp.size, dim)[self.dp.index]
                for t, dim in zip(tree_leaves(tree), self.dims)]

    def init(self, params) -> AdamWState:
        zeros = [torch.zeros_like(t, dtype=torch.float32, memory_format=torch.contiguous_format)
                 for t in self.slices(params)]
        return AdamWState(0, tree_unflatten(params, zeros),
                          tree_unflatten(params, [torch.zeros_like(z) for z in zeros]))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """grads: the averaged gradient's slices (f32), in ``params``' tree."""
        grads = tree_leaves(grads)
        sq = sum(float(share) * (g.float() * g.float()).sum()
                 for g, share in zip(grads, self.shares))
        gn = torch.sqrt(C.psum(torch.as_tensor(sq, dtype=torch.float32,
                                               device=grads[0].device).reshape(1), self.world)[0])
        views = self.slices(params)
        like = {i: t for i, t in enumerate(views)}
        _, state, gn = self.opt.update({i: g for i, g in enumerate(grads)},
                                       AdamWState(state.step, _keyed(state.m), _keyed(state.v)),
                                       like, grad_norm=gn)
        for t, dim, view in zip(tree_leaves(params), self.dims, views):
            if dim is not None and not self.fsdp:
                t.copy_(C.all_gather(view, self.dp, dim))
        return params, AdamWState(state.step, tree_unflatten(params, tree_leaves(state.m)),
                                  tree_unflatten(params, tree_leaves(state.v))), gn


def _keyed(tree) -> dict:
    return {i: t for i, t in enumerate(tree_leaves(tree))}


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``."""
    def lr(step: int) -> float:
        s = float(step)
        if s < warmup:
            return peak * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))
    return lr
