"""Collectives over the axes of a device mesh (the port's counterpart of
``shard_map``'s ``psum`` / ``pmean`` / ``axis_index`` / ``all_gather``,
which the reference reaches through ``compat.shard_map``, and the
reduce-scatter its ZeRO-1 accumulator lowers to).

An ``Axis`` is one mesh axis, or a tuple of them, as this rank sees it:
its process group, its size and this rank's index along it
(``launch/mesh.py`` builds them). Over an axis of size 1 every function
here returns its input and communicates nothing.

Three autograd operators carry tensor parallelism (Megatron-LM's ``f``,
``g`` and its gather):

* ``copy_to(x, ax)`` — identity forward, all-reduce (sum) backward. It
  enters a region whose ranks each compute a part (column-parallel
  products, the local experts, a replicated weight applied to the local
  heads): each rank's gradient of ``x`` is a partial sum, and the
  all-reduce makes it whole on every rank.
* ``reduce_from(x, ax)`` — all-reduce (sum) forward, identity backward. It
  leaves such a region (row-parallel products, the combined expert output,
  the masked embedding lookup): every rank receives the same gradient of
  the sum, which is the gradient of each part.
* ``gather_from(x, ax, dim)`` — all-gather forward, the rank's slice
  backward. It leaves a region whose ranks each hold a block of a dim (a
  column-parallel product's output, e.g. the frontend projection ``proj``
  sharded by its last dim): every rank then computes the same function of
  the whole tensor, so each receives the whole gradient and keeps the
  slice of its own block. Where the gathered tensor enters a sharded region
  again its gradient there is a partial sum, and ``copy_to`` at that entry
  makes it whole first.

FSDP (ZeRO-3) of the params has its own gather over the data axes:

* ``gather_params(w, ax, dim)`` — all-gather forward, reduce-scatter
  backward. ``w`` is this rank's slice of a weight along ``dim``; every
  data rank runs its own batch shard through the whole weight, so each
  rank's gradient of it is its shard's part, and the whole gradient is
  their sum: the backward casts it to f32, sums it over the axis and cuts
  out the rank's slice in one reduce-scatter, then rounds it to the
  weight's type (autograd gives a slice the gradient of its own dtype).
  ``gather_from``'s backward keeps the slice without the sum, which is
  right over the model axis, where every rank holds the whole gradient,
  and would here leave each rank its own shard's part.

``torch.distributed.nn.functional.all_reduce`` is not ``reduce_from``: its
backward all-reduces the gradient too, which multiplies a replicated
gradient by the axis size. Leaving ``copy_to`` out at the entry of a
region leaves each rank with its part of the gradient of the norms and the
router, and the ranks' replicated weights part after one AdamW step.

``pmean`` averages a value over an axis forward and passes its gradient
through unchanged: the data-parallel gradients are averaged once, after
the backward (``training/train_loop.py``), so each rank's own contribution
is what its backward must carry.

``lse_combine(o, lse, ax)`` merges attention partials over the ranks'
blocks of keys (a decode ring whose slots are sharded over the model
axis) by their log-sum-exps: one all-gather of the packed (o, lse), then
the same f32 merge in rank order on every rank, so the ranks hold
bit-equal results.

Every collective adds its result's bytes to ``RECORD[op]`` (``count``,
``bytes``), the form of the reference dry-run's ``parse_collectives``, and
the host wall of the blocking call (``seconds``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

RECORD: Dict[str, Dict[str, int]] = {}


def reset() -> None:
    RECORD.clear()


def record() -> Dict[str, Dict[str, int]]:
    """{op: {"count", "bytes", "seconds"}} since the last ``reset``."""
    return {op: dict(r) for op, r in RECORD.items()}


def _note(op: str, t: torch.Tensor, t0: float) -> None:
    r = RECORD.setdefault(op, {"count": 0, "bytes": 0, "seconds": 0.0})
    r["count"] += 1
    r["bytes"] += t.numel() * t.element_size()
    r["seconds"] += time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class Axis:
    """A mesh axis (or tuple of axes) as one rank sees it."""
    group: Any        # torch.distributed ProcessGroup, None when size == 1
    size: int
    index: int


def psum(t: torch.Tensor, ax: Optional[Axis], inplace: bool = False) -> torch.Tensor:
    """Sum over the axis: a new tensor, ``t`` left as it was, or with
    ``inplace`` (a contiguous ``t``) into ``t`` itself."""
    if ax is None or ax.size == 1:
        return t
    out = t if inplace else t.contiguous().clone()
    t0 = time.perf_counter()
    dist.all_reduce(out, group=ax.group)
    _note("all-reduce", out, t0)
    return out


def pmax(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    if ax is None or ax.size == 1:
        return t
    out = t.contiguous().clone()
    t0 = time.perf_counter()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    _note("all-reduce", out, t0)
    return out


def reduce_scatter(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """``t`` (contiguous) summed over the axis and cut along dim 0 into the
    axis' blocks: this rank's block, a new tensor."""
    if ax is None or ax.size == 1:
        return t
    out = t.new_empty((t.shape[0] // ax.size,) + t.shape[1:])
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(out, t, group=ax.group)
    _note("reduce-scatter", out, t0)
    return out


def all_gather(t: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in axis order."""
    if ax is None or ax.size == 1:
        return t
    parts: List[torch.Tensor] = [torch.empty_like(t, memory_format=torch.contiguous_format)
                                 for _ in range(ax.size)]
    t0 = time.perf_counter()
    dist.all_gather(parts, t.contiguous(), group=ax.group)
    out = torch.cat(parts, dim)
    _note("all-gather", out, t0)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.size = ax, dim, x.shape[dim]
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.size, ctx.size), None, None


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(w, ax, dim)

    @staticmethod
    def backward(ctx, g):
        src = g.movedim(ctx.dim, 0).to(torch.float32, memory_format=torch.contiguous_format)
        part = reduce_scatter(src, ctx.ax).movedim(0, ctx.dim)
        return part.to(g.dtype, memory_format=torch.contiguous_format), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return psum(x, ax) / ax.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Identity forward, all-reduce backward (module docstring)."""
    if ax is None or ax.size == 1:
        return x
    return _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """All-reduce forward, identity backward (module docstring)."""
    if ax is None or ax.size == 1:
        return x
    return _ReduceFrom.apply(x, ax)


def gather_from(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward, the rank's slice of the gradient
    backward (module docstring)."""
    if ax is None or ax.size == 1:
        return x
    return _GatherFrom.apply(x, ax, dim % x.ndim)


def gather_params(w: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """A weight's slices gathered along ``dim`` over the data axes forward,
    the gradient summed in f32 and reduce-scattered to the slice backward
    (module docstring)."""
    if ax is None or ax.size == 1:
        return w
    return _GatherParams.apply(w, ax, dim % w.ndim)


def pmean(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Mean over the axis forward, the gradient passed through."""
    if ax is None or ax.size == 1:
        return x
    return _PMean.apply(torch.as_tensor(x), ax)


def lse_combine(o: torch.Tensor, lse: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Softmax attention over the union of the ranks' key blocks from each
    rank's partial: o [B,H,D] (normalised over its block) and lse [B,H]
    f32, its log-sum-exp of the scaled logits; one all-gather of the pair
    packed in f32, then ``merge_partials``. Over no axis, o."""
    if ax is None or ax.size == 1:
        return o
    packed = torch.cat([o.float(), lse.float()[..., None]], -1)
    return merge_partials(all_gather(packed[None], ax, 0)).to(o.dtype)


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """parts [n,B,H,D+1]: block r's (o_r, lse_r) packed along the last dim
    -> sum_r w_r o_r / sum_r w_r in f32, w_r = exp(lse_r - max_r lse_r),
    summed in block order. A block with lse = -inf (no valid key) has
    weight 0 whatever its o; where every block has -inf the result is 0."""
    D = parts.shape[-1] - 1
    lses = parts[..., D]
    m = lses.amax(0)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    acc = torch.zeros(parts.shape[1:-1] + (D,), dtype=torch.float32, device=parts.device)
    den = torch.zeros(parts.shape[1:-1], dtype=torch.float32, device=parts.device)
    for r in range(parts.shape[0]):
        w = torch.exp(lses[r] - m)
        acc = acc + torch.where(torch.isneginf(lses[r])[..., None], 0.0,
                                w[..., None] * parts[r, ..., :D])
        den = den + w
    return acc / den.clamp(min=1e-30)[..., None]
