"""The mesh-axis primitives of ``dmlc_tpu/ops/sequence_parallel.py`` over a
``torch.distributed`` process group.

The JAX package runs its schedules inside ``shard_map`` over a named mesh
axis and reaches the axis through ``jax.lax`` (``axis_index``, ``ppermute``,
``all_to_all(tiled=True)``) and ``utils/jax_compat.axis_size``. Here there
is no mesh object: every rank calls the schedule with its own shard, and the
axis is a process group. ``group=None`` means the default group when
``torch.distributed`` is initialised, and a single rank (no collective runs)
when it is not. A data-parallel × sequence-parallel layout is a set of
sub-groups made with ``dist.new_group``: each data-parallel row of ranks
passes its own sequence group.

``torch.distributed`` ops do not differentiate, so :func:`ppermute` and
:func:`all_to_all` are ``torch.autograd.Function``s: the backward of a shift
is the opposite shift, and the backward of an all-to-all is the all-to-all
with its split and concat dims swapped. Every rank must run the same
collectives in the same order, forward and backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dmlc_tpu_torch.utils.logging import check


def _active(group) -> bool:
    return group is not None or (dist.is_available() and dist.is_initialized())


def axis_size(group=None) -> int:
    """Ranks on the axis (``jax.lax.axis_size``)."""
    return dist.get_world_size(group) if _active(group) else 1


def axis_index(group=None) -> int:
    """This rank's position on the axis (``jax.lax.axis_index``)."""
    return dist.get_rank(group) if _active(group) else 0


def _global_rank(group, group_rank: int) -> int:
    if group is None:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = axis_size(group)
    if n == 1 or shift % n == 0:
        return x
    me = axis_index(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x, _global_rank(group, (me + shift) % n),
                   group=group),
        dist.P2POp(dist.irecv, out, _global_rank(group, (me - shift) % n),
                   group=group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to rank ``(me + shift) % n`` and return what rank
    ``(me - shift) % n`` sent: ``jax.lax.ppermute`` with the ring
    permutation ``[(i, (i + shift) % n)]``. Differentiable."""
    return _PPermute.apply(x, group, shift)


def _exchange(x: torch.Tensor, group, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    n = axis_size(group)
    if n == 1:
        return x
    check(x.shape[split_dim] % n == 0,
          "all_to_all: dim %d of shape %s does not split over %d ranks",
          split_dim, tuple(x.shape), n)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_exchange(grad, ctx.group, concat_dim, split_dim), None, None,
                None)


def all_to_all(x: torch.Tensor, group=None, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    split ``x`` into n chunks along ``split_dim``, send chunk i to rank i,
    and concatenate the chunks received along ``concat_dim`` in rank order.
    Differentiable. The result may not be contiguous."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)
