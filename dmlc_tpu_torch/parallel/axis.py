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

``torch.distributed`` ops do not differentiate, so :func:`ppermute`,
:func:`all_to_all`, :func:`psum` and :func:`pvary` are
``torch.autograd.Function``s: the backward of a permutation is the inverse
permutation, and the backward of an all-to-all is the all-to-all with its
split and concat dims swapped. The reference runs inside ``shard_map``,
where a ``psum`` with a replicated result transposes to the identity (each
rank already holds the whole replicated cotangent) and a replicated input
used per rank transposes to a ``psum`` of the cotangents: :func:`psum` and
:func:`pvary` are that pair. Every rank must run the same collectives in
the same order, forward and backward; :func:`keep_in_graph` ties a value
that a rank does not use into its backward graph, so that the rank still
runs the collective that made it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dmlc_tpu_torch.obs.xla_cost import note_collective
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


def _check_perm(perm, n: int) -> None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    check(all(0 <= r < n for r in srcs + dsts),
          "ppermute: pair outside [0, %d): %s", n, perm)
    check(len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts),
          "ppermute: a rank sends or receives twice in %s", perm)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Send ``x`` to the destination of this rank's pair and return what
    its source sent, or zeros where no pair ends here.

    gloo's point-to-point send hands a CUDA tensor's device pointer to the
    socket (``writev``: "Bad address", an H100 with PyTorch 2.11), so over
    a gloo group a CUDA tensor is copied to the host and the received one
    back: that is gloo's transport (two ranks sharing one card), and the
    compute stays on the card. gloo's all-to-all and all-reduce stage CUDA
    tensors themselves; NCCL moves them as they are."""
    me = axis_index(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me]:
        return x
    if not dst and not src:
        return torch.zeros_like(x)
    stage = (x.device.type == "cuda"
             and dist.get_backend(group) == dist.Backend.GLOO)
    send = (x.detach().to("cpu") if stage else x).contiguous()
    recv = torch.empty_like(send)
    ops = []
    if dst:
        # the bytes this rank sends, for a step-cost recording
        note_collective(send.numel() * send.element_size())
        ops.append(dist.P2POp(dist.isend, send, _global_rank(group, dst[0]),
                              group=group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, _global_rank(group, src[0]),
                              group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not src:
        return torch.zeros_like(x)
    return recv.to(x.device) if stage else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(grad, ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, group=None, shift: int = 1,
             perm=None) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, perm)``: each rank sends ``x`` to the
    destination of its ``(source, destination)`` pair and returns what the
    source of the pair that ends at it sent, or zeros where no pair ends
    there. ``perm=None`` is the ring ``[(i, (i + shift) % n)]``.
    Differentiable: the backward permutes the cotangent by the inverse
    pairs (a rank that sent nothing gets a zero cotangent)."""
    n = axis_size(group)
    if perm is None:
        if n == 1 or shift % n == 0:
            return x
        perm = [(i, (i + shift) % n) for i in range(n)]
    perm = [(int(s), int(d)) for s, d in perm]
    _check_perm(perm, n)
    return _PPermute.apply(x, group, perm)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if axis_size(group) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.psum`` inside ``shard_map`` with a replicated result:
    every rank gets the sum of every rank's ``x``. Its backward is the
    identity, not another all-reduce: every rank holds the whole
    replicated cotangent, and summing it again would scale each gradient
    by the group's size."""
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.pmean``: :func:`psum` over the group's size (backward
    ×1/n, no communication)."""
    return psum(x, group) / axis_size(group)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for grad, groups, needed in zip(grads, ctx.groups,
                                        ctx.needs_input_grad[1:]):
            if needed:
                # a rank that did not use its copy still joins the sum
                for group in groups:
                    grad = _all_reduce(grad, group)
            out.append(grad)
        return (None, *out)


def pvary(xs, groups):
    """Mark replicated tensors as used per rank (``jax.lax.pvary``, the
    transpose of :func:`psum`): the identity forward; the backward sums
    each cotangent over its groups, so that every rank's gradient of a
    replicated input is the whole gradient, as ``shard_map`` gives for an
    input it replicates. ``xs`` is a list of tensors and ``groups`` a list
    of the same length, each entry a tuple of groups to sum over in turn
    (None is the default group, as everywhere here). One node for all of
    them: its all-reduces run in one fixed order on every rank, after the
    rest of the backward."""
    groups = tuple(tuple(g for g in gs if axis_size(g) > 1) for gs in groups)
    check(len(groups) == len(xs), "pvary: %d tensors, %d group lists",
          len(xs), len(groups))
    if not any(groups):
        return list(xs)
    return list(_PVary.apply(groups, *xs))


class _KeepInGraph(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, dep):
        ctx.dep_meta = (dep.shape, dep.dtype, dep.device)
        return o

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.dep_meta
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def keep_in_graph(o: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """Return ``o``; give ``dep`` a zero gradient. Ties a value that made a
    collective (a ring's last K/V rotation, a pipeline's hand-off) into the
    backward graph on every rank, so that each rank runs that collective's
    backward, in the same order, also where it does not use the value."""
    return _KeepInGraph.apply(o, dep)


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
    note_collective(send.numel() * send.element_size())
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
