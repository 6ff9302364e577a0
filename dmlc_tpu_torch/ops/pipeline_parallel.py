"""Pipeline parallelism: GPipe-style microbatch pipelining over a process
group (the port of ``dmlc_tpu/ops/pipeline_parallel.py``).

- the model is N identical-structure STAGES whose parameters carry a
  leading stage dim; each rank of the group keeps one stage
  (:func:`shard_pipeline_params`: model memory scales out with depth);
- a batch is split into M microbatches; the schedule runs M + N - 1 ticks
  (a Python loop where the reference runs one ``lax.scan``): at tick t,
  rank i computes its stage on microbatch t - i and hands the activation
  to rank i + 1 with one ``ppermute`` over the open pairs
  ``[(i, i + 1)]`` (the last stage sends nothing, stage 0 receives
  zeros);
- the GPipe bubble applies: N - 1 of the ticks are fill and drain, so the
  efficiency is M / (M + N - 1).

The outputs are collected on the last stage and replicated over the group
by a ``psum`` whose backward is the identity. Every rank runs every tick's
hand-off in its backward too (each hand-off is tied into the next tick's
with ``parallel.axis.keep_in_graph``), in the same order on every rank.

The schedule is exact: outputs equal folding the stages in order
(:func:`pipeline_oracle`), gradients too.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dmlc_tpu_torch.parallel.axis import (axis_index, axis_size,
                                          keep_in_graph, ppermute, psum,
                                          pvary)
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def pipeline_oracle(stage_fn: Callable, params, x):
    """Sequential reference: fold every stage over x (stage s uses each
    leaf's slice ``[s]``)."""
    n_stages = _leaves(params)[0].shape[0]
    y = x
    for s in range(n_stages):
        y = stage_fn(_tree_map(lambda a: a[s], params), y)
    return y


def make_pipeline(group, stage_fn: Callable, num_microbatches: int,
                  batch_group=None):
    """f(params, x[batch, ...]) -> y with the GPipe microbatch schedule.

    ``stage_fn(stage_params, act) -> act`` is one stage (shapes
    preserved); ``params`` is this rank's stage, each leaf with leading
    dim 1 (:func:`shard_pipeline_params`). Every rank of the group passes
    the same ``x`` (replicated over the pipeline, as the reference's) and
    gets the whole ``y``. With ``batch_group`` (a second group: each
    data-parallel row of ranks passes its own pipeline group) ``x`` is
    this row's batch shard and each row streams its own microbatches, so
    the PER-SHARD batch must divide into ``num_microbatches``; the
    stages' gradients are summed over ``batch_group``, and ``x``'s over
    the pipeline group, as ``shard_map`` sums a replicated input's."""
    m = num_microbatches

    def pipe(params, x):
        size, idx = axis_size(group), axis_index(group)
        leaves = _leaves(params)
        check(all(a.shape[0] == 1 for a in leaves),
              "params lead dim %d != 1: pass this rank's stage "
              "(shard_pipeline_params)", leaves[0].shape[0])
        local_batch = x.shape[0]
        check(local_batch % m == 0 and local_batch >= m,
              "per-shard batch %d must divide into %d microbatches",
              local_batch, m)
        dp = () if batch_group is None else (batch_group,)
        x, *leaves = pvary([x] + leaves, [(group,)] + [dp] * len(leaves))
        stage = _unflatten(params, [a[0] for a in leaves])
        micro = x.reshape(m, local_batch // m, *x.shape[1:])
        perm = [(i, i + 1) for i in range(size - 1)]  # forward hand-off
        outputs = [None] * m
        state = None  # the activation handed over at the last tick
        for t in range(m + size - 1):
            # stage 0 injects microbatch t, the others consume the hand-off;
            # on fill/drain ticks a REAL microbatch stands in for the
            # carry: a stage with a zero singularity (a norm) would give
            # NaN values whose gradients poison the rest through 0 · NaN
            if not idx <= t < idx + m:
                inp = micro[0]
            else:
                inp = micro[t] if idx == 0 else state
            out = stage_fn(stage, inp)
            done = t - (size - 1)
            if idx == size - 1 and done >= 0:
                outputs[done] = out
            if size > 1:
                if state is not None:
                    out = keep_in_graph(out, state)
                state = ppermute(out, group, perm=perm)
        if idx == size - 1:
            y = torch.stack(outputs)
        else:
            y = torch.zeros_like(micro)
        if state is not None:
            y = keep_in_graph(y, state)
        # the outputs live on the last stage only; psum replicates them
        return psum(y, group).reshape(local_batch, *x.shape[1:])

    return pipe


def shard_pipeline_params(params, group=None):
    """This rank's stage of stage-stacked params (leading dim = the
    group's size), each leaf with leading dim 1."""
    n, me = axis_size(group), axis_index(group)
    for a in _leaves(params):
        check(a.shape[0] == n, "params lead dim %d != pipeline stages %d",
              a.shape[0], n)
    return _tree_map(lambda a: a[me:me + 1], params)


def pipeline_params_from_numpy(np_params, device=None):
    """Stage-stacked numpy params (the JAX package's) as f32 tensors on
    ``device`` (None means cuda), the same tree."""
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.tensor(
        np.asarray(a, dtype=np.float32), device=dev), np_params)
