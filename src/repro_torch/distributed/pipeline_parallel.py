"""GPipe-style pipeline parallelism over point-to-point sends — port of
``repro/distributed/pipeline_parallel.py``.

One rank of a process group is one stage.  Micro-batches flow through a
skewed schedule of T = n_micro + n_stages - 1 ticks; at each tick every
stage runs its part on the activation it holds, then passes it to the next
stage (``batch_isend_irecv``, where JAX ``ppermute``s).  The last stage
banks the finished micro-batches and broadcasts them, so every stage
returns all outputs (JAX's ``psum`` of the last stage's).  Bubble fraction
(S-1)/T as usual for GPipe.  An inactive stage (before its first or after
its last micro-batch) skips ``stage_fn``: JAX computes and discards it.

Model-agnostic: ``stage_fn(stage_params, x)`` is any per-stage function
and ``stage_params`` whatever it takes, this rank's own (JAX's per-device
slice of the stacked params).  The forward only: the sends carry no
gradient.  ``pipeline_stage_from_stack`` makes a stage of a ``Stack``'s
layers.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def gpipe_forward(stage_fn: Callable, group, n_stages: int) -> Callable:
    """Returns f(stage_params, microbatches [n_micro, mb, ...]) -> outputs
    [n_micro, mb, ...] on every rank of ``group`` (stage = rank in group;
    the micro-batches alike on every rank, only stage 0 reads them)."""
    size = dist.get_world_size(group)
    if size != n_stages:
        raise ValueError(f"n_stages={n_stages}, but the group has {size} ranks")

    def run(params, xs: torch.Tensor) -> torch.Tensor:
        sid = dist.get_rank(group)
        peer = lambda s: dist.get_global_rank(group, s % n_stages)
        n_micro = xs.shape[0]
        hold = torch.zeros_like(xs[0])                 # activation in flight
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            if 0 <= t - sid < n_micro:
                y = stage_fn(params, xs[t] if sid == 0 else hold)
            else:
                y = hold
            if sid == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = y
            if n_stages == 1:
                hold = y
                continue
            # rotate activations stage s -> s+1
            nxt = torch.empty_like(y)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), peer(sid + 1), group),
                    dist.P2POp(dist.irecv, nxt, peer(sid - 1), group)]):
                req.wait()
            hold = nxt
        if n_stages > 1:
            dist.broadcast(outs, peer(n_stages - 1), group=group)
        return outs

    return run


def pipeline_stage_from_stack(stack, reps_per_stage: int) -> Callable:
    """Adapter: stage s = repeats [s·reps_per_stage, (s+1)·reps_per_stage)
    of ``stack`` (``nn/transformer.py::Stack``, one module a layer); its
    ``stage_fn(s, x)`` takes the stage index for params."""
    per = reps_per_stage * len(stack.pattern)

    def stage_fn(stage: int, x: torch.Tensor) -> torch.Tensor:
        for blk in stack.layers[stage * per:(stage + 1) * per]:
            x, _, _ = blk(x)
        return x

    return stage_fn
