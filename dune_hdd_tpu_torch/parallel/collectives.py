"""Collectives over the per-shard tensors of one mesh axis.

The reference takes these from ``jax.lax`` inside ``jax.shard_map``.  In the
port a shard-local body runs once per shard, and a collective is a function
of the list of per-shard tensors along one axis, in shard order (shard i
lives on its own device, which may repeat: four shards on ``cuda:0`` are
what eight virtual CPU devices are to the reference).  Each returns one
tensor per shard, on that shard's device:

* ``psum`` / ``pmax``: the shards reduced in shard order on every
  receiving device, so a D-shard reduction is deterministic;
* ``all_gather``: the shards concatenated (``tiled``) or stacked;
* ``ppermute``: shard ``dst`` receives shard ``src`` for each pair of
  ``perm``; a shard that receives nothing gets zeros (as ``jax.lax``).

No result aliases a sender's tensor: ``ppermute`` copies even between
shards of one device (``.to(same_device)`` would return the sender's tensor,
and an in-place update of a received halo would corrupt the sender's slab).
The reductions and gathers compute one result per distinct device, shared by
that device's shards: fresh tensors, read-only by convention.

When the axis spans processes (``ProcessSpan``, the mesh's last axis after
``torch.distributed`` is initialized; see ``parallel/sharded.py``), each
collective adds one ``torch.distributed`` leg after the local one:
``all_reduce`` for psum / pmax, ``all_gather``, and a ring of
``batch_isend_irecv`` for ppermute.  The process group's backend (gloo for
CPU tensors, NCCL for CUDA tensors) does the sending; an operation the
backend lacks raises.

Each call is counted per kind in ``collective.<kind>`` while recording
(``utils/profiling.py``), so tests can assert what the reference's tests
read from the compiled HLO ("collective-permute, no all-gather").
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.profiling import count

__all__ = ["ProcessSpan", "psum", "pmax", "all_gather", "ppermute"]


class ProcessSpan(NamedTuple):
    """An axis split over ``count`` processes, process-major: this process
    (``index``) holds the axis' shards [index * local, (index + 1) * local)."""

    count: int
    index: int


def _per_device(xs: Sequence[torch.Tensor], make) -> List[torch.Tensor]:
    """``make(device)`` once per distinct device of ``xs``, one per shard."""
    done = {}
    out = []
    for x in xs:
        if x.device not in done:
            done[x.device] = make(x.device)
        out.append(done[x.device])
    return out


def _reduce(xs, op, span: Optional[ProcessSpan], dist_op) -> List[torch.Tensor]:
    def local(device):
        acc = xs[0].to(device, copy=True)
        for x in xs[1:]:
            acc = op(acc, x.to(device))
        return acc

    if span is None or span.count == 1:
        return _per_device(xs, local)
    import torch.distributed as dist

    total = local(xs[0].device)
    dist.all_reduce(total, op=dist_op(dist))
    return _per_device(xs, lambda device: total.to(device, copy=True))


def psum(xs: Sequence[torch.Tensor], span: Optional[ProcessSpan] = None) -> List[torch.Tensor]:
    """Sum over the axis, in shard order (then across processes)."""
    count("collective.psum")
    return _reduce(xs, torch.add, span, lambda dist: dist.ReduceOp.SUM)


def pmax(xs: Sequence[torch.Tensor], span: Optional[ProcessSpan] = None) -> List[torch.Tensor]:
    """Elementwise maximum over the axis."""
    count("collective.pmax")
    return _reduce(xs, torch.maximum, span, lambda dist: dist.ReduceOp.MAX)


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False,
               span: Optional[ProcessSpan] = None) -> List[torch.Tensor]:
    """Every shard's tensor on every shard: concatenated along the first
    axis (``tiled``) or stacked in a new first axis."""
    count("collective.all_gather")
    join = torch.cat if tiled else torch.stack

    def local(device):
        return join([x.to(device) for x in xs])

    if span is None or span.count == 1:
        return _per_device(xs, local)
    import torch.distributed as dist

    mine = torch.stack([x.to(xs[0].device) for x in xs])
    parts = [torch.empty_like(mine) for _ in range(span.count)]
    dist.all_gather(parts, mine)
    everything = torch.cat(parts)  # [all shards, ...]
    return _per_device(xs, lambda device: join(list(everything.to(device).unbind(0))))


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             span: Optional[ProcessSpan] = None) -> List[torch.Tensor]:
    """Shard ``dst`` receives a copy of shard ``src``'s tensor for each
    (src, dst) of ``perm`` (axis indices, across processes when the axis
    spans them); shards that receive nothing get zeros."""
    count("collective.ppermute")
    local = len(xs)
    offset = 0 if span is None else span.index * local
    out: List[Optional[torch.Tensor]] = [None] * local
    remote = []
    for src, dst in perm:
        s, d = src - offset, dst - offset
        if 0 <= s < local and 0 <= d < local:
            out[d] = xs[s].to(xs[d].device, copy=True)
        elif 0 <= s < local or 0 <= d < local:
            remote.append((src, dst))
    if remote:
        import torch.distributed as dist

        ops = []
        for src, dst in remote:
            s, d = src - offset, dst - offset
            if 0 <= s < local:
                ops.append(dist.P2POp(dist.isend, xs[s].contiguous(), dst // local))
            else:
                out[d] = torch.empty_like(xs[d])
                ops.append(dist.P2POp(dist.irecv, out[d], src // local))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [torch.zeros_like(x) if y is None else y for x, y in zip(xs, out)]
