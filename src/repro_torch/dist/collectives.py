"""The collectives the JAX package uses under ``shard_map``, over the
process group of one mesh dimension (``DeviceMesh.get_group(axis)``):

  all_gather   — ``lax.all_gather``: every rank's tensor, stacked on a new
                 leading axis in group-rank order;
  all_to_all   — ``lax.all_to_all(x, axis, 0, 0, tiled=True)``: chunk j of
                 the leading axis goes to rank j, and chunk i of the result
                 came from rank i;
  ppermute     — ``lax.ppermute``: (source, destination) pairs of group
                 ranks; a rank that no pair sends to receives zeros;
  psum / pmax / pmin — ``lax.psum`` / ``pmax`` / ``pmin``;
  pmean        — ``lax.pmean``: the sum divided by the group's size.

Every function returns a new tensor on its input's device and leaves its
input unchanged. The one policy: on a gloo group a tensor is copied to
the host, sent, and the result copied back to the input's device, here
and nowhere else (gloo moves CUDA tensors only for broadcast and
all_reduce). On an NCCL group it stays on the card. The backend is the
caller's process group's; nothing here chooses one or falls back.

Each call adds the bytes of the send buffer this rank hands to it to a
per-process count by operation (``wire_bytes`` / ``reset_wire``): the
executor's and the smoke script's wire budget per superstep; and one per
tensor handed to a per-process count of calls (``wire_calls``), which the
dry run reports beside the bytes (``analysis.comm``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

OPS = ("all_gather", "all_to_all", "ppermute", "all_reduce")
_wire: Dict[str, int] = dict.fromkeys(OPS, 0)
_calls: Dict[str, int] = dict.fromkeys(OPS, 0)


def wire_bytes() -> Dict[str, int]:
    """Bytes this process has handed to each collective since the last
    ``reset_wire``."""
    return dict(_wire)


def wire_calls() -> Dict[str, int]:
    """Tensors this process has handed to each collective since the last
    ``reset_wire``."""
    return dict(_calls)


def reset_wire() -> None:
    for k in _wire:
        _wire[k] = 0
        _calls[k] = 0


def _count(op: str, *tensors: torch.Tensor) -> None:
    _wire[op] += sum(t.numel() * t.element_size() for t in tensors)
    _calls[op] += len(tensors)


def _staged(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _wire_copy(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of x in the memory the group's backend sends
    from: the host for gloo, x's device otherwise."""
    if _staged(group):
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's x in group-rank order."""
    _count("all_gather", x)
    src = _wire_copy(x, group)
    # zeros, not empty: a backend that moves no data (the dry run's fake
    # world) leaves them as they are
    out = [torch.zeros_like(src) for _ in range(size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all over the leading axis, which must divide by the
    group's size."""
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide by "
                         f"the group's {n} ranks")
    _count("all_to_all", x)
    src = _wire_copy(x, group)
    out = torch.zeros_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             group) -> List[torch.Tensor]:
    """Each tensor of ``xs`` sent along ``perm`` ((source, destination)
    pairs of group ranks, each rank at most once on either side), all in
    ONE ``batch_isend_irecv``: separate batches per tensor would deadlock
    gloo. A rank receives zeros where no pair sends to it."""
    for side in zip(*perm):      # checked alike on every rank
        if len(set(side)) != len(side):
            raise ValueError(f"a rank appears twice on one side of {perm}")
    me = rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    ranks = dist.get_process_group_ranks(group)
    send = [_wire_copy(x, group) for x in xs]
    recv = [torch.zeros_like(s) for s in send]
    if dst and src and dst[0] == me == src[0]:        # a self-edge
        recv = send
    else:
        ops = []
        for tag, (s, r) in enumerate(zip(send, recv)):
            if dst:
                ops.append(dist.P2POp(dist.isend, s, ranks[dst[0]], group,
                                      tag))
            if src:
                ops.append(dist.P2POp(dist.irecv, r, ranks[src[0]], group,
                                      tag))
        if dst:
            _count("ppermute", *xs)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return [r.to(x.device) for r, x in zip(recv, xs)]


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    _count("all_reduce", x)
    out = _wire_copy(x, group)
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.device)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MIN, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / size(group)


REDUCE = {"sum": psum, "max": pmax, "min": pmin}
