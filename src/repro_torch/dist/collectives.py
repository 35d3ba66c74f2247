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

DTensor's collectives (the models under ``dist.sharding``'s rules) are
not these: sharding propagation issues PyTorch's functional collectives
(``_c10d_functional``) itself. ``CollectiveLog`` is a dispatch mode that
sees each of them as it is handed to c10d, on each rank's local tensors,
and adds its input's bytes (the operand bytes XLA's HLO counts) to a
count by the HLO collective's name. It is also where those collectives
are staged: gloo (PyTorch 2.11 on the H100 machine) takes CUDA tensors
for all_reduce, reduce_scatter_tensor and all_to_all_single but refuses
all_gather_into_tensor, so on a gloo group an all-gather of a CUDA
tensor is run on a copy in pinned host memory and its result copied
back to the card (``STAGED``). DTensors on a CUDA mesh of gloo ranks run
under this mode.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

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


# ---------------------------------------------- DTensor's collectives
# c10d functional op -> the HLO collective it is
FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional")
# what gloo refuses on CUDA tensors (checked on the H100 machine)
STAGED = ("all_gather_into_tensor", "all_gather_into_tensor_coalesced")


def _functional_name(func):
    ns, _, name = func._schema.name.partition("::")
    return name if ns in _NAMESPACES and name in FUNCTIONAL else None


def _needs_stage(name: str, inputs, group_name) -> bool:
    """Whether this functional collective must go through host memory:
    one of ``STAGED`` on CUDA tensors of a gloo group."""
    if name not in STAGED or inputs[0].device.type != "cuda":
        return False
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _staged(_resolve_process_group(group_name))


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def _run_staged(func, args, kwargs, device):
    """``func`` (an all-gather) on host copies of its inputs, waited for,
    its output(s) copied back to ``device``."""
    inp = args[0]
    host = ([_host_copy(t) for t in inp] if isinstance(inp, (list, tuple))
            else _host_copy(inp))
    out = func(host, *args[1:], **kwargs)
    wait = torch.ops._c10d_functional.wait_tensor
    if isinstance(out, (list, tuple)):
        return [wait(o).to(device) for o in out]
    return wait(out).to(device)


class CollectiveLog(TorchDispatchMode):
    """While active, counts every c10d functional collective this process
    issues: ``bytes`` (HLO name -> the input bytes handed over, a
    coalesced op's every input) and ``count`` (HLO name -> ops).

    A DTensor op is passed on to DTensor's own dispatch (so that the mode
    sees the local ops and collectives it issues); the fake tensors of
    DTensor's sharding propagation pass through uncounted."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}
        self.count: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = _functional_name(func)
        if name is not None and all(t in (torch.Tensor,
                                          torch.nn.Parameter)
                                    for t in types):
            inp = args[0]
            ins = list(inp) if isinstance(inp, (list, tuple)) else [inp]
            hlo = FUNCTIONAL[name]
            self.bytes[hlo] = self.bytes.get(hlo, 0) + sum(
                t.numel() * t.element_size() for t in ins)
            self.count[hlo] = self.count.get(hlo, 0) + 1
            if _needs_stage(name, ins, args[-1]):
                return _run_staged(func, args, kwargs, ins[0].device)
        return func(*args, **kwargs)
