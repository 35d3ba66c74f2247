"""Array-backed TaskBag — the paper's default ``ArrayList``-based bag (§2.3),
for P places at once. The counterpart of ``repro.core.taskbag``.

A bag holds the bags of all P places::

    {"items": {field: (P, C, *trailing) tensor, ...}, "size": (P,) int32}

with a fixed capacity ``C``; a packet is ``{"items": {field: (P, K, ...)},
"count": (P,) int32}``. The JAX package writes one place's bag and
``vmap``s it; here every operation works on the leading P axis directly.

Operations write the item tensors in place and return the bag, with a new
``size`` tensor in the same dict: a bag of the paper's UTS at 1024 places
is 168 MB, too large to copy per operation. Where only some places may
change (the masked loops that stand in for ``vmap`` of ``while_loop``), an
optional ``mask`` ((P,) bool) leaves the other places untouched.

Writes and reads of K rows at a per-place offset clamp that offset into
``[0, C - K]``, as ``jax.lax.dynamic_update_slice`` / ``dynamic_slice``
do: they neither drop nor wrap. Rows beyond ``size`` are dead space.

The paper's default split "removes half of the elements from the end of
the ArrayList"; ``split_tail_half`` implements exactly that (capped at the
steal packet size K). UTS and BC split by interval halving instead
(``repro_torch.problems``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Bag = Dict[str, object]     # {"items": {...}, "size": (P,) int32}
Packet = Dict[str, object]  # {"items": {...(P, K, ...)}, "count": (P,) int32}
# field -> (trailing shape, dtype) of one item
ItemSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def make_bag(item_spec: ItemSpec, capacity: int, P: int,
             device) -> Bag:
    """P empty bags with room for ``capacity`` items each."""
    items = {k: torch.zeros((P, capacity) + tuple(shape), dtype=dt,
                            device=device)
             for k, (shape, dt) in item_spec.items()}
    return {"items": items,
            "size": torch.zeros((P,), dtype=torch.int32, device=device)}


def make_packet(item_spec: ItemSpec, k: int, P: int, device) -> Packet:
    items = {key: torch.zeros((P, k) + tuple(shape), dtype=dt,
                              device=device)
             for key, (shape, dt) in item_spec.items()}
    return {"items": items,
            "count": torch.zeros((P,), dtype=torch.int32, device=device)}


def bag_size(bag: Bag) -> torch.Tensor:
    return bag["size"]


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (P,) or (P, K) mask shaped to broadcast against ``like``."""
    return mask.reshape(tuple(mask.shape)
                        + (1,) * (like.dim() - mask.dim()))


def _rows(start: torch.Tensor, k: int) -> torch.Tensor:
    """(P, k) int64 row indices start + [0, k)."""
    lane = torch.arange(k, dtype=torch.int64, device=start.device)
    return start.to(torch.int64)[:, None] + lane[None, :]


def _index(arr: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (P, K) expanded over ``arr``'s trailing dims."""
    if arr.dim() == 2:
        return rows
    return _lanes(rows, arr).expand(tuple(rows.shape) + arr.shape[2:])


def take_rows(arr: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """arr (P, C, ...) at per-place rows (P, K) -> (P, K, ...)."""
    return arr.gather(1, _index(arr, rows))


def _clamped_rows(bag: Bag, start: torch.Tensor, k: int) -> torch.Tensor:
    cap = next(iter(bag["items"].values())).shape[1]
    return _rows(start.clamp(0, cap - k), k)


def push_block(bag: Bag, block: Dict[str, torch.Tensor],
               count: torch.Tensor) -> Bag:
    """Append ``count`` (P,) valid rows of ``block`` (leading P, K axes) to
    each place's bag. All K rows are written (rows beyond ``count`` land
    in dead space and are overwritten by later pushes), at offset ``size``
    clamped into [0, C - K].

    The write is guarded on ``count > 0``: the offset clamps, so an
    unguarded no-op push into a nearly-full bag would otherwise overwrite
    live rows (merges reach every place with count 0 almost everywhere)."""
    size = bag["size"]
    count = count.to(torch.int32)
    k = next(iter(block.values())).shape[1]
    rows = _clamped_rows(bag, size, k)
    put = count > 0
    for key, v in bag["items"].items():
        idx = _index(v, rows)
        new = block[key].to(v.dtype)
        v.scatter_(1, idx, torch.where(_lanes(put, new), new,
                                       v.gather(1, idx)))
    bag["size"] = size + count
    return bag


def push_one(bag: Bag, item: Dict[str, torch.Tensor]) -> Bag:
    """Push one item (fields (P, ...)) onto every place's bag."""
    block = {k: v[:, None] for k, v in item.items()}
    ones = torch.ones_like(bag["size"])
    return push_block(bag, block, ones)


def peek_tail(bag: Bag) -> Dict[str, torch.Tensor]:
    """Each place's newest item. The row index clamps into [0, C - 1], as
    a JAX gather clamps an out-of-bounds index."""
    cap = next(iter(bag["items"].values())).shape[1]
    rows = (bag["size"] - 1).clamp(0, cap - 1)[:, None].to(torch.int64)
    return {k: take_rows(v, rows)[:, 0] for k, v in bag["items"].items()}


def pop_tail(bag: Bag, mask: Optional[torch.Tensor] = None
             ) -> Tuple[Bag, Dict[str, torch.Tensor]]:
    """Each place's newest item; the size drops by one (not below 0) at
    the places in ``mask`` (all when None)."""
    item = peek_tail(bag)
    size = bag["size"]
    popped = (size - 1).clamp(min=0)
    bag["size"] = popped if mask is None else torch.where(mask, popped,
                                                          size)
    return bag, item


def read_front(bag: Bag, k: int) -> Dict[str, torch.Tensor]:
    """First (oldest) k rows of each place, copied."""
    return {key: v[:, :k].clone() for key, v in bag["items"].items()}


def write_front(bag: Bag, block: Dict[str, torch.Tensor],
                mask: Optional[torch.Tensor] = None) -> Bag:
    """Overwrite the first K rows of each place in ``mask`` (all when
    None) with ``block``."""
    for key, v in bag["items"].items():
        new = block[key].to(v.dtype)
        front = v[:, :new.shape[1]]
        if mask is not None:
            new = torch.where(_lanes(mask, new), new, front)
        front.copy_(new)
    return bag


def split_tail_half(bag: Bag, k: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[Bag, Packet]:
    """Paper's default ArrayList split: remove ceil(half) of each place's
    items from the END of its list (capped at the packet width k) and
    hand them over. Places outside ``mask`` give nothing (count 0) and
    keep their size. The packet's rows are read at offset size - take,
    clamped into [0, C - k] as ``dynamic_slice`` clamps."""
    size = bag["size"]
    take = torch.minimum((size + 1) // 2, torch.full_like(size, k))
    if mask is not None:
        take = torch.where(mask, take, torch.zeros_like(take))
    start = (size - take).clamp(min=0)
    rows = _clamped_rows(bag, start, k)
    live = torch.arange(k, device=size.device)[None, :] < take[:, None]
    items = {}
    for key, v in bag["items"].items():
        got = take_rows(v, rows)
        # Rows beyond `take` are garbage; zero them so the packet is
        # self-describing.
        items[key] = torch.where(_lanes(live, got), got,
                                 torch.zeros_like(got))
    bag["size"] = size - take
    return bag, {"items": items, "count": take.to(torch.int32)}


def merge_packet(bag: Bag, packet: Packet) -> Bag:
    """Paper's default merge: append the incoming items (§2.3)."""
    return push_block(bag, packet["items"], packet["count"])


def compact_block(block: Dict[str, torch.Tensor], valid: torch.Tensor
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Stable-compact the valid rows of each place's (K, ...) block to the
    front (the order of ``argsort(~valid, stable=True)``): each valid lane
    moves to its exclusive prefix count; invalid lanes go to a sink
    column that is cut off. Returns (compacted block, count (P,) int32);
    invalid rows are zero."""
    P, k = valid.shape
    dest = torch.where(valid, valid.cumsum(1) - 1, k)
    out = {}
    for key, v in block.items():
        buf = torch.zeros((P, k + 1) + tuple(v.shape[2:]), dtype=v.dtype,
                          device=v.device)
        buf.scatter_(1, _index(buf, dest), v)
        out[key] = buf[:, :k]
    return out, valid.sum(1).to(torch.int32)


def empty_like_packet(packet: Packet) -> Packet:
    return {
        "items": {k: torch.zeros_like(v)
                  for k, v in packet["items"].items()},
        "count": torch.zeros_like(packet["count"]),
    }
