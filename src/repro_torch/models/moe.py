"""Mixture-of-Experts layer: top-k router, capacity-bounded dispatch, the
Switch load-balancing loss and per-expert token counts (the GLB expert
rebalancer's signal, ``glb_moe.py``).

The counterpart of ``repro.models.moe``'s global dispatch
(``_moe_fwd_global``): routing, capacity, queue positions, drops to the
sentinel row E, the combine and the aux outputs are JAX's, step for step.
The three expert products, einsums over the (E, cap, D) capacity buffers
in JAX, are grouped matrix products here, through ``kernels.ops.gmm``: the
capacity buffer is packed by expert, expert e's kept slots taking rows
``offs[e] + pos`` with ``sizes[e] = min(count_e, cap)`` and ``offs`` their
exclusive cumsum, all on the device. An expert that keeps no row has an
empty group, whose weights the kernel never reads. The buffer keeps its
static shape (E * cap + 1, D): the rows past ``sum(sizes)`` stay zero and
``gmm`` writes zeros there. JAX's empty capacity slots were zero rows,
which stay zero through silu(0) * 0 and the ``wo`` product, so every kept
slot sees the einsum's value and this is the einsum's function.

``cfg.moe_impl``: ``auto`` and ``global`` run this dispatch with the
``gmm`` kernel wrapper (the kernel on a CUDA tensor, its plain version on
a CPU one), as JAX's ``auto`` runs the global dispatch without a mesh;
``ref`` runs it with the plain ``gmm_ref`` on any device (the yardstick
the kernel path is held to); ``ep``, JAX's shard_map expert parallelism,
is not ported yet (ROADMAP §1, "Distribution") and raises.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import dense_init

MOE_IMPLS = ("auto", "global", "ref")


def moe_init(cfg: ModelConfig, generator, device, dtype):
    """Router (D, E) and expert weights wg, wi (E, D, F), wo (E, F, D),
    with the distributions of ``repro.models.moe.moe_init``, stored in
    ``dtype``."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init((D, E), generator, device).to(dtype),
        "wg": dense_init((E, D, Fd), generator, device, in_axis=1).to(dtype),
        "wi": dense_init((E, D, Fd), generator, device, in_axis=1).to(dtype),
        "wo": dense_init((E, Fd, D), generator, device, in_axis=1).to(dtype),
    }


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert for T tokens: JAX's expression as is (Python's
    ``round`` rounds half to even)."""
    return int(max(1, round(T * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _top_k(probs, k: int):
    """lax.top_k's order: descending, the lower index first among equal
    values (a stable sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_fwd(p, x, cfg: ModelConfig, expert_perm=None) -> Tuple[torch.Tensor,
                                                               dict]:
    """x (B, S, D) -> (y (B, S, D), aux). aux: ``aux_loss``,
    ``expert_counts`` (E,) and ``dropped`` as float32 tensors, and
    ``capacity`` (int). ``expert_perm`` ((E,) int): logical expert e's
    weights live at slot expert_perm[e] (the rebalancer's placement)."""
    if cfg.moe_impl == "ep":
        raise NotImplementedError(
            "moe_impl='ep' (shard_map expert parallelism) is not ported "
            "yet: ROADMAP §1, Distribution")
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; have "
                         f"{MOE_IMPLS + ('ep',)}")
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)

    # Router logits in the compute dtype, then float32, as JAX.
    logits = (xt @ p["router"]).float()                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)                        # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    if expert_perm is not None:
        perm = torch.as_tensor(expert_perm, device=x.device).long()
        gate_idx = perm[gate_idx]

    # aux load-balance loss (Switch-style): E * sum_e f_e * p_e. The
    # one-hot rows are made by a scatter: F.one_hot reads its input's
    # range back to the host, a sync per layer.
    flat_idx = gate_idx.reshape(T * K, 1)
    onehot = torch.zeros((T * K, E), dtype=torch.int32, device=x.device)
    onehot.scatter_(1, flat_idx, 1)                               # (T*K, E)
    n_routed = onehot.sum(0)                                      # (E,)
    counts = n_routed.float()
    aux_loss = E * (counts / (T * K) * probs.mean(0)).sum()

    # Capacity-bounded dispatch: the queue position of each routed (t, k)
    # slot within its expert, in (t, k) order over the whole batch (JAX's
    # exclusive cumsum over the (T*K, E) one-hot, read at the slot's
    # expert). Expert e keeps sizes[e] = min(count_e, cap) slots, packed at
    # rows offs[e] + pos of the (E * cap, D) buffer, unique; dropped slots
    # go to the sentinel row E * cap (JAX's sentinel expert E), sliced off
    # below.
    cap = capacity(T, cfg)
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, flat_idx)[:, 0]
    kept = pos < cap                                              # (T*K,)
    sizes = n_routed.clamp(max=cap).to(torch.int32)
    offs = torch.cumsum(sizes, 0) - sizes
    dest = torch.where(kept, offs[flat_idx[:, 0]] + pos, E * cap)

    # scatter-add each slot's token, as JAX's .at[].add (one call for the
    # K slots of every token: each kept row receives exactly one token)
    buf = torch.zeros((E * cap + 1, D), dtype=dt, device=x.device)
    buf.index_add_(0, dest, xt[:, None].expand(T, K, D).reshape(T * K, D))
    # (JAX shards the buffers here with shard_act, a no-op on one device.)

    rows = buf[:E * cap]
    impl = "ref" if cfg.moe_impl == "ref" else "auto"
    mm = lambda a, w: ops.gmm(a, w, sizes, impl=impl)
    h = F.silu(mm(rows, p["wg"])) * mm(rows, p["wi"])
    ye = torch.cat([mm(h, p["wo"]),
                    torch.zeros((1, D), dtype=dt, device=x.device)])

    # combine: gather each (t, k) slot back, weighted by its gate, the K
    # terms added one after another in dt
    terms = (ye[dest] * gate_vals.reshape(T * K, 1).to(dt)).reshape(T, K, D)
    y = terms[:, 0]
    for kk in range(1, K):
        y = y + terms[:, kk]
    dropped = (~kept).sum().float()
    return y.reshape(B, S, D), {"aux_loss": aux_loss,
                                "expert_counts": counts,
                                "dropped": dropped, "capacity": cap}
