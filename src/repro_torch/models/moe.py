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

``cfg.moe_impl``: ``global`` runs this dispatch with the ``gmm`` kernel
wrapper (the kernel on a CUDA tensor, its plain version on a CPU one);
``ref`` runs it with the plain ``gmm_ref`` on any device (the yardstick
the kernel path is held to); ``ep`` is JAX's shard_map expert
parallelism (``_moe_fwd_ep``) over the ``mesh=`` the caller passes, a
``torch.distributed`` ``DeviceMesh`` with a ``model`` dimension that
divides ``n_experts``: data parallel over ``data`` (and ``pod``), each
``model`` rank computing only its ``E / ranks`` local experts through the
``gmm`` kernel and the combine one ``psum`` over ``model``. ``auto`` takes
``ep`` when it is given such a mesh (JAX's ``auto`` reads the ambient
mesh) and ``global`` otherwise.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..dist import collectives as C
from ..kernels import ops
from .config import ModelConfig
from .layers import dense_init

MOE_IMPLS = ("auto", "global", "ref", "ep")


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


def _route(p, xt, K: int, expert_perm):
    """The router of both dispatches: logits in the compute dtype, then
    float32 (as JAX), softmax, top-K, the gates normalised over the K, and
    the logical experts mapped to their slots by ``expert_perm``. xt
    (T, D) -> probs (T, E), gate_vals (T, K), gate_idx (T, K)."""
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    if expert_perm is not None:
        perm = torch.as_tensor(expert_perm, device=xt.device).long()
        gate_idx = perm[gate_idx]
    return probs, gate_vals, gate_idx


def _ep_mesh(cfg: ModelConfig, mesh):
    """``mesh`` if ``cfg.moe_impl`` takes expert parallelism on it, else
    None (JAX's choice of the ambient mesh, on the mesh passed in)."""
    if cfg.moe_impl not in ("auto", "ep"):
        return None
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" in names and cfg.n_experts % mesh["model"].size() == 0:
        return mesh
    if cfg.moe_impl == "ep":
        raise ValueError("moe_impl='ep' needs a mesh with a 'model' axis "
                         "dividing n_experts")
    return None


def moe_fwd(p, x, cfg: ModelConfig, expert_perm=None,
            mesh=None) -> Tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (y (B, S, D), aux). aux: ``aux_loss``,
    ``expert_counts`` (E,) and ``dropped`` as float32 tensors, and
    ``capacity`` (int). ``expert_perm`` ((E,) int): logical expert e's
    weights live at slot expert_perm[e] (the rebalancer's placement).
    ``mesh``: a ``DeviceMesh`` for ``moe_impl`` ``ep`` / ``auto`` (see
    ``_moe_fwd_ep``: there x and y are this rank's data shard)."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; have "
                         f"{MOE_IMPLS}")
    mesh = _ep_mesh(cfg, mesh)
    if mesh is not None:
        return _moe_fwd_ep(p, x, cfg, expert_perm, mesh)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)
    probs, gate_vals, gate_idx = _route(p, xt, K, expert_perm)

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


def _rank_within_expert(gate_idx_flat, E: int):
    """Queue position of each routed (t, k) slot within its expert, via a
    stable sort (JAX's ``_rank_within_expert``): the same positions as
    the global dispatch's exclusive cumsum, from O(T K) vectors. Returns
    (positions, per-expert counts)."""
    n = gate_idx_flat.shape[0]
    dev = gate_idx_flat.device
    sorted_e, order = torch.sort(gate_idx_flat, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=sorted_e.dtype, device=dev))
    rank_sorted = torch.arange(n, device=dev) - starts[sorted_e]
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    pos.scatter_(0, order, rank_sorted)
    return pos, torch.bincount(gate_idx_flat, minlength=E)


def _moe_fwd_ep(p, x, cfg: ModelConfig, expert_perm, mesh):
    """Expert parallelism on ``mesh`` (JAX's shard_map ``_moe_fwd_ep``):
    data parallel over the mesh's ``pod`` and ``data`` dimensions, expert
    parallel over ``model``. x (B_loc, S, D) is this rank's data shard
    (the ranks of one ``model`` group pass the same one) and y its shard
    of the output. ``p`` holds every expert's weights, as JAX's global
    view does; a rank reads only its E / ranks experts' slices.

    Capacity is per data shard and the queue order is the stable token
    order, so each shard's y, drops and counts are those of the global
    dispatch run on that shard alone. Each rank packs the kept slots of
    its local experts into a (E_loc * cap, D) buffer, expert e's slot at
    row e * cap + pos, and runs the three products through ``gmm`` with
    group sizes [cap] * E_loc (empty slots are zero rows, which stay
    zero); every other slot goes to a zero sentinel row. Each token's
    experts live on one rank each, so the combine is one ``psum`` over
    ``model``. ``aux_loss`` is the per-shard Switch estimator averaged
    (``pmean``) over the data dimensions, ``expert_counts`` and
    ``dropped`` are summed (``psum``) over them, one dimension after
    another."""
    Bl, Sl, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    Tl = Bl * Sl
    dt = x.dtype
    dev = x.device
    dp = [mesh.get_group(a) for a in ("pod", "data")
          if a in mesh.mesh_dim_names]
    model = mesh.get_group("model")
    E_loc = E // C.size(model)
    lo = C.rank(model) * E_loc
    xt = x.reshape(Tl, D)
    probs, gate_vals, gate_idx = _route(p, xt, K, expert_perm)

    # routing stats from (T K,) vectors, no (T, K, E) one-hots
    flat_e = gate_idx.reshape(Tl * K)
    pos, counts = _rank_within_expert(flat_e, E)
    counts = counts.float()
    aux_loss = E * (counts / (Tl * K) * probs.mean(0)).sum()

    cap = capacity(Tl, cfg)
    kept = pos < cap
    rel = flat_e - lo
    mine = kept & (rel >= 0) & (rel < E_loc)
    dest = torch.where(mine, rel * cap + pos, E_loc * cap)
    buf = torch.zeros((E_loc * cap + 1, D), dtype=dt, device=dev)
    buf.index_add_(0, dest, xt[:, None].expand(Tl, K, D).reshape(Tl * K, D))

    rows = buf[:E_loc * cap]
    sizes = torch.full((E_loc,), cap, dtype=torch.int32, device=dev)
    w = {k: p[k][lo:lo + E_loc] for k in ("wg", "wi", "wo")}
    mm = lambda a, wk: ops.gmm(a, w[wk], sizes)
    h = F.silu(mm(rows, "wg")) * mm(rows, "wi")
    ye = torch.cat([mm(h, "wo"), torch.zeros((1, D), dtype=dt, device=dev)])

    terms = (ye[dest] * gate_vals.reshape(Tl * K, 1).to(dt)).reshape(Tl, K,
                                                                     D)
    y = terms[:, 0]
    for kk in range(1, K):
        y = y + terms[:, kk]
    # each token's experts live on exactly one rank each -> psum = combine
    y = C.psum(y, model).reshape(Bl, Sl, D)

    dropped = (~kept).sum().float()
    n_dp = 1
    for g in dp:
        aux_loss = C.psum(aux_loss, g)
        counts = C.psum(counts, g)
        dropped = C.psum(dropped, g)
        n_dp *= C.size(g)
    return y, {"aux_loss": aux_loss / n_dp, "expert_counts": counts,
               "dropped": dropped, "capacity": capacity(Tl * n_dp, cfg)}
