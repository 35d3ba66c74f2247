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

``cfg.deepseek_moe`` (DeepSeek-V3 / Moonlight, ``_moe_fwd_dropless``)
computes every routed (token, k) row: no capacity and no drops, so a
token's output depends on its own row alone. Its router scores with a
sigmoid in float32, chooses the top-k by score plus the layer's
correction bias (``router_bias``), and weights the chosen scores
renormalised to sum one times ``cfg.routed_scale``. The rows are sorted
by expert and the three products run through ``gmm`` with the true group
sizes; ``n_shared_experts`` adds one SwiGLU of width ``n_shared_experts
* expert_d_ff`` that every token takes. Its aux
carries ``moe_load``: (rows through ``gmm``, experts that got a row, the
most rows on one expert), int64 on the device; and ``routes``, a list of
the layer's chosen experts (T, K), to which ``run_layers`` appends every
MoE layer's in order (what an engine with ``cfg.route_log`` records).

On DTensors (the models under ``dist.sharding``'s rules) the mesh is
the activations' own, and ``auto`` makes JAX's choice on it. ``ep`` is
``_moe_fwd_ep``'s local work on each rank's data shard and local experts
(``dist.sharding.local_call``), its combine and statistics DTensor
partial sums (so that autograd carries them). ``global`` is JAX's global
dispatch: every rank routes the whole batch, the (E, cap, D) slot
buffer is constrained to ``("expert", "batch", "none")`` at JAX's site
and the expert products run on each rank's experts and slots, expert e's
slot at row e * cap + pos as in JAX's buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist import collectives as C
from ..dist.sharding import local_call, replicated, shard_act
from ..kernels import ops
from .config import ModelConfig
from .layers import dense_init, mlp_fwd, mlp_init

MOE_IMPLS = ("auto", "global", "ref", "ep")


def moe_init(cfg: ModelConfig, generator, device, dtype):
    """Router (D, E) and expert weights wg, wi (E, D, F), wo (E, F, D),
    with the distributions of ``repro.models.moe.moe_init``, stored in
    ``dtype``; dropless (the sigmoid router) also its correction bias
    ``router_bias`` (E,) float32 (zeros), and with shared experts their
    SwiGLU ``shared`` (D, n_shared * F)."""
    D, Fd, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    p = {
        "router": dense_init((D, E), generator, device).to(dtype),
        "wg": dense_init((E, D, Fd), generator, device, in_axis=1).to(dtype),
        "wi": dense_init((E, D, Fd), generator, device, in_axis=1).to(dtype),
        "wo": dense_init((E, Fd, D), generator, device, in_axis=1).to(dtype),
    }
    if cfg.deepseek_moe:
        p["router_bias"] = torch.zeros(E, dtype=torch.float32, device=device)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(D, cfg.n_shared_experts * Fd, generator,
                               device, dtype)
    return p


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
    if cfg.deepseek_moe:
        if isinstance(x, DTensor) or expert_perm is not None or \
                mesh is not None:
            raise NotImplementedError(
                "dropless MoE: no expert placement, expert parallelism or "
                "sharding rules")
        return _moe_fwd_dropless(p, x, cfg)
    if isinstance(x, DTensor):
        if _ep_mesh(cfg, x.device_mesh) is not None:
            return _moe_fwd_ep_dt(p, x, cfg, expert_perm)
        return _moe_fwd_global_dt(p, x, cfg, expert_perm)
    mesh = _ep_mesh(cfg, mesh)
    if mesh is not None:
        return _moe_fwd_ep(p, x, cfg, expert_perm, mesh)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)
    probs, gate_vals, gate_idx = _route(p, xt, K, expert_perm)

    flat_idx = gate_idx.reshape(T * K, 1)
    onehot, counts, aux_loss = _balance(probs, flat_idx, E)
    n_routed = onehot.sum(0)                                      # (E,)

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
    # (JAX shards the slot buffers here with shard_act, a no-op on one
    # device; ``_moe_fwd_global_dt`` does on a mesh.)

    rows = buf[:E * cap]
    impl = "ref" if cfg.moe_impl == "ref" else "auto"
    mm = lambda a, w: ops.gmm(a, w, sizes, impl=impl)
    h = F.silu(mm(rows, p["wg"])) * mm(rows, p["wi"])
    ye = torch.cat([mm(h, p["wo"]),
                    torch.zeros((1, D), dtype=dt, device=x.device)])

    y = _combine(ye, dest, gate_vals, K)
    dropped = (~kept).sum().float()
    return y.reshape(B, S, D), {"aux_loss": aux_loss,
                                "expert_counts": counts,
                                "dropped": dropped, "capacity": cap}


def route_sigmoid(p, xt, cfg: ModelConfig):
    """The sigmoid router (DeepSeek-V3 ``noaux_tc`` with one group):
    scores s = sigmoid(xt W_r) in float32 (T, E); the top-k experts by s
    plus the correction bias (the bias moves the choice only); their
    weights the chosen s over their sum, times ``cfg.routed_scale``.
    Returns (weights (T, K) float32, experts (T, K) int64)."""
    s = torch.sigmoid(xt.float() @ p["router"].float())
    _, idx = _top_k(s + p["router_bias"].float(), cfg.top_k)
    w = s.gather(1, idx)
    return w / w.sum(-1, keepdim=True) * cfg.routed_scale, idx


def _moe_fwd_dropless(p, x, cfg: ModelConfig):
    """Every (token, k) row computed (see the module docstring): the rows
    sorted by expert (stable), ``gmm`` over the true group sizes, the K
    weighted terms of each token added in order, then the shared
    experts. No host sync."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, gate_idx = route_sigmoid(p, xt, cfg)
    flat = gate_idx.reshape(T * K)
    sorted_e, order = torch.sort(flat, stable=True)
    bounds = torch.searchsorted(
        sorted_e, torch.arange(E + 1, dtype=sorted_e.dtype, device=x.device))
    counts = bounds[1:] - bounds[:-1]                            # (E,)
    dest = torch.empty_like(order)
    dest[order] = torch.arange(T * K, device=x.device)
    rows = xt[order // K]                             # grouped by expert
    impl = "ref" if cfg.moe_impl == "ref" else "auto"
    sizes = counts.to(torch.int32)
    mm = lambda a, w: ops.gmm(a, w, sizes, impl=impl)
    h = F.silu(mm(rows, p["wg"])) * mm(rows, p["wi"])
    y = _combine(mm(h, p["wo"]), dest, gate_vals, K)
    if "shared" in p:
        y = y + mlp_fwd(p["shared"], xt)
    zero = torch.zeros((), device=x.device)
    load = torch.stack([counts.sum(), (counts > 0).sum(), counts.max()])
    return y.reshape(B, S, D), {"aux_loss": zero,
                                "expert_counts": counts.float(),
                                "dropped": zero, "capacity": T * K,
                                "moe_load": load, "routes": [gate_idx]}


def _balance(probs, flat_idx, E: int):
    """The aux load-balance loss (Switch-style), E * sum_e f_e * p_e, of
    routing ``flat_idx`` (T*K, 1) with router probabilities ``probs``
    (T, E). Returns (one-hot (T*K, E) int32, counts (E,) float32, loss).
    The one-hot is a comparison with arange(E): no scatter, and no read
    back to the host (F.one_hot reads its input's range, a sync per
    layer)."""
    onehot = (flat_idx == torch.arange(E, device=flat_idx.device)).to(
        torch.int32)
    counts = onehot.sum(0).float()
    T_K = flat_idx.shape[0]
    return onehot, counts, E * (counts / T_K * probs.mean(0)).sum()


def _dispatch_global(xt, probs, gate_vals, gate_idx, cfg: ModelConfig):
    """JAX's global dispatch of the whole batch xt (T, D) into its (E,
    cap, D) slot buffer, expert e's kept slot at row e * cap + pos and
    every dropped slot at the sentinel row E * cap. Returns (buffer,
    destination (T*K,), counts, aux loss, drops)."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    flat_idx = gate_idx.reshape(T * K, 1)
    onehot, counts, aux_loss = _balance(probs, flat_idx, E)
    cap = capacity(T, cfg)
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, flat_idx)[:, 0]
    kept = pos < cap
    dest = torch.where(kept, flat_idx[:, 0] * cap + pos, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dest, xt[:, None].expand(T, K, D).reshape(T * K, D))
    return (buf[:E * cap].reshape(E, cap, D), dest, counts, aux_loss,
            (~kept).sum().float())


def _combine(ye, dest, gate_vals, K: int):
    """Each (t, k) slot's expert output gathered back from the rows ``ye``
    (the sentinel zero row last), weighted by its gate, the K terms added
    one after another in ye's dtype. Returns (T, D)."""
    D = ye.shape[-1]
    T = gate_vals.shape[0]
    terms = (ye[dest] * gate_vals.reshape(T * K, 1).to(ye.dtype)).reshape(
        T, K, D)
    y = terms[:, 0]
    for kk in range(1, K):
        y = y + terms[:, kk]
    return y


def _expert_ffn(xe, wg, wi, wo, impl: str):
    """The SwiGLU of each expert on its slots, xe (E, cap, D) with every
    slot a row (empty ones zero), through ``ops.gmm`` with group sizes
    [cap] * E. Returns (E, cap, D)."""
    E, cap, D = xe.shape
    rows = xe.reshape(E * cap, D)
    sizes = torch.full((E,), cap, dtype=torch.int32, device=xe.device)
    mm = lambda a, w: ops.gmm(a, w, sizes, impl=impl)
    h = F.silu(mm(rows, wg)) * mm(rows, wi)
    return mm(h, wo).reshape(E, cap, D)


def _moe_fwd_global_dt(p, x, cfg: ModelConfig, expert_perm):
    """The global dispatch on DTensors (see the module docstring)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    mesh = x.device_mesh
    R = (Replicate(),) * mesh.ndim

    def route(xr, router):
        xt = xr.reshape(B * S, D)
        probs, gate_vals, gate_idx = _route({"router": router}, xt, K,
                                            expert_perm)
        return (gate_vals,) + _dispatch_global(xt, probs, gate_vals,
                                               gate_idx, cfg)

    gate_vals, xe, dest, counts, aux_loss, dropped = local_call(
        route, (R,) * 6, replicated(x), replicated(p["router"]))
    xe = shard_act(xe, "expert", "batch", "none")                # EP slots
    wpl = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else
           Replicate() for pl in xe.placements]
    w = [p[k].redistribute(mesh, wpl) for k in ("wg", "wi", "wo")]
    impl = "ref" if cfg.moe_impl == "ref" else "auto"
    ye = local_call(lambda xe, *w: _expert_ffn(xe, *w, impl),
                    xe.placements, xe, *w)

    def combine(ye, dest, gate_vals):
        rows = torch.cat([ye.reshape(E * ye.shape[1], D),
                          torch.zeros((1, D), dtype=ye.dtype,
                                      device=ye.device)])
        return _combine(rows, dest, gate_vals, K).reshape(B, S, D)

    y = local_call(combine, R, replicated(ye), dest, gate_vals)
    back = [pl if isinstance(pl, Shard) else Replicate()
            for pl in x.placements]
    return y.redistribute(mesh, back), {
        "aux_loss": aux_loss, "expert_counts": counts, "dropped": dropped,
        "capacity": capacity(B * S, cfg)}


def _rank_within_expert(gate_idx_flat, E: int):
    """Queue position of each routed (t, k) slot within its expert, via a
    stable sort (JAX's ``_rank_within_expert``): the same positions as
    the global dispatch's exclusive cumsum, from O(T K) vectors. Returns
    (positions, per-expert counts)."""
    n = gate_idx_flat.shape[0]
    dev = gate_idx_flat.device
    sorted_e, order = torch.sort(gate_idx_flat, stable=True)
    # each expert's run in the sorted order; its length is the count
    # (bincount would size its output from the values: a host read)
    bounds = torch.searchsorted(
        sorted_e, torch.arange(E + 1, dtype=sorted_e.dtype, device=dev))
    starts = bounds[:-1]
    rank_sorted = torch.arange(n, device=dev) - starts[sorted_e]
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    pos.scatter_(0, order, rank_sorted)
    return pos, bounds[1:] - starts


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
    dp = [mesh.get_group(a) for a in ("pod", "data")
          if a in mesh.mesh_dim_names]
    model = mesh.get_group("model")
    E_loc = cfg.n_experts // C.size(model)
    lo = C.rank(model) * E_loc
    w = [p[k][lo:lo + E_loc] for k in ("wg", "wi", "wo")]
    y, aux_loss, counts, dropped = _ep_local(
        x.reshape(Bl * Sl, D), p["router"], *w, cfg, expert_perm, lo)
    Tl = Bl * Sl
    # each token's experts live on exactly one rank each -> psum = combine
    y = C.psum(y, model).reshape(Bl, Sl, D)

    n_dp = 1
    for g in dp:
        aux_loss = C.psum(aux_loss, g)
        counts = C.psum(counts, g)
        dropped = C.psum(dropped, g)
        n_dp *= C.size(g)
    return y, {"aux_loss": aux_loss / n_dp, "expert_counts": counts,
               "dropped": dropped, "capacity": capacity(Tl * n_dp, cfg)}


def _ep_local(xt, router, wg, wi, wo, cfg: ModelConfig, expert_perm,
              lo: int):
    """One rank's part of the expert-parallel dispatch, before any
    collective: its tokens xt (T, D) routed over all E experts, the kept
    slots of its local experts [lo, lo + E_loc) (``wg`` etc. their
    weights) packed at row e * cap + pos, and the combine of what they
    give. Returns (y (T, D): this rank's experts' share, aux loss, counts
    (E,), drops) of these tokens."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    E_loc = wg.shape[0]
    dt, dev = xt.dtype, xt.device
    probs, gate_vals, gate_idx = _route({"router": router}, xt, K,
                                        expert_perm)
    # routing stats from (T K,) vectors, no (T, K, E) one-hots
    flat_e = gate_idx.reshape(T * K)
    pos, counts = _rank_within_expert(flat_e, E)
    counts = counts.float()
    aux_loss = E * (counts / (T * K) * probs.mean(0)).sum()

    cap = capacity(T, cfg)
    kept = pos < cap
    rel = flat_e - lo
    mine = kept & (rel >= 0) & (rel < E_loc)
    dest = torch.where(mine, rel * cap + pos, E_loc * cap)
    buf = torch.zeros((E_loc * cap + 1, D), dtype=dt, device=dev)
    buf.index_add_(0, dest, xt[:, None].expand(T, K, D).reshape(T * K, D))
    ye = _expert_ffn(buf[:E_loc * cap].reshape(E_loc, cap, D), wg, wi, wo,
                     "auto")
    ye = torch.cat([ye.reshape(E_loc * cap, D),
                    torch.zeros((1, D), dtype=dt, device=dev)])
    return (_combine(ye, dest, gate_vals, K), aux_loss, counts,
            (~kept).sum().float())


def _moe_fwd_ep_dt(p, x, cfg: ModelConfig, expert_perm):
    """``_moe_fwd_ep`` on DTensors: x's batch split over the data dims
    (``pod``, ``data``) kept, x replicated over ``model``, the router
    replicated and the experts split over ``model`` alone (JAX's
    shard_map in_specs). The combine is a partial sum over ``model``; the
    aux loss, a mean, and the counts and drops, sums, are partial sums
    over the data dims that split the batch."""
    B, S, D = x.shape
    E = cfg.n_experts
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    split = [names[md] in ("pod", "data") and isinstance(pl, Shard)
             and pl.dim == 0 for md, pl in enumerate(x.placements)]
    xpl = [Shard(0) if sp else Replicate() for sp in split]
    x = x.redistribute(mesh, xpl)
    wpl = [Shard(0) if n == "model" else Replicate() for n in names]
    w = [p[k].redistribute(mesh, wpl) for k in ("wg", "wi", "wo")]
    E_loc = E // mesh["model"].size()
    lo = mesh.get_local_rank("model") * E_loc
    n_dp = 1
    for md, sp in enumerate(split):
        n_dp *= mesh.size(md) if sp else 1

    def local(xl, router, wg, wi, wo):
        Bl = xl.shape[0]
        y, aux, counts, dropped = _ep_local(
            xl.reshape(Bl * S, D), router, wg, wi, wo, cfg, expert_perm,
            lo)
        return y.reshape(Bl, S, D), aux, counts, dropped

    ypl = tuple(Partial() if n == "model" else pl
                for n, pl in zip(names, xpl))
    spl = tuple(Partial() if sp else Replicate() for sp in split)
    y, aux, counts, dropped = local_call(
        local, (ypl, spl, spl, spl), x, replicated(p["router"]), *w)
    R = [Replicate()] * mesh.ndim
    return y.redistribute(mesh, xpl), {
        "aux_loss": aux.redistribute(mesh, R) / n_dp,
        "expert_counts": counts.redistribute(mesh, R),
        "dropped": dropped.redistribute(mesh, R),
        "capacity": capacity(B * S, cfg)}
