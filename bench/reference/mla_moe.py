"""Plain float32 reference of latent attention with shared-expert routed
MoE (DeepSeek-V3 style, Moonlight-16B-A3B), held against what the served
path produced.

Per layer: RMSNorm -> MLA -> RMSNorm -> SwiGLU (the first
``first_k_dense_replace`` layers) or MoE; then a final RMSNorm and the
head. MLA in the expanded form, as DeepSeek-V2's paper writes it: q = h
W_q per head split into q_nope and q_pe; a = h W_kva, c = RMSNorm(a[:r])
with ``kv_norm``, k_pe = RoPE(a[r:]) shared by the heads; [k_nope, v] = c
W_kvb per head; keys [k_nope, k_pe], queries [q_nope, RoPE(q_pe)],
softmax(q k / sqrt(dn + dr)) causal, then W_o. MoE: s = sigmoid(h W_r);
the top-k experts by s + bias; weights s over their sum times
``routed_scaling_factor``; the sum of each chosen expert's SwiGLU
weighted, plus the shared experts' SwiGLU.

Routing held to the program's where they tie. Under random weights an
expert choice that rounding flips near a tie moves the residual stream
by more than the next layers' top-k spacing, so a float32 run and a bf16
one that each route on their own part ways within a few layers whatever
their precision (``layouts/mla_moe.py``). Where the program's choices
for a token in a layer are known (``layout.program_routes``: its engine
logs them), the reference takes them when they are k distinct experts
each scoring (s + bias, on the reference's own hidden state) within
``TIE`` of its own k-th best, and its own choice otherwise; so a sound
program is followed through its near-ties, and a choice past a tie, a
wrong expert's output or a wrong weight still parts the two. The
weights are always the reference's own scores of the experts taken.
``served_gaps`` reports, under ``routing``, how many choices were held
and how many departed past ``TIE``, and the largest shortfall of a
program's choice below the reference's k-th best.

Plain PyTorch in float32 with TF32 off, no kernels, no cache and no
batching: each sequence runs whole, prompt and served tokens together,
one layer at a time (every sequence through layer l before layer l + 1),
attention in blocks of queries; the MoE takes every sequence's tokens at
once, one expert at a time. Weights are regenerated from the run's seed
by ``harness.weights`` in the order of ``layouts/mla_moe.py``. Nothing
here imports the program; of what it made, the reference reads the
served tokens and the expert ids it logged, nothing else.

Departures from the published model, all shared with the program: the
weights (and the correction bias) are random; RoPE rotates the two
halves of the dr dims (the published code interleaves them: under random
weights a fixed permutation of those columns of W_q and W_kva); RoPE's
angles are taken in float64.

``mode="fp8"`` is the comparison's control: every matrix product's
operands (the router's too) rounded to float8 e4m3 as in
``reference/dense.py``; norms, RoPE, the routing arithmetic and the
softmax stay float32. Its routing is held to the program's by the same
rule, on its own scores.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from harness import weights as W
from layouts import layout_of
from reference.dense import _Mat, _rope, _rope_tables, rmsnorm, tf32_off

# How far (in s + bias) each expert the program chose may score below the
# reference's k-th best and still be taken. A sound bf16 run's choices
# fall short by at most 0.033-0.041 a run (16 seeds on an H100, about
# 1e5 held choices each); a planted routed fault's, and the float8
# control's, by up to 0.75-0.81, past this on 1e5 or more choices.
TIE = 0.08


def causal_attention(q, k, v, rows: int = 512):
    """Softmax attention of q, k (T, H, dk) and v (T, H, dv), query i
    seeing keys 0..i, scaled by 1 / sqrt(dk), in blocks of ``rows``
    queries. Returns (T, H, dv)."""
    T = q.shape[0]
    qh, kh, vh = q.transpose(0, 1), k.permute(1, 2, 0), v.transpose(0, 1)
    out = q.new_empty((T, q.shape[1], v.shape[-1]))
    scale = 1.0 / math.sqrt(q.shape[-1])
    for s in range(0, T, rows):
        e = min(T, s + rows)
        sc = torch.matmul(qh[:, s:e], kh[..., :e]) * scale   # (H, r, e)
        vis = (torch.arange(s, e, device=q.device)[:, None]
               >= torch.arange(e, device=q.device)[None])
        sc = sc.masked_fill(~vis, float("-inf")).softmax(-1)
        out[s:e] = torch.matmul(sc, vh[:, :e]).transpose(0, 1)
    return out


def _swiglu(h, g, u, dn):
    return (F.silu(h @ g) * (h @ u)) @ dn


def _attention(x, p, d, cos, sin):
    T = x.shape[0]
    H, r, dn, dr = d["H"], d["r"], d["dn"], d["dr"]
    h = rmsnorm(x, p["ln1"], d["eps"])
    q = (h @ p["q"]).view(T, H, dn + dr)
    a = h @ p["kv_a"]
    c = rmsnorm(a[:, :r], p["kv_norm"], d["eps"])
    k_pe = _rope(a[:, None, r:], cos, sin)
    kv = (c @ p["kv_b"]).view(T, H, -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(T, H, dr)], dim=-1)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    o = causal_attention(q, k, kv[..., dn:].contiguous())
    return x + o.reshape(T, -1) @ p["o"]


def route(h, router, bias, d, held=None, stats=None):
    """(weights (T, K), experts (T, K)) of the sigmoid router; with
    ``held`` (T, K) (the program's choices, -1 where unknown) each token
    takes the program's experts where they tie with its own (``TIE``).
    ``stats`` adds up ``held``, ``departed`` and ``max_deficit``."""
    s = torch.sigmoid(h @ router)
    sel = s + bias
    top = torch.topk(sel, d["K"], dim=-1)
    idx = top.indices
    if held is not None:
        E = d["E"]
        hs = held.clamp(0, E - 1)
        srt = hs.sort(-1).values
        have = (((held >= 0) & (held < E)).all(-1)
                & (srt[:, 1:] != srt[:, :-1]).all(-1))
        deficit = top.values[:, -1] - sel.gather(1, hs).min(-1).values
        take = have & (deficit <= TIE)
        if stats is not None:
            differs = (srt != idx.sort(-1).values).any(-1)
            stats["held"] += int((take & differs).sum())
            stats["departed"] += int((have & ~take).sum())
            if bool(have.any()):
                stats["max_deficit"] = max(stats["max_deficit"],
                                           float(deficit[have].max()))
        idx = torch.where(take[:, None], hs, idx)
    w = s.gather(1, idx)
    return w / w.sum(-1, keepdim=True) * d["scale"], idx


def _moe(h, raw, p, d, mode, held=None, stats=None):
    """The routed experts (one at a time, each over the tokens that chose
    it) and the shared experts, of the normalised tokens h (T, D)."""
    w, idx = route(h, p["router"], p["router_bias"], d, held, stats)
    y = _swiglu(h, p["sg"], p["su"], p["sd"])
    for e in range(d["E"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(h[tok], _Mat(raw["wg"][e], mode),
                      _Mat(raw["wi"][e], mode), _Mat(raw["wo"][e], mode))
        y.index_add_(0, tok, out * w[tok, slot, None])
    return y


def _layer_params(cfg, seed, li, device, mode):
    """Layer ``li``: 2-D matrices as float32 (or float8-rounded) ``_Mat``s,
    vectors in float32; the experts' (E, ., .) stacks stay raw, made
    ``_Mat``s one expert at a time."""
    raw = W.layer(cfg, seed, li, device)
    p = {}
    for name, t in raw.items():
        if t.dim() == 2:
            p[name] = _Mat(t, mode)
        elif t.dim() == 1:
            p[name] = t.float()
    return p, {k: raw[k] for k in ("wg", "wi", "wo") if k in raw}


def _held(d, routes, lens, device):
    """The program's choices (T, MoE layers, K) over the sequences laid
    end to end, -1 where a sequence has none; None where none has."""
    if routes is None or all(r is None for r in routes):
        return None
    n_moe = sum(1 for li in range(d["L"]) if li >= d["dense"])
    return torch.cat([
        r.to(device) if r is not None else
        torch.full((n, n_moe, d["K"]), -1, dtype=torch.long, device=device)
        for r, n in zip(routes, lens)])


@torch.no_grad()
def logits_at(cfg: dict, seed: int, seqs: Sequence[Tuple[List[int], int]],
              device, modes: Sequence[str] = ("f32",), routes=None,
              stats=None):
    """For each (tokens, first) in ``seqs``: the logits (n, vocab) float32
    at positions first .. len(tokens) - 1 of the sequence ``tokens``, once
    per entry of ``modes`` (``f32`` or ``fp8``). ``routes``: for each
    sequence the program's choices (len(tokens), MoE layers, K) or None;
    ``stats``: a dict per mode, filled by ``route``. Returns ``{mode:
    [logits of each sequence]}``."""
    tf32_off()
    lay = layout_of(cfg)
    d = lay.dims(cfg)
    emb = W.embed(cfg, seed, device).float()
    hs = {m: [emb[torch.as_tensor(t, device=device)] for t, _ in seqs]
          for m in modes}
    del emb
    T_max = max(len(t) for t, _ in seqs)
    cos, sin = _rope_tables(T_max, d["dr"], d["theta"], device)
    lens = [len(t) for t, _ in seqs]
    held = _held(d, routes, lens, device)
    for li in range(d["L"]):
        for m in modes:
            p, experts = _layer_params(cfg, seed, li, device, m)
            xs = [_attention(x, p, d, cos[:n], sin[:n])
                  for x, n in zip(hs[m], lens)]
            x = torch.cat(xs)
            h = rmsnorm(x, p["ln2"], d["eps"])
            if lay.is_moe(d, li):
                hl = None if held is None else held[:, li - d["dense"]]
                x = x + _moe(h, experts, p, d, m, hl,
                             None if stats is None else stats[m])
            else:
                x = x + _swiglu(h, p["gate"], p["up"], p["down"])
            hs[m] = list(torch.split(x, lens))
            del p, experts, xs, x, h
    head = W.head(cfg, seed, device)
    fn = W.final_norm(cfg, seed, device)
    out = {}
    for m in modes:
        hm = _Mat(head, m)
        out[m] = [rmsnorm(h[first:], fn, d["eps"]) @ hm
                  for h, (_, first) in zip(hs[m], seqs)]
    return out


def served_gaps(cfg: dict, seed: int, served, device,
                control: bool = False) -> dict:
    """``served``: (prompt, out) pairs, the tokens a greedy server emitted.
    Each served token's gap is how far the reference's logit of it lies
    below the reference's largest logit at that position (0 where the
    server chose the reference's own best). Returns ``{"gap": [per
    sequence, a list of gaps]}`` and with ``control`` also ``"control"``:
    the same gap for the token that the float8 network puts first at each
    of those positions. Routing is held to the program's where it logged
    it (module docstring); ``routing`` gives, for each mode, the choices
    held and departed, the largest shortfall, and the sequences with no
    log (``unlogged``)."""
    seqs = [(list(p) + list(o[:-1]), len(p) - 1) for p, o in served]
    modes = ("f32", "fp8") if control else ("f32",)
    lay = layout_of(cfg)
    routes = [lay.program_routes(p, len(t)) for (p, _), (t, _) in
              zip(served, seqs)]
    stats = {m: {"held": 0, "departed": 0, "max_deficit": 0.0,
                 "unlogged": sum(r is None for r in routes)} for m in modes}
    lg = logits_at(cfg, seed, seqs, device, modes, routes, stats)
    res = {"gap": [], "control": [] if control else None, "routing": stats}
    for j, (_, o) in enumerate(served):
        z = lg["f32"][j]
        best = z.max(-1).values
        tok = torch.as_tensor(o, device=z.device).long()[:, None]
        res["gap"].append((best - z.gather(-1, tok)[:, 0]).tolist())
        if control:
            c = lg["fp8"][j].argmax(-1, keepdim=True)
            res["control"].append((best - z.gather(-1, c)[:, 0]).tolist())
    return res
