"""Plain float32 reference of a dense GQA decoder (Mistral / Qwen2 style),
held against what the served path produced.

[RMSNorm -> GQA attention with RoPE (and q/k/v biases where the
configuration has them) -> RMSNorm -> SwiGLU MLP] x L, a final RMSNorm
and the head, as the configurations' sources describe them. Plain PyTorch
in float32 with TF32 off, no kernels, no cache and no batching: each
sequence runs whole, prompt and served tokens together, one layer at a
time (every sequence through layer l before layer l+1), so that only one
layer's weights are held in float32 at a time and a 12B model fits
beside nothing else on one card. The weights are regenerated from the
run's seed by ``harness.weights`` in the order of ``layouts/dense.py``;
nothing here imports the program or reads anything it made.

Departures from the published models, all shared with the program: the
weights are random (``harness.weights``), and RoPE's angles are taken in
float64 before their sine and cosine (more exact than either side needs).

``mode="fp8"`` is the comparison's control: the same network with every
matrix product's operands rounded to float8 e4m3 (weights by output
column, activations by row, each scaled to the format's largest value),
the step below the configurations' bfloat16 that a serving stack would
take; norms, RoPE and the softmax stay float32.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from harness import weights as W
from layouts import layout_of

FP8_MAX = 448.0


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled along ``dim`` so that each slice's
    largest magnitude maps to the format's largest value."""
    s = FP8_MAX / x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _Mat:
    """One weight matrix (in, out) in float32, or its float8 rounding."""

    def __init__(self, w: torch.Tensor, mode: str):
        w = w.float()
        self.w = _fp8(w, 0) if mode == "fp8" else w
        self.mode = mode

    def __rmatmul__(self, x):
        if self.mode == "fp8":
            x = _fp8(x, -1)
        return x @ self.w


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope_tables(T: int, hd: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin):
    """x (T, H, hd): rotate its two halves (the ``rotate_half`` form)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def causal_attention(q, k, v, rows: int = 512):
    """Softmax attention of q (T, Hq, hd) over k, v (T, Hkv, hd), query i
    seeing keys 0..i, in blocks of ``rows`` queries."""
    T, Hq, hd = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    qh = q.reshape(T, Hkv, g, hd).permute(1, 2, 0, 3)     # (Hkv, g, T, hd)
    kh = k.permute(1, 2, 0).unsqueeze(1)                  # (Hkv, 1, hd, T)
    vh = v.permute(1, 0, 2).unsqueeze(1)                  # (Hkv, 1, T, hd)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for s in range(0, T, rows):
        e = min(T, s + rows)
        sc = torch.matmul(qh[:, :, s:e], kh[..., :e]) * scale
        vis = (torch.arange(s, e, device=q.device)[:, None]
               >= torch.arange(e, device=q.device)[None])
        sc = sc.masked_fill(~vis, float("-inf")).softmax(-1)
        o = torch.matmul(sc, vh[:, :, :e])                # (Hkv, g, r, hd)
        out[s:e] = o.permute(2, 0, 1, 3).reshape(e - s, Hq, hd)
    return out


def _layer(x, p, d, cos, sin):
    T = x.shape[0]
    h = rmsnorm(x, p["ln1"], d["eps"])
    q, k, v = h @ p["q"], h @ p["k"], h @ p["v"]
    if d["bias"]:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope(q.view(T, d["Hq"], d["hd"]), cos, sin)
    k = _rope(k.view(T, d["Hkv"], d["hd"]), cos, sin)
    a = causal_attention(q, k, v.view(T, d["Hkv"], d["hd"]))
    x = x + a.reshape(T, -1) @ p["o"]
    h = rmsnorm(x, p["ln2"], d["eps"])
    return x + (F.silu(h @ p["gate"]) * (h @ p["up"])) @ p["down"]


def _layer_params(cfg, seed, li, device, mode):
    raw = W.layer(cfg, seed, li, device)
    p = {}
    for name, t in raw.items():
        if t.dim() == 2:
            p[name] = _Mat(t, mode)
        else:
            p[name] = t.float()
    return p


@torch.no_grad()
def logits_at(cfg: dict, seed: int, seqs: Sequence[Tuple[List[int], int]],
              device, modes: Sequence[str] = ("f32",)):
    """For each (tokens, first) in ``seqs``: the logits (n, vocab) float32
    at positions first .. len(tokens) - 1 of the sequence ``tokens``, once
    per entry of ``modes`` (``f32`` or ``fp8``). Returns
    ``{mode: [logits of each sequence]}``."""
    tf32_off()
    d = layout_of(cfg).dims(cfg)
    emb = W.embed(cfg, seed, device).float()
    hs = {m: [emb[torch.as_tensor(t, device=device)] for t, _ in seqs]
          for m in modes}
    del emb
    T_max = max(len(t) for t, _ in seqs)
    cos, sin = _rope_tables(T_max, d["hd"], d["theta"], device)
    for li in range(d["L"]):
        for m in modes:
            p = _layer_params(cfg, seed, li, device, m)
            for j, (t, _) in enumerate(seqs):
                n = len(t)
                hs[m][j] = _layer(hs[m][j], p, d, cos[:n], sin[:n])
            del p
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
    of those positions."""
    seqs = [(list(p) + list(o[:-1]), len(p) - 1) for p, o in served]
    modes = ("f32", "fp8") if control else ("f32",)
    lg = logits_at(cfg, seed, seqs, device, modes)
    res = {"gap": [], "control": [] if control else None}
    for j, (_, o) in enumerate(served):
        z = lg["f32"][j]
        best = z.max(-1).values
        tok = torch.as_tensor(o, device=z.device).long()[:, None]
        res["gap"].append((best - z.gather(-1, tok)[:, 0]).tolist())
        if control:
            c = lg["fp8"][j].argmax(-1, keepdim=True)
            res["control"].append((best - z.gather(-1, c)[:, 0]).tolist())
    return res
