"""Latent attention with shared-expert routed MoE (DeepSeek-V3 style,
Moonlight-16B-A3B): [RMSNorm -> MLA -> RMSNorm -> SwiGLU (the first
``first_k_dense_replace`` layers) or MoE] x L, a final RMSNorm and the
head. Its plain reference is ``reference/mla_moe.py``; the program's side
is ``repro_torch.models.mla`` and the dropless path of
``repro_torch.models.moe``.

MLA (no query LoRA): q (D, H (dn + dr)); kv_a (D, r + dr), whose first r
columns are normalised (``kv_norm``) into the latent c and whose last dr
take RoPE as the key part every head shares; kv_b (r, H (dn + dv)), each
head's k_nope (dn) and v (dv) columns; o (H dv, D). The MoE: a sigmoid
router (D, E) in float32, the top-k by score plus a correction bias, the
chosen scores renormalised and scaled by ``routed_scaling_factor``;
experts wg, wi (E, D, Fe), wo (E, Fe, D); ``n_shared_experts`` shared
experts as one SwiGLU sg, su (D, Es Fe), sd (Es Fe, D).

Weights (``harness.weights``, ``x @ W``): per layer one buffer in the
served dtype holding q, kv_a, kv_b, o and then either gate, up, down
(dense layers) or router, router_bias, wg, wi, wo, sg, su, sd; then the
norm weights ln1, kv_norm, ln2 in float32. Matrices take 1 / sqrt(fan
in), the correction bias ``harness.weights.BIAS_STD`` (the published one
is trained; a random one of that size moves choices near a tie).

The expert choices the program made: ``model_config`` hands the port a
``route_log`` (``ROUTES``, emptied at each call), which its engine fills
with the experts each served token went to in every MoE layer;
``program_routes`` gives them to the reference, which holds its own
routing to them where they tie with its own choice within rounding
(``reference/mla_moe.py``). Under random weights one routed expert's
weighted output is ~8% of the residual stream, more than the spacing of
the top-k boundary in the next layers' router inputs: an expert choice
that bf16 rounding flips near a tie flips more choices downstream, until
a bf16 run and a float32 reference that route on their own route most
tokens differently (95% of a 2,048-token prompt by layer 26 on an H100)
and no logit comparison tells bf16 from float8.

Model FLOPs (the ``mfu`` yardstick): 2 a product weight a token at the
active weights (attention, the dense SwiGLU or the router, k routed and
the shared experts); attention 2 H (dn + dr + dv) a (query, visible key)
pair a layer, whatever form computes it (the engine's decode runs the
absorbed form, which does more); the head 2 D V where a token is
sampled.

Attention calls' bytes read each input once and write the output once.
A prefill call (the expanded form) that launched S rows: q and k (S, H,
dn + dr), v and out (S, H, dv). A decode call (the absorbed form,
``mla_paged_decode``) over all slots: each slot's q (H, r + dr) and out
(H, r), its length, and each active slot's latent rows (r + dr) of its
window and its block-table entries.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

import torch

from harness import weights as W
from harness.flops import BF16, INT32

# The last configuration's route log: prompt (a tuple) -> the program's
# expert choices for its positions (``MLAConfig.route_log``).
ROUTES: dict = {}
# What the program and the reference implement of the DeepSeek-V3 family:
# a configuration that asks for anything else is refused.
SUPPORTED = {"q_lora_rank": None, "scoring_func": "sigmoid",
             "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "norm_topk_prob": True, "moe_layer_freq": 1,
             "hidden_act": "silu", "attention_bias": False}


def dims(cfg: dict) -> dict:
    for key, want in SUPPORTED.items():
        if cfg.get(key) != want:
            raise ValueError(f"mla_moe: {key} {cfg.get(key)!r} is not "
                             f"supported (only {want!r})")
    if cfg.get("rope_scaling"):
        raise ValueError("mla_moe: rope_scaling is not supported")
    return {"L": cfg["num_hidden_layers"], "D": cfg["hidden_size"],
            "V": cfg["vocab_size"],
            "tied": bool(cfg.get("tie_word_embeddings", False)),
            "H": cfg["num_attention_heads"], "r": cfg["kv_lora_rank"],
            "dn": cfg["qk_nope_head_dim"], "dr": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "F": cfg["intermediate_size"],
            "Fe": cfg["moe_intermediate_size"],
            "E": cfg["n_routed_experts"], "K": cfg["num_experts_per_tok"],
            "Es": cfg["n_shared_experts"],
            "dense": cfg["first_k_dense_replace"],
            "scale": float(cfg["routed_scaling_factor"]),
            "theta": float(cfg["rope_theta"]),
            "eps": float(cfg["rms_norm_eps"])}


def is_moe(d: dict, li: int) -> bool:
    return li >= d["dense"]


def layer_leaves(d: dict, li: int) -> List[Tuple[str, tuple, float]]:
    D, H, r, F, Fe, E = d["D"], d["H"], d["r"], d["F"], d["Fe"], d["E"]
    dn, dr, dv = d["dn"], d["dr"], d["dv"]
    out = [("q", (D, H * (dn + dr)), 1 / math.sqrt(D)),
           ("kv_a", (D, r + dr), 1 / math.sqrt(D)),
           ("kv_b", (r, H * (dn + dv)), 1 / math.sqrt(r)),
           ("o", (H * dv, D), 1 / math.sqrt(H * dv))]
    if not is_moe(d, li):
        return out + [("gate", (D, F), 1 / math.sqrt(D)),
                      ("up", (D, F), 1 / math.sqrt(D)),
                      ("down", (F, D), 1 / math.sqrt(F))]
    Fs = d["Es"] * Fe
    return out + [("router", (D, E), 1 / math.sqrt(D)),
                  ("router_bias", (E,), W.BIAS_STD),
                  ("wg", (E, D, Fe), 1 / math.sqrt(D)),
                  ("wi", (E, D, Fe), 1 / math.sqrt(D)),
                  ("wo", (E, Fe, D), 1 / math.sqrt(Fe)),
                  ("sg", (D, Fs), 1 / math.sqrt(D)),
                  ("su", (D, Fs), 1 / math.sqrt(D)),
                  ("sd", (Fs, D), 1 / math.sqrt(Fs))]


def layer_norms(d: dict, li: int) -> List[Tuple[str, int]]:
    return [("ln1", d["D"]), ("kv_norm", d["r"]), ("ln2", d["D"])]


def model_config(cfg: dict):
    """The port's ``MLAConfig`` for a configuration file's keys, which
    records the expert choices of what it serves into ``ROUTES`` (emptied
    here: one run's at a time)."""
    from repro_torch.models.config import MLAConfig

    d = dims(cfg)
    ROUTES.clear()
    return MLAConfig(
        name=cfg["name"], family="moe", n_layers=d["L"], d_model=d["D"],
        n_heads=d["H"], n_kv_heads=d["H"], d_ff=d["F"], vocab=d["V"],
        rope_theta=d["theta"], tie_embeddings=d["tied"], norm_eps=d["eps"],
        n_experts=d["E"], top_k=d["K"], kv_lora_rank=d["r"],
        qk_nope_head_dim=d["dn"], qk_rope_head_dim=d["dr"],
        v_head_dim=d["dv"], moe_d_ff=d["Fe"], n_shared_experts=d["Es"],
        first_k_dense=d["dense"], routed_scale=d["scale"],
        route_log=ROUTES, dtype=cfg["torch_dtype"])


def program_routes(prompt, n: int):
    """The program's expert choices (n, MoE layers, k) int64 for the
    first ``n`` positions of the request whose prompt is ``prompt``, or
    None where its log does not cover exactly those (a request served
    elsewhere)."""
    pieces = ROUTES.get(tuple(prompt))
    if not pieces or sum(p.shape[0] for p in pieces) != n:
        return None
    return torch.cat(pieces).long()


def make_params(cfg: dict, mcfg, seed: int, device) -> dict:
    """The benchmark's weights in the port's layout: matrices as they are,
    norm weights w as the port's scales w - 1, the correction bias in
    float32, the vocabulary padded to ``padded_vocab`` with zeros."""
    d = dims(cfg)
    V, Vp = d["V"], mcfg.padded_vocab

    def pad(t, dim):
        if Vp == V:
            return t
        shape = list(t.shape)
        shape[dim] = Vp
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(dim, 0, V).copy_(t)
        return out

    params = {"embed": pad(W.embed(cfg, seed, device), 0)}
    if not d["tied"]:
        params["head"] = pad(W.head(cfg, seed, device), 1)
    params["blocks"] = []
    for li in range(d["L"]):
        w = W.layer(cfg, seed, li, device)
        blk = {"ln1": w["ln1"] - 1.0, "ln2": w["ln2"] - 1.0,
               "attn": {"wq": w["q"], "wkv_a": w["kv_a"],
                        "kv_norm": w["kv_norm"] - 1.0, "wkv_b": w["kv_b"],
                        "wo": w["o"]}}
        if is_moe(d, li):
            blk["moe"] = {"router": w["router"],
                          "router_bias": w["router_bias"].float(),
                          "wg": w["wg"], "wi": w["wi"], "wo": w["wo"],
                          "shared": {"wg": w["sg"], "wi": w["su"],
                                     "wo": w["sd"]}}
        else:
            blk["mlp"] = {"wg": w["gate"], "wi": w["up"], "wo": w["down"]}
        params["blocks"].append(blk)
    params["final_ln"] = W.final_norm(cfg, seed, device) - 1.0
    return params


def attention_weights(d: dict) -> int:
    D, H, r = d["D"], d["H"], d["r"]
    return (D * H * (d["dn"] + d["dr"]) + D * (r + d["dr"])
            + r * H * (d["dn"] + d["dv"]) + H * d["dv"] * D)


def active_weights(d: dict) -> int:
    """Product weights a token goes through, over all layers (the head
    apart): attention, and the dense SwiGLU or the router, k routed
    experts and the shared ones."""
    D = d["D"]
    moe = 3 * D * d["Fe"] * (d["K"] + d["Es"]) + D * d["E"]
    return sum(attention_weights(d) + (moe if is_moe(d, li)
                                       else 3 * D * d["F"])
               for li in range(d["L"]))


def param_count(d: dict) -> int:
    """Every parameter: embeddings, layers (all experts), norms."""
    D = d["D"]
    moe = 3 * D * d["Fe"] * (d["E"] + d["Es"]) + D * d["E"] + d["E"]
    layers = sum(attention_weights(d) + 2 * D + d["r"]
                 + (moe if is_moe(d, li) else 3 * D * d["F"])
                 for li in range(d["L"]))
    return (1 if d["tied"] else 2) * d["V"] * D + layers + D


def _pair_flops(d: dict) -> float:
    """Attention FLOPs of one (query, visible key) pair in one layer."""
    return 2.0 * d["H"] * (d["dn"] + d["dr"] + d["dv"])


def prompt_flops(d: dict, n: int) -> float:
    return (2.0 * active_weights(d) * n
            + _pair_flops(d) * d["L"] * n * (n + 1) / 2
            + 2.0 * d["D"] * d["V"])


def decode_flops(d: dict, cache_len: int, tokens: int) -> float:
    pairs = tokens * (cache_len + 1) + tokens * (tokens - 1) / 2
    return (tokens * (2.0 * active_weights(d) + 2.0 * d["D"] * d["V"])
            + _pair_flops(d) * d["L"] * pairs)


def prefill_attention(d: dict, rows: int) -> Tuple[float, float]:
    H, dk, dv = d["H"], d["dn"] + d["dr"], d["dv"]
    flops = _pair_flops(d) * rows * (rows + 1) / 2
    nbytes = BF16 * rows * H * (2 * dk + 2 * dv)
    return flops * d["L"], float(nbytes) * d["L"]


def decode_attention(d: dict, windows: Iterable[int], slots: int,
                     block_size: int) -> Tuple[float, float]:
    """The absorbed form: H queries of r + dr against one latent row a
    key, values its first r columns."""
    H, dk, dv = d["H"], d["r"] + d["dr"], d["r"]
    flops, nbytes = 0.0, float(BF16 * slots * H * (dk + dv) + INT32 * slots)
    for w in windows:
        flops += 2.0 * H * (dk + dv) * w
        nbytes += BF16 * w * dk + INT32 * -(-w // block_size)
    return flops * d["L"], nbytes * d["L"]


def gmm_work(d: dict, rows: int, experts_hit: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the three ``gmm`` calls of MoE layers that routed
    ``rows`` (token, k) rows in all, summed over calls, whose experts with
    a row number ``experts_hit`` summed over calls: each such expert's
    three matrices read once a call, each row's inputs read and outputs
    written once a product."""
    D, Fe = d["D"], d["Fe"]
    flops = 3 * 2.0 * rows * D * Fe
    nbytes = BF16 * (experts_hit * 3 * D * Fe + rows * 3 * (D + Fe))
    return flops, float(nbytes)
