"""The dense GQA decoder (Mistral / Qwen2 style): [RMSNorm -> GQA
attention with RoPE (q/k/v biases where the configuration has them) ->
RMSNorm -> SwiGLU MLP] x L, a final RMSNorm and the head. Its plain
reference is ``reference/dense.py``.

Weights (``harness.weights``, the ``x @ W`` convention, so a matrix is
(in, out)): per layer one buffer in the served dtype holding ``q`` (D,
Hq*hd), ``k``, ``v`` (D, Hkv*hd), ``o`` (Hq*hd, D), ``gate``, ``up`` (D,
F), ``down`` (F, D) and, with ``attention_bias``, ``bq``, ``bk``, ``bv``;
then its two norm weights ``ln1``, ``ln2`` in float32.

Model FLOPs (the ``mfu`` yardstick, the same work whatever implements
it): a matrix product of the non-embedding weights is 2 FLOPs a weight a
token; causal attention is 4 * hd FLOPs a head for each (query, visible
key) pair (q.k, then p.v); the head is 2 * D * V at each position whose
token is sampled. A prompt of n tokens is n rows of products, n(n+1)/2
pairs a head and layer, and one head position; a decoded token at cache
length c (it sees c + 1 keys) is one row, c + 1 pairs, one head
position. Padding and logits that nobody samples are not work.

Attention calls' bytes read each input once and write the output once. A
prefill call that launched S rows (causal over all of them, padding
included): q, k, v, out. A decode call over all slots: each slot's q and
output, and each active slot's keys and values of its window and its
block-table entries.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

import torch

from harness import weights as W
from harness.flops import BF16, INT32


def dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    Hq = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or D // Hq
    return {"L": cfg["num_hidden_layers"], "D": D, "Hq": Hq,
            "Hkv": cfg["num_key_value_heads"], "hd": hd,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "bias": bool(cfg.get("attention_bias", False)),
            "tied": bool(cfg.get("tie_word_embeddings", False)),
            "theta": float(cfg["rope_theta"]),
            "eps": float(cfg["rms_norm_eps"])}


def layer_leaves(d: dict, li: int) -> List[Tuple[str, tuple, float]]:
    """Every layer alike: each matrix normal with standard deviation
    1 / sqrt(fan in), each bias ``harness.weights.BIAS_STD``."""
    D, Hq, Hkv, hd, F = d["D"], d["Hq"], d["Hkv"], d["hd"], d["F"]
    out = [("q", (D, Hq * hd), 1 / math.sqrt(D)),
           ("k", (D, Hkv * hd), 1 / math.sqrt(D)),
           ("v", (D, Hkv * hd), 1 / math.sqrt(D)),
           ("o", (Hq * hd, D), 1 / math.sqrt(Hq * hd)),
           ("gate", (D, F), 1 / math.sqrt(D)),
           ("up", (D, F), 1 / math.sqrt(D)),
           ("down", (F, D), 1 / math.sqrt(F))]
    if d["bias"]:
        out += [("bq", (Hq * hd,), W.BIAS_STD),
                ("bk", (Hkv * hd,), W.BIAS_STD),
                ("bv", (Hkv * hd,), W.BIAS_STD)]
    return out


def layer_norms(d: dict, li: int) -> List[Tuple[str, int]]:
    return [("ln1", d["D"]), ("ln2", d["D"])]


def model_config(cfg: dict):
    """The port's ModelConfig for a configuration file's keys."""
    from repro_torch.models.config import ModelConfig

    d = dims(cfg)
    return ModelConfig(
        name=cfg["name"], family=cfg["family"], n_layers=d["L"],
        d_model=d["D"], n_heads=d["Hq"], n_kv_heads=d["Hkv"], d_ff=d["F"],
        vocab=d["V"], head_dim=d["hd"], qkv_bias=d["bias"],
        rope_theta=d["theta"], tie_embeddings=d["tied"], norm_eps=d["eps"],
        dtype=cfg["torch_dtype"])


def make_params(cfg: dict, mcfg, seed: int, device) -> dict:
    """The benchmark's weights in the port's layout: matrices as they are,
    norm weights w as the port's scales w - 1, the vocabulary padded to
    ``padded_vocab`` with zero rows or columns."""
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
        attn = {"wq": w["q"], "wk": w["k"], "wv": w["v"], "wo": w["o"]}
        if d["bias"]:
            attn.update(bq=w["bq"], bk=w["bk"], bv=w["bv"])
        params["blocks"].append({
            "ln1": w["ln1"] - 1.0, "attn": attn, "ln2": w["ln2"] - 1.0,
            "mlp": {"wg": w["gate"], "wi": w["up"], "wo": w["down"]}})
    params["final_ln"] = W.final_norm(cfg, seed, device) - 1.0
    return params


def layer_weights(d: dict) -> int:
    """Non-embedding matrix weights of one layer."""
    D, Hq, Hkv, hd, F = d["D"], d["Hq"], d["Hkv"], d["hd"], d["F"]
    return D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D + 3 * D * F


def prompt_flops(d: dict, n: int) -> float:
    return (2.0 * layer_weights(d) * d["L"] * n
            + 4.0 * d["hd"] * d["Hq"] * d["L"] * n * (n + 1) / 2
            + 2.0 * d["D"] * d["V"])


def decode_flops(d: dict, cache_len: int, tokens: int) -> float:
    pairs = tokens * (cache_len + 1) + tokens * (tokens - 1) / 2
    return (tokens * (2.0 * layer_weights(d) * d["L"] + 2.0 * d["D"] * d["V"])
            + 4.0 * d["hd"] * d["Hq"] * d["L"] * pairs)


def prefill_attention(d: dict, rows: int) -> Tuple[float, float]:
    Hq, Hkv, hd = d["Hq"], d["Hkv"], d["hd"]
    flops = 4.0 * hd * Hq * rows * (rows + 1) / 2
    nbytes = BF16 * rows * hd * (2 * Hq + 2 * Hkv)
    return flops * d["L"], float(nbytes) * d["L"]


def decode_attention(d: dict, windows: Iterable[int], slots: int,
                     block_size: int) -> Tuple[float, float]:
    Hq, Hkv, hd = d["Hq"], d["Hkv"], d["hd"]
    flops, nbytes = 0.0, float(BF16 * slots * 2 * Hq * hd + INT32 * slots)
    for w in windows:
        flops += 4.0 * hd * Hq * w
        nbytes += BF16 * 2 * w * Hkv * hd + INT32 * -(-w // block_size)
    return flops * d["L"], nbytes * d["L"]
