"""The benchmark's weights, made on the device from the run's seed.

Both sides read these: the harness hands them to the system under test
(``harness.system`` lays them out as the program wants them), and the
reference regenerates them, layer by layer, from the same seed after the
program's state is freed. Nothing here imports the program.

Layout (the configuration's own keys, the ``x @ W`` convention, so a
matrix is (in, out)):

* ``embed`` (vocab, D) and, unless ``tie_word_embeddings``, ``head``
  (D, vocab), each one call;
* per layer, one call for all of its matrices and biases in the served
  dtype (the configuration's ``torch_dtype``) (``q`` (D, Hq*hd), ``k``, ``v`` (D, Hkv*hd), ``o`` (Hq*hd, D),
  ``gate``, ``up`` (D, F), ``down`` (F, D), and with ``attention_bias``
  ``bq``, ``bk``, ``bv``), and one for its two norm weights in float32
  (``ln1``, ``ln2``, the multipliers themselves);
* ``final_norm`` (D,) float32.

Each matrix is normal with standard deviation 1/sqrt(fan in), the
embedding and the biases 0.02 (the configurations' ``initializer_range``),
a norm weight 1 + 0.1 * normal: biases and norm weights are not zero, so
that the comparison sees them. Larger biases are a constant added to
every position's values: at 16k-token contexts, where random attention
averages over most of the prompt, they make every position's logits
alike and every served token the same one, and the comparison then has
no near ties to read.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

EMBED_STD = 0.02
BIAS_STD = 0.02
NORM_STD = 0.1


def dims(cfg: dict) -> dict:
    """The sizes every part of the benchmark reads from a configuration
    file's keys."""
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


def layer_leaves(d: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of one layer's matrices and biases, in the order
    they sit in the layer's buffer."""
    D, Hq, Hkv, hd, F = d["D"], d["Hq"], d["Hkv"], d["hd"], d["F"]
    out = [("q", (D, Hq * hd), 1 / math.sqrt(D)),
           ("k", (D, Hkv * hd), 1 / math.sqrt(D)),
           ("v", (D, Hkv * hd), 1 / math.sqrt(D)),
           ("o", (Hq * hd, D), 1 / math.sqrt(Hq * hd)),
           ("gate", (D, F), 1 / math.sqrt(D)),
           ("up", (D, F), 1 / math.sqrt(D)),
           ("down", (F, D), 1 / math.sqrt(F))]
    if d["bias"]:
        out += [("bq", (Hq * hd,), BIAS_STD), ("bk", (Hkv * hd,), BIAS_STD),
                ("bv", (Hkv * hd,), BIAS_STD)]
    return out


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's seed (any
    whole number, larger than 64 bits too)."""
    state = np.random.SeedSequence([int(seed) % (1 << 128), 77, stream])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]) >> 1)
    return g


def _normal(n: int, dtype, device, g, std: float = 1.0, mean: float = 0.0):
    t = torch.empty(n, dtype=dtype, device=device)
    return t.normal_(mean, std, generator=g)


def served_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["torch_dtype"])


def layer(cfg: dict, seed: int, li: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights: views of one buffer in the served dtype and
    the norm weights in float32."""
    d = dims(cfg)
    dtype = served_dtype(cfg)
    leaves = layer_leaves(d)
    g = _generator(seed, 1000 + li, device)
    buf = _normal(sum(math.prod(s) for _, s, _ in leaves), dtype, device, g)
    out, off = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape).mul_(std)
        off += n
    norms = _normal(2 * d["D"], torch.float32, device, g, NORM_STD, 1.0)
    out["ln1"], out["ln2"] = norms[:d["D"]], norms[d["D"]:]
    return out


def embed(cfg: dict, seed: int, device):
    d = dims(cfg)
    return _normal(d["V"] * d["D"], served_dtype(cfg), device,
                   _generator(seed, 1, device), EMBED_STD).view(d["V"], d["D"])


def head(cfg: dict, seed: int, device):
    """(D, vocab); the embedding's transpose when the two are tied."""
    d = dims(cfg)
    if d["tied"]:
        return embed(cfg, seed, device).T
    return _normal(d["D"] * d["V"], served_dtype(cfg), device,
                   _generator(seed, 2, device),
                   1 / math.sqrt(d["D"])).view(d["D"], d["V"])


def final_norm(cfg: dict, seed: int, device):
    return _normal(dims(cfg)["D"], torch.float32, device,
                   _generator(seed, 3, device), NORM_STD, 1.0)
