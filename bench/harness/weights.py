"""The benchmark's weights, made on the device from the run's seed.

Both sides read these: the harness hands them to the system under test
(the layout's ``make_params`` lays them out as the program wants them),
and the reference regenerates them, layer by layer, from the same seed
after the program's state is freed. Nothing here imports the program.

What a layer holds is its layout's (``bench/layouts/<layout>.py``, named
by the configuration): one call for all of the layer's matrices and
biases in the served dtype (the configuration's ``torch_dtype``), in the
order of the layout's ``layer_leaves``, then one for its norm weights in
float32 (``layer_norms``, the multipliers themselves), both from the
layer's own stream. Besides: ``embed`` (vocab, D) and, unless
``tie_word_embeddings``, ``head`` (D, vocab), each one call, and
``final_norm`` (D,) float32.

A layout gives each matrix a standard deviation (1/sqrt(fan in) as a
rule); the embedding and the biases take 0.02 (the configurations'
``initializer_range``), a norm weight 1 + 0.1 * normal: biases and norm
weights are not zero, so that the comparison sees them. Larger biases
are a constant added to every position's values: at 16k-token contexts,
where random attention averages over most of the prompt, they make every
position's logits alike and every served token the same one, and the
comparison then has no near ties to read.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from layouts import layout_of

EMBED_STD = 0.02
BIAS_STD = 0.02
NORM_STD = 0.1


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
    of one float32 buffer of norm weights, both from the layer's stream."""
    lay = layout_of(cfg)
    d = lay.dims(cfg)
    leaves = lay.layer_leaves(d, li)
    norms = lay.layer_norms(d, li)
    g = _generator(seed, 1000 + li, device)
    buf = _normal(sum(math.prod(s) for _, s, _ in leaves), served_dtype(cfg),
                  device, g)
    out, off = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape).mul_(std)
        off += n
    nbuf = _normal(sum(n for _, n in norms), torch.float32, device, g,
                   NORM_STD, 1.0)
    off = 0
    for name, n in norms:
        out[name] = nbuf[off:off + n]
        off += n
    return out


def embed(cfg: dict, seed: int, device):
    d = layout_of(cfg).dims(cfg)
    return _normal(d["V"] * d["D"], served_dtype(cfg), device,
                   _generator(seed, 1, device), EMBED_STD).view(d["V"], d["D"])


def head(cfg: dict, seed: int, device):
    """(D, vocab); the embedding's transpose when the two are tied."""
    d = layout_of(cfg).dims(cfg)
    if d["tied"]:
        return embed(cfg, seed, device).T
    return _normal(d["D"] * d["V"], served_dtype(cfg), device,
                   _generator(seed, 2, device),
                   1 / math.sqrt(d["D"])).view(d["D"], d["V"])


def final_norm(cfg: dict, seed: int, device):
    return _normal(layout_of(cfg).dims(cfg)["D"], torch.float32, device,
                   _generator(seed, 3, device), NORM_STD, 1.0)
