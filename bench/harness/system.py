"""The system under test: the port's serving engine, built from a
configuration file and the benchmark's weights. The only module of the
harness that imports the program."""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.obs import Tracer
from repro_torch.serve.engine import Engine, Request

from . import weights as W

__all__ = ["Request", "model_config", "make_params", "make_engine",
           "make_tracer"]


def model_config(cfg: dict) -> ModelConfig:
    """The port's ModelConfig for a configuration file's keys."""
    d = W.dims(cfg)
    return ModelConfig(
        name=cfg["name"], family=cfg["family"], n_layers=d["L"],
        d_model=d["D"], n_heads=d["Hq"], n_kv_heads=d["Hkv"], d_ff=d["F"],
        vocab=d["V"], head_dim=d["hd"], qkv_bias=d["bias"],
        rope_theta=d["theta"], tie_embeddings=d["tied"], norm_eps=d["eps"],
        dtype=cfg["torch_dtype"])


def make_params(cfg: dict, mcfg: ModelConfig, seed: int, device) -> dict:
    """The benchmark's weights (``harness.weights``) in the port's layout:
    matrices as they are, norm weights w as the port's scales w - 1, the
    vocabulary padded to ``padded_vocab`` with zero rows or columns."""
    d = W.dims(cfg)
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


def make_engine(mcfg: ModelConfig, params, engine: dict, device,
                tracer=None) -> Engine:
    return Engine(mcfg, params, max_slots=engine["max_slots"],
                  max_seq=engine["max_seq"], pad_len=engine["pad_len"],
                  steps_per_sync=engine["steps_per_sync"], paged=True,
                  block_size=engine["block_size"], tracer=tracer,
                  device=device)


def make_tracer():
    return Tracer()


def bucket(engine: dict, prompt_len: int) -> int:
    """The padded length a fresh admission prefills (the engine's rule:
    prompts are cut to ``pad_len`` and padded to a multiple of it)."""
    n = min(prompt_len, engine["pad_len"])
    return min(math.ceil(n / engine["pad_len"]) * engine["pad_len"],
               engine["max_seq"])
