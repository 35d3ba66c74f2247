"""The system under test: the port's serving engine, built from a
configuration file and the benchmark's weights through the layout the
file names. With the layouts' ``model_config`` and ``make_params``, the
only code of the harness that imports the program."""
from __future__ import annotations

from layouts import layout_of
from repro_torch.obs import Tracer
from repro_torch.serve.engine import Engine, Request

__all__ = ["Request", "model_config", "make_params", "make_engine",
           "make_tracer"]


def model_config(cfg: dict):
    """The program's ModelConfig for a configuration file."""
    return layout_of(cfg).model_config(cfg)


def make_params(cfg: dict, mcfg, seed: int, device) -> dict:
    """The benchmark's weights in the program's parameter layout."""
    return layout_of(cfg).make_params(cfg, mcfg, seed, device)


def make_engine(mcfg, params, engine: dict, device, tracer=None) -> Engine:
    return Engine(mcfg, params, max_slots=engine["max_slots"],
                  max_seq=engine["max_seq"], pad_len=engine["pad_len"],
                  steps_per_sync=engine["steps_per_sync"], paged=True,
                  block_size=engine["block_size"], tracer=tracer,
                  device=device)


def make_tracer():
    return Tracer()
