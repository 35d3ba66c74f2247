"""Model layouts: everything in the benchmark that knows how a model is
built. A configuration file names its layout under ``"layout"``, and
``load_layout(name)`` loads ``bench/layouts/<name>.py``; its plain
reference is ``bench/reference/<name>.py``, which exposes
``served_gaps(cfg, seed, served, device, control)``. The harness,
the weights' streams and the step arithmetic are generic: a model of a
new layout comes as these two files, its configuration, its limits and
its entries in ``BENCHMARK.json``.

A layout module defines:

* ``dims(cfg) -> dict``: the sizes the layout reads from a configuration
  file's keys. The generic code reads ``L`` (layers), ``D`` (hidden
  size), ``V`` (vocabulary) and ``tied`` (the head is the embedding's
  transpose); the rest is the layout's own.
* ``layer_leaves(d, li) -> [(name, shape, std)]``: layer ``li``'s
  matrices and biases in the served dtype, in the order they sit in the
  layer's buffer (``harness.weights.layer`` draws them from one stream).
* ``layer_norms(d, li) -> [(name, size)]``: layer ``li``'s norm weights
  in float32, drawn after the leaves from the same stream.
* ``model_config(cfg)``: the program's ``ModelConfig`` for the file.
* ``make_params(cfg, mcfg, seed, device)``: the benchmark's weights
  (``harness.weights``) in the program's parameter layout.
* ``prompt_flops(d, n)``: model FLOPs of prefilling a prompt of ``n``
  tokens and sampling its first token.
* ``decode_flops(d, cache_len, tokens)``: model FLOPs of ``tokens`` decode
  steps of one sequence whose cache holds ``cache_len`` tokens.
* ``prefill_attention(d, rows)``: (FLOPs, bytes) of the attention calls
  of one prefill that launched ``rows`` rows, over all layers.
* ``decode_attention(d, windows, slots, block_size)``: (FLOPs, bytes) of
  one decode iteration's attention calls over all layers; ``windows``
  are the keys each active slot sees.

Only ``model_config`` and ``make_params`` may import the program, and
only inside their bodies: the reference loads the layout too, and loads
nothing of the program.
"""
from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

LAYOUTS = Path(__file__).resolve().parent
INTERFACE = ("dims", "layer_leaves", "layer_norms", "model_config",
             "make_params", "prompt_flops", "decode_flops",
             "prefill_attention", "decode_attention")
NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@functools.lru_cache(maxsize=None)
def load_layout(name: str, folder: Path = LAYOUTS):
    """The layout module ``<folder>/<name>.py``, loaded once."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"layout name {name!r} is not a module name")
    path = Path(folder) / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no layout {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"bench_layout_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"layout {name!r} ({path}) lacks "
                         f"{', '.join(missing)}")
    return mod


def layout_of(cfg: dict):
    """The layout that a configuration file names. There is no default:
    a file without ``"layout"`` is refused."""
    if "layout" not in cfg:
        raise ValueError(f"configuration {cfg.get('name')!r} names no "
                         f"layout: add \"layout\": \"<name>\" for "
                         f"bench/layouts/<name>.py")
    return load_layout(cfg["layout"])
