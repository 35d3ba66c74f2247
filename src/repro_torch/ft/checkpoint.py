"""Checkpointing, in the layout of ``repro.ft.checkpoint`` (one directory
per step), so that either package reads what the other wrote::

    <dir>/step_000000123/
        manifest.json        # step, sorted keys, extra (data state, ...)
        arrays/<flat_key with / as __>.npy

- ``save`` snapshots the tree to host numpy arrays synchronously and
  writes the files, optionally on a background thread (``async_``) so
  that the card keeps stepping; it writes ``step_*.tmp`` first and renames
  it, so a crash mid-write leaves no half checkpoint behind.
- ``restore`` returns the tree of numpy arrays; the caller places them
  (the training CLI converts its layout with ``weights.params_from_jax``).
- A ``keep`` window garbage-collects old steps.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _host(v) -> np.ndarray:
    """A leaf as a host numpy copy (bfloat16, which numpy lacks, as
    float32): the training loop updates its tensors in place, so an async
    save must not share their memory."""
    if torch.is_tensor(v):
        v = v.detach().to("cpu", copy=True)
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.array(v)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Write a checkpoint; with ``async_`` the file I/O runs on a
    background thread (returned, to be joined) after a synchronous
    snapshot to host memory."""
    flat = {k: _host(v) for k, v in _flatten(tree).items()}

    def _write():
        d = os.path.join(ckpt_dir, f"step_{step:09d}")
        tmp = d + ".tmp"
        os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
        for k, v in flat.items():
            np.save(os.path.join(tmp, "arrays",
                                 k.replace("/", "__") + ".npy"), v)
        manifest = {"step": step, "keys": sorted(flat),
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None):
    """Load a checkpoint (the latest when ``step`` is None). Returns
    (tree of numpy arrays, manifest extra, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {k: np.load(os.path.join(d, "arrays",
                                    k.replace("/", "__") + ".npy"))
            for k in manifest["keys"]}
    return _unflatten(flat), manifest.get("extra", {}), step
