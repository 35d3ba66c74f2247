"""End-to-end training driver, flag for flag ``repro.launch.train``, plus
``--device`` (``cuda`` unless asked for ``cpu``; CUDA without a card
raises).

  - presets (tiny / 100m / full) scaled from any --arch config
  - the deterministic, checkpointable data pipeline
  - periodic (optionally async) checkpoints in the JAX package's layout
    (parameters and AdamW moments stacked per layer, ``weights.
    params_to_jax``), so either package resumes the other's; --resume
    restores parameters, optimizer state and data state
  - --fail-at-step N simulates a node failure (the FT drill: a restart
    with --resume must reach the same final state)
  - GLB-MoE expert rebalancing every --rebalance-every steps (moe archs)

Float32 master weights; the layers compute in ``cfg.dtype`` (bf16 at full
width), through the kernels on the card.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --preset tiny --steps 60 --device cpu --ckpt-dir /tmp/ckpt \\
      --ckpt-every 20
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataState, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models.config import ModelConfig
from repro_torch.models.glb_moe import glb_expert_rebalance
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.trainer import init_train_state, make_train_step
from repro_torch.weights import params_from_jax, params_to_jax


def preset_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    if preset == "full":
        return cfg
    if preset == "tiny":
        return dataclasses.replace(cfg.smoke(), name=cfg.name + "-tiny",
                                   dtype="float32")
    if preset == "100m":
        return dataclasses.replace(
            cfg,
            name=cfg.name + "-100m",
            n_layers=12,
            d_model=768,
            n_heads=12 if cfg.n_heads else 0,
            n_kv_heads=4 if cfg.n_kv_heads else 0,
            head_dim=64 if cfg.n_heads else 0,
            d_ff=2048 if cfg.d_ff else 0,
            vocab=32000,
            n_experts=min(cfg.n_experts, 8),
            top_k=min(cfg.top_k, 2),
            remat="none",
            dtype="float32",
        )
    raise ValueError(preset)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _restore(ckpt_dir: str, cfg: ModelConfig, device):
    tree, extra, step = ckpt.restore(ckpt_dir)
    f32 = dict(cfg=cfg, device=device, dtype=torch.float32)
    params = params_from_jax(tree["params"], **f32)
    opt = {"m": params_from_jax(tree["opt"]["m"], **f32),
           "v": params_from_jax(tree["opt"]["v"], **f32),
           "step": torch.as_tensor(np.asarray(tree["opt"]["step"]),
                                   dtype=torch.int32, device=device)}
    return params, opt, extra, step


def _host_tree(params, opt):
    """The checkpoint tree in the JAX package's layout."""
    return {"params": params_to_jax(params),
            "opt": {"m": params_to_jax(opt["m"]),
                    "v": params_to_jax(opt["v"]),
                    "step": np.asarray(opt["step"].item(), np.int32)}}


def train(argv=None, on_step: Optional[Callable] = None):
    """Run the CLI on ``argv``. ``on_step(step, metrics)``, if given, is
    called after each step (step counted from 1) with that step's
    metrics. Returns (params, opt, history)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = preset_config(get_config(args.arch), args.preset)
    oc = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                   total_steps=args.steps)
    data = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)

    start_step = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        params, opt, extra, step = _restore(args.ckpt_dir, cfg, device)
        data.state = DataState.from_dict(extra["data"])
        start_step = step
        print(f"[train] resumed from step {step}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params, opt = init_train_state(cfg, gen, device)

    step_fn = make_train_step(cfg, oc)
    history = []
    expert_perm = (np.arange(cfg.n_experts) if cfg.family == "moe"
                   else None)
    pending = None

    t0 = time.time()
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            raise RuntimeError(
                f"[train] simulated node failure at step {step}")
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.next_batch().items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if on_step is not None:
            on_step(step + 1, metrics)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics["loss"])
            history.append({"step": step + 1, "loss": loss})
            print(f"[train] step {step+1:5d} loss {loss:.4f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if (cfg.family == "moe" and args.rebalance_every
                and (step + 1) % args.rebalance_every == 0):
            counts = metrics["expert_counts"].cpu().numpy()
            res = glb_expert_rebalance(counts, expert_perm, n_ranks=4)
            expert_perm = res.perm
            print(f"[train] GLB-MoE rebalance: load std "
                  f"{res.loads_before.std():.1f} -> "
                  f"{res.loads_after.std():.1f} ({len(res.swaps)} swaps)")
        if (args.ckpt_dir and args.ckpt_every
                and (step + 1) % args.ckpt_every == 0):
            if pending is not None:
                pending.join()
            pending = ckpt.save(
                args.ckpt_dir, step + 1, _host_tree(params, opt),
                extra={"data": data.state.to_dict(), "arch": cfg.name,
                       "seed": args.seed},
                async_=args.ckpt_async)
    if pending is not None:
        pending.join()
    if args.metrics_out:
        fingerprint = float(sum(float(torch.sum(torch.abs(x.detach().float())))
                                for x in tree_leaves(params)))
        with open(args.metrics_out, "w") as f:
            json.dump({"history": history, "fingerprint": fingerprint}, f)
    return params, opt, history


if __name__ == "__main__":
    train()
