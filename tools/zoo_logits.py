#!/usr/bin/env python3
"""Where the kernel and plain paths of a deep bf16 model part, on one GPU.

    python3 tools/zoo_logits.py [--arch zamba2-7b] [--depths 1,6,24,81]

Builds the arch at full width on the card from seed 0 (random bf16
weights, as ``chip_smoke.py`` does) and one 256-token prompt (the prompt
of ``chip_smoke._logit_parity``), then compares last-position logits of
``forward`` at each depth in ``--depths`` (the first layers of the same
weights) under five routes, each error the largest |difference| over the
largest |logit| of the second side:

  auto       every kernel (the served path);
  ref        every plain version (sequential ``ssd_ref``, ``attention_ref``);
  attn-only  the attention kernels, the plain SSD scan;
  ssd-only   ``ssd_chunked``, the plain attention;
  f32        the plain versions on float32 copies of the same weights, and
             float32 activations: the function both bf16 routes round.

So the table says whether the two bf16 routes part because a kernel is
off (one route far from f32, the other near) or because both round to
bf16 between layers and the rounding compounds with depth (both about
equally far from f32). Needs a CUDA device; prints the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ROUTES = {"auto": dict(attn_impl="auto", decode_impl="auto"),
          "ref": dict(attn_impl="ref", decode_impl="ref"),
          # attn_impl drives both the prefill attention and mamba's SSD
          # route; the routes that split them patch ops.ssd below.
          "attn-only": dict(attn_impl="auto", decode_impl="auto"),
          "ssd-only": dict(attn_impl="ref", decode_impl="ref")}


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init_lm

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--depths", default="1,6,12,24,48,81")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("zoo_logits: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS[args.arch]
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (1, 256)),
                           dtype=torch.int32, device="cuda")
    real_ssd = ops.ssd

    def ssd_as(impl):
        return lambda *a, **k: real_ssd(*a, **dict(k, impl=impl))

    def logits(depth, route, p, c):
        sub = dict(p, blocks=p["blocks"][:depth])
        c = dataclasses.replace(c, n_layers=depth, **ROUTES.get(route, {}))
        if route == "attn-only":
            ops.ssd = ssd_as("ref")
        elif route == "ssd-only":
            ops.ssd = ssd_as("auto")
        try:
            with torch.inference_mode():
                return forward(sub, c, toks)[0][0, -1].float()
        finally:
            ops.ssd = real_ssd

    f32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _to(params, torch.float32)
    err = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
    print(f"{cfg.name}: share of max |logit| by which the last-position "
          "logits of two routes differ")
    print(f"{'depth':>5s} {'auto-ref':>9s} {'auto-f32':>9s} {'ref-f32':>9s}"
          f" {'attn-ref':>9s} {'ssd-ref':>9s} {'argmax equal'}")
    for depth in (int(d) for d in args.depths.split(",")):
        depth = min(depth, cfg.n_layers)
        got = {r: logits(depth, r, params, cfg) for r in ROUTES}
        got["f32"] = logits(depth, "ref", p32, f32)
        top = {r: int(v.argmax()) for r, v in got.items()}
        print(f"{depth:5d} {err(got['auto'], got['ref']):9.4f} "
              f"{err(got['auto'], got['f32']):9.4f} "
              f"{err(got['ref'], got['f32']):9.4f} "
              f"{err(got['attn-only'], got['ref']):9.4f} "
              f"{err(got['ssd-only'], got['ref']):9.4f} "
              f"{len(set(top.values())) == 1} {top}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
