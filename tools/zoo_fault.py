#!/usr/bin/env python3
"""Kernel faults that the zamba2-7b check of ``chip_smoke.py`` must catch,
on one GPU.

    python3 tools/zoo_fault.py

Makes zamba2-7b at full width on the card as the zoo phase of
``chip_smoke.py`` does (random bf16 weights from seed 0), then runs that
phase's check, ``chip_smoke._mixer_parity``, once on the kernels as built
(it must pass) and once under each fault below. A fault is
planted at run time by wrapping ``kernels.ops``: the kernel still runs,
and its output is spoilt or it is called the way a faulty kernel would
behave; no source changes. ``_mixer_parity`` calls each kernel twice a
layer, once for its check and once on the whole kernel path, so a fault
"in layer L" spoils both of that layer's calls.

  ssd-zero       ssd_chunked's output zeroed in Mamba2 layer 40;
  ssd-no-carry   in layer 40, the scan restarted from a zero state at
                 every 64-token chunk: the state carried across chunks
                 dropped. Measured, not required to fail: at init_lm's
                 A = -1 and dt = softplus(x . w_dt) the state decays by
                 about e^-0.7 a token, so the carry reaches only the first
                 few tokens of a chunk, and at smoke widths its mark on
                 the mixer's output stays under the limit. The card test
                 of ssd_chunked (tests/test_torch_cuda.py, dt scaled by
                 0.1) holds the carry at every width;
  attn-no-mask   flash_attention without its causal mask at the shared
                 block's 7th application (after layer 41);
  attn-one-head  flash_attention's output for query head 0 zeroed at the
                 7th application.

Prints the card's name and power limit first, then each run's check line
and whether the check passed or failed. Exits 1 if the run as built fails
or a fault of ``MUST_FAIL`` passes.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FAULTS = ("ssd-zero", "ssd-no-carry", "attn-no-mask", "attn-one-head")
MUST_FAIL = ("ssd-zero", "attn-no-mask", "attn-one-head")
LAYER = 40      # the Mamba2 layer whose SSD calls are spoilt
APPLICATION = 6  # the shared block's application whose attention is


def faulty(fault, real_ssd, real_attn):
    """(ssd, attention) in the signatures of ``kernels.ops``, with
    ``fault`` planted in the kernel route (impl ``auto``) only."""
    import torch

    calls = {"ssd": 0, "attn": 0}

    def hit(kind, at):
        n = calls[kind]
        calls[kind] += 1
        return fault.split("-")[0] == kind and n // 2 == at

    def ssd(x, dt, A, B, C, *, chunk=64, impl="auto"):
        if impl != "auto" or not hit("ssd", LAYER):
            return real_ssd(x, dt, A, B, C, chunk=chunk, impl=impl)
        if fault == "ssd-zero":
            y, h = real_ssd(x, dt, A, B, C, chunk=chunk, impl=impl)
            return torch.zeros_like(y), h
        parts = [real_ssd(*(t[:, s:s + chunk].contiguous()
                            for t in (x, dt)), A,
                          *(t[:, s:s + chunk].contiguous() for t in (B, C)),
                          chunk=chunk, impl=impl)
                 for s in range(0, x.shape[1], chunk)]
        return torch.cat([y for y, _ in parts], 1), parts[-1][1]

    def attention(q, k, v, *, causal=True, impl="auto", **kw):
        if (impl != "auto" or kw.get("lengths") is not None
                or not hit("attn", APPLICATION)):
            return real_attn(q, k, v, causal=causal, impl=impl, **kw)
        if fault == "attn-no-mask":
            return real_attn(q, k, v, causal=False, impl=impl, **kw)
        o = real_attn(q, k, v, causal=causal, impl=impl, **kw).clone()
        o[:, :, 0] = 0                       # (B, S, Hq, D): head 0
        return o

    return ssd, attention


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("zoo_fault: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.build_all()
    cfg, params = cs._zoo_weights(cs.ZOO_HYBRID)
    return check(cfg, params)


def check(cfg, params) -> int:
    """The check as built, then under each fault; 0 if it passed the
    first and failed every fault of MUST_FAIL."""
    import chip_smoke as cs
    from repro_torch.kernels import ops

    real = (ops.ssd, ops.attention)
    bad = 0
    for fault in ("as built",) + FAULTS:
        if fault in FAULTS:
            ops.ssd, ops.attention = faulty(fault, *real)
        try:
            cs._mixer_parity(cfg, params)
            passed = True
        except SystemExit as e:
            print(e, flush=True)
            passed = False
        finally:
            ops.ssd, ops.attention = real
        must = ("pass" if fault == "as built" else
                "fail" if fault in MUST_FAIL else None)
        right = must is None or passed == (must == "pass")
        bad += not right
        verdict = (f"must {must}: {'ok' if right else 'WRONG'}" if must
                   else "measured only")
        print(f"[fault] {fault}: the check {'passed' if passed else 'failed'}"
              f" ({verdict})", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
