"""Roofline terms of a traced step, against the NVIDIA H100 SXM's peaks.
The counterpart of ``repro.analysis.roofline``, with the same fields,
``finalize``, ``row()`` keys and ``model_flops``:

  compute    = FLOPs (per device) / PEAK_FLOPS
  memory     = bytes (per device) / HBM_BW
  collective = collective operand bytes (per device) / LINK_BW

The trace of a language-model step (``analysis.cost``) sees the whole
step on the global batch, so the dry run divides its FLOPs and bytes by
the number of chips: the spec's "X / (chips * BW)" with global X is the
per-device form used here. A GLB superstep is traced on one place, which
is per device already. MODEL_FLOPS = 6*N*D (6*N_active*D for MoE) flags
remat and redundant work through the useful-compute ratio.

Every term is reckoned from the data sheet's peaks, never measured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM data sheet, per card: dense bf16 on the tensor cores,
# HBM3, and NVLink 4 (900 GB/s both ways, so 450 GB/s a direction).
PEAK_FLOPS = 989e12      # bf16, dense
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 450e9          # bytes/s a direction
HBM_BYTES = 80e9         # device memory, "80 GB"
# The other types' peaks, for a kernel's bound (chip_smoke.py): f32 off
# the tensor cores; the sheet gives no int32 rate, so int32 counts one
# operation per CUDA-core lane per clock (132 SMs x 128 lanes x 1.98 GHz),
# the rate behind the f32 figure, which counts an FMA as two.
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12,
                       "int32": 33.5e12}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    bytes_accessed: float        # per-device bytes
    collective: Dict[str, int]   # per-device collective operand bytes
    chips: int
    model_flops: float           # 6*N(active)*tokens, GLOBAL
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0    # MODEL_FLOPS / (FLOPs * chips)
    roofline_frac: float = 0.0   # useful work / (dominant time * peak)

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops / PEAK_FLOPS
        self.t_memory = self.bytes_accessed / HBM_BW
        self.t_collective = self.collective.get("total", 0) / LINK_BW
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops * self.chips
        self.useful_ratio = (self.model_flops / total) if total else 0.0
        t_dom = max(terms.values())
        if t_dom > 0:
            # fraction of the compute roofline the step achieves if the
            # dominant term fully serializes (upper-bound-style estimate)
            self.roofline_frac = (
                self.model_flops / self.chips / PEAK_FLOPS
            ) / t_dom
        return self

    def row(self) -> Dict[str, object]:
        return {
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bottleneck": self.bottleneck,
            "useful_ratio": round(self.useful_ratio, 4),
            "roofline_frac": round(self.roofline_frac, 4),
            "hlo_gflops_per_dev": round(self.flops / 1e9, 2),
            "hlo_gbytes_per_dev": round(self.bytes_accessed / 1e9, 3),
            "coll_mbytes_per_dev": round(
                self.collective.get("total", 0) / 1e6, 3
            ),
        }


def model_flops(cfg, shape) -> float:
    """6*N*D with D = tokens this step; MoE uses active params. Training
    counts fwd+bwd (the 6x); prefill/decode use the 2x forward-only factor."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: 1 token/seq


def build(cost: Dict[str, float], collective: Dict[str, int], chips: int,
          mflops: float) -> Roofline:
    """The roofline of a step from its trace, in place of JAX's compiled
    executable: ``cost`` holds the per-device ``flops`` and ``bytes``
    (``analysis.cost.trace_cost``'s, divided by ``chips`` for a trace of
    the global step), ``collective`` the per-device collective bytes
    (``analysis.comm``)."""
    return Roofline(
        flops=float(cost.get("flops", 0.0)),
        bytes_accessed=float(cost.get("bytes", 0.0)),
        collective=collective,
        chips=chips,
        model_flops=mflops,
    ).finalize()
