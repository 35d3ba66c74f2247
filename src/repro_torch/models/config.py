"""Model + shape configuration for the assigned architectures."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 0           # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- hybrid (Zamba2): one shared attention block every `attn_every`
    attn_every: int = 0
    # --- modality frontends (stubs per spec: precomputed embeddings)
    n_codebooks: int = 0        # musicgen EnCodec streams
    mrope: bool = False         # qwen2-vl multimodal rotary
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- numerics / perf knobs
    dtype: str = "bfloat16"     # compute/activation dtype
    remat: str = "full"         # none | dots | full
    attn_impl: str = "auto"     # kernels.ops.attention impl (prefill/train)
    decode_impl: str = "auto"   # Sq==1 cached-decode impl (flash_decode)
    scan_layers: bool = True    # lax.scan over stacked layer params
    moe_impl: str = "auto"      # auto | global | ep (shard_map EP dispatch)

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def padded_vocab(self) -> int:
        # pad so TP vocab sharding divides for any model-axis <= 256, and
        # the MXU lane dim stays 128-aligned
        return int(math.ceil(self.vocab / 256) * 256)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        # long_500k decode only runs for bounded-state archs (spec).
        return self.family in ("ssm", "hybrid")

    # ------------------------------------------------- parameter counting
    def param_count(self) -> int:
        """Total parameters (N for the roofline's 6·N·D)."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        D = self.d_model
        n = 0
        # embeddings (+ output head unless tied)
        emb = self.padded_vocab * D
        n += emb * (self.n_codebooks or 1)
        if not self.tie_embeddings:
            n += self.padded_vocab * D * (self.n_codebooks or 1)
        per_layer_attn = 0
        if self.n_heads:
            per_layer_attn = (
                D * self.n_heads * self.hd          # wq
                + 2 * D * self.n_kv_heads * self.hd  # wk, wv
                + self.n_heads * self.hd * D         # wo
            )
        mlp = 3 * D * self.d_ff if self.d_ff else 0  # SwiGLU
        if self.family == "moe":
            e = self.top_k if active_only else self.n_experts
            mlp = 3 * D * self.d_ff * e + D * self.n_experts  # experts+router
        mamba = 0
        if self.family in ("ssm", "hybrid"):
            di, nh, ns = self.d_inner, self.ssm_heads, self.ssm_state
            mamba = (
                D * (2 * di + 2 * ns + nh)      # wz,wx,wB,wC,wdt projections
                + self.ssm_conv * (di + 2 * ns)  # depthwise convs (x,B,C)
                + di * D                         # out_proj
                + 2 * nh                         # A_log, D skip
            )
        if self.family == "hybrid":
            n_attn_applications = 1  # weights shared -> count once
            n += per_layer_attn * n_attn_applications + self.n_layers * (
                mamba + 2 * D
            ) + self.n_layers * (3 * D * self.d_ff if self.d_ff else 0)
        elif self.family == "ssm":
            n += self.n_layers * (mamba + D)
        else:
            n += self.n_layers * (per_layer_attn + mlp + 2 * D)
        return n

    # ------------------------------------------------------ smoke variant
    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        hd2 = 16 // 2  # reduced head_dim of 16
        s1 = hd2 // 4
        s2 = (hd2 - s1 + 1) // 2
        return dataclasses.replace(
            self,
            mrope_sections=(s1, s2, hd2 - s1 - s2),
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def smoke(self) -> "ShapeConfig":
        return ShapeConfig(self.name + "-smoke", min(self.seq_len, 64),
                           min(self.global_batch, 2), self.kind)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
