"""ArchConfig — the architectures of the LM zoo, as data.

Counterpart of `repro/configs/base.py`: the same frozen dataclass, with
`param_dtype` / `compute_dtype` as torch dtypes. `tiny()` derives the
reduced same-family config the CPU tests use. `remat` checkpoints each
period of layers in training (`DecoderLM.loss`). The reference's
`scan_layers` is not carried: nothing reads it (the port unrolls its
layers). Its `unroll_inner`, `ShapeConfig` grid and analytic parameter
counts (`n_params`, `n_active_params`) belong to the dry-run / roofline
tooling, which is not ported yet (ROADMAP.md Queue 1, item 5g).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention pattern ---
    attn_kind: str = "global"       # global | local | local_global
    local_window: int = 4096
    local_global_period: int = 0    # e.g. 6 => 5 local : 1 global

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 family) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attn block after every `hybrid_period` ssm layers
    hybrid_period: int = 0

    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500         # stub audio frames

    # --- vlm (llama-3.2-vision): cross-attn block every `cross_attn_period`
    cross_attn_period: int = 0
    vision_seq: int = 1601          # stub patch embeddings

    # --- misc ---
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"               # silu (gated) | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    mtp: bool = False               # deepseek multi-token prediction head
    sub_quadratic: bool = False     # eligible for long_500k
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True              # recompute each period on backward
    source: str = ""                # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def with_dtypes(self, param_dtype, compute_dtype) -> "ArchConfig":
        return dataclasses.replace(self, param_dtype=param_dtype,
                                   compute_dtype=compute_dtype)

    def tiny(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        reps = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16 if self.n_heads else 0,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(2, self.n_kv_heads) if self.n_kv_heads else 0,
            local_window=32,
            encoder_seq=24 if self.family == "encdec" else self.encoder_seq,
            vision_seq=16 if self.family == "vlm" else self.vision_seq,
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
        )
        if self.n_experts:
            reps.update(n_experts=4, top_k=min(2, self.top_k), moe_d_ff=64,
                        first_dense_layers=min(1, self.first_dense_layers))
        if self.use_mla:
            reps.update(q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=8,
                        qk_nope_dim=16, v_head_dim=16)
        if self.local_global_period:
            reps.update(local_global_period=2)
        if self.hybrid_period:
            reps.update(hybrid_period=2)
        if self.cross_attn_period:
            reps.update(cross_attn_period=2)
        if self.n_encoder_layers:
            reps.update(n_encoder_layers=2)
        # keep layer-count divisibility with periods
        period = reps.get("local_global_period") or reps.get("hybrid_period") \
            or reps.get("cross_attn_period")
        if period:
            reps["n_layers"] = 2 * period
        return dataclasses.replace(self, **reps)
