"""The 10 architectures of the LM zoo, the reference's configs as data.

Counterpart of `repro/configs/registry.py`, value for value.

`[source; tier]` provenance is recorded per config. Values not present in
the assignment line (head_dim, window sizes, MLA ranks, dense-prefix FFN)
come from the cited public model cards and are marked in `source`.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


mamba2_2p7b = _reg(ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    sub_quadratic=True,
    source="[arXiv:2405.21060; unverified] SSD; 80 heads of P=64",
))

whisper_small = _reg(ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, encoder_seq=1500,
    norm_type="layernorm", act="gelu",
    source="[arXiv:2212.04356; unverified] enc-dec; conv frontend stubbed "
           "(batch['enc'] = precomputed 1500-frame embeddings)",
))

llama32_vision_90b = _reg(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    cross_attn_period=5, vision_seq=1601, rope_theta=500000.0,
    source="[hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified] "
           "cross-attn image layers every 5; patch embeddings stubbed",
))

olmo_1b = _reg(ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm_type="nonparam_ln", tie_embeddings=True,
    source="[arXiv:2402.00838; hf] non-parametric LN, tied embeddings",
))

granite_3_2b = _reg(ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155, tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf] GQA kv=8",
))

h2o_danube3_4b = _reg(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    attn_kind="local", local_window=4096, sub_quadratic=True,
    source="[arXiv:2401.16818; unverified] llama+mistral mix, SWA window "
           "4096 (mistral default)",
))

gemma3_12b = _reg(ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    attn_kind="local_global", local_global_period=6, local_window=1024,
    rope_theta=1000000.0, sub_quadratic=True, tie_embeddings=True,
    source="[hf:google/gemma-3-12b family; unverified] 5 local (w=1024) : "
           "1 global, 128k ctx",
))

phi35_moe = _reg(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, moe_d_ff=6400, capacity_factor=1.25,
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf] 16 experts top-2",
))

deepseek_v3 = _reg(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    first_dense_layers=3, capacity_factor=1.25,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    mtp=True,
    source="[arXiv:2412.19437; hf] MLA; 1 shared + 256 routed top-8; MTP "
           "depth-1; dense d_ff=18432 for the 3-layer dense prefix "
           "(assignment's d_ff=2048 is the routed expert size)",
))

zamba2_2p7b = _reg(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    hybrid_period=6, sub_quadratic=True,
    source="[arXiv:2411.15242; hf] Mamba2 backbone + shared attn+MLP block "
           "every 6 layers (LoRA specialization simplified to per-group "
           "input norms; see DESIGN.md)",
))


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)
