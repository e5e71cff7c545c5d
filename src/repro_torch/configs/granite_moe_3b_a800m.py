"""granite-moe-3b-a800m: MoE 40 experts top-8, per-expert d_ff=512
[hf:ibm-granite/granite-3.0-3b-a800m-base].

Note: the assignment line says "MoE 40e top-8" while its bracket remark
says "32 experts"; we follow the explicit field (40 experts, top-8),
which matches the HF model card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    experts_per_token=8,
    # 40 small experts, top-8: the imbalance-sensitive case the
    # grouped-GEMM backend exists for.
    moe_backend="grouped",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
