"""zamba2-2.7b: hybrid Mamba-2 + shared attention blocks [arXiv:2411.15242].

54 Mamba-2 layers; ONE shared attention+MLP block (single weight set)
applied every 6 SSM layers -- the Zamba parameter-sharing trick."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_variant="mamba2",
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_headdim=64,
    # Mamba-2 maps onto the mamba1 selective-scan kernels by head
    # broadcast: the hand-written CUDA kernels in the port
    # (kernels/selective_scan.py; the name is the JAX package's).
    ssm_backend="pallas",
    shared_attn_every=6,
    citation="arXiv:2411.15242",
)
