"""falcon-mamba-7b: attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_variant="mamba1",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    # The fused selective scan: the hand-written CUDA kernels in the port
    # (kernels/selective_scan.py; the name is the JAX package's).
    ssm_backend="pallas",
    citation="arXiv:2410.05355",
)
