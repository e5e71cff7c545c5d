"""Paper Table 1 MLLM-18B: 14B LLM + ViT-3B + Whisper-0.6B (a copy of
``repro.configs.mllm_18b``).

Vision head dim 2400 / 24 = 100: the attention kernels take it
zero-padded to 128 (``models/attention.py`` ``_flash``)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="mllm-18b",
    family="vlm",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    encoders=(
        EncoderConfig(name="vision", n_layers=40, d_model=2400, n_heads=24,
                      d_ff=9600, embed_dim=1176, downsample=4,
                      tokens_per_example_max=2304),  # 672/14 = 48x48
        EncoderConfig(name="audio", n_layers=32, d_model=1280, n_heads=20,
                      d_ff=5120, embed_dim=1280, downsample=2, padded=True,
                      conv_attention=True, tokens_per_example_max=1500),
    ),
    citation="OrchMLLM Table 1 (MLLM-18B)",
)
