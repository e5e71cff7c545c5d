"""Paper Table 1 MLLM-10B: Qwen2-7B backbone + ViT-2B + Whisper-0.6B.

Downsample rates (paper S8): vision 1, audio 2.  Vision batched packed
(no padding, Alg 1); audio batched padded (Alg 2 + conv cost model)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="mllm-10b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    encoders=(
        EncoderConfig(name="vision", n_layers=36, d_model=2048, n_heads=16,
                      d_ff=8192, embed_dim=1176, downsample=1,
                      tokens_per_example_max=1024),  # 448/14 = 32x32
        EncoderConfig(name="audio", n_layers=32, d_model=1280, n_heads=20,
                      d_ff=5120, embed_dim=1280, downsample=2, padded=True,
                      conv_attention=True, tokens_per_example_max=1500),
    ),
    citation="OrchMLLM Table 1 (MLLM-10B)",
)
