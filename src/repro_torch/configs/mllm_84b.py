"""Paper Table 1 MLLM-84B: 72B LLM + ViT-6B + Whisper-6B (a copy of
``repro.configs.mllm_84b``)."""
import dataclasses

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="mllm-84b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    encoders=(
        EncoderConfig(name="vision", n_layers=45, d_model=3200, n_heads=25,
                      d_ff=12800, embed_dim=1176, downsample=4,
                      tokens_per_example_max=4096),  # 896/14 = 64x64
        EncoderConfig(name="audio", n_layers=48, d_model=3072, n_heads=24,
                      d_ff=12288, embed_dim=1280, downsample=4, padded=True,
                      conv_attention=True, tokens_per_example_max=1500),
    ),
    # Train on the flash path end to end (encoders + backbone + decode):
    # the attention kernels on the card, their plain versions on the CPU.
    attention_impl="flash",
    block_q=128,
    block_kv=128,
    citation="OrchMLLM Table 1 (MLLM-84B)",
)

# Pipeline-staged variant (the paper's 2560-GPU regime analogue): 80
# backbone layers over 4 stages, 16 microbatches so the 1F1B steady
# state saturates and the warm-up/cool-down bubbles can absorb the
# encoder compute.  The port's orchestrator plans with it
# (``core/pipeline.py``); no stage runs on its own rank yet.
STAGED_CONFIG = dataclasses.replace(
    CONFIG, pp_stages=4, pp_microbatches=16, pp_bubble_fill=True)
