"""Config schema, a copy of ``repro.configs.base``.

The dataclasses keep every field of the JAX package's schema, so a
config built here compares equal, field by field, to its counterpart
there.  The port carries the architectures it runs as sibling
``<arch>.py`` modules (see :mod:`repro_torch.configs`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["EncoderConfig", "EngineConfig", "ModelConfig", "with_attention_backend"]

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """A modality encoder submodule (paper S2.1).

    For assigned [vlm]/[audio] archs the *frontend* (ViT / mel+conv) is a
    stub -- ``input_specs()`` supplies precomputed patch/frame embeddings
    of shape [tokens, embed_dim]; the transformer below (n_layers may be
    0 for pure-stub connectors like LLaVA's) plus the MLP connector is
    real and is a balancing *phase* of its own.
    """

    name: str  # "vision" | "audio"
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    embed_dim: int  # incoming stub embedding dim
    downsample: int = 1  # paper S8: downsample before the connector
    padded: bool = False  # paper: audio batches WITH padding (conv arch)
    conv_attention: bool = False  # App. A cost model for conv-transformers
    tokens_per_example_max: int = 2048
    scan_unroll: int = 1  # roofline probes (see ModelConfig.scan_unroll)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // n_heads

    # Attention variants.
    rope_theta: float = 10_000.0
    qk_norm: bool = False  # qwen3
    sliding_window: int | None = None  # h2o-danube SWA
    nonparametric_norm: bool = False  # olmo-1b
    tie_embeddings: bool = False

    # MoE.
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # Expert dispatch backend: "dense" = legacy [E, capacity, d] buffer
    # (static shapes, drops past capacity); "grouped" = drop-free sorted
    # dispatch through the grouped-GEMM kernels (CUDA in the port,
    # kernels/grouped_gemm.py; tile-skip over empty experts).
    moe_backend: Literal["dense", "grouped"] = "dense"
    moe_block_m: int = 128
    moe_block_n: int = 128

    # SSM (mamba).
    ssm_variant: Literal["mamba1", "mamba2", None] = None
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64  # mamba2
    # Selective-scan backend: "scan" = chunked lax.scan recurrence;
    # "pallas" = the fused kernel (kernels/selective_scan.py) with its
    # chunk-checkpointed custom VJP.
    ssm_backend: Literal["scan", "pallas"] = "scan"
    ssm_block_d: int = 128
    ssm_chunk: int = 64

    # Hybrid (zamba2): a shared attention block every `shared_attn_every`
    # SSM layers, reusing ONE set of attention weights each time.
    shared_attn_every: int = 0

    # Encoder-decoder (whisper): n_layers counts DECODER layers;
    # cross-attention in every decoder layer.
    is_encoder_decoder: bool = False
    encoder_layers: int = 0

    # Multimodal encoders (paper S2.1 submodules).
    encoders: tuple[EncoderConfig, ...] = ()

    # Numerics / implementation.
    dtype: str = "bfloat16"
    # Attention backend for every attention site (encoders, LLM
    # backbone, cross attention, decode) -- see
    # repro_torch.models.attention.ATTENTION_BACKENDS (the port runs
    # "reference" and "flash"; chunked variants decode via "reference").
    #   "chunked_unrolled" = roofline mode: inner scans (attention KV
    #   blocks, xent chunks) unroll so cost_analysis counts every
    #   iteration (XLA prices a while-loop body once).
    #   "flash" = the segment flash-attention kernel (CUDA in the port;
    #   its plain PyTorch version on CPU tensors).
    attention_impl: Literal[
        "reference", "chunked", "chunked_unrolled", "flash", "flash_interpret"
    ] = "chunked"
    block_q: int = 512
    block_kv: int = 512
    # Beyond-paper: window-chunked segment attention.  When set (to the
    # max example/segment length), self-attention over packed streams
    # computes [W x 2W] windows instead of [T x T] -- exact because
    # post-balanced segments never exceed W.  None = paper-faithful.
    segment_window: int | None = None
    # Beyond-paper: explicit sharding constraint on the MoE dispatch
    # buffers ([E, C, d] capacity dim over the model axis) -- a S-Perf
    # knob against collective-bound MoE steps.
    moe_shard_buffers: bool = False
    remat: bool = True
    # Layer-scan unroll factor; the dry-run compiles at 1 and 2 (3 for
    # hybrids) and extrapolates exact per-layer FLOPs/bytes/collectives.
    scan_unroll: int = 1
    # Consult the kernel autotune cache (kernels/autotune.py) at trace
    # time: tuned block shapes override block_q/block_kv, moe_block_*,
    # ssm_block_d/ssm_chunk when a cache entry matches the call shape.
    kernel_autotune: bool = False
    autotune_cache: str | None = None  # path; None = default location
    # Pipeline parallelism (docs/pipeline.md): number of stages the LLM
    # backbone is partitioned into (1 = DP-only), microbatches per step
    # (0 = auto: 2*pp_stages), and whether encoder microbatches are
    # scheduled into the 1F1B warm-up/cool-down bubbles.
    pp_stages: int = 1
    pp_microbatches: int = 0
    pp_bubble_fill: bool = True
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_backend(self) -> str:
        """The configured attention backend (``attention_impl`` keeps its
        historical field name for config compatibility)."""
        return self.attention_impl

    @property
    def decode_backend(self) -> str:
        """Backend for single-token decode.  The chunked scan is pure
        overhead for a 1-row query, so chunked variants decode through
        the dense reference row; flash backends pass through (the kernel
        pads the query tile)."""
        if self.attention_impl in ("flash", "flash_interpret"):
            return self.attention_impl
        return "reference"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6*N*D roofline term)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        return _param_count(self, active_only=True)

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family: <=2 layers, d_model<=256,
        <=4 experts -- runs one forward/train step on CPU."""
        enc = tuple(
            dataclasses.replace(
                e, n_layers=min(e.n_layers, 2), d_model=128, n_heads=2,
                d_ff=256, embed_dim=64, tokens_per_example_max=64,
            )
            for e in self.encoders
        )
        return dataclasses.replace(
            self,
            n_layers=2,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=256 if not self.ssm_variant else 128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=None,
            d_ff=512,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_headdim=32 if self.ssm_variant == "mamba2" else self.ssm_headdim,
            ssm_state=min(self.ssm_state, 16) or self.ssm_state,
            sliding_window=64 if self.sliding_window else None,
            shared_attn_every=2 if self.shared_attn_every else 0,
            block_q=64,
            block_kv=64,
            encoders=enc,
            name=self.name + "-smoke",
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the continuous-batching serving engine
    (:mod:`repro_torch.serving.engine`).

    The pool is ``num_blocks`` KV blocks of ``block_size`` tokens each
    (block 0 is the reserved all-zero null block, so the usable capacity
    is ``num_blocks - 1``).  ``token_budget`` caps the modality-weighted
    work admitted per engine step: each running decode costs the serving
    cost model's ``decode_cost`` (1 by default) and each admitted
    prefill costs ``f(weighted prompt length)``.  ``max_model_len`` is
    the logical per-sequence cache length (prompt + generation must fit
    unless the model uses a sliding window, whose ring needs only
    ``sliding_window`` slots).  ``prefill_pad`` / ``decode_pad`` round
    batched shapes up so jit retraces stay bounded.
    """

    block_size: int = 16
    num_blocks: int = 129
    max_num_seqs: int = 8
    token_budget: int = 512
    max_model_len: int = 256
    replicas: int = 1
    prefill_pad: int = 32
    decode_pad: int = 4
    # Max padding overhead of a prefill sub-batch, as a fraction of its
    # useful tokens: a group is closed rather than padded past
    # useful * (1 + prefill_waste) slots.  Admitted prompts are split
    # into length-sorted groups (Algorithm 2's bounded padded batches)
    # so one long prompt cannot inflate every co-admitted short one to
    # its padded length.
    prefill_waste: float = 0.35
    balancing_backend: str = "vectorized"

    def __post_init__(self) -> None:
        if self.block_size < 1 or self.num_blocks < 2:
            raise ValueError("need block_size >= 1 and num_blocks >= 2 "
                             "(block 0 is the reserved null block)")
        if self.max_model_len % self.block_size:
            raise ValueError(
                f"max_model_len={self.max_model_len} must be a multiple of "
                f"block_size={self.block_size}")
        if self.max_num_seqs < 1 or self.replicas < 1:
            raise ValueError("need max_num_seqs >= 1 and replicas >= 1")
        if self.token_budget < 1 or self.prefill_pad < 1 or self.decode_pad < 1:
            raise ValueError("token_budget / prefill_pad / decode_pad must be >= 1")
        if self.prefill_waste < 0.0:
            raise ValueError("prefill_waste must be >= 0")

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1


def with_attention_backend(cfg: ModelConfig, backend: str | None) -> ModelConfig:
    """Copy of ``cfg`` on the given attention backend, validated eagerly
    (a typo fails here, not deep inside a jitted trace).  None = cfg
    unchanged."""
    if backend is None:
        return cfg
    from repro_torch.models.attention import ATTENTION_BACKENDS

    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; "
                         f"choose from {ATTENTION_BACKENDS}")
    return dataclasses.replace(cfg, attention_impl=backend)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    total = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size  # lm head

    def attn_params() -> int:
        return d * nh * hd + 2 * d * nkv * hd + nh * hd * d

    def mlp_params() -> int:
        return 3 * d * f  # swiglu

    def mamba_params() -> int:
        di = cfg.d_inner
        n = cfg.ssm_state
        if cfg.ssm_variant == "mamba2":
            nheads = di // cfg.ssm_headdim
            return d * (2 * di + 2 * n + nheads) + di * d + di * cfg.ssm_conv
        # mamba1: in_proj 2*di, x_proj di->(dt_rank+2n), dt_proj, out_proj, A, D, conv
        dt_rank = max(1, d // 16)
        return (
            d * 2 * di + di * (dt_rank + 2 * n) + dt_rank * di + di * d
            + di * n + di + di * cfg.ssm_conv
        )

    if cfg.family in ("dense", "vlm"):
        total += cfg.n_layers * (attn_params() + mlp_params())
    elif cfg.family == "moe":
        e_count = cfg.experts_per_token if active_only else cfg.n_experts
        total += cfg.n_layers * (attn_params() + e_count * mlp_params() + d * cfg.n_experts)
    elif cfg.family == "ssm":
        total += cfg.n_layers * mamba_params()
    elif cfg.family == "hybrid":
        total += cfg.n_layers * mamba_params()
        if cfg.shared_attn_every:
            total += attn_params() + mlp_params()  # ONE shared block
    elif cfg.family == "audio":
        total += cfg.n_layers * (2 * attn_params() + mlp_params())  # dec: self+cross
        total += cfg.encoder_layers * (attn_params() + mlp_params())
    for e in cfg.encoders:
        ed, ef = e.d_model, e.d_ff
        per = 4 * ed * ed + 3 * ed * ef
        total += e.n_layers * per + e.embed_dim * ed + ed * d  # + connector
    return total
