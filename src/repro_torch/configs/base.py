"""Model configuration dataclass + registry (``--arch`` resolution).

The port's own copy of ``repro/configs/base.py``: every field is kept,
so one config describes a model for both packages, but nothing here
imports ``repro``.  The implementation-selection knobs (scan_impl,
conv_impl, step_impl, ...) are accepted as in ``repro``; what each
means in the port is stated in ``repro_torch/kernels/ops.py``."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config per architecture; frozen/hashable so it can be a static
    argument to jit'd step functions."""
    name: str
    family: str                  # transformer | mamba | jamba | xlstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | ln | ln_nonparam
    tie_embeddings: bool = False

    # mlp
    mlp: str = "swiglu"          # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False     # arctic: dense MLP in parallel with MoE
    moe_every: int = 1               # MoE at layers i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    #: pad the expert dim to this multiple-of-mesh size with inert experts
    #: (router logits forced to -inf) so EP shards evenly; 0 = no padding.
    expert_pad_to: int = 0
    #: MoE dispatch: "dense" (pjit-auto) | "ep" (shard_map all-to-all) |
    #: "auto" (ep when a mesh with a model axis is active)
    moe_impl: str = "auto"
    norm_topk: bool = True
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # Mamba / SSM
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)
    attn_every: int = 0              # jamba: attention at i%attn_every==attn_offset
    attn_offset: int = 0

    # xLSTM
    slstm_every: int = 0             # sLSTM at i%slstm_every==slstm_offset
    slstm_offset: int = 7

    # modality frontends (STUBS per assignment: precomputed embeddings)
    frontend: str = "tokens"         # tokens | audio_stub | vision_stub
    n_codebooks: int = 1             # musicgen output heads
    img_tokens: int = 0              # phi3v: image patch embeds prepended

    # numerics / implementation selection (the MARCA knobs)
    dtype: str = "bfloat16"
    #: production default: chunked_seq (fused per-step chain, chunk-level
    #: remat — §Perf iterations M1-M2); "chunked" (associative) is the
    #: paper-baseline XLA implementation, "pallas" the TPU kernel.
    scan_impl: str = "chunked_seq"   # seq | assoc | chunked | chunked_seq | pallas
    scan_chunk: int = 64
    #: per-token decode step: "megakernel" = ONE Pallas launch per token
    #: for the whole layer stack (layer axis in the kernel grid; jamba
    #: attention sublayers excepted), "fused" = single launch per layer
    #: for the state-update/contraction/gate chain, "xla" = the ref.py
    #: oracle, "auto" = megakernel on TPU, else fused where it compiles
    #: natively (everywhere for pure-XLA fused steps); the
    #: REPRO_STEP_IMPL env var overrides "auto" only
    step_impl: str = "auto"          # auto | megakernel | fused | xla
    attn_impl: str = "chunked"       # chunked | ref | pallas
    attn_chunk: int = 512
    exp_impl: str = "exact"          # exact | ours | fast   (MARCA §5)
    silu_impl: str = "exact"         # exact | ours | paper  (MARCA §5)
    conv_impl: str = "xla"           # xla | pallas
    remat: bool = True
    scan_layers: bool = True         # lax.scan over stacked layer params

    #: logits dtype out of the unembed matmul ("float32" | "bfloat16");
    #: bf16 halves the (tokens x vocab) stream, lse still accumulates f32
    logits_dtype: str = "float32"

    #: KV-cache storage dtype for decode: "model" (= cfg.dtype) | "int8"
    #: (per-position absmax scales; halves/quarters decode cache memory,
    #: fixes the MHA decode_32k cells that exceed 16 GB/chip)
    kv_cache_dtype: str = "model"

    #: Weight storage dtype: "f32" (params as handed in) | "int8"
    #: (per-output-channel absmax codes with f32 scale leaves riding the
    #: same pytree — see core/weight_quant.py).  Dense projections and
    #: mamba's A dequantize where they are consumed — inside the decode
    #: kernels for fused/megakernel steps — so decode streams ~4x fewer
    #: weight bytes per token; embed/unembed/MoE stay f32.
    weight_dtype: str = "f32"

    #: Recurrent-state storage dtype for the pooled decode state
    #: ("f32" | "bf16" | "int8" | "fp8").  int8/fp8 store the SSM h (and
    #: xLSTM matrix memory C) with per-slot-per-layer-per-channel-group
    #: f32 absmax scales kept alongside the cache pytree; the decode
    #: step dequantizes on read and requantizes on write (decayed
    #: running absmax), so slot capacity scales ~4x while step math
    #: stays f32.  Pairs with kv_cache_dtype, which covers the
    #: attention KV strips; state_dtype covers the recurrent blocks.
    state_dtype: str = "f32"

    # training defaults
    max_seq: int = 4096

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.dt_rank == 0:
            object.__setattr__(self, "dt_rank",
                               math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Analytical parameter count (drives 6ND roofline + memory calc)."""
        from repro_torch.models import registry
        return registry.count_params(self)

    def n_active_params(self) -> int:
        from repro_torch.models import registry
        return registry.count_params(self, active_only=True)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab — structure preserved."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        dt_rank=8,
        max_seq=64,
        scan_chunk=16,
        attn_chunk=32,
        dtype="float32",
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.attn_every:
        kw.update(n_layers=max(cfg.attn_every, 2))
    if cfg.slstm_every:
        kw.update(n_layers=max(cfg.slstm_every, 2))
    if cfg.img_tokens:
        kw.update(img_tokens=8)
    return dataclasses.replace(cfg, **kw)
