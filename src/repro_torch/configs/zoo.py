"""All architecture configs.

10 assigned archs (exact hyperparameters from the assignment table,
[source; verified-tier] in each docstring line) + the paper's own Mamba
family (Table 1).  One ``register(ModelConfig(...))`` per arch; resolve with
``--arch <name>``.

The port's own copy of ``repro/configs/zoo.py`` (same names, same
hyperparameters); the port serves the mamba family only so far.
"""
from repro_torch.configs.base import ModelConfig, register

# --- dense transformers ----------------------------------------------------

#: granite-20b [dense] 52L d6144 48H (kv=1 MQA) ff24576 V49152 — llama-arch,
#: code [arXiv:2405.04324; hf]
GRANITE_20B = register(ModelConfig(
    name="granite-20b", family="transformer", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, norm="rmsnorm",
    mlp="swiglu"))

#: olmo-1b [dense] 16L d2048 16H (MHA) ff8192 V50304 — non-parametric LN
#: [arXiv:2402.00838; hf]
OLMO_1B = register(ModelConfig(
    name="olmo-1b", family="transformer", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304, norm="ln_nonparam",
    mlp="swiglu", tie_embeddings=True))

#: qwen2-7b [dense] 28L d3584 28H (kv=4) ff18944 V152064 — GQA, QKV bias
#: [arXiv:2407.10671; hf]
QWEN2_7B = register(ModelConfig(
    name="qwen2-7b", family="transformer", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, qkv_bias=True,
    rope_theta=1e6, norm="rmsnorm", mlp="swiglu"))

#: qwen2.5-14b [dense] 48L d5120 40H (kv=8) ff13824 V152064 — GQA, QKV bias
#: [hf:Qwen/Qwen2.5-0.5B; hf]
QWEN2_5_14B = register(ModelConfig(
    name="qwen2.5-14b", family="transformer", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064, qkv_bias=True,
    rope_theta=1e6, norm="rmsnorm", mlp="swiglu"))

#: musicgen-large [audio] 48L d2048 32H (MHA) ff8192 V2048 — decoder-only
#: over EnCodec tokens, 4 codebooks, stub frontend [arXiv:2306.05284; hf]
MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large", family="transformer", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048, norm="ln", mlp="gelu",
    frontend="audio_stub", n_codebooks=4))

#: phi-3-vision-4.2b [vlm] 32L d3072 32H (MHA) ff8192 V32064 — phi3-mini +
#: CLIP stub (576 patch embeds) [hf:microsoft/Phi-3-vision-128k-instruct; hf]
PHI3_VISION = register(ModelConfig(
    name="phi-3-vision-4.2b", family="transformer", n_layers=32,
    d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    norm="rmsnorm", mlp="swiglu", frontend="vision_stub", img_tokens=576))

# --- MoE transformers --------------------------------------------------------

#: qwen2-moe-a2.7b [moe] 24L d2048 16H (MHA) ff1408/expert V151936 —
#: 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
QWEN2_MOE = register(ModelConfig(
    name="qwen2-moe-a2.7b", family="transformer", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936, qkv_bias=True,
    norm="rmsnorm", mlp="swiglu", n_experts=60, top_k=4,
    n_shared_experts=4, expert_pad_to=64))

#: arctic-480b [moe] 35L d7168 56H (kv=8) ff4864 V32000 — 128 experts top-2
#: + dense residual [hf:Snowflake/snowflake-arctic-base; hf]
ARCTIC_480B = register(ModelConfig(
    name="arctic-480b", family="transformer", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, norm="rmsnorm",
    mlp="swiglu", n_experts=128, top_k=2, dense_residual=True))

# --- hybrid / SSM -----------------------------------------------------------

#: jamba-v0.1-52b [hybrid] 32L d4096 32H (kv=8) ff14336 V65536, MoE 16e
#: top-2 — Mamba+attn 1:7, MoE every other layer [arXiv:2403.19887; hf]
JAMBA_52B = register(ModelConfig(
    name="jamba-v0.1-52b", family="jamba", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, norm="rmsnorm",
    mlp="swiglu", n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4, d_state=16, d_conv=4, expand=2))

#: xlstm-350m [ssm] 24L d1024 4H ff0 V50304 — sLSTM + mLSTM 1:7
#: [arXiv:2405.04517; unverified]
XLSTM_350M = register(ModelConfig(
    name="xlstm-350m", family="xlstm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, norm="ln", slstm_every=8,
    slstm_offset=7, tie_embeddings=True))

# --- the paper's own models (Table 1) ----------------------------------------

_MAMBA_TABLE1 = {
    "mamba-130m": (24, 768),
    "mamba-370m": (48, 1024),
    "mamba-790m": (48, 1536),
    "mamba-1.4b": (48, 2048),
    "mamba-2.8b": (64, 2560),
}

# vocab: Mamba's GPT-NeoX tokenizer is 50277, padded to 50280 in the
# release; we pad further to 50304 (multiple of 256) so the embedding
# shards evenly over the 16-way mesh axes — standard practice.
for _name, (_L, _d) in _MAMBA_TABLE1.items():
    register(ModelConfig(
        name=_name, family="mamba", n_layers=_L, d_model=_d,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=50304, norm="rmsnorm",
        tie_embeddings=True, d_state=16, d_conv=4, expand=2))

#: The ten assigned architectures (dry-run / roofline set).
ASSIGNED = [
    "granite-20b", "olmo-1b", "qwen2-7b", "qwen2.5-14b", "musicgen-large",
    "jamba-v0.1-52b", "xlstm-350m", "qwen2-moe-a2.7b", "arctic-480b",
    "phi-3-vision-4.2b",
]

MAMBA_FAMILY = list(_MAMBA_TABLE1)
