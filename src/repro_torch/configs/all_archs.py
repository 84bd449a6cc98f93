"""The 10 assigned architectures, exact configs from the assignment table
(the port's own copy of ``repro.configs.all_archs``, as data).

Sources are noted per entry ([arXiv/hf; tier] as given).  ``block_pattern``
encodes one period of the layer stack (scanned ``repeats`` times).
"""
from .base import ArchConfig, register


# [ssm] sLSTM + mLSTM blocks [arXiv:2405.04517]
XLSTM_350M = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    head_dim=256,
    # xLSTM[7:1]: 7 mLSTM blocks per sLSTM block
    block_pattern=("mlstm",) * 7 + ("slstm",),
    supports_long_context=True,      # recurrent state, O(1) per token
))

# [dense] GQA, squared-ReLU [arXiv:2402.16819]
NEMOTRON_4_340B = register(ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    head_dim=192,
    block_pattern=("attn",),
    mlp_act="squared_relu",
    rope_theta=10000.0,
))

# [dense] 5:1 local:global, 128k [hf:google/gemma-3 family]
GEMMA3_12B = register(ArchConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144,
    head_dim=256,
    block_pattern=("local",) * 5 + ("global",),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    mlp_act="gelu_glu",
    tie_embeddings=True,
    supports_long_context=True,      # 5/6 layers O(window); global layers SP-sharded
))

# [dense] local+global alternating, logit softcap [arXiv:2408.00118]
GEMMA2_2B = register(ArchConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000,
    head_dim=256,
    block_pattern=("local", "global"),
    window_size=4096,
    attn_softcap=50.0, final_softcap=30.0,
    mlp_act="gelu_glu",
    tie_embeddings=True,
    supports_long_context=True,
))

# [dense] MLA [hf:openbmb/MiniCPM3-4B]
MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    mla=True, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    head_dim=96,                      # nope+rope
    block_pattern=("attn",),
    mlp_act="silu_glu",
))

# [audio] enc-dec, multimodal [arXiv:2308.11596]
SEAMLESS_M4T_MEDIUM = register(ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    enc_layers=12, dec_layers=12,
    block_pattern=("attn",),
    mlp_act="gelu",
    frontend="audio",                 # stub: precomputed frame embeddings
))

# [moe] 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
GRANITE_MOE_1B = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    head_dim=64,
    block_pattern=("moe",),
    num_experts=32, experts_per_token=8, moe_d_ff=512,
    mlp_act="silu_glu",
    tie_embeddings=True,
))

# [moe] MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434]
DEEPSEEK_V2_236B = register(ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288,                       # the dense first layer
    vocab_size=102400,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    head_dim=192,
    prologue=("dense_ffn_attn",),     # layer 0 uses the dense FFN
    block_pattern=("moe",),
    num_experts=160, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1536,
    mlp_act="silu_glu",
))

# [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242]
ZAMBA2_2P7B = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    head_dim=80,
    # one shared attention block application per 6 mamba2 blocks
    block_pattern=("mamba",) * 5 + ("mamba+shared_attn",),
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    mlp_act="gelu_glu",
    supports_long_context=True,       # SSM state is O(1); shared-attn KV is SP-sharded
))

# [vlm] anyres tiling; mistral-7b backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf]
LLAVA_NEXT_MISTRAL_7B = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    head_dim=128,
    block_pattern=("attn",),
    mlp_act="silu_glu",
    rope_theta=1_000_000.0,
    frontend="vision",                # stub: precomputed patch embeddings
    num_patches=576,                  # one 24x24 anyres base tile
))

ALL_ARCHS = [
    "xlstm-350m", "nemotron-4-340b", "gemma3-12b", "gemma2-2b",
    "minicpm3-4b", "seamless-m4t-medium", "granite-moe-1b-a400m",
    "deepseek-v2-236b", "zamba2-2.7b", "llava-next-mistral-7b",
]
