"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2 every other
layer [arXiv:2403.19887]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", layers=32, d_model=4096,
    num_heads=32, kv_heads=8, d_ff=14336, vocab=65536,
    num_experts=16, top_k=2, moe_d_ff=14336, moe_every=2,
    attn_period=8, attn_offset=4, mamba_d_state=16, mamba_expand=2,
    tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=8, d_model=128, num_heads=4, kv_heads=2, d_ff=256, vocab=512,
    num_experts=4, top_k=2, moe_d_ff=256, remat=False, dtype="float32",
)
