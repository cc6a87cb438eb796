"""llama4-scout-17b-a16e — MoE 16 experts top-1, shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", layers=48, d_model=5120,
    num_heads=40, kv_heads=8, d_ff=8192, vocab=202048,
    num_experts=16, top_k=1, moe_d_ff=8192, moe_every=1, shared_expert=True,
    rope_theta=5e5, tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=2, d_ff=128, vocab=512,
    num_experts=4, top_k=1, moe_d_ff=128, remat=False, dtype="float32",
)
