"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

d_ff=2048 is the per-expert width; a shared expert mirrors the DeepSeek-V3
lineage the paper table describes.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", layers=61, d_model=7168,
    num_heads=64, kv_heads=8, d_ff=2048, vocab=163840,
    num_experts=384, top_k=8, moe_d_ff=2048, moe_every=1, shared_expert=True,
    tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=2, d_ff=128, vocab=512,
    num_experts=8, top_k=2, moe_d_ff=128, remat=False, dtype="float32",
)
