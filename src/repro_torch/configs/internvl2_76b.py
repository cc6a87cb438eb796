"""internvl2-76b — InternViT frontend stub + 80L LLM backbone
[arXiv:2404.16821]. Patch embeddings arrive precomputed (256 patches)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", layers=80, d_model=8192,
    num_heads=64, kv_heads=8, d_ff=28672, vocab=128256,
    frontend="vit", frontend_seq=256, tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=2, d_ff=256, vocab=512,
    frontend_seq=8, remat=False, dtype="float32",
)
