"""qwen2-7b — dense, GQA kv=4, QKV bias [arXiv:2407.10671]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense", layers=28, d_model=3584,
    num_heads=28, kv_heads=4, d_ff=18944, vocab=152064,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=2, d_ff=256, vocab=512,
    remat=False, dtype="float32",
)
