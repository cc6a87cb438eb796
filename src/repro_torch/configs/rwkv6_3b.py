"""rwkv6-3b — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", layers=32, d_model=2560,
    num_heads=40, kv_heads=40, d_ff=8960, vocab=65536,
    rwkv=True, tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=2, d_ff=256, vocab=512, remat=False,
    dtype="float32",
)
