"""qwen1.5-32b — dense, MHA (kv=40), QKV bias [hf:Qwen/Qwen1.5-32B]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", layers=64, d_model=5120,
    num_heads=40, kv_heads=40, d_ff=27392, vocab=152064,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=4, d_ff=256, vocab=512,
    remat=False, dtype="float32",
)
