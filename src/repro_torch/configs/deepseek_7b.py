"""deepseek-7b — llama-arch dense MHA [arXiv:2401.02954]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense", layers=30, d_model=4096,
    num_heads=32, kv_heads=32, d_ff=11008, vocab=102400,
    tie_embeddings=False,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=4, d_ff=256, vocab=512,
    remat=False, dtype="float32",
)
