"""granite-3-2b — dense GQA kv=8 [hf:ibm-granite/granite-3.0-2b-base]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", layers=40, d_model=2048,
    num_heads=32, kv_heads=8, d_ff=8192, vocab=49155,
    tie_embeddings=True,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, d_model=128, num_heads=4, kv_heads=2, d_ff=256, vocab=512,
    remat=False, dtype="float32",
)
