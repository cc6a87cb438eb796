"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].
Audio frontend stub: precomputed frame embeddings feed the encoder."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", layers=12, d_model=1024,
    num_heads=16, kv_heads=16, d_ff=4096, vocab=256206,
    encoder_layers=12, frontend="audio", frontend_seq=1024,
    tie_embeddings=True,
)
SMOKE_CONFIG = dataclasses.replace(
    CONFIG, layers=2, encoder_layers=2, d_model=128, num_heads=4, kv_heads=4,
    d_ff=256, vocab=512, frontend_seq=16, remat=False, dtype="float32",
)
