"""Model configuration — one dataclass covering all 10 assigned architectures.

Port of ``repro.models.config``, copied verbatim (it imports no JAX, but the
port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None          # per-expert FFN width
    moe_every: int = 1                      # every n-th layer is MoE
    shared_expert: bool = False
    # hybrid (Jamba): one attention layer per ``attn_period`` layers
    attn_period: int = 0                    # 0 = all-attention
    attn_offset: int = 0                    # index within period that is attention
    mamba_d_state: int = 16
    mamba_expand: int = 2
    # rwkv
    rwkv: bool = False
    # encoder-decoder (Seamless): encoder layers; cross-attention in decoder
    encoder_layers: int = 0
    # modality frontend stub: tokens are precomputed embeddings
    frontend: Optional[str] = None          # None | "vit" | "audio"
    frontend_seq: int = 0                   # frontend sequence length (patches/frames)
    # execution
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attention_chunk: int = 1024
    la_chunk: int = 32                     # linear-attention chunk
    vocab_pad_multiple: int = 128          # pad embedding rows (TPU lanes +
                                           # keeps vocab shardable over model)
    # beyond-paper optimization toggles (EXPERIMENTS §Perf; off = baseline)
    opt_act_sharding: bool = True          # H1: pin residual/logits sharding
    opt_decode_fastpath: bool = True       # H2: fused single-token attention
    opt_moe_slot_loop: bool = True         # H3: per-slot dispatch (no N·K blowup)
    analysis_unroll: bool = False          # roofline path: unroll inner scans

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return -(-self.vocab // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' | 'rwkv' for layer i's mixer."""
        if self.rwkv:
            return "rwkv"
        if self.attn_period > 0:
            return "attn" if i % self.attn_period == self.attn_offset else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_every == self.moe_every - 1)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        D, L = self.d_model, self.layers
        hd = self.resolved_head_dim
        n = self.vocab * D                                    # embedding
        if not self.tie_embeddings:
            n += self.vocab * D
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                n += D * hd * (self.num_heads + 2 * self.kv_heads) + self.num_heads * hd * D
            elif kind == "mamba":
                di = self.mamba_expand * D
                H = max(di // 64, 1)
                n += 2 * D * di + 2 * D * H * self.mamba_d_state + D * H + di * D
            elif kind == "rwkv":
                n += 5 * D * D + 2 * D * 64                   # time mixing + lora
            if kind == "rwkv":
                n += 2 * D * self.d_ff + D * D                # channel mixing
            elif self.layer_is_moe(i):
                ff = self.moe_d_ff or self.d_ff
                n += 3 * self.num_experts * D * ff
                if self.shared_expert:
                    n += 3 * D * ff
            else:
                n += 3 * D * self.d_ff
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                n += D * hd * (self.num_heads + 2 * self.kv_heads) + self.num_heads * hd * D
                n += 3 * D * self.d_ff
            # decoder cross-attention
            n += L * (D * hd * (self.num_heads + 2 * self.kv_heads) + self.num_heads * hd * D)
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        D, L = self.d_model, self.layers
        full = self.param_count()
        ff = self.moe_d_ff or self.d_ff
        dead = 0
        for i in range(L):
            if self.layer_is_moe(i):
                dead += 3 * (self.num_experts - self.top_k) * D * ff
        return int(full - dead)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}
