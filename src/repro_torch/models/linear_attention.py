"""Chunked decayed linear attention — the shared recurrence engine for
RWKV-6 (vector data-dependent decay) and the selective-SSM half of Jamba
(scalar-per-head decay, SSD formulation).

Port of ``repro.models.linear_attention``.  Recurrence (per head, state
S ∈ R^{K×V}):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ            w_t ∈ (0,1)^K (vector)
    o_t = r_tᵀ (S_{t-1} + u ⊙ k_t v_tᵀ)           (u: RWKV bonus, optional)

The full-sequence form is the reference's chunked matmul form (log-space
decay ratios, f32 accumulation); the state is carried across chunks by a
Python loop in place of ``lax.scan``.  Decode keeps the O(1) recurrent state.

Numerical contract (as in the reference): the cumulative log-decay span
inside one chunk must stay below ~85 nats, so callers clamp per-step log
decay to ≥ LOG_W_MIN and use chunk ≤ 32; exponent arguments are also clipped
at ±85.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG_W_MIN = -2.5   # per-step decay floor (see numerical contract above)
_EXP_CAP = 85.0


def _safe_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -_EXP_CAP, _EXP_CAP))


def chunked_linear_attention(
    r: torch.Tensor,            # [B, H, T, K]   receptance / query
    k: torch.Tensor,            # [B, H, T, K]
    v: torch.Tensor,            # [B, H, T, V]
    log_w: torch.Tensor,        # [B, H, T, K]   log decay, <= 0
    *,
    u: Optional[torch.Tensor] = None,   # [H, K] RWKV "bonus" for current token
    chunk: int = 32,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, K, V]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, H, T, V], final_state [B, H, K, V]).

    T must be a multiple of ``min(chunk, T)``, as in the reference.
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"pad T={T} to a multiple of chunk={chunk}")
    NC = T // chunk

    f32 = torch.float32
    rc = r.reshape(B, H, NC, chunk, K).to(f32)
    kc = k.reshape(B, H, NC, chunk, K).to(f32)
    vc = v.reshape(B, H, NC, chunk, V).to(f32)
    lw = log_w.reshape(B, H, NC, chunk, K).to(f32)

    # W_t = sum_{s<=t} log w_s (inclusive); decay(s→t) for s < t is
    # exp(W_{t-1} − W_s), so kv_s enters the state undecayed
    Wc = torch.cumsum(lw, dim=-2)                                 # [B,H,NC,C,K]

    r_dec = rc * _safe_exp(Wc - lw)     # r_t ⊙ exp(W_{t-1})  (exclusive cumsum)
    k_dec = kc * _safe_exp(-Wc)         # k_s ⊙ exp(−W_s)     (inclusive)
    A = torch.einsum("bhntk,bhnsk->bhnts", r_dec, k_dec)
    idx = torch.arange(chunk, device=r.device)
    strict = idx[:, None] > idx[None, :]
    A = torch.where(strict, A, 0.0)
    o_intra = torch.einsum("bhnts,bhnsv->bhntv", A, vc)
    if u is not None:
        diag = torch.einsum("bhntk,hk,bhntk->bhnt", rc, u.to(f32), kc)
        o_intra = o_intra + diag[..., None] * vc

    # cross-chunk recurrence: state carried between chunks
    W_end = Wc[..., -1, :]                                        # [B,H,NC,K]
    r_in = rc * _safe_exp(Wc - lw)                                # decay from chunk start
    k_out = kc * _safe_exp(W_end[..., None, :] - Wc)              # decay to chunk end

    S = (
        torch.zeros((B * H, K, V), dtype=f32, device=r.device)
        if initial_state is None
        else initial_state.reshape(B * H, K, V).to(f32)
    )
    flat = lambda a: a.movedim(2, 0).reshape(NC, B * H, *a.shape[3:])
    r_in, k_out, vcf, w_end = flat(r_in), flat(k_out), flat(vc), flat(W_end)
    o_cross = []
    for n in range(NC):
        o_cross.append(torch.bmm(r_in[n], S))                     # "btk,bkv->btv"
        S = S * _safe_exp(w_end[n])[..., None] + torch.bmm(k_out[n].transpose(1, 2), vcf[n])
    o_cross = torch.stack(o_cross).reshape(NC, B, H, chunk, V).movedim(0, 2)
    out = (o_intra + o_cross).reshape(B, H, T, V)
    return out.to(r.dtype), S.reshape(B, H, K, V)


def linear_attention_decode(
    r: torch.Tensor,            # [B, H, K]
    k: torch.Tensor,            # [B, H, K]
    v: torch.Tensor,            # [B, H, V]
    log_w: torch.Tensor,        # [B, H, K]
    state: torch.Tensor,        # [B, H, K, V]
    *,
    u: Optional[torch.Tensor] = None,   # [H, K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token decode: O(1) state update."""
    f32 = torch.float32
    r32, k32, v32 = r.to(f32), k.to(f32), v.to(f32)
    kv = k32[..., :, None] * v32[..., None, :]                    # [B,H,K,V]
    if u is not None:
        att_state = state + u.to(f32)[None, :, :, None] * kv
    else:
        att_state = state
    out = torch.einsum("bhk,bhkv->bhv", r32, att_state)
    new_state = state * torch.exp(log_w.to(f32))[..., None] + kv
    return out.to(r.dtype), new_state
