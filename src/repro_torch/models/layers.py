"""Shared neural layers: norms, RoPE, GQA attention (flash-style), MLPs.

Port of ``repro.models.layers``.  Functional style as in the reference: every
layer is ``*_init(gen, ...) -> params`` (a seeded ``torch.Generator`` takes
the place of the PRNG key; the tensors land on the generator's device) plus a
plain ``apply`` function over a dict of tensors.

Attention is the reference's chunked online-softmax ("flash") loop over KV
blocks in plain PyTorch ops, with the running max and denominator in float32
— no [T, T] score tensor and no library attention, so the port keeps the
reference's numerics.  The decode fast path is a separate masked softmax over
the whole cache (``_decode_attention``), as in the reference.

Port-only: the ``*_tp`` functions and :func:`embed`/:func:`unembed` on
vocabulary blocks run a layer tensor-parallel over model shards, where the
reference leaves the split to XLA's partitioner (``launch/sharded.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.util.costs import move

Params = Dict[str, Any]

DEFAULT_KV_CHUNK = 1024


def param_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws from ``gen`` (float32), scaled, then cast."""
    out = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def uniform(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform [0, 1) draws from ``gen`` (float32), then cast."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype)


def embed_init(gen, vocab: int, dim: int, dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # normalised in f32, cast back to x's dtype, and only then scaled
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"]


def layernorm_init(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * params["scale"] + params["bias"]


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """``1 / theta ** (i / head_dim)`` for even i, float32: the exponent in
    float32 as the reference writes it, the power and the reciprocal in
    float64 and rounded once, which is the constant XLA folds the
    reference's expression to under ``jax.jit`` (two float32 roundings, as
    the reference gives run eagerly, land one ulp off at some i)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return (1.0 / theta ** exponent.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T].  Half-split halves, f32 angles."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)                      # [Dh/2]
    angles = positions[..., :, None, None].float() * freqs               # [..., T, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_init(
    gen,
    d_model: int,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    qkv_bias: bool = False,
    dtype=torch.float32,
) -> Params:
    p: Params = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, kv_heads * head_dim, dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((num_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv_heads * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv_heads * head_dim,), dtype=dtype, device=dev)
    return p


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, Hkv, Dh] → [B, T, Hkv*groups, Dh] (GQA broadcast)."""
    if groups == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, groups, d).reshape(b, t, h * groups, d)


def flash_attention(
    q: torch.Tensor,            # [B, Tq, H, Dh]
    k: torch.Tensor,            # [B, Tk, H, Dh]
    v: torch.Tensor,            # [B, Tk, H, Dh]
    *,
    causal: bool = True,
    q_offset=0,
    kv_chunk: int = DEFAULT_KV_CHUNK,
    kv_valid_len=None,
) -> torch.Tensor:
    """Chunked online-softmax attention (no [Tq, Tk] materialisation).

    ``q_offset`` is the absolute position of q[0] (for causal masking of
    decode steps). ``kv_valid_len`` masks cache padding during decode.
    """
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    q32 = q.float() * scale
    kv_chunk = min(kv_chunk, Tk)
    num_chunks = -(-Tk // kv_chunk)
    Tk_pad = num_chunks * kv_chunk
    if Tk_pad != Tk:
        k = F.pad(k, (0, 0, 0, 0, 0, Tk_pad - Tk))
        v = F.pad(v, (0, 0, 0, 0, 0, Tk_pad - Tk))

    q_pos = q_offset + torch.arange(Tq, device=dev)
    valid_len = Tk if kv_valid_len is None else kv_valid_len
    m = torch.full((B, H, Tq), -math.inf, device=dev)
    l = torch.zeros((B, H, Tq), device=dev)
    acc = torch.zeros((B, H, Tq, Dh), device=dev)
    for c in range(num_chunks):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb)              # [B, H, Tq, C]
        mask = kv_pos[None, :] < valid_len
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked blocks
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                          # [B, Tq, H, Dh]


def _decode_attention(
    q: torch.Tensor,          # [B, 1, H, Dh]
    k: torch.Tensor,          # [B, S, Hkv, Dh]
    v: torch.Tensor,          # [B, S, Hkv, Dh]
    groups: int,
    valid_len,
) -> torch.Tensor:
    """Single-token attention over the full cache (no chunk loop)."""
    B, S, Hkv, Dh = k.shape
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Hkv, groups, Dh).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    mask = torch.arange(S, device=q.device) < valid_len
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, 1, Hkv * groups, Dh).to(q.dtype)


def cache_write_start(cache_index: int, T: int, max_len: int) -> int:
    """Start row of a T-row cache write at ``cache_index``, clamped into
    [0, max_len - T] as ``jax.lax.dynamic_update_slice`` clamps it."""
    return min(max(cache_index, 0), max_len - T)


def attention_apply(
    params: Params,
    x: torch.Tensor,                    # [B, T, D]
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,
    rope_theta: float = 10000.0,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    kv_chunk: int = DEFAULT_KV_CHUNK,
    decode_fastpath: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention. With ``cache`` given, runs a decode/prefill cache update.

    The new K/V rows are written into ``cache``'s tensors in place (the
    reference donates the cache to its decode step) and the same tensors are
    returned.  ``cache_index`` is a Python int; a tensor is read to the host.
    """
    return _attend(params, x @ params["wq"], x @ params["wk"], x @ params["wv"],
                   num_heads=num_heads, kv_heads=kv_heads, head_dim=head_dim,
                   positions=positions, rope_theta=rope_theta, causal=causal, cache=cache,
                   cache_index=cache_index, kv_chunk=kv_chunk, decode_fastpath=decode_fastpath)


def _attend(params: Params, q, k, v, *, num_heads: int, kv_heads: int, head_dim: int,
            positions: torch.Tensor, rope_theta: float = 10000.0, causal: bool = True,
            cache=None, cache_index=None, kv_chunk: int = DEFAULT_KV_CHUNK,
            decode_fastpath: bool = True, partial: bool = False):
    """:func:`attention_apply` after the q/k/v projections ([B, T, heads ×
    head_dim] each).  With ``partial`` the output projection's result is
    float32, unrounded (:func:`row_partial`: ``wo`` is one row block of
    tensor parallelism)."""
    B, T = q.shape[:2]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, T, num_heads, head_dim)
    k = k.reshape(B, T, kv_heads, head_dim)
    v = v.reshape(B, T, kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    groups = num_heads // kv_heads
    new_cache = None
    if cache is not None:
        # write new kv at cache_index, attend over the whole (masked) cache
        idx = int(cache_index) if cache_index is not None else 0
        ck, cv = cache["k"], cache["v"]
        start = cache_write_start(idx, T, ck.shape[1])
        ck[:, start:start + T] = k.to(ck.dtype)
        cv[:, start:start + T] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        valid = idx + T
        if T == 1 and decode_fastpath:
            out = _decode_attention(q, ck, cv, groups, valid)
        else:
            out = flash_attention(
                q, _repeat_kv(ck, groups), _repeat_kv(cv, groups),
                causal=causal, q_offset=idx, kv_chunk=kv_chunk, kv_valid_len=valid,
            )
    else:
        out = flash_attention(
            q, _repeat_kv(k, groups), _repeat_kv(v, groups),
            causal=causal, kv_chunk=kv_chunk,
        )
    out = _project(out.reshape(B, T, num_heads * head_dim), params["wo"], partial)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model: int, d_ff: int, gated: bool = True, dtype=torch.float32) -> Params:
    w_in = dense_init(gen, d_model, d_ff, dtype)
    w_gate = dense_init(gen, d_model, d_ff, dtype) if gated else None
    p = {"w_in": w_in, "w_out": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = w_gate
    return p


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w_in"]
    return _mlp_out(params, h, x @ params["w_gate"] if "w_gate" in params else None)


def _mlp_out(params: Params, h: torch.Tensor, gate: Optional[torch.Tensor],
             partial: bool = False) -> torch.Tensor:
    """:func:`mlp_apply` after the input projections ``h`` (and ``gate``);
    with ``partial`` the output float32, unrounded (:func:`row_partial`:
    ``w_out`` is one row block of tensor parallelism)."""
    if gate is not None:
        h = F.silu(gate) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default form
    return _project(h, params["w_out"], partial)


def _project(h: torch.Tensor, w: torch.Tensor, partial: bool) -> torch.Tensor:
    return row_partial(h, w) if partial else h @ w


# ---------------------------------------------------------------------------
# tensor parallelism: one block of a weight on each model shard
# ---------------------------------------------------------------------------


def is_tp(w) -> bool:
    """Whether a weight (or a cache leaf) comes as one block per model shard,
    each on its shard's device (a tuple, from the sharded executor's gather,
    ``launch/sharded.py::unit_gather``), rather than whole."""
    return isinstance(w, tuple)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D tensors with a float32 result: of narrower inputs the
    products accumulate in float32 and the result is not rounded."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":          # no mm with a wider output there
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _RowPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        out = _mm_f32(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)       # exact: tp_reduce's backward widened a narrow gradient
        gh = g @ w.T if ctx.needs_input_grad[0] else None
        gw = (h.reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gh, gw


def row_partial(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a row block ``w`` of tensor parallelism, as a float32
    partial sum: of narrower inputs the products accumulate in float32 and
    the result is not rounded, so that :func:`tp_reduce` rounds the sum over
    the shards once, as one device's ``h @ w`` rounds once.  The backward is
    one device's (its gradients at the inputs' dtype).  Of float32 inputs,
    ``h @ w`` itself."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    return _RowPartial.apply(h, w)


class _Columns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, *ws):
        ctx.set_materialize_grads(False)
        flat = x.reshape(-1, x.shape[-1])
        xs = [move(flat, ws[i].device, "all-reduce") for i in range(0, len(ws), n)]
        ctx.n, ctx.shape, ctx.src = n, x.shape, x.device
        ctx.save_for_backward(*xs, *ws)
        return tuple((xm @ w).reshape(*x.shape[:-1], w.shape[-1])
                     for i, xm in enumerate(xs) for w in ws[i * n:(i + 1) * n])

    @staticmethod
    def backward(ctx, *gs):
        n, saved = ctx.n, ctx.saved_tensors
        xs, ws = saved[:len(saved) // (n + 1)], saved[len(saved) // (n + 1):]
        sums, gws = [None] * n, []        # per weight of a shard, over the shards
        for i, xm in enumerate(xs):
            for j in range(n):
                g = gs[i * n + j]
                g = None if g is None else g.reshape(-1, g.shape[-1])
                gws.append(xm.T @ g if g is not None and ctx.needs_input_grad[2 + i * n + j]
                           else None)
                if g is not None:
                    p = move(_mm_f32(g, ws[i * n + j].T), ctx.src, "all-reduce")
                    sums[j] = p if sums[j] is None else sums[j] + p
        # each weight's sum rounded once, then added as one device's autograd
        # adds the gradients of one input's uses: the last use's first
        gx = None
        for p in reversed([p for p in sums if p is not None]):
            p = p.to(xs[0].dtype)
            gx = p if gx is None else gx + p
        gx = None if gx is None else gx.reshape(ctx.shape)
        return (gx, None, *gws)


def tp_columns(x: torch.Tensor, blocks) -> list:
    """``x`` (on the reducing device) multiplied on each model shard by that
    shard's column blocks (``blocks[m]``, a tuple of weights on its device):
    a list, per shard, of the tuple of products.  ``x`` goes to each shard
    once: the broadcast half of the all-reduce that :func:`tp_reduce` begins
    (the residual add and the norm run once, on the reducing device, between
    the two halves).  In the backward, the input gradient of each block
    ``blocks[m][j]`` comes to ``x``'s device float32 and unrounded; those of
    block j are summed over the shards in float32 in shard order and cast
    once, as the forward's partial sums are, and the n sums are added at
    ``x``'s dtype as one device's autograd adds the input gradients of its
    n matmuls on ``x``: the layer rounds where one device's layer rounds.
    The weights get their own gradients."""
    n = len(blocks[0])
    out = _Columns.apply(x, n, *(w for ws in blocks for w in ws))
    return [out[m * n:(m + 1) * n] for m in range(len(blocks))]


def tp_reduce(parts, device, dtype) -> torch.Tensor:
    """The model shards' partial outputs moved to ``device`` and summed there
    in shard order in float32, then cast once to ``dtype``: the reduce half
    of an all-reduce.  The row blocks' partials come as float32
    (:func:`row_partial`) and move so; the embedding's, at their own dtype
    (each is a block's rows or zeros, so its sum is exact)."""
    acc = None
    for p in parts:
        p = move(p, device, "all-reduce")
        # a float32 sum and a narrower part add in float32 (the part widened exactly)
        acc = p.float() if acc is None else acc + p
    return acc if acc.dtype == dtype else acc.to(dtype)


def head_slice(t: torch.Tensor, m: int, n: int, device, dim: int = 0) -> torch.Tensor:
    """Model shard m's slice, entries [m·n, (m+1)·n) along ``dim``, of a
    tensor whole on the reducing device (a per-head vector or state that the
    reference replicates over ``model``), moved to the shard's ``device``:
    its part of the gather of that tensor, whose gradient's way back is a
    reduce-scatter."""
    return move(t.narrow(dim, m * n, n), device, "all-gather", "reduce-scatter")


def gather_heads(states, device) -> torch.Tensor:
    """The model shards' new recurrent states of their heads (dimension 1,
    in shard order) whole on ``device``: an all-gather."""
    return torch.cat([move(s, device, "all-gather") for s in states], 1)


def _blocks(params: Params, m: int) -> Params:
    return {k: v[m] for k, v in params.items()}


def attention_apply_tp(params: Params, x: torch.Tensor, *, num_heads: int, kv_heads: int,
                       positions: torch.Tensor, cache=None, **kw):
    """:func:`attention_apply` with ``params`` as column blocks (``wq``,
    ``wk``, ``wv``, the biases: whole heads and GQA groups) and row blocks
    (``wo``), one per model shard: each shard attends over its
    ``num_heads/M`` heads and ``kv_heads/M`` kv heads on its device, against
    its piece of the cache (``cache["k"][m]``, written in place), and the
    partial outputs are summed on ``x``'s device (:func:`tp_reduce`).
    Returns (output, cache as per-shard tuples)."""
    M = len(params["wq"])
    outs, caches = [], []
    qkv = tp_columns(x, list(zip(params["wq"], params["wk"], params["wv"])))
    for m, (q, k, v) in enumerate(qkv):
        out, c = _attend(
            _blocks(params, m), q, k, v, num_heads=num_heads // M, kv_heads=kv_heads // M,
            positions=move(positions, q.device, "all-gather"),
            cache=None if cache is None else _blocks(cache, m), partial=True, **kw)
        outs.append(out)
        caches.append(c)
    new = None if cache is None else {k: tuple(c[k] for c in caches) for k in ("k", "v")}
    return tp_reduce(outs, x.device, x.dtype), new


def mlp_apply_tp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_apply` with ``w_in``/``w_gate`` as column blocks and
    ``w_out`` as row blocks, one per model shard, each shard's slice of the
    ffn on its device; the partial outputs summed on ``x``'s device."""
    gated = "w_gate" in params
    cols = tp_columns(x, list(zip(params["w_in"], params["w_gate"])) if gated
                      else [(w,) for w in params["w_in"]])
    parts = [_mlp_out(_blocks(params, m), c[0], c[1] if gated else None, partial=True)
             for m, c in enumerate(cols)]
    return tp_reduce(parts, x.device, x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed(embedding, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding [V, D].  Of vocabulary blocks (one per
    model shard), each shard looks up the tokens in its block, masked to
    zero outside it, and the partials are summed on the tokens' device (one
    block holds each token, so the sum is exact)."""
    if not is_tp(embedding):
        return embedding[tokens.long()]
    parts, start = [], 0
    for e in embedding:
        n = e.shape[0]
        local = move(tokens, e.device, "all-gather") - start
        row = local.clamp(0, n - 1)
        parts.append(e[row] * (row == local)[..., None])
        start += n
    return tp_reduce(parts, tokens.device, embedding[0].dtype)


def unembed(x: torch.Tensor, embedding) -> torch.Tensor:
    """Tied unembedding: [B, T, D] × [V, D]^T → logits.  Of vocabulary blocks
    (one per model shard), each shard's logits for its block, concatenated
    on ``x``'s device (an all-gather)."""
    if not is_tp(embedding):
        return x @ embedding.T
    parts = tp_columns(x, [(e.t(),) for e in embedding])
    return torch.cat([move(p, x.device, "all-gather", "reduce-scatter") for (p,) in parts], dim=-1)
