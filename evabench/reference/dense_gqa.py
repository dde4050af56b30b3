"""Plain reference of a dense decoder with grouped-query attention, as
Qwen2 and Qwen3 publish it (hf ``Qwen2ForCausalLM``, ``Qwen3ForCausalLM``):

    x = embed[tokens]
    each layer:
        h = rmsnorm(x) * attn_norm
        q, k, v = h Wq (+ bq), h Wk (+ bk), h Wv (+ bv)     (qkv_bias)
        q, k = rmsnorm_head(q) * q_norm, rmsnorm_head(k) * k_norm   (qk_norm)
        q, k = rope(q), rope(k)        (rotate-half, theta = rope_theta)
        x = x + softmax(q k^T / sqrt(hd), causal) v  Wo   (kv heads shared
                                                          by groups of q heads)
        h = rmsnorm(x) * mlp_norm
        x = x + (silu(h Wgate) * (h Wup)) Wdown
    logits = (rmsnorm(x) * final_norm) Whead       (Whead = embed^T if tied)

in fp32 with TF32 off, every position of every sequence recomputed from
its tokens (no cache, no batching across a sequence's positions). The
block weights are rebuilt dense from the drawn VQ indices, codebooks and
scales, one layer at a time and in blocks of columns, so the whole
model is never dense at once. The sequences' tokens are stacked into one
matrix for the linears and attend one sequence at a time.

``precisions`` runs further copies of the residual stream beside the fp32
one through the same rebuilt weights, each computed in a lower
precision: both operands of every linear and of the head, and the
residual stream after every add, rounded to it before fp32 arithmetic.
"fp8" (float8 e4m3 under a per-row absmax scale on activations and the
stream, a per-column one on weights) is the control, the computation one
step below the configuration's bf16; "bf16" is a plain computation at
the configuration's own precision, a witness of what bf16 rounding
alone does to the logits.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

E4M3_MAX = 448.0
COLS = 16384         # columns of a dense weight rebuilt at once


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under an absmax scale over ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def dense(lin: Dict[str, torch.Tensor], layer: int, lo: int,
          hi: int) -> torch.Tensor:
    """Columns [lo, hi) of layer ``layer``'s weight (K, hi - lo), fp32:
    W[v d + e, j] = scale[j] sum_c codebooks[c, e, idx[c, v, j]]."""
    idx = lin["idx"][layer][:, :, lo:hi].long()             # (C, V, n)
    cb = lin["codebooks"][layer].float()                     # (C, d, 256)
    C, V, n = idx.shape
    d = cb.shape[1]
    w = torch.zeros((V, d, n), dtype=torch.float32, device=idx.device)
    for c in range(C):
        w += cb[c][:, idx[c]].permute(1, 0, 2)               # (V, d, n)
    return w.reshape(V * d, n) * lin["scale"][layer][lo:hi].float()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _product(p: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in precision ``p``, accumulated in fp32."""
    if p == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    if p == "bf16":
        return _bf16(x) @ _bf16(w)
    return x @ w


def _linear(xs: Dict[str, torch.Tensor], lin, layer: int,
            bias=None) -> Dict[str, torch.Tensor]:
    N = lin["scale"].shape[-1]
    outs = {p: [] for p in xs}
    for lo in range(0, N, COLS):
        hi = min(N, lo + COLS)
        w = dense(lin, layer, lo, hi)
        for p, x in xs.items():
            outs[p].append(_product(p, x, w))
        del w
    ys = {p: torch.cat(v, dim=-1) for p, v in outs.items()}
    if bias is not None:
        ys = {p: y + bias.float() for p, y in ys.items()}
    return ys


def _residual(p: str, x: torch.Tensor) -> torch.Tensor:
    if p == "fp8":
        return _fp8(x, -1)
    return _bf16(x) if p == "bf16" else x


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) at positions 0..T-1, rotate-half."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, groups: int) -> torch.Tensor:
    """Causal attention of one sequence: q (T, H, hd), k/v (T, Hk, hd)."""
    T, H, hd = q.shape
    Hk = k.shape[1]
    qg = q.reshape(T, Hk, groups, hd)
    s = torch.einsum("thgd,shd->hgts", qg, k) / math.sqrt(hd)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("hgts,shd->thgd", torch.softmax(s, dim=-1), v)
    return o.reshape(T, H * hd)


def logits(cfg: Dict, w: Dict, seqs: Sequence[torch.Tensor],
           starts: Sequence[int], precisions: Sequence[str] = ("fp32",)
           ) -> Dict[str, List[torch.Tensor]]:
    """fp32 logits over the vocabulary at positions starts[i].. of each
    sequence (seqs[i]: int64 token ids on the weights' device), by
    precision: {"fp32": [(len_i - starts[i], vocab), ...], "fp8": ...}."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(cfg, w, seqs, starts, precisions)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits(cfg, w, seqs, starts, precisions):
    L, eps = cfg["num_hidden_layers"], cfg["rms_norm_eps"]
    H, Hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    q_dim, kv_dim = H * hd, Hk * hd
    lens = [int(s.shape[0]) for s in seqs]
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + n)
    tokens = torch.cat(list(seqs))
    x0 = w["embed"][tokens].float()
    xs = {p: _residual(p, x0.clone()) for p in precisions}
    del x0
    for layer in range(L):
        hs = {p: _rmsnorm(x, w["attn_norm"][layer], eps) for p, x in xs.items()}
        bias = w["qkv_bias"][layer] if cfg["qkv_bias"] else None
        qkv = _linear(hs, w["wqkv"], layer, bias)
        att = {}
        for p, y in qkv.items():
            q = y[:, :q_dim].reshape(-1, H, hd)
            k = y[:, q_dim:q_dim + kv_dim].reshape(-1, Hk, hd)
            v = y[:, q_dim + kv_dim:].reshape(-1, Hk, hd)
            if cfg["qk_norm"]:
                q = _rmsnorm(q, w["q_norm"][layer], eps)
                k = _rmsnorm(k, w["k_norm"][layer], eps)
            outs = []
            for a, b in zip(offs, offs[1:]):
                outs.append(_attention(_rope(q[a:b], cfg["rope_theta"]),
                                       _rope(k[a:b], cfg["rope_theta"]),
                                       v[a:b], H // Hk))
            att[p] = torch.cat(outs)
        del qkv
        o = _linear(att, w["wo"], layer)
        xs = {p: _residual(p, xs[p] + o[p]) for p in xs}
        del att, o
        hs = {p: _rmsnorm(x, w["mlp_norm"][layer], eps) for p, x in xs.items()}
        gu = _linear(hs, w["gu"], layer)
        ff = cfg["intermediate_size"]
        act = {p: torch.nn.functional.silu(y[:, :ff]) * y[:, ff:]
               for p, y in gu.items()}
        del gu, hs
        down = _linear(act, w["down"], layer)
        xs = {p: _residual(p, xs[p] + down[p]) for p in xs}
        del act, down
    want = torch.cat([torch.arange(a + s, b, device=tokens.device)
                      for a, b, s in zip(offs, offs[1:], starts)])
    head = (w["embed"].t() if w["head"] is None else w["head"]).float()
    head = head[:, :cfg["vocab_size"]]
    out = {}
    for p, x in xs.items():
        h = _rmsnorm(x[want], w["final_norm"], eps)
        z = _product(p, h, head)
        n = [b - a - s for a, b, s in zip(offs, offs[1:], starts)]
        out[p] = list(torch.split(z, n))
    return out
