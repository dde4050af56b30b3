"""RecurrentGemma family (arXiv:2402.19427; ``repro/models/rglru.py``): a
Griffin-style hybrid of RG-LRU recurrent layers and local
(sliding-window) attention, pattern (rec, rec, attn).

RG-LRU recurrence (diagonal):
    r_t = sigmoid(W_a y_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x y_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

Temporal-mixing block: gate branch (linear + gelu) * (linear -> causal
conv1d (width 4) -> RG-LRU) -> out projection; every layer is followed
by the SwiGLU MLP. 26 layers = 8 x (rec, rec, attn) + 2 trailing rec.

What the reference computes, not the published RecurrentGemma: no
embedding scale, a separate head, ``jax.nn.gelu``'s tanh approximation.

The reference stacks its G = num_layers // 3 groups and its trailing
rec layers on leading axes and scans them; here ``params["groups"]`` is
a list of G per-group dicts and ``params["trail"]`` a list of the
trailing layers, walked by Python loops. The decode cache keeps the
reference's stacked layout, batch on axis 1: {"groups": {"b0_rec": {"h"
(G, B, d_rnn) fp32, "conv" (G, B, W - 1, d_rnn)}, "b1_rec": ...,
"b2_attn": {"k", "v" (G, B, ring, Hk, hd), "len" (G, B)}}, "trail":
{"h", "conv" (n_trail, B, ...)}}, the rings of ``min(max_len,
local_window)`` positions. Decode writes each layer's slice of every
leaf in place (``copy_``; attention writes its ring rows itself), so a
captured graph reads and writes fixed buffers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, RunConfig

RGLRU_C = 8.0


def make_rec_layer(gen, cfg: ModelConfig, *, device, block_device) -> Any:
    """A recurrent layer: its projections (``wa``/``wx`` biased, the
    biases on ``device``) and MLP on ``block_device``; ``lam`` =
    softplus^-1(-log(u) / c), u ~ U[0.9, 0.999] (a ~ u at r = 1), the
    conv taps ``cw`` (W, d_rnn), ``cb`` and the norms on ``device``."""
    d, dr = cfg.d_model, cfg.d_rnn
    lin = lambda K, N, **kw: cm.make_linear(gen, K, N, device=block_device,
                                            **kw)
    u = torch.rand((dr,), generator=gen, device=device) * 0.099 + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    return {"norm": cm.make_rmsnorm(d, device),
            "gate_proj": lin(d, dr), "x_proj": lin(d, dr),
            "cw": torch.randn((cfg.conv_width, dr), generator=gen,
                              device=device) * 0.1,
            "cb": torch.zeros((dr,), device=device),
            "wa": lin(dr, dr, bias=True, bias_device=device),
            "wx": lin(dr, dr, bias=True, bias_device=device),
            "lam": lam,
            "out": lin(dr, d),
            "mlp_norm": cm.make_rmsnorm(d, device),
            "mlp": cm.make_mlp(gen, d, cfg.d_ff, block_device=block_device)}


def make_attn_layer(gen, cfg: ModelConfig, *, device, block_device) -> Any:
    return {"norm": cm.make_rmsnorm(cfg.d_model, device),
            "attn": cm.make_attention(gen, cfg, device=device,
                                      block_device=block_device),
            "mlp_norm": cm.make_rmsnorm(cfg.d_model, device),
            "mlp": cm.make_mlp(gen, cfg.d_model, cfg.d_ff,
                               block_device=block_device)}


def causal_conv1d(y: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor,
                  buf: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. y (B, S, dr); cw (W, dr); ``buf`` (B, W - 1,
    dr) the last W - 1 inputs before y (None: zeros). The W taps are
    summed in fp32 in tap order. Returns (out in y's dtype, the last W - 1
    inputs: the next call's ``buf``)."""
    S, W = y.shape[1], cw.shape[0]
    if buf is None:
        ypad = F.pad(y, (0, 0, W - 1, 0))
    else:
        ypad = torch.cat([buf.to(y.dtype), y], dim=1)
    out = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    for w in range(W):
        out = out + ypad[:, w:w + S].float() * cw[w][None, None, :]
    return (out + cb[None, None, :]).to(y.dtype), ypad[:, -(W - 1):]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 in log
    depth (Hillis-Steele doubling over the (a, b) pairs with the
    reference's ``combine``: (a1 a2, b1 a2 + b2)), without the cumulative
    product of ``a`` a closed form would take (it underflows fp32 within
    a long prompt). Returns the b part, h."""
    d, S = 1, a.shape[1]
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rg_lru(y: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
           lam: torch.Tensor, h0: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y/r/i (B, S, dr); h0 (B, dr) fp32. One step when S = 1 (decode:
    h = a h0 + sqrt(max(1 - a^2, 1e-12)) (i y), in the reference's
    operation order), else the log-depth scan (``_scan``) with h0 as its
    first element (a = 0). Returns (h (B, S, dr) fp32, h at the last
    position)."""
    log_a = -RGLRU_C * F.softplus(lam.float())[None, None, :] * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i.float() * y.float())
    if y.shape[1] == 1:
        hs = h0[:, None, :] * a + gated
    else:
        hs = _scan(torch.cat([torch.zeros_like(a[:, :1]), a], dim=1),
                   torch.cat([h0[:, None, :], gated], dim=1))[:, 1:]
    return hs, hs[:, -1]


def rec_layer_fwd(lp, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
                  cache: Optional[Dict] = None):
    """A recurrent layer then its MLP, from ``cache`` ({"h", "conv"}; None:
    zeros). ``wa``/``wx`` give fp32 gates. Returns (x, the new {"h",
    "conv"} in decode and prefill, else None)."""
    B = x.shape[0]
    xn = cm.rmsnorm(lp["norm"], x, cfg.norm_eps)
    gate = F.gelu(cm.linear(lp["gate_proj"], xn, rc), approximate="tanh")
    y = cm.linear(lp["x_proj"], xn, rc)
    y, new_buf = causal_conv1d(y, lp["cw"], lp["cb"],
                               None if cache is None else cache["conv"])
    r = torch.sigmoid(cm.linear(lp["wa"], y, rc, out_dtype=torch.float32))
    i = torch.sigmoid(cm.linear(lp["wx"], y, rc, out_dtype=torch.float32))
    h0 = (cache["h"] if cache is not None else
          torch.zeros((B, cfg.d_rnn), dtype=torch.float32, device=x.device))
    hs, h_last = rg_lru(y, r, i, lp["lam"], h0)
    x = x + cm.linear(lp["out"], hs.to(x.dtype) * gate, rc)
    h2 = cm.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    x = x + cm.mlp_fwd(lp["mlp"], h2, rc)
    if rc.mode not in ("decode", "prefill"):
        return x, None
    return x, {"h": h_last, "conv": new_buf.to(x.dtype)}


def attn_layer_fwd(lp, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig, *,
                   positions: torch.Tensor, cache: Optional[Dict] = None):
    """Local attention over a ring of ``local_window`` positions, then the
    MLP. Returns (x, attention's cache: the prefill's fresh {"k", "v",
    "len"}, or ``cache`` written in place in decode)."""
    h = cm.rmsnorm(lp["norm"], x, cfg.norm_eps)
    a, new_cache = cm.attention_fwd(lp["attn"], h, rc, cfg,
                                    positions=positions, cache=cache,
                                    window=cfg.local_window)
    x = x + a
    h = cm.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + cm.mlp_fwd(lp["mlp"], h, rc), new_cache


# ---------------------------------------------------------------------------
# The model: (rec, rec, attn) groups, then the trailing rec layers
# ---------------------------------------------------------------------------


def _split(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, trailing rec layers): (8, 2) for 26 layers."""
    period = len(cfg.rec_pattern)
    return cfg.num_layers // period, cfg.num_layers % period


def _blocks(cfg: ModelConfig):
    """(cache/param name, kind) of each layer of a group."""
    return [(f"b{i}_{kind}", kind) for i, kind in enumerate(cfg.rec_pattern)]


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                block_device) -> Any:
    """Dense params drawn from ``gen``: ``"groups"``, a list of G per-group
    dicts {"b0_rec", "b1_rec", "b2_attn"}, and ``"trail"``, a list of the
    trailing rec layers; the block linears on ``block_device``
    (``"meta"`` keeps only their shapes)."""
    n_groups, n_trail = _split(cfg)
    kw = {"device": device, "block_device": block_device}
    groups = [{name: (make_rec_layer if kind == "rec" else make_attn_layer)(
        gen, cfg, **kw) for name, kind in _blocks(cfg)}
        for _ in range(n_groups)]
    params = {"embedding": cm.make_embedding(gen, cfg.padded_vocab,
                                             cfg.d_model, device),
              "groups": groups,
              "final_norm": cm.make_rmsnorm(cfg.d_model, device),
              "lm_head": cm.make_linear(gen, cfg.d_model, cfg.padded_vocab,
                                        device=device)}
    if n_trail:
        params["trail"] = [make_rec_layer(gen, cfg, **kw)
                           for _ in range(n_trail)]
    return params


def _layer(kind, lp, x, rc, cfg, positions, cache):
    """One layer from ``cache`` (its slice of the stacked leaves; None:
    no state). A rec layer's new state is written back into the slice in
    place; attention writes its ring itself in decode."""
    if kind != "rec":
        return attn_layer_fwd(lp, x, rc, cfg, positions=positions,
                              cache=cache)
    x, nc = rec_layer_fwd(lp, x, rc, cfg, cache)
    if cache is not None and nc is not None:
        for leaf, t in nc.items():
            cache[leaf].copy_(t)
    return x, nc


def forward(params: Any, tokens: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig, *, positions: Optional[torch.Tensor] = None,
            caches: Optional[Any] = None) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> fp32 logits (B, S, padded_vocab) (prefill under
    ``rc.lm_head_last_only``: (B, 1, padded_vocab)) and the caches: a
    fresh stacked cache in prefill; ``caches`` updated in place when
    given; None otherwise."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = cm.embed(params["embedding"], tokens, cfg.act_dtype)
    segments = [("groups", params["groups"], _blocks(cfg))]
    if "trail" in params:
        segments.append(("trail", params["trail"], [(None, "rec")]))
    fresh: Dict[str, Any] = {}
    for seg, layers, blocks in segments:
        stacked = None if caches is None else caches[seg]

        def group_fwd(lp, x, g, blocks=blocks, stacked=stacked):
            new = {}
            for name, kind in blocks:
                node = (None if stacked is None else
                        stacked if name is None else stacked[name])
                cache = (None if node is None else
                         {n: t[g] for n, t in node.items()})
                x, new[name] = _layer(kind, lp if name is None else lp[name],
                                      x, rc, cfg, positions, cache)
            return x, new

        made = []
        group = (cm.remat_layer(group_fwd, rc) if seg == "groups"
                 else group_fwd)
        for g, lp in enumerate(layers):
            x, new = group(lp, x, g)
            made.append(new)
        if caches is None and rc.mode == "prefill":
            stack = lambda nodes: {n: torch.stack([c[n] for c in nodes])
                                   for n in nodes[0]}
            fresh[seg] = (stack([m[None] for m in made]) if seg == "trail"
                          else {name: stack([m[name] for m in made])
                                for name, _ in blocks})
    if rc.mode == "prefill" and rc.lm_head_last_only:
        x = x[:, -1:]  # skip the vocab projection of the prompt's tokens
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.lm_head(params["lm_head"], x, rc)
    if caches is not None:
        return logits, caches
    if rc.mode == "prefill":
        return logits, fresh
    return logits, None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict[str, Any]:
    """The stacked decode cache (module docstring), zeros, as the
    reference's ``init_cache`` makes it: fp32 ``h``, ``conv`` and the
    rings in ``dtype``, rings of ``min(max_len, local_window)``
    positions."""
    n_groups, n_trail = _split(cfg)
    W = min(max_len, cfg.local_window)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)

    def rec_state(L):
        return {"h": zeros(L, batch, cfg.d_rnn, dt=torch.float32),
                "conv": zeros(L, batch, cfg.conv_width - 1, cfg.d_rnn)}

    groups = {}
    for name, kind in _blocks(cfg):
        groups[name] = (rec_state(n_groups) if kind == "rec" else {
            "k": zeros(n_groups, batch, W, cfg.num_kv_heads, cfg.head_dim),
            "v": zeros(n_groups, batch, W, cfg.num_kv_heads, cfg.head_dim),
            "len": zeros(n_groups, batch, dt=torch.int32)})
    caches = {"groups": groups}
    if n_trail:
        caches["trail"] = rec_state(n_trail)
    return caches
