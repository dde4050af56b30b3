"""Llama-3.2-Vision family (``repro/models/vision.py``): a GQA decoder in
which every ``cross_attn_period``-th layer is a gated cross-attention
layer over image patch embeddings.

What the reference computes, not the published model: the vision tower
is a stub, one biased (d_model, d_model) projection (``img_proj``) of
precomputed patch embeddings (B, n_img, d_model), applied once a
forward. A self layer is RMSNorm, rope attention over the self cache and
the SwiGLU MLP. A cross layer computes its own q, k and v: q from the
text stream and k, v from the projected image, both q and k normalized
per head (``qnorm``/``knorm``), attended without rope or a causal mask;
its attention and MLP outputs are added through ``tanh`` of the scalar
fp32 gates ``attn_gate`` and ``mlp_gate`` (zero at init, as the
reference's: a freshly drawn model ignores the image). Decode attends
the cached image keys and values over ``xlen`` in plain torch, as the
reference's ``decode_attention`` does.

The reference stacks its G = num_layers // cross_attn_period groups
(``self0`` ... ``self{period-2}``, then ``cross``) and scans them; here
``params["groups"]`` is a list of G per-group dicts walked by a Python
loop. The decode cache keeps the reference's stacked layout, batch on
axis 1: {"self{i}": {"k", "v" (G, B, max_len, Hk, hd), "len" (G, B)},
"cross": {"xk", "xv" (G, B, N_IMG_TOKENS, Hk, hd), "xlen" (G, B)}}. A
prefill returns image memories of as many rows as the image (the keys
already normalized) with ``xlen`` that count; the engine writes them at
rows [0, n_img) of a slot (``init_cache`` sets ``xlen`` to N_IMG_TOKENS
on every slot, as the reference's). Decode writes the self-attention
rows in place and reads the memories only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, RunConfig

# the image memory a cache holds: one tile's patch embeddings
N_IMG_TOKENS = 1601


def _self_names(cfg: ModelConfig) -> Tuple[str, ...]:
    return tuple(f"self{i}" for i in range(cfg.cross_attn_period - 1))


def _init_self_layer(gen, cfg: ModelConfig, **kw) -> Any:
    return {"attn_norm": cm.make_rmsnorm(cfg.d_model, kw["device"]),
            "attn": cm.make_attention(gen, cfg, **kw),
            "mlp_norm": cm.make_rmsnorm(cfg.d_model, kw["device"]),
            "mlp": cm.make_mlp(gen, cfg.d_model, cfg.d_ff,
                               block_device=kw["block_device"])}


def _init_cross_layer(gen, cfg: ModelConfig, **kw) -> Any:
    dev = kw["device"]
    return {"attn_norm": cm.make_rmsnorm(cfg.d_model, dev),
            "xattn": cm.make_attention(gen, cfg, **kw),
            "attn_gate": torch.zeros((), device=dev),
            "mlp_norm": cm.make_rmsnorm(cfg.d_model, dev),
            "mlp": cm.make_mlp(gen, cfg.d_model, cfg.d_ff,
                               block_device=kw["block_device"]),
            "mlp_gate": torch.zeros((), device=dev),
            "qnorm": cm.make_rmsnorm(cfg.head_dim, dev),
            "knorm": cm.make_rmsnorm(cfg.head_dim, dev)}


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                block_device) -> Any:
    """Dense params drawn from ``gen``: the embedding, ``img_proj``, the
    ``"groups"`` list of G per-group dicts (the self layers, then
    ``cross``), the final norm and the head; the block linears on
    ``block_device`` (``"meta"`` keeps only their shapes), everything
    else on ``device``."""
    period = cfg.cross_attn_period
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not "
                         f"a multiple of cross_attn_period {period}")
    kw = {"device": device, "block_device": block_device}
    d = cfg.d_model

    def group():
        g = {name: _init_self_layer(gen, cfg, **kw)
             for name in _self_names(cfg)}
        g["cross"] = _init_cross_layer(gen, cfg, **kw)
        return g

    return {"embedding": cm.make_embedding(gen, cfg.padded_vocab, d, device),
            "img_proj": cm.make_linear(gen, d, d, device=device, bias=True),
            "groups": [group() for _ in range(cfg.num_layers // period)],
            "final_norm": cm.make_rmsnorm(d, device),
            "lm_head": cm.make_linear(gen, d, cfg.padded_vocab,
                                      device=device)}


def _self_fwd(lp: Any, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
              positions: torch.Tensor, cache: Optional[Dict]
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = cm.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a, nc = cm.attention_fwd(lp["attn"], h, rc, cfg, positions=positions,
                             cache=cache)
    x = x + a
    h = cm.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + cm.mlp_fwd(lp["mlp"], h, rc), nc


def _cross_fwd(lp: Any, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
               img: Optional[torch.Tensor], cache: Optional[Dict]
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The gated cross-attention layer. Decode (over ``cache``) attends
    the cached memories over ``xlen``; otherwise k and v come from the
    projected image ``img`` (B, n_img, d_model), and a prefill returns
    them as the layer's fresh memories ({"xk", "xv", "xlen"})."""
    B, S, _ = x.shape
    H, Hk, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.norm_eps
    h = cm.rmsnorm(lp["attn_norm"], x, eps)
    q = cm.linear(lp["xattn"]["wq"], h, rc).reshape(B, S, H, hd)
    q = cm.rmsnorm(lp["qnorm"], q, eps)
    new_cache = None
    if rc.mode == "decode" and cache is not None:
        o = cm.decode_attention(q, cache["xk"], cache["xv"], cache["xlen"])
        new_cache = cache
    else:
        k = cm.linear(lp["xattn"]["wk"], img, rc).reshape(B, -1, Hk, hd)
        k = cm.rmsnorm(lp["knorm"], k, eps)
        v = cm.linear(lp["xattn"]["wv"], img, rc).reshape(B, -1, Hk, hd)
        o = cm.blocked_attention(q, k, v, causal=False, chunk=rc.attn_chunk)
        if rc.mode == "prefill":
            new_cache = {"xk": k, "xv": v,
                         "xlen": torch.full((B,), k.shape[1],
                                            dtype=torch.int32,
                                            device=x.device)}
    a = cm.linear(lp["xattn"]["wo"], o.reshape(B, S, H * hd), rc)
    x = x + torch.tanh(lp["attn_gate"]).to(x.dtype) * a
    h = cm.rmsnorm(lp["mlp_norm"], x, eps)
    f = cm.mlp_fwd(lp["mlp"], h, rc)
    return x + torch.tanh(lp["mlp_gate"]).to(x.dtype) * f, new_cache


def _stack(nodes) -> Dict[str, torch.Tensor]:
    return {n: torch.stack([c[n] for c in nodes]) for n in nodes[0]}


def forward(params: Any, tokens: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig, *, image_embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Any] = None) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> fp32 logits (B, S, padded_vocab) (prefill under
    ``rc.lm_head_last_only``: (B, 1, padded_vocab)) and the caches.
    ``image_embeds`` (B, n_img, d_model) go through ``img_proj`` once; a
    decode passes none. A prefill without ``caches`` returns a fresh
    stacked cache; a decode updates ``caches`` in place and returns it; a
    prefill over a paged slot view (a chunked-prefill continuation,
    ``serve/paging.slot_view``) writes the view's self-attention in place
    and returns it beside the fresh image memories (``paging.merge_slot``
    writes them at rows [0, n_img) of the slot); None otherwise."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = cm.embed(params["embedding"], tokens, cfg.act_dtype)
    img = None
    if image_embeds is not None:
        img = cm.linear(params["img_proj"], image_embeds.to(cfg.act_dtype), rc)
    names = _self_names(cfg)
    at = lambda g, node: None if caches is None else {
        n: t[g] for n, t in caches[node].items()}

    def group_fwd(gp, x, img, g):
        new = {}
        for name in names:
            x, new[name] = _self_fwd(gp[name], x, rc, cfg, positions,
                                     at(g, name))
        x, new["cross"] = _cross_fwd(gp["cross"], x, rc, cfg, img,
                                     at(g, "cross"))
        return x, new

    made = []
    group = cm.remat_layer(group_fwd, rc)
    for g, gp in enumerate(params["groups"]):
        x, new = group(gp, x, img, g)
        made.append(new)
    if rc.mode == "prefill" and rc.lm_head_last_only:
        x = x[:, -1:]  # skip the vocab projection of the prompt's tokens
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.lm_head(params["lm_head"], x, rc)
    if rc.mode != "prefill":
        return logits, caches
    cross = _stack([m["cross"] for m in made])
    if caches is not None:
        return logits, {**{n: caches[n] for n in names}, "cross": cross}
    return logits, {**{n: _stack([m[n] for m in made]) for n in names},
                    "cross": cross}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict[str, Any]:
    """The stacked decode cache (module docstring), zeros but ``xlen`` =
    N_IMG_TOKENS on every slot, as the reference's ``init_cache`` makes
    it."""
    G, Hk, hd = (cfg.num_layers // cfg.cross_attn_period, cfg.num_kv_heads,
                 cfg.head_dim)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    caches = {name: {"k": zeros(G, batch, max_len, Hk, hd),
                     "v": zeros(G, batch, max_len, Hk, hd),
                     "len": torch.zeros((G, batch), dtype=torch.int32,
                                        device=device)}
              for name in _self_names(cfg)}
    caches["cross"] = {"xk": zeros(G, batch, N_IMG_TOKENS, Hk, hd),
                       "xv": zeros(G, batch, N_IMG_TOKENS, Hk, hd),
                       "xlen": torch.full((G, batch), N_IMG_TOKENS,
                                          dtype=torch.int32, device=device)}
    return caches
