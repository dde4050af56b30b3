"""Decoder-only transformer, the dense and MoE families
(``repro/models/transformer.py`` without MLA and ``first_dense_layers``).
A MoE config (``family="moe"``) has a ``"moe"`` node in each layer in
place of ``"mlp"``; a config with ``sliding_window`` attends within the
window and decodes over ring caches of ``min(max_len, window)``
positions. The reference scans a stacked layer axis; here
``params["layers"]`` is a list of per-layer dicts walked by a Python
loop, and the decode cache keeps the reference's stacked layout
``{"body": {"k": (L, B, S, Hk, hd), "v": ..., "len": (L, B)}}`` (plus
``k_s``/``v_s`` (L, B, S, Hk) scale leaves for the int8 and KV-VQ
layouts) so each layer reads and updates its slice in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.vq import KVQuantConfig
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, RunConfig


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                block_device) -> Any:
    """Dense params drawn from ``gen``; the block linears (the experts
    included) go to ``block_device`` (``"meta"`` keeps only their
    shapes)."""
    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "attn_norm": cm.make_rmsnorm(cfg.d_model, device),
            "mlp_norm": cm.make_rmsnorm(cfg.d_model, device),
            "attn": cm.make_attention(gen, cfg, device=device,
                                      block_device=block_device),
        }
        if cfg.family == "moe":
            layer["moe"] = cm.make_moe(gen, cfg, device=device,
                                       block_device=block_device)
        else:
            layer["mlp"] = cm.make_mlp(gen, cfg.d_model, cfg.d_ff,
                                       block_device=block_device)
        layers.append(layer)
    params = {
        "embedding": cm.make_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                       device),
        "layers": layers,
        "final_norm": cm.make_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.make_linear(gen, cfg.d_model, cfg.padded_vocab,
                                           device=device)
    return params


def _layer_fwd(lp: Any, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig, *,
               positions: torch.Tensor, cache: Optional[Dict]
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = cm.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a, new_cache = cm.attention_fwd(lp["attn"], h, rc, cfg, positions=positions,
                                    cache=cache, window=cfg.sliding_window)
    x = x + a
    h = cm.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if "moe" in lp:
        return x + cm.moe_fwd(lp["moe"], h, rc, cfg), new_cache
    return x + cm.mlp_fwd(lp["mlp"], h, rc), new_cache


def forward(params: Any, tokens: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig, *, positions: Optional[torch.Tensor] = None,
            caches: Optional[Any] = None) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> fp32 logits (B, S, padded_vocab) and the caches:
    a fresh stacked cache in prefill; ``caches`` updated in place in
    decode, and in prefill over a paged slot view (a chunked-prefill
    continuation, ``serve/paging.slot_view``); None otherwise."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = cm.embed(params["embedding"], tokens, cfg.act_dtype)
    body = None if caches is None else caches["body"]
    fresh = []
    for i, lp in enumerate(params["layers"]):
        cache = None if body is None else {n: t[i] for n, t in body.items()}
        x, nc = _layer_fwd(lp, x, rc, cfg, positions=positions, cache=cache)
        if body is None and nc is not None:
            fresh.append(nc)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.lm_head(params.get("lm_head"), x, rc,
                        emb_params=params["embedding"])
    if caches is not None:
        return logits, caches
    if rc.mode == "prefill":
        return logits, {"body": {n: torch.stack([c[n] for c in fresh])
                                 for n in ("k", "v", "len")}}
    return logits, None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device, *,
               kv_int8: bool = False,
               kvq: Optional[KVQuantConfig] = None) -> Dict[str, Any]:
    """Zeroed stacked decode cache, contiguous: fp ``k``/``v`` in
    ``dtype``; with ``kv_int8``, int8 ``k``/``v`` and bf16 per-(token,
    head) ``k_s``/``v_s`` scales; with ``kvq``, uint8 codebook indices
    (``kvq.idx_width(head_dim)`` per token and head) and the same bf16
    scale leaves. A sliding-window config's caches are rings of
    ``min(max_len, sliding_window)`` positions, in every layout. The
    paged layout is ``serve/paging.init_paged_cache``
    (``Model.init_cache(paging=...)``)."""
    if kvq is not None and kv_int8:
        raise ValueError("kvq is mutually exclusive with kv_int8")
    L, Hk = cfg.num_layers, cfg.num_kv_heads
    S = (min(max_len, cfg.sliding_window) if cfg.sliding_window
         else max_len)
    lead = (L, batch, S, Hk)
    body = {"len": torch.zeros((L, batch), dtype=torch.int32, device=device)}
    if kvq is not None or kv_int8:
        width, kdt = ((kvq.idx_width(cfg.head_dim), torch.uint8)
                      if kvq is not None else (cfg.head_dim, torch.int8))
        for n in ("k", "v"):
            body[n] = torch.zeros(lead + (width,), dtype=kdt, device=device)
            body[n + "_s"] = torch.zeros(lead, dtype=torch.bfloat16,
                                         device=device)
    else:
        for n in ("k", "v"):
            body[n] = torch.zeros(lead + (cfg.head_dim,), dtype=dtype,
                                  device=device)
    return {"body": body}
