"""Decoder-only transformer, the dense and MoE families
(``repro/models/transformer.py``). A MoE config (``family="moe"``) has
a ``"moe"`` node in each layer in place of ``"mlp"``; a config with
``sliding_window`` attends within the window and decodes over ring
caches of ``min(max_len, window)`` positions; a ``use_mla`` config
(deepseek-v2) attends through multi-head latent attention
(``common.mla_fwd``) and caches a latent; ``first_dense_layers`` puts
that many dense-MLP layers (``params["pre_layers"]``, cache subtree
``"pre"``) before the ``"layers"`` (``"body"``). The reference scans a
stacked layer axis; here each segment is a list of per-layer dicts
walked by a Python loop, and the decode cache keeps the reference's
stacked layout, e.g. ``{"body": {"k": (L, B, S, Hk, hd), "v": ...,
"len": (L, B)}}`` (plus ``k_s``/``v_s`` (L, B, S, Hk) scale leaves for
the int8, int4 and KV-VQ layouts; MLA: ``latent`` (L, B, S, r), ``k_rope``
(L, B, S, dr), under KV-VQ uint8 ``latent`` indices and a ``latent_s``
(L, B, S, 1) scale), so each layer reads and updates its slice in
place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.vq import KVQuantConfig
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, RunConfig

# param segment -> its cache subtree, in the order forward walks them
SEGMENTS = (("pre_layers", "pre"), ("layers", "body"))


def _init_layer(gen: torch.Generator, cfg: ModelConfig, *, moe: bool,
                device, block_device) -> Dict[str, Any]:
    make_attn = cm.make_mla if cfg.use_mla else cm.make_attention
    layer = {"attn_norm": cm.make_rmsnorm(cfg.d_model, device),
             "mlp_norm": cm.make_rmsnorm(cfg.d_model, device),
             "attn": make_attn(gen, cfg, device=device,
                               block_device=block_device)}
    if moe:
        layer["moe"] = cm.make_moe(gen, cfg, device=device,
                                   block_device=block_device)
    else:
        layer["mlp"] = cm.make_mlp(gen, cfg.d_model, cfg.d_ff,
                                   block_device=block_device)
    return layer


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                block_device) -> Any:
    """Dense params drawn from ``gen``; the block linears (the experts
    included) go to ``block_device`` (``"meta"`` keeps only their
    shapes). ``first_dense_layers`` dense-MLP layers go under
    ``"pre_layers"``, the rest under ``"layers"``."""
    kw = {"device": device, "block_device": block_device}
    n_body = cfg.num_layers - cfg.first_dense_layers
    layers = [_init_layer(gen, cfg, moe=cfg.family == "moe", **kw)
              for _ in range(n_body)]
    pre = [_init_layer(gen, cfg, moe=False, **kw)
           for _ in range(cfg.first_dense_layers)]
    params = {
        "embedding": cm.make_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                       device),
        "layers": layers,
        "final_norm": cm.make_rmsnorm(cfg.d_model, device),
    }
    if pre:
        params["pre_layers"] = pre
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.make_linear(gen, cfg.d_model, cfg.padded_vocab,
                                           device=device)
    return params


def _layer_fwd(lp: Any, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig, *,
               positions: torch.Tensor, cache: Optional[Dict]
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = cm.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, new_cache = cm.mla_fwd(lp["attn"], h, rc, cfg, positions=positions,
                                  cache=cache)
    else:
        a, new_cache = cm.attention_fwd(lp["attn"], h, rc, cfg,
                                        positions=positions, cache=cache,
                                        window=cfg.sliding_window)
    x = x + a
    h = cm.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if "moe" in lp:
        return x + cm.moe_fwd(lp["moe"], h, rc, cfg), new_cache
    return x + cm.mlp_fwd(lp["mlp"], h, rc), new_cache


def forward(params: Any, tokens: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig, *, positions: Optional[torch.Tensor] = None,
            caches: Optional[Any] = None) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> fp32 logits (B, S, padded_vocab) and the caches:
    a fresh stacked cache in prefill (each subtree stacks every leaf its
    layers returned); ``caches`` updated in place in decode, and in
    prefill over a paged slot view (a chunked-prefill continuation,
    ``serve/paging.slot_view``); None otherwise. The ``"pre_layers"``
    run before the ``"layers"``, each layer through
    ``common.remat_layer``."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = cm.embed(params["embedding"], tokens, cfg.act_dtype)
    fresh: Dict[str, Any] = {}
    for seg, sub in SEGMENTS:
        if seg not in params:
            continue
        stacked = None if caches is None else caches[sub]
        made = []
        layer = cm.remat_layer(_layer_fwd, rc)
        for i, lp in enumerate(params[seg]):
            cache = (None if stacked is None
                     else {n: t[i] for n, t in stacked.items()})
            x, nc = layer(lp, x, rc, cfg, positions=positions, cache=cache)
            if stacked is None and nc is not None:
                made.append(nc)
        if made:
            fresh[sub] = {n: torch.stack([c[n] for c in made])
                          for n in made[0]}
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.lm_head(params.get("lm_head"), x, rc,
                        emb_params=params["embedding"])
    if caches is not None:
        return logits, caches
    if rc.mode == "prefill":
        return logits, fresh
    return logits, None


def _layer_cache(cfg: ModelConfig, L: int, batch: int, S: int, dtype,
                 device, kv_int8: bool, kvq: Optional[KVQuantConfig],
                 kv_int4: bool = False) -> Dict[str, torch.Tensor]:
    """One segment's stacked cache node of L layers."""
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    length = zeros((L, batch), torch.int32)
    if cfg.use_mla:
        if kv_int8 or kv_int4:
            raise ValueError(f"kv_bits={4 if kv_int4 else 8} integer caches "
                             "have no MLA latent layout; use 16 or the KV-VQ "
                             "4/2-bit modes")
        r = cfg.kv_lora_rank
        node = ({"latent": zeros((L, batch, S, kvq.idx_width(r)),
                                 torch.uint8),
                 "latent_s": zeros((L, batch, S, 1), torch.bfloat16)}
                if kvq is not None
                else {"latent": zeros((L, batch, S, r), dtype)})
        node["k_rope"] = zeros((L, batch, S, cfg.qk_rope_dim), dtype)
        node["len"] = length
        return node
    lead = (L, batch, S, cfg.num_kv_heads)
    node = {"len": length}
    if kvq is not None or kv_int8 or kv_int4:
        width, kdt = ((kvq.idx_width(cfg.head_dim), torch.uint8)
                      if kvq is not None
                      else (cfg.head_dim // (2 if kv_int4 else 1), torch.int8))
        for n in ("k", "v"):
            node[n] = zeros(lead + (width,), kdt)
            node[n + "_s"] = zeros(lead, torch.bfloat16)
    else:
        for n in ("k", "v"):
            node[n] = zeros(lead + (cfg.head_dim,), dtype)
    return node


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device, *,
               kv_int8: bool = False, kv_int4: bool = False,
               kvq: Optional[KVQuantConfig] = None) -> Dict[str, Any]:
    """Zeroed stacked decode cache, contiguous, ``{"body": ...}`` and,
    with ``first_dense_layers``, ``"pre"``: fp ``k``/``v`` in ``dtype``;
    with ``kv_int8``, int8 ``k``/``v`` and bf16 per-(token, head)
    ``k_s``/``v_s`` scales; with ``kv_int4``, the same scales beside
    int4 values packed two a byte (``k``/``v`` (..., head_dim / 2) int8,
    ``common.pack_int4``: the reference's ``jnp.int4`` leaves take a
    byte a value); with ``kvq``, uint8 codebook indices
    (``kvq.idx_width(head_dim)`` per token and head) and the same bf16
    scale leaves. An MLA config caches ``latent`` (fp, or under ``kvq``
    ``kvq.idx_width(kv_lora_rank)`` uint8 indices and a bf16 ``latent_s``
    scale per token) and ``k_rope``; it has no int8 layout. A
    sliding-window config's caches are rings of ``min(max_len,
    sliding_window)`` positions, in every layout. The paged layout is
    ``serve/paging.init_paged_cache`` (``Model.init_cache(paging=...)``).

    Raises:
      ValueError: two of ``kvq``, ``kv_int8`` and ``kv_int4``;
        ``kv_int8`` or ``kv_int4`` on an MLA config."""
    if kvq is not None and (kv_int8 or kv_int4):
        raise ValueError("kvq is mutually exclusive with kv_int8/kv_int4")
    if kv_int8 and kv_int4:
        raise ValueError("kv_int8 is mutually exclusive with kv_int4")
    S = (min(max_len, cfg.sliding_window) if cfg.sliding_window
         else max_len)
    node = lambda L: _layer_cache(cfg, L, batch, S, dtype, device, kv_int8,
                                  kvq, kv_int4)
    caches = {"body": node(cfg.num_layers - cfg.first_dense_layers)}
    if cfg.first_dense_layers:
        caches["pre"] = node(cfg.first_dense_layers)
    return caches
