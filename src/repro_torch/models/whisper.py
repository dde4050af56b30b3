"""Whisper family (arXiv:2212.04356; ``repro/models/whisper.py``): an
encoder-decoder transformer backbone.

What the reference computes, not the published Whisper: the conv/mel
frontend is a stub, one biased (d_model, d_model) projection of
precomputed frame embeddings (B, S_src, d_model); the encoder is
bidirectional self-attention and a GELU MLP (``jax.nn.gelu``'s tanh
form) under LayerNorm, the decoder causal self-attention, cross-attention
over the encoder's output and the GELU MLP; sinusoidal absolute
positions are added to both streams, and every self-attention (encoder
and decoder) also applies rope at ``cfg.rope_theta``, as the reference's
``attention_fwd`` does whenever it has no ``kv_source``. ``wq``/``wk``/
``wv`` carry biases, ``wo`` none.

The reference stacks its layers and scans them; here ``params["encoder"]``
and ``params["decoder"]`` are lists of per-layer dicts walked by Python
loops. The decode cache keeps the reference's stacked layout, batch on
axis 1: {"self": {"k", "v" (L, B, max_len, Hk, hd), "len" (L, B)},
"cross_k", "cross_v" (L, B, S_SRC, Hk, hd), "cross_len" (L, B)}. A
prefill computes each layer's cross ``wk``/``wv`` products once, for its
attention and for the cache, and returns memories of as many rows as
there were frames, with ``cross_len`` that count; the engine writes them
at rows [0, frames) of a slot's S_SRC (``init_cache`` sets ``cross_len``
to S_SRC on every slot, as the reference's). Decode writes the
self-attention rows in place and reads the memories only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig, RunConfig

# the encoder memory a cache holds: a 30-s window of 1500 frames
S_SRC = 1500


def sinusoid_at(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The sinusoidal embedding at ``positions`` (any shape): [sin, cos]
    of position / 10000^(2i / d) in fp32 (``common.timescales``), cast to
    ``dtype``."""
    ang = (positions.float()[..., None]
           / cm.timescales(d, 10000.0, positions.device))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoid_pos(S: int, d: int, dtype, device=None) -> torch.Tensor:
    """The (S, d) table of ``sinusoid_at`` at positions 0..S-1."""
    return sinusoid_at(torch.arange(S, dtype=torch.float32, device=device),
                       d, dtype)


def _init_enc_layer(gen, cfg: ModelConfig, **kw) -> Any:
    return {"attn_norm": cm.make_layernorm(cfg.d_model, kw["device"]),
            "attn": cm.make_attention(gen, cfg, bias=True, **kw),
            "mlp_norm": cm.make_layernorm(cfg.d_model, kw["device"]),
            "mlp": cm.make_gelu_mlp(gen, cfg.d_model, cfg.d_ff, **kw)}


def _init_dec_layer(gen, cfg: ModelConfig, **kw) -> Any:
    return {"self_norm": cm.make_layernorm(cfg.d_model, kw["device"]),
            "self_attn": cm.make_attention(gen, cfg, bias=True, **kw),
            "cross_norm": cm.make_layernorm(cfg.d_model, kw["device"]),
            "cross_attn": cm.make_attention(gen, cfg, bias=True, **kw),
            "mlp_norm": cm.make_layernorm(cfg.d_model, kw["device"]),
            "mlp": cm.make_gelu_mlp(gen, cfg.d_model, cfg.d_ff, **kw)}


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                block_device) -> Any:
    """Dense params drawn from ``gen``: the frontend's projection, the
    ``"encoder"`` and ``"decoder"`` lists, the norms, the embedding and
    the head; the block linears on ``block_device`` (``"meta"`` keeps
    only their shapes), everything else on ``device``."""
    kw = {"device": device, "block_device": block_device}
    d = cfg.d_model
    return {
        "frontend": {"proj": cm.make_linear(gen, d, d, device=device,
                                            bias=True)},
        "encoder": [_init_enc_layer(gen, cfg, **kw)
                    for _ in range(cfg.encoder_layers)],
        "enc_norm": cm.make_layernorm(d, device),
        "embedding": cm.make_embedding(gen, cfg.padded_vocab, d, device),
        "decoder": [_init_dec_layer(gen, cfg, **kw)
                    for _ in range(cfg.num_layers)],
        "final_norm": cm.make_layernorm(d, device),
        "lm_head": cm.make_linear(gen, d, cfg.padded_vocab, device=device),
    }


def encode(params: Any, frames: torch.Tensor, rc: RunConfig,
           cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S, d_model), precomputed embeddings -> the encoder's
    memory (B, S, d_model): the frontend's projection plus the sinusoid,
    then bidirectional layers in prefill mode (rope at 0..S-1, no
    cache)."""
    B, S, _ = frames.shape
    eps = cfg.norm_eps
    x = cm.linear(params["frontend"]["proj"], frames.to(cfg.act_dtype), rc)
    x = x + sinusoid_pos(S, cfg.d_model, cfg.act_dtype, frames.device)[None]
    positions = torch.arange(S, dtype=torch.int32,
                             device=frames.device)[None].expand(B, S)
    enc_rc = rc.replace(mode="prefill" if rc.mode == "decode" else rc.mode)
    for lp in params["encoder"]:
        h = cm.layernorm(lp["attn_norm"], x, eps)
        a, _ = cm.attention_fwd(lp["attn"], h, enc_rc, cfg,
                                positions=positions, causal=False)
        x = x + a
        h = cm.layernorm(lp["mlp_norm"], x, eps)
        x = x + cm.gelu_mlp_fwd(lp["mlp"], h, enc_rc)
    return cm.layernorm(params["enc_norm"], x, eps)


def _dec_layer_fwd(lp: Any, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
                   *, positions: torch.Tensor, memory: Optional[torch.Tensor],
                   cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """A decoder layer. Decode (over ``cache``): self-attention writes its
    rows in place, cross-attention attends the cached memory over
    ``cross_len``. Otherwise cross-attention attends ``memory``; a
    prefill returns the layer's fresh cross memories ({"cross_k",
    "cross_v", "cross_len"}) beside its self-attention cache."""
    eps = cfg.norm_eps
    h = cm.layernorm(lp["self_norm"], x, eps)
    a, new_self = cm.attention_fwd(
        lp["self_attn"], h, rc, cfg, positions=positions,
        cache=None if cache is None else cache["self"])
    x = x + a
    h = cm.layernorm(lp["cross_norm"], x, eps)
    new_cache = None
    if rc.mode == "decode" and cache is not None:
        B, H, hd = h.shape[0], cfg.num_heads, cfg.head_dim
        q = cm.linear(lp["cross_attn"]["wq"], h, rc).reshape(B, 1, H, hd)
        o = cm.decode_attention(q, cache["cross_k"], cache["cross_v"],
                                cache["cross_len"])
        c = cm.linear(lp["cross_attn"]["wo"], o.reshape(B, 1, cfg.q_dim), rc)
        new_cache = cache
    else:
        c, cross = cm.attention_fwd(lp["cross_attn"], h, rc, cfg,
                                    positions=positions, kv_source=memory,
                                    causal=False)
        if rc.mode == "prefill":
            B, Sm = memory.shape[:2]
            new_cache = {"self": new_self, "cross_k": cross["k"],
                         "cross_v": cross["v"],
                         "cross_len": torch.full((B,), Sm, dtype=torch.int32,
                                                 device=x.device)}
    x = x + c
    h = cm.layernorm(lp["mlp_norm"], x, eps)
    return x + cm.gelu_mlp_fwd(lp["mlp"], h, rc), new_cache


_CROSS = ("cross_k", "cross_v", "cross_len")


def forward(params: Any, tokens: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig, *, frames: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Any] = None) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> fp32 logits (B, S, padded_vocab) (prefill under
    ``rc.lm_head_last_only``: (B, 1, padded_vocab)) and the caches. The
    memory is ``memory`` or, from ``frames``, the encoder's. A prefill
    without ``caches`` returns a fresh stacked cache; a decode updates
    ``caches`` in place and returns it; a prefill over a paged slot view
    (a chunked-prefill continuation, ``serve/paging.slot_view``) writes
    the view's self-attention in place and returns it beside the fresh
    cross memories (``paging.merge_slot`` writes them at rows [0,
    frames) of the slot); None otherwise."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    if memory is None and frames is not None:
        memory = encode(params, frames, rc, cfg)
    x = cm.embed(params["embedding"], tokens, cfg.act_dtype)
    x = x + sinusoid_at(positions, cfg.d_model, cfg.act_dtype)
    made = []
    layer = cm.remat_layer(_dec_layer_fwd, rc)
    for i, lp in enumerate(params["decoder"]):
        cache = None
        if caches is not None:
            cache = {"self": {n: t[i] for n, t in caches["self"].items()},
                     **{n: caches[n][i] for n in _CROSS}}
        x, nc = layer(lp, x, rc, cfg, positions=positions, memory=memory,
                      cache=cache)
        made.append(nc)
    if rc.mode == "prefill" and rc.lm_head_last_only:
        x = x[:, -1:]  # skip the vocab projection of the prompt's tokens
    x = cm.layernorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.lm_head(params["lm_head"], x, rc)
    if rc.mode != "prefill":
        return logits, caches
    stack = lambda name: torch.stack([c[name] for c in made])
    cross = {n: stack(n) for n in _CROSS}
    if caches is not None:
        return logits, {"self": caches["self"], **cross}
    return logits, {"self": {n: torch.stack([c["self"][n] for c in made])
                             for n in made[0]["self"]}, **cross}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict[str, Any]:
    """The stacked decode cache (module docstring), zeros but
    ``cross_len`` = S_SRC on every slot, as the reference's
    ``init_cache`` makes it."""
    L, Hk, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"self": {"k": zeros(L, batch, max_len, Hk, hd),
                     "v": zeros(L, batch, max_len, Hk, hd),
                     "len": torch.zeros((L, batch), dtype=torch.int32,
                                        device=device)},
            "cross_k": zeros(L, batch, S_SRC, Hk, hd),
            "cross_v": zeros(L, batch, S_SRC, Hk, hd),
            "cross_len": torch.full((L, batch), S_SRC, dtype=torch.int32,
                                    device=device)}
