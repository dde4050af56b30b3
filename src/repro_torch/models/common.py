"""Shared model building blocks (the subset of ``repro/models/common.py``
the serving path reaches): configs, linear layers (dense / VQ / INT8
through the planner), rmsnorm and layernorm, rotary embeddings, blocked
prefill attention (causal, optionally within a sliding window, or
bidirectional: an encoder, or cross-attention over a memory through
``attention_fwd``'s ``kv_source``), decode attention over the KV cache — fp, int8 (``k``/
``v`` int8 + bf16 ``k_s``/``v_s``), int4 (two nibbles packed a byte,
``pack_int4``) or KV-VQ (uint8 codebook indices + bf16 scales, the
codebooks under the attention params' ``kv_cb``),
contiguous or paged (block arenas and a block table,
``serve/paging.py``), a full cache or a sliding-window ring (``window >
0``: the cache holds ``min(max_len, window)`` positions and position p
lives at slot ``p % S``) — the chunked-prefill continuation over a paged
slot view, multi-head latent attention (MLA, deepseek-v2: a latent
cache of ``kv_lora_rank`` + a shared rope key per token, fp or KV-VQ,
contiguous or paged), the SwiGLU and GELU MLPs, the top-k MoE layer
with capacity routing, embedding, LM head and the training loss.

Params are plain dicts of tensors (VQWeight nodes after quantization);
every initializer draws from an explicit ``torch.Generator``. A MoE
layer's experts are stacked on a leading E axis, as the reference holds
them (a stacked VQWeight: ``idx`` (E, C, V, N), ``codebooks`` (E, C, d,
2^n), ``scale`` (E, N)); ``_expert_ffn`` slices expert e's 2-D VQWeight
(``core.vq.vq_index``: contiguous views) for the kernels.

Unlike the functional reference, decode updates the KV cache IN PLACE
(the new token's K/V rows and the ``len`` leaf), which saves a full copy
of the cache per step; ``attention_fwd`` returns the same cache dict.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import ops as core_ops
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import PlanPolicy
from repro_torch.runtime import tensor_parallel as tp
from repro_torch.core.vq import (KVQuantConfig, dequantize, kv_decode,
                                 kv_encode, vq_index)

Params = Any


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description; the same fields and defaults as the
    reference's ``ModelConfig``."""

    name: str
    family: str                      # dense | moe | xlstm | rglru | whisper | vision
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0
    local_window: int = 0
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    rec_pattern: Tuple[str, ...] = ()
    d_rnn: int = 0
    conv_width: int = 4
    xlstm_pattern: Tuple[str, ...] = ()
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    cross_attn_period: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vq_d: int = 8
    vq_n: int = 8
    vq_C: int = 2

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128."""
        return ((self.vocab_size + 127) // 128) * 128


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Static execution-mode knobs: the run ``mode`` (train | prefill |
    decode), the matmul ``plan_policy``, the prefill attention chunk,
    ``remat`` (train mode recomputes each layer's activations in the
    backward, ``remat_layer``), ``lm_head_last_only`` (an xLSTM prefill
    projects only the last token onto the vocabulary), ``mla_absorb`` (MLA decode attends in the
    latent space, ``wkv_b`` folded into the query and output sides,
    instead of expanding the whole latent cache through ``wkv_b``) and
    ``kv_vq``, the KV-VQ config whose scale variant decode appends
    encode with (the cache layout itself is read off the cache's
    leaves)."""

    mode: str = "train"
    plan_policy: PlanPolicy = PlanPolicy()
    attn_chunk: int = 1024
    remat: bool = True
    lm_head_last_only: bool = False
    mla_absorb: bool = False
    kv_vq: Optional[KVQuantConfig] = None

    @property
    def policy(self) -> PlanPolicy:
        return self.plan_policy

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def replace_policy(self, **kw) -> "RunConfig":
        return dataclasses.replace(
            self, plan_policy=dataclasses.replace(self.plan_policy, **kw))


def _save_dots():
    # the products without batch dims (the linears: ``aten.mm``, and
    # ``aten.addmm``) are kept, everything else is recomputed: the
    # reference's ``dots_with_no_batch_dims_saveable``
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    keep = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def remat_layer(fn: Callable, rc: RunConfig) -> Callable:
    """``fn`` (a layer or a group of layers) as the reference wraps it in
    ``jax.checkpoint``: in train mode with ``rc.remat``, while autograd
    records, under ``torch.utils.checkpoint`` (non-reentrant), which
    keeps the layer's inputs and the outputs of its products without
    batch dims and recomputes the rest in the backward (the models draw
    no random numbers, so no RNG state is kept); otherwise ``fn``
    itself."""
    if not (rc.remat and rc.mode == "train" and torch.is_grad_enabled()):
        return fn
    from torch.utils.checkpoint import checkpoint

    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=_save_dots,
                             preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, K: int, N: int, device) -> torch.Tensor:
    if torch.device(device).type == "meta":  # shape only: quantized later
        return torch.empty((K, N), device="meta")
    return torch.randn((K, N), generator=gen, device=device) / math.sqrt(K)


def make_linear(gen, K: int, N: int, *, device, bias: bool = False,
                bias_device=None) -> Params:
    """A (K, N) linear on ``device``; ``bias`` adds zeros (N,) on
    ``bias_device`` (default ``device``): real zeros even over meta
    weights, since quantization keeps them."""
    p = {"w": _dense_init(gen, K, N, device)}
    if bias:
        p["b"] = torch.zeros((N,), device=bias_device or device)
    return p


def make_rmsnorm(d: int, device) -> Params:
    return {"g": torch.ones((d,), device=device)}


def make_layernorm(d: int, device) -> Params:
    return {"g": torch.ones((d,), device=device),
            "b2": torch.zeros((d,), device=device)}


def make_attention(gen, cfg: ModelConfig, *, device, block_device,
                   bias: Optional[bool] = None) -> Params:
    """wq, wk, wv and wo on ``block_device``; ``bias`` (default
    ``cfg.qkv_bias``) gives wq, wk and wv zero biases on ``device`` (wo
    never has one); ``qk_norm`` adds the per-head rmsnorms."""
    bias = cfg.qkv_bias if bias is None else bias
    p = {"wq": make_linear(gen, cfg.d_model, cfg.q_dim, device=block_device),
         "wk": make_linear(gen, cfg.d_model, cfg.kv_dim, device=block_device),
         "wv": make_linear(gen, cfg.d_model, cfg.kv_dim, device=block_device),
         "wo": make_linear(gen, cfg.q_dim, cfg.d_model, device=block_device)}
    if bias:  # real zeros even over meta weights: quantization keeps them
        for name in ("wq", "wk", "wv"):
            p[name]["b"] = torch.zeros((p[name]["w"].shape[1],), device=device)
    if cfg.qk_norm:
        p["qnorm"] = make_rmsnorm(cfg.head_dim, device)
        p["knorm"] = make_rmsnorm(cfg.head_dim, device)
    return p


def make_mla(gen, cfg: ModelConfig, *, device, block_device) -> Params:
    """An MLA block (reference ``models/common.py:741-751``): ``wq`` (D,
    H(dn + dr)), ``wkv_a`` (D, r + dr), the latent's rmsnorm ``kv_norm``,
    ``wkv_b`` (r, H(dn + dv)) and ``wo`` (H dv, D)."""
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {"wq": make_linear(gen, cfg.d_model, H * (dn + dr),
                              device=block_device),
            "wkv_a": make_linear(gen, cfg.d_model, r + dr,
                                 device=block_device),
            "kv_norm": make_rmsnorm(r, device),
            "wkv_b": make_linear(gen, r, H * (dn + dv), device=block_device),
            "wo": make_linear(gen, H * dv, cfg.d_model, device=block_device)}


def make_mlp(gen, d_model: int, d_ff: int, *, block_device) -> Params:
    return {"gate": make_linear(gen, d_model, d_ff, device=block_device),
            "up": make_linear(gen, d_model, d_ff, device=block_device),
            "down": make_linear(gen, d_ff, d_model, device=block_device)}


def make_gelu_mlp(gen, d_model: int, d_ff: int, *, device,
                  block_device) -> Params:
    """A biased GELU MLP (xLSTM's sLSTM FFN): ``up`` (d_model, d_ff) and
    ``down`` (d_ff, d_model) on ``block_device``, their biases on
    ``device``."""
    return {"up": make_linear(gen, d_model, d_ff, device=block_device,
                              bias=True, bias_device=device),
            "down": make_linear(gen, d_ff, d_model, device=block_device,
                                bias=True, bias_device=device)}


def make_moe(gen, cfg: ModelConfig, *, device, block_device) -> Params:
    """A MoE layer: the dense router ``wr`` (D, E) on ``device`` (never
    quantized: N = E is below the quantizer's 64) and the experts'
    gate/up/down stacked on a leading E axis on ``block_device``; the
    shared experts (``num_shared_experts``) as one MLP of
    ``num_shared_experts`` x the expert width."""
    E, dff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff

    def stack(K, N):
        if torch.device(block_device).type == "meta":
            return torch.empty((E, K, N), device="meta")
        return torch.stack([_dense_init(gen, K, N, block_device)
                            for _ in range(E)])

    p = {"router": {"wr": _dense_init(gen, cfg.d_model, E, device)},
         "experts": {"gate": {"w": stack(cfg.d_model, dff)},
                     "up": {"w": stack(cfg.d_model, dff)},
                     "down": {"w": stack(dff, cfg.d_model)}}}
    if cfg.num_shared_experts:
        p["shared"] = make_mlp(gen, cfg.d_model, dff * cfg.num_shared_experts,
                               block_device=block_device)
    return p


def make_embedding(gen, vocab: int, d: int, device) -> Params:
    return {"emb": torch.randn((vocab, d), generator=gen, device=device) * 0.02}


# ---------------------------------------------------------------------------
# Linear apply — the single place where EVA enters the model
# ---------------------------------------------------------------------------


def linear(p: Params, x: torch.Tensor, rc: RunConfig, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply a (possibly VQ-quantized) linear layer: the (spec, policy)
    pair resolves through the planner to one backend (dense ``fp``, EVA
    ``eva_fused`` in decode, ``dequant`` elsewhere; a VQ-Logits head
    ``{"vql": ...}`` through ``vql_gather_torch``)."""
    out_dtype = out_dtype or x.dtype
    leaf = next(p[k] for k in ("vq", "vql", "w") if k in p)
    if "vq" in p and tp.is_dtensor(leaf):
        # a VQ weight sharded over ``model``: planned and run on its shard
        def run(xl, vl):
            return plan_mod.plan_node({"vq": vl}, xl, mode=rc.mode,
                                      policy=rc.policy,
                                      out_dtype=out_dtype).execute(xl, vl)

        y = tp.vq_linear(x, leaf, run)
    else:
        pl = plan_mod.plan_node(p, x, mode=rc.mode, policy=rc.policy,
                                out_dtype=out_dtype)
        y = pl.execute(x, leaf)
    y = tp.reduce_partial(y)  # a row-parallel output, whole again
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def grouped_linear(p: Params, x: torch.Tensor, rc: RunConfig
                   ) -> Tuple[torch.Tensor, ...]:
    """One wide matmul for a grouped family, sliced at its split points."""
    return core_ops.split_grouped_outputs(linear(p, x, rc), p["vq"])


# ---------------------------------------------------------------------------
# Norms & rotary
# ---------------------------------------------------------------------------


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = p["g"]
    if g.dtype == torch.float32:
        # an fp32 product then a cast: two vectorized kernels, faster on
        # the card than the one below, which casts element by element
        return (y * g).to(x.dtype)
    if g.requires_grad or y.requires_grad:
        # autograd takes no ``out=``: the same product, upcast, then cast
        return (y * g.float()).to(x.dtype)
    # a bf16 gain (a stacked leaf's serving dtype): one kernel takes the
    # fp32 product and rounds it to x's dtype as it stores, bit for bit
    # the upcast gain's product (faster than an upcast kernel or a
    # mixed-dtype product followed by a cast)
    return torch.mul(y, g, out=torch.empty_like(x))


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm as the reference computes it: the fp32 mean and variance,
    ``rsqrt(var + eps)``, then the fp32 gain ``g`` and bias ``b2``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b2"].float()).to(x.dtype)


def timescales(dim: int, theta: float, device) -> torch.Tensor:
    """theta^(2i / dim) for i < dim / 2 as the reference computes it: the
    fp32 exponent, the power rounded once to fp32 (taken in fp64: fp32
    ``pow`` is off by an ulp at theta 1e6 for some i, and a large theta
    magnifies that in the angle)."""
    e = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return torch.pow(float(np.float32(theta)), e.double()).float()


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """1 / theta^(2i / head_dim): ``timescales``' fp32 reciprocal."""
    return 1.0 / timescales(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_chunk_scores(q, k, scale):
    # q: (B, Sq, H, hd), k: (B, Ck, Hk, hd) -> scores (B, H, Sq, Ck)
    B, Sq, H, hd = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, hd)
    s = torch.einsum("bshgd,bchd->bhgsc", qg.float(), k.float())
    return (s * scale).reshape(B, H, Sq, k.shape[1])


def _attn_chunk_apply(p, v):
    # p: (B, H, Sq, Ck), v: (B, Ck, Hk, hd) -> (B, Sq, H, hd)
    B, H, Sq, Ck = p.shape
    Hk = v.shape[2]
    pg = p.reshape(B, Hk, H // Hk, Sq, Ck)
    o = torch.einsum("bhgsc,bchd->bshgd", pg, v.float())
    return o.reshape(B, Sq, H, v.shape[-1])


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int = 1024, window: int = 0,
                      q_offset: Union[int, torch.Tensor] = 0,
                      causal: bool = True) -> torch.Tensor:
    """Memory-bounded attention (prefill): q in chunks, kv chunks folded
    with an online softmax, -1e30 masking (the reference's
    ``blocked_attention``, every kv chunk visited). ``causal`` masks the
    positions after each query; ``causal=False`` (an encoder, or
    cross-attention over Skv != Sq memory rows) masks only the kv
    padding. ``window > 0`` also masks the positions ``window`` or more
    behind each query (sliding-window attention). ``q_offset`` is the
    absolute position of q[0], an int or a 0-dim device tensor (the
    chunked-prefill continuation: no host sync)."""
    if tp.is_dtensor(q) or tp.is_dtensor(k):  # heads over ``model``
        return tp.by_heads(blocked_attention, q, k, v, chunk=chunk,
                           window=window, q_offset=q_offset, causal=causal)
    B, Sq, H, hd = q.shape
    hd_v = v.shape[-1]
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq, ck = min(chunk, Sq), min(chunk, Skv)
    pq, pk = (-Sq) % cq, (-Skv) % ck
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    dev = q.device

    outs = []
    for iq in range(nq):
        qi = q[:, iq * cq:(iq + 1) * cq]
        q_pos = q_offset + iq * cq + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq), -1e30, device=dev)
        l = torch.zeros((B, H, cq), device=dev)
        acc = torch.zeros((B, cq, H, hd_v), device=dev)
        for jk in range(nk):
            lo, hi = jk * ck, jk * ck + ck - 1
            s = _attn_chunk_scores(qi, k[:, lo:hi + 1], scale)   # (B,H,cq,ck)
            pos_c = torch.arange(lo, hi + 1, device=dev)
            mask = (pos_c < Skv)[None, :].expand(cq, ck)
            if causal:
                mask = mask & (pos_c[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (pos_c[None, :] > (q_pos[:, None] - window))
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = _attn_chunk_apply(p, v[:, lo:hi + 1])             # (B,cq,H,hd)
            acc = acc * corr.transpose(1, 2)[..., None] + o
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     ring: bool = False) -> torch.Tensor:
    """Plain attention over a contiguous cache; ``cache_len`` counts the
    Sq queries just written: query i sits at ``cache_len - Sq + i``. A
    ring (sliding-window) cache decodes one query at a time: every slot
    below ``min(cache_len, S)`` is valid (the last S positions once the
    ring has wrapped).

    Raises:
      ValueError: ``ring`` with more than one query."""
    B, S, Hk, hd = k_cache.shape
    Sq = q.shape[1]
    if ring and Sq != 1:
        raise ValueError("ring caches decode one token at a time")
    s = _attn_chunk_scores(q, k_cache, 1.0 / math.sqrt(hd))  # (B, H, Sq, S)
    pos = torch.arange(S, device=q.device)
    if ring:
        valid = (pos[None, :] < cache_len.clamp(max=S)[:, None])[:, None]
    else:
        qpos = (cache_len[:, None] - Sq
                + torch.arange(Sq, device=q.device)[None, :])
        valid = pos[None, None, :] <= qpos[..., None]           # (B, Sq, S)
    s = torch.where(valid[:, None], s, torch.full_like(s, -1e30))
    return _attn_chunk_apply(torch.softmax(s, dim=-1), v_cache).to(q.dtype)


def paged_view(arena: torch.Tensor, block_table: torch.Tensor
               ) -> torch.Tensor:
    """The slot-contiguous view of a paged arena: a (B, W) block table
    over a (NB, bs, F...) arena -> (B, W * bs, F...). Sentinel ids (NB)
    clamp to block NB - 1, as the reference's ``mode="clip"`` gather:
    finite values the attention mask (``pos < len``) hides. ``W * bs`` is
    the contiguous cache's length (``serve/paging.py``)."""
    B, W = block_table.shape
    NB, bs = arena.shape[0], arena.shape[1]
    idx = block_table.long().clamp(0, NB - 1).reshape(-1)
    return arena.index_select(0, idx).reshape((B, W * bs) + arena.shape[2:])


def _quantize_kv(x: torch.Tensor, int4: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int quantization of a K/V slice: x
    (B, S, Hk, hd) -> (values, bf16 (B, S, Hk) scales): int8 values in
    [-127, 127], or with ``int4`` values in [-7, 7] packed two a byte
    (``pack_int4``: (B, S, Hk, hd / 2) int8)."""
    qmax = 7.0 if int4 else 127.0
    absmax = x.float().abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x.float() / scale[..., None]), -qmax,
                    qmax).to(torch.int8)
    return (pack_int4(q) if int4 else q), scale.to(torch.bfloat16)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] (..., hd) -> (..., hd / 2) int8 bytes, two
    two's-complement nibbles a byte: the even column in the low nibble,
    the odd column in the high one. Torch has no int4 dtype."""
    lo, hi = q[..., 0::2], q[..., 1::2]
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """``pack_int4``'s inverse: (..., hd / 2) int8 bytes -> (..., hd)
    int8 values (each nibble sign-extended by arithmetic shifts)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def kv_layout(cache: Dict, head_dim: int) -> str:
    """The layout of an attention cache node, the one place that tells
    them apart: "kvq" (uint8 codebook indices), "int4" (int8 bytes of
    packed nibbles: the cache's last dim is half the new rows' head dim
    ``head_dim``), "int8", or "fp"."""
    if "k_s" not in cache:
        return "fp"
    if cache["k"].dtype == torch.uint8:
        return "kvq"
    return "int4" if cache["k"].shape[-1] * 2 == head_dim else "int8"


def _dequantize_kv(q: torch.Tensor, s: torch.Tensor, layout: str
                   ) -> torch.Tensor:
    """An int8 or int4 cache leaf and its scales as bf16 rows, as the
    reference reads them (``q.astype(bf16) * s.astype(bf16)``)."""
    bf = torch.bfloat16
    vals = unpack_int4(q) if layout == "int4" else q
    return vals.to(bf) * s[..., None].to(bf)


def _kvq_decode_attention(q, k_idx, v_idx, k_s, v_s, lengths, cb_k, cb_v,
                          rc: RunConfig,
                          block_table: Optional[torch.Tensor] = None,
                          window: int = 0) -> torch.Tensor:
    """Attend over a KV-VQ cache: contiguous (B, S, ...) leaves, or with
    ``block_table`` (B, W) the paged arenas (NB, bs, ...). A single query
    over a full cache resolves through the planner (``kind="kvq_attn"``:
    the dequantize oracle under impl="torch", kernel B7 under
    impl="cuda"), a paged site planned as a contiguous one of S = W * bs
    positions, as the reference plans it, its operands the arenas and
    the table; several queries, and a ring cache (``window > 0``), whose
    validity the kvq_attn backends do not know, dequantize and attend,
    as the reference does."""
    paged = block_table is not None
    if q.shape[1] == 1 and window == 0:
        _, bs, Hk, idx_w = k_idx.shape
        S = block_table.shape[1] * bs if paged else bs
        spec = plan_mod.kvq_attention_spec(
            B=q.shape[0], S=S, H=q.shape[2], Hk=Hk, hd=q.shape[3],
            idx_width=idx_w, entries=cb_k.shape[-2], x_dtype=q.dtype,
            out_dtype=q.dtype)
        idx = (k_idx, v_idx, k_s, v_s) + ((block_table,) if paged else ())
        return plan_mod.plan(spec, rc.policy).execute(
            (q, *idx, lengths, cb_k, cb_v), None)
    if paged:
        k_idx, v_idx, k_s, v_s = (paged_view(t, block_table)
                                  for t in (k_idx, v_idx, k_s, v_s))
    return decode_attention(q, kv_decode(k_idx, k_s, cb_k),
                            kv_decode(v_idx, v_s, cb_v), lengths,
                            ring=window > 0)


def _encoded_rows(p: Params, k: torch.Tensor, v: torch.Tensor,
                  cache: Dict, rc: RunConfig) -> Dict[str, torch.Tensor]:
    """The new tokens' cache rows in the cache's layout, by leaf name:
    fp ``k``/``v``; int8- or int4-quantized values and scales; or KV-VQ
    indices and scales, encoded against the attention params'
    codebooks."""
    layout = kv_layout(cache, k.shape[-1])
    if layout == "kvq":
        variant = rc.kv_vq.variant if rc.kv_vq is not None else "outlier"
        (k, k_s), (v, v_s) = (kv_encode(k, p["kv_cb"]["k"], variant),
                              kv_encode(v, p["kv_cb"]["v"], variant))
    elif layout == "fp":
        return {"k": k, "v": v}
    else:
        int4 = layout == "int4"
        (k, k_s), (v, v_s) = _quantize_kv(k, int4), _quantize_kv(v, int4)
    return {"k": k, "v": v, "k_s": k_s, "v_s": v_s}


def _decode_contiguous(p, q, rows, cache, rc: RunConfig,
                       window: int = 0) -> torch.Tensor:
    """Write ``rows`` (B, S, ...) at positions len..len+S-1 of the
    contiguous cache, in place, then attend. A ring cache (``window >
    0``) writes position p at slot ``p % Sc`` and drops nothing."""
    B, S = q.shape[:2]
    Sc = cache["k"].shape[1]
    cache_len = cache["len"]                                       # (B,)
    ring = window > 0
    if S == 1 and tp.time_sharded(cache) \
            and kv_layout(cache, q.shape[-1]) == "fp":
        return tp.sp_decode_attention(q, rows, cache, ring=ring)
    # the reference drops the positions past capacity (mode="drop").
    # With fixed shapes and no host sync, each dropped position of a
    # window repeats the write of its row's last position that fits,
    # so duplicate (b, slot) pairs all carry one value; a row where no
    # position fits writes slot Sc - 1's own value back. One token
    # (the engine's step) has no duplicates and needs no gather.
    if ring:
        src, any_fit = None, None
        slot = (cache_len[:, None].long()
                + torch.arange(S, device=q.device)[None, :]) % Sc  # (B, S)
    elif S == 1:
        src = None
        slot = cache_len[:, None].long().clamp(max=Sc - 1)         # (B, 1)
        any_fit = (cache_len < Sc)[:, None]
    else:
        last = (Sc - 1 - cache_len.long()).clamp(max=S - 1)       # (B,)
        src = torch.minimum(torch.arange(S, device=q.device)[None, :],
                            last[:, None]).clamp(min=0)            # (B, S)
        any_fit = (last >= 0)[:, None]                             # (B, 1)
        slot = (cache_len[:, None].long() + src).clamp(max=Sc - 1)
    b_iota = torch.arange(B, device=q.device)[:, None]
    for name, new in rows.items():
        buf = cache[name]
        new = new.to(buf.dtype) if src is None else new.to(buf.dtype)[b_iota, src]
        if any_fit is None:
            buf[b_iota, slot] = new
            continue
        keep = any_fit.reshape(any_fit.shape + (1,) * (new.dim() - 2))
        buf[b_iota, slot] = torch.where(keep, new, buf[b_iota, slot])
    cache["len"].copy_(cache_len + S)
    new_len = cache["len"]
    layout = kv_layout(cache, q.shape[-1])
    if layout == "kvq":
        return _kvq_decode_attention(q, cache["k"], cache["v"], cache["k_s"],
                                     cache["v_s"], new_len, p["kv_cb"]["k"],
                                     p["kv_cb"]["v"], rc, window=window)
    if layout != "fp":
        return decode_attention(
            q, _dequantize_kv(cache["k"], cache["k_s"], layout),
            _dequantize_kv(cache["v"], cache["v_s"], layout), new_len,
            ring=ring)
    if rc.policy.impl == "cuda" and S == 1 and not ring:
        from repro_torch.kernels.flash_decode import flash_decode

        return flash_decode(q, cache["k"], cache["v"], new_len)
    return decode_attention(q, cache["k"], cache["v"], new_len, ring=ring)


def _decode_paged(p, q, rows, cache, rc: RunConfig,
                  window: int = 0) -> torch.Tensor:
    """Write ``rows`` (B, S, ...) at positions len..len+S-1 through the
    block table, in place, then attend over the arenas (reference
    ``models/common.py:529-608``). Arenas hold NB + 1 blocks, the last
    the sink (``serve/paging.py``): the sentinel id NB is the sink's
    index, so a row of a free or mid-prefill slot (its table row all
    sentinel) and a position past capacity write there, and no two
    writes of a step that anything reads share a target. A ring
    (``window > 0``) writes position p at its slot ``p % (W * bs)``."""
    B, S = q.shape[:2]
    bt = cache["block_table"]                                      # (B, W)
    NB, bs = cache["k"].shape[0] - 1, cache["k"].shape[1]
    W = bt.shape[1]
    ring = window > 0
    cache_len = cache["len"]                                       # (B,)
    pos = cache_len[:, None].long() + torch.arange(S, device=q.device)
    if ring:
        pos = pos % (W * bs)
    blk = bt.gather(1, (pos // bs).clamp(max=W - 1)).long()       # (B, S)
    phys = torch.where(pos < W * bs, blk, NB)
    off = pos % bs
    for name, new in rows.items():
        cache[name][phys, off] = new.to(cache[name].dtype)
    cache["len"].copy_(cache_len + S)
    new_len = cache["len"]
    arena = {n: cache[n][:NB] for n in rows}                       # no sink
    layout = kv_layout(cache, q.shape[-1])
    if layout == "kvq":
        return _kvq_decode_attention(
            q, arena["k"], arena["v"], arena["k_s"], arena["v_s"], new_len,
            p["kv_cb"]["k"], p["kv_cb"]["v"], rc, block_table=bt,
            window=window)
    if layout != "fp":
        view = {n: paged_view(a, bt) for n, a in arena.items()}
        return decode_attention(
            q, _dequantize_kv(view["k"], view["k_s"], layout),
            _dequantize_kv(view["v"], view["v_s"], layout), new_len,
            ring=ring)
    if rc.policy.impl == "cuda" and S == 1 and not ring:
        from repro_torch.kernels.flash_decode import flash_decode_paged

        return flash_decode_paged(q, arena["k"], arena["v"], bt, new_len)
    return decode_attention(q, paged_view(arena["k"], bt),
                            paged_view(arena["v"], bt), new_len, ring=ring)


def _prefill_continuation(q, k, v, positions, cache, rc: RunConfig,
                          window: int = 0) -> torch.Tensor:
    """A chunked-prefill continuation over a one-slot paged view
    (``serve/paging.slot_view``; reference ``models/common.py:679-722``):
    the chunk's K/V go through the table at their absolute positions,
    its pad rows past ``prefill_len`` and positions past capacity to the
    sink, then the chunk attends over the view with its query offset at
    the committed length ``len``; ``len`` becomes ``len + prefill_len``.
    Everything stays on the device (no host sync), so a CUDA graph holds
    it. The fp cache only, batch 1, as the reference (which also gates
    it off for rings: ``window`` masks the attention only)."""
    if "k_s" in cache:
        raise NotImplementedError(
            "chunked prefill over quantized (int8/KV-VQ) KV caches is not "
            "supported")
    B, S = q.shape[:2]
    if B != 1:
        raise ValueError(
            f"chunked-prefill continuation requires B == 1, got {B}")
    bt = cache["block_table"]                                      # (1, W)
    NB, bs = cache["k"].shape[0] - 1, cache["k"].shape[1]
    W = bt.shape[1]
    hist, true_c = cache["len"], cache["prefill_len"]              # (1,)
    p0 = positions[0].long()                                       # (S,)
    valid = (torch.arange(S, device=q.device) < true_c) & (p0 < W * bs)
    phys = torch.where(valid, bt[0][(p0 // bs).clamp(max=W - 1)].long(), NB)
    off = p0 % bs
    for name, new in (("k", k), ("v", v)):
        cache[name][phys, off] = new[0].to(cache[name].dtype)
    o = blocked_attention(q, paged_view(cache["k"][:NB], bt),
                          paged_view(cache["v"][:NB], bt),
                          chunk=rc.attn_chunk, window=window,
                          q_offset=hist[0])
    cache["len"].copy_(hist + true_c)
    return o


def attention_fwd(p: Params, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
                  *, positions: torch.Tensor, cache: Optional[Dict] = None,
                  window: int = 0, causal: bool = True,
                  kv_source: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention (causal unless ``causal=False``: an encoder), or
    with ``kv_source`` (B, Skv, D) cross-attention: q from ``x``, k and
    v from ``kv_source``, no rope, no cache, attended through
    ``blocked_attention`` (whisper's decode attends its cached memory
    through ``decode_attention`` itself, as the reference's). Decode writes the new tokens' K/V rows —
    fp, int8-quantized or KV-VQ-encoded, as the cache's leaves say — and
    ``len`` into ``cache`` in place (positions past capacity are dropped),
    contiguous or through the block table of a paged cache, then attends:
    the fp cache through ``flash_decode`` / ``flash_decode_paged`` under
    ``impl="cuda"`` (one new token), the KV-VQ cache through its planned
    backend, the int8 cache through plain torch (the reference has no
    kernel for it). Prefill over a paged slot view is a chunked-prefill
    continuation (``_prefill_continuation``), also in place.

    ``window > 0`` is sliding-window attention: prefill masks positions
    ``window`` or more behind each query, and the decode cache is a
    ring (position p at slot ``p % S``) attended through plain torch on
    every layout, as the reference gates its kernels (``window == 0``).

    Raises:
      ValueError: ``kv_source`` with a grouped ``wqkv`` (the quantization
        never groups cross-attention) or with a cache."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = x if kv_source is None else kv_source
    Skv = kv_in.shape[1]
    if kv_source is not None and ("wqkv" in p or cache is not None):
        raise ValueError(
            "grouped wqkv is invalid for cross-attention" if "wqkv" in p
            else "cross-attention takes no cache: decode attends the "
                 "cached memory through decode_attention")
    if "wqkv" in p:
        q, k, v = grouped_linear(p["wqkv"], x, rc)
    else:
        q = linear(p["wq"], x, rc)
        k, v = linear(p["wk"], kv_in, rc), linear(p["wv"], kv_in, rc)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, Skv, Hk, hd)
    v = v.reshape(B, Skv, Hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(p["knorm"], k, cfg.norm_eps)
    if kv_source is None:  # rope only in self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if rc.mode == "decode" and cache is not None:
        rows = _encoded_rows(p, k, v, cache, rc)
        decode = _decode_paged if "block_table" in cache else _decode_contiguous
        o = decode(p, q, rows, cache, rc, window=window)
        new_cache = cache
    elif cache is not None and "block_table" in cache:
        if rc.mode != "prefill":
            raise ValueError(
                "paged cache reached attention_fwd outside decode/prefill")
        o = _prefill_continuation(q, k, v, positions, cache, rc,
                                  window=window)
        new_cache = cache
    elif cache is not None:
        raise ValueError(
            "a prefill over an existing cache needs a paged slot view "
            "(serve/paging.slot_view)")
    else:
        o = blocked_attention(q, k, v, chunk=rc.attn_chunk, window=window,
                              causal=causal)
        if rc.mode == "prefill":
            new_cache = {"k": k, "v": v,
                         "len": (positions[:, -1] + 1).to(torch.int32)}
    y = linear(p["wo"], o.reshape(B, S, H * hd), rc)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2): compressed KV latent cache
# ---------------------------------------------------------------------------


def _mla_write(cache: Dict, rows: Dict[str, torch.Tensor]) -> Tuple[
        Dict[str, torch.Tensor], torch.Tensor]:
    """Write one token's latent-cache ``rows`` (name -> (B, F)) at
    position ``len`` of every row, clamped to the last slot (the
    reference's ``minimum(len, Sc - 1)``: a full cache overwrites its last
    position), contiguous or through the block table (a sentinel block is
    the sink), in place; then ``len`` += 1. Returns each written leaf's
    (B, Sc, F) view (a paged arena's gathered view, the sink excluded)
    and the new lengths."""
    first = cache[next(iter(rows))]
    cache_len = cache["len"]                                       # (B,)
    if "block_table" in cache:
        bt = cache["block_table"]                                  # (B, W)
        NB, bs = first.shape[0] - 1, first.shape[1]
        slot = cache_len.long().clamp(max=bt.shape[1] * bs - 1)
        blk = bt.gather(1, (slot // bs)[:, None])[:, 0].long()
        for name, new in rows.items():
            cache[name][blk, slot % bs] = new.to(cache[name].dtype)
        views = {n: paged_view(cache[n][:NB], bt) for n in rows}
    else:
        slot = cache_len.long().clamp(max=first.shape[1] - 1)
        b_iota = torch.arange(slot.shape[0], device=slot.device)
        for name, new in rows.items():
            cache[name][b_iota, slot] = new.to(cache[name].dtype)
        views = {n: cache[n] for n in rows}
    cache["len"].copy_(cache_len + 1)
    return views, cache["len"]


def _mla_absorbed(p: Params, q_nope, q_rope, lat, kr, new_len,
                  cfg: ModelConfig, out_dtype) -> torch.Tensor:
    """Weight-absorbed MLA decode attention (reference
    ``models/common.py:875-907``): ``wkv_b`` (dequantized when VQ'd) is
    folded into the query and output sides, and the scores and the
    weighted sum run over the (B, Sc, r) latent cache in fp32."""
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    node = p["wkv_b"]
    wb = dequantize(node["vq"]) if "vq" in node else node["w"]
    wb = wb.float().reshape(r, H, dn + dv)
    Wk, Wv = wb[..., :dn], wb[..., dn:]
    latf, krf = lat.float(), kr.float()
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope.float(), Wk)    # (B,1,H,r)
    s_nope = torch.einsum("bshr,bSr->bhsS", q_eff, latf)
    s_rope = torch.einsum("bshd,bSd->bhsS", q_rope.float(), krf)
    scores = (s_nope + s_rope) / math.sqrt(float(dn + dr))
    valid = (torch.arange(lat.shape[1], device=lat.device)[None, :]
             < new_len[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    attn = torch.softmax(scores, dim=-1)                          # (B,H,1,S)
    o_lat = torch.einsum("bhsS,bSr->bshr", attn, latf)
    return torch.einsum("bshr,rhv->bshv", o_lat, Wv).to(out_dtype)


def mla_fwd(p: Params, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig, *,
            positions: torch.Tensor, cache: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention (reference ``models/common.py:754-930``):
    K/V compressed to a ``kv_lora_rank`` latent (rmsnormed) plus one
    ``qk_rope_dim`` rope key shared by the heads per token; ``wkv_b``
    expands the latent into each head's no-rope key and value. A grouped
    ``wq_kva`` node runs q and kv_a as one matmul.

    Prefill expands the prompt's latent and attends through
    ``blocked_attention`` (q/k head dim dn + dr against v's dv), returning
    a fresh {"latent", "k_rope", "len"} cache. Decode (one token) writes
    the token's latent — fp, or under a KV-VQ cache (``latent_s`` present)
    uint8 indices and a bf16 scale encoded against ``p["kv_cb"]["lat"]``,
    one "head" of width r — and its rope key into the cache in place,
    contiguous or through the block table, then attends over the whole
    (dequantized, or gathered) latent cache: by default the faithful
    expand (``wkv_b`` over every cached position, then
    ``decode_attention``), under ``rc.mla_absorb`` in the latent space
    (``_mla_absorbed``). Attention is plain torch in every branch, as
    in the reference (its flash-decode kernels serve ``attention_fwd``
    only).

    Raises:
      NotImplementedError: a prefill over a paged cache (chunked prefill
        of an MLA cache is not supported, as in the reference).
      ValueError: a prefill over a contiguous cache."""
    B, S, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if "wq_kva" in p:
        q, kv_a = grouped_linear(p["wq_kva"], x, rc)
    else:
        q, kv_a = linear(p["wq"], x, rc), linear(p["wkv_a"], x, rc)
    q = q.reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    latent = rmsnorm(p["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)                           # (B,S,1,dr)

    def expand(lat, kr):
        kv = linear(p["wkv_b"], lat, rc).reshape(
            lat.shape[0], lat.shape[1], H, dn + dv)
        k_nope, vv = kv[..., :dn], kv[..., dn:]
        dt = torch.promote_types(k_nope.dtype, kr.dtype)
        kk = torch.cat([k_nope.to(dt),
                        kr.to(dt).expand(*k_nope.shape[:3], dr)], dim=-1)
        return kk, vv

    new_cache = None
    if cache is not None and rc.mode != "decode":
        if "block_table" in cache:
            raise NotImplementedError(
                "chunked prefill for MLA latent caches is not supported "
                "(serve/engine.py gates chunking off for use_mla models)")
        raise ValueError("an MLA prefill takes no cache")
    if cache is not None:
        rows = {"k_rope": k_rope.reshape(B, dr)}
        kvq = "latent_s" in cache
        if kvq:
            variant = rc.kv_vq.variant if rc.kv_vq is not None else "outlier"
            cb_lat = p["kv_cb"]["lat"]                          # (1,R,E,vd)
            idx, sc = kv_encode(latent[:, :, None, :], cb_lat, variant)
            rows.update(latent=idx.reshape(B, -1),
                        latent_s=sc.reshape(B, 1))
        else:
            rows["latent"] = latent.reshape(B, r)
        views, new_len = _mla_write(cache, rows)
        lat = (kv_decode(views["latent"][:, :, None, :], views["latent_s"],
                         cb_lat)[:, :, 0, :] if kvq else views["latent"])
        if rc.mla_absorb:
            o = _mla_absorbed(p, q_nope, q_rope, lat, views["k_rope"],
                              new_len, cfg, x.dtype)
        else:
            kk, vv = expand(lat, views["k_rope"][:, :, None, :])
            o = decode_attention(torch.cat([q_nope, q_rope], dim=-1), kk,
                                 vv, new_len)
        new_cache = cache
    else:
        kk, vv = expand(latent, k_rope)
        o = blocked_attention(torch.cat([q_nope, q_rope], dim=-1), kk, vv,
                              chunk=rc.attn_chunk)
        if rc.mode == "prefill":
            new_cache = {"latent": latent, "k_rope": k_rope.reshape(B, S, dr),
                         "len": (positions[:, -1] + 1).to(torch.int32)}
    y = linear(p["wo"], o.reshape(B, S, H * dv), rc)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP, embedding, LM head
# ---------------------------------------------------------------------------


def mlp_fwd(p: Params, x: torch.Tensor, rc: RunConfig) -> torch.Tensor:
    if "gu" in p:
        g, u = grouped_linear(p["gu"], x, rc)
    else:
        g, u = linear(p["gate"], x, rc), linear(p["up"], x, rc)
    return linear(p["down"], F.silu(g) * u, rc)


def gelu_mlp_fwd(p: Params, x: torch.Tensor, rc: RunConfig) -> torch.Tensor:
    """down(gelu(up(x))) with ``jax.nn.gelu``'s default, the tanh
    approximation."""
    return linear(p["down"], F.gelu(linear(p["up"], x, rc),
                                    approximate="tanh"), rc)


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots of each expert's buffer for ``T`` tokens: ceil(T * k / E x
    capacity_factor), at least 1 and at most T (the reference's
    expression, evaluated the same way)."""
    cap = max(1, int(math.ceil(T * cfg.top_k / cfg.num_experts
                               * cfg.capacity_factor)))
    return min(cap, T)


def _expert_node(node: Params, e: int) -> Params:
    """Expert ``e``'s linear node of an E-stacked one: its VQWeight
    (``vq_index``) or dense weight, with the node's other leaves."""
    return {k: (vq_index(v, e) if k == "vq" else v[e]) for k, v in node.items()}


def _expert_ffn(ep: Params, x: torch.Tensor, rc: RunConfig) -> torch.Tensor:
    """x: (E, cap, D) -> (E, cap, D): each expert's SwiGLU MLP over its
    ``cap`` rows, one expert at a time (the reference vmaps it over E),
    empty rows included: every linear goes through the planner at M =
    cap (under ``impl="cuda"`` B1 in decode, B3 in prefill), grouped
    gate|up as one ``gu`` matmul per expert."""
    outs = []
    for e in range(x.shape[0]):
        if "gu" in ep:
            g, u = grouped_linear(_expert_node(ep["gu"], e), x[e], rc)
        else:
            g = linear(_expert_node(ep["gate"], e), x[e], rc)
            u = linear(_expert_node(ep["up"], e), x[e], rc)
        outs.append(linear(_expert_node(ep["down"], e), F.silu(g) * u, rc))
    return torch.stack(outs)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows of ``idx`` (a comparison: no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_route(logits: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, int]:
    """Token-choice top-k routing with capacity (reference
    ``models/common.py:1038-1066``) from the router's fp32 logits (T,
    E): the fp32 softmax, the top k gates (a stable descending sort:
    equal gates keep the lower expert first, as ``lax.top_k`` does)
    renormalized, and each (token, choice)'s position in its expert's
    buffer counted in integers (the reference's fp32 cumsum is exact at
    these counts). Returns (topi (T, k), topv (T, k) fp32, pos (T*k,)
    int64, keep (T*k,) bool, cap)."""
    T, E, k = logits.shape[0], cfg.num_experts, cfg.top_k
    gates = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = srt[:, :k], order[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    cap = moe_capacity(cfg, T)
    flat = (topi.reshape(T * k, 1)
            == torch.arange(E, device=logits.device)).long()      # (T*k, E)
    pos = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1)     # (T*k,)
    return topi, topv, pos, pos < cap, cap


def moe_fwd(p: Params, x: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig) -> torch.Tensor:
    """Token-choice top-k MoE with capacity-based dense dispatch
    (reference ``models/common.py:1038-1099``): route (``moe_route``;
    the router's product in fp32, never quantized), gather each kept
    (token, choice) into its expert's (cap, D) buffer, run every expert
    over its buffer (``_expert_ffn``), and combine the kept outputs
    weighted by the renormalized gates in fp32. A choice past its
    expert's capacity is dropped (weight 0). Decode-sized dispatch (T*k
    *E*cap <= 2^22) uses one-hot einsums, longer prefills a scatter and
    gather, as the reference; both are exact (one nonzero term per
    slot). Everything is static-shaped: no host sync, so a CUDA graph
    holds it. Shared experts add an MLP over every token."""
    orig = x.shape
    D = orig[-1]
    xt = x.reshape(-1, D)                                          # (T, D)
    T, E, k = xt.shape[0], cfg.num_experts, cfg.top_k
    logits = torch.matmul(xt.float(),
                          p["router"]["wr"].to(xt.dtype).float())  # (T, E)
    topi, topv, pos, keep, cap = moe_route(logits, cfg)
    expert_of = topi.reshape(T * k)
    weight_of = topv.reshape(T * k) * keep
    tok_of = torch.arange(T, device=x.device)[:, None].expand(T, k).reshape(-1)
    slot = pos.clamp(max=cap - 1)
    if T * k * E * cap <= (1 << 22):
        oh = _one_hot(expert_of, E) * keep[:, None].float()       # (T*k, E)
        ohc = oh[:, :, None] * _one_hot(slot, cap)[:, None, :]
        disp = torch.einsum("sec,sd->ecd", ohc,
                            xt[tok_of].float()).to(xt.dtype)
        out_e = _expert_ffn(p["experts"], disp, rc)               # (E, cap, D)
        gathered = torch.einsum("sec,ecd->sd", ohc, out_e.float())
    else:
        disp = torch.zeros((E, cap, D), dtype=xt.dtype, device=x.device)
        disp.index_put_((expert_of, slot),
                        torch.where(keep[:, None], xt[tok_of],
                                    torch.zeros_like(xt[tok_of])),
                        accumulate=True)
        out_e = _expert_ffn(p["experts"], disp, rc)
        gathered = out_e[expert_of, slot].float()                 # (T*k, D)
    comb = (gathered * weight_of[:, None]).reshape(T, k, D).sum(1)
    y = comb.to(x.dtype)
    if cfg.num_shared_experts:
        y = y + mlp_fwd(p["shared"], xt, rc)
    return y.reshape(orig)


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if tp.rows_sharded(p["emb"]):  # a vocab sharded over ``model``
        return tp.vocab_parallel_embed(p["emb"], tokens).to(dtype)
    return p["emb"][tokens].to(dtype)


def lm_head(p: Optional[Params], x: torch.Tensor, rc: RunConfig,
            emb_params=None) -> torch.Tensor:
    if p is None:  # tied
        w = emb_params["emb"].t().to(x.dtype)
        return core_ops.fp_matmul(x, w, out_dtype=torch.float32)
    return linear(p, x, rc, out_dtype=torch.float32)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits (B, S, V) fp32,
    labels (B, S) int; with ``mask`` (B, S) the mask-weighted mean (over
    at least one position)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
