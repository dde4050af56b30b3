"""xLSTM family (arXiv:2405.04517; ``repro/models/xlstm.py``):
alternating mLSTM / sLSTM blocks.

mLSTM: a matrix memory C (hd x hd a head) with an exponential input gate
and a sigmoid forget gate; decode runs the sequential recurrence
(``mlstm_sequential``), prefill the chunkwise-parallel form
(``mlstm_chunkwise``: an attention-like quadratic form inside each chunk,
the state carried across chunks), which the tests hold to each other.

sLSTM: a scalar memory with exponential gating and block-diagonal (per
head) recurrent weights ``rz``; prefill and decode scan over time.

Blocks (``d_ff = 0``: the projections live inside them):
  mLSTM block: x + down(mLSTM(up_h(norm(x))) * silu(up_g(norm(x))))
  sLSTM block: x + out(sLSTM(norm(x))), then x + ffn(norm(x)) (pf 4/3)

The reference stacks its G = num_layers / len(xlstm_pattern) groups on a
leading axis and scans them; here ``params["groups"]`` is a list of G
per-group dicts walked by a Python loop, and the decode cache keeps the
reference's stacked layout, batch on axis 1: {"b0_mlstm": {"C" (G, B, H,
hd, hd), "n" (G, B, H, hd), "m" (G, B, H)}, "b1_slstm": {"c", "n", "h"
(G, B, H, hd), "m" (G, B, H)}}, all fp32 and of a size that does not
grow with the sequence. Decode updates each group's slice of every leaf
in place (``copy_``), so a captured graph reads and writes fixed
buffers, and reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.roofline import counting
from repro_torch.models.common import ModelConfig, RunConfig

MLSTM_PF = 2      # mLSTM up-projection factor
SLSTM_PF = 4 / 3  # sLSTM FFN projection factor


def _di(cfg: ModelConfig) -> int:  # mLSTM inner dim
    return MLSTM_PF * cfg.d_model


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def make_mlstm_block(gen, cfg: ModelConfig, *, device, block_device) -> Any:
    """The block's projections on ``block_device``; the dense gates
    ``w_if`` (di, 2H, biased: never quantized, N = 2H is below the
    quantizer's 64) and the norm on ``device``."""
    D, di, H = cfg.d_model, _di(cfg), cfg.num_heads
    lin = lambda K, N: cm.make_linear(gen, K, N, device=block_device)
    return {"norm": cm.make_rmsnorm(D, device),
            "up_h": lin(D, di), "up_g": lin(D, di),
            "wq": lin(di, di), "wk": lin(di, di), "wv": lin(di, di),
            "w_if": cm.make_linear(gen, di, 2 * H, device=device, bias=True),
            "down": lin(di, D)}


def _mlstm_gates(p, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log i~, log f) (B, S, H) fp32 from ``w_if``: dense, always (the
    reference runs it with ``mode="train"``)."""
    g = cm.linear(p["w_if"], h, RunConfig(mode="train"))
    gi, gf = g.float().chunk(2, dim=-1)
    return gi, F.logsigmoid(gf)


def mlstm_sequential(q, k, v, log_i, log_f, state):
    """The recurrence (decode and the oracle). q/k/v (B, S, H, hd);
    log_i/log_f (B, S, H); state {"C" (B, H, hd, hd), "n" (B, H, hd),
    "m" (B, H)}. Returns (out (B, S, H, hd) fp32, new state)."""
    hd = q.shape[-1]
    qs = q.float() / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt = qs[:, t], kf[:, t], vf[:, t]
        li, lf = log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)
        f_ = torch.exp(lf + m - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])          # (B, H, hd_v, hd_k)
        n = f_[..., None] * n + i_[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_chunkwise(q, k, v, log_i, log_f, state, *, chunk: int = 256):
    """The chunkwise-parallel mLSTM (prefill): in each chunk of L
    positions a stabilized quadratic form (attention with a decay mask)
    plus the carried state's contribution, then the state moved to the
    chunk's end. The sequence pads to whole chunks (log i~ with -1e30, so
    pad positions add nothing); ``cummax`` is ``jax.lax.cummax``."""
    B, S, H, hd = q.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    qs = q.float() / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    iota = torch.arange(L, device=q.device)
    causal = (iota[:, None] >= iota[None, :])[None, :, :, None]
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for c in range(q.shape[1] // L):
        sl = slice(c * L, (c + 1) * L)
        qt, kt, vt, li, lf = qs[:, sl], kf[:, sl], vf[:, sl], log_i[:, sl], \
            log_f[:, sl]
        b = torch.cumsum(lf, dim=1)        # decay from the chunk's start
        total = b[:, -1]                   # (B, H)
        a_max = torch.cummax(li - b, dim=1).values
        m_state = b + m[:, None, :]
        m_t = torch.maximum(a_max + b, m_state)                   # (B, L, H)
        w_state = torch.exp(m_state - m_t)
        num_state = torch.einsum("bhvk,blhk->blhv", C, qt) * w_state[..., None]
        den_state = torch.einsum("bhk,blhk->blh", n, qt) * w_state
        # D[t, s] = exp(b_t - b_s + li_s - m_t) for s <= t
        d_log = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :]
        d_log = torch.where(causal, d_log, torch.full_like(d_log, -1e30))
        scores = torch.einsum("blhk,bshk->blsh", qt, kt) * torch.exp(
            d_log - m_t[:, :, None, :])
        num = num_state + torch.einsum("blsh,bshv->blhv", scores, vt)
        den = den_state + scores.sum(dim=2)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        m_end = torch.maximum(total + m, a_max[:, -1] + total)
        decay = torch.exp(total + m - m_end)                      # (B, H)
        w_s = torch.exp(total[:, None] - b + li - m_end[:, None])  # (B, L, H)
        C = decay[..., None, None] * C + torch.einsum(
            "bshv,bshk->bhvk", vt * w_s[..., None], kt)
        n = decay[..., None] * n + torch.einsum("bshk,bsh->bhk", kt, w_s)
        m = m_end
    return torch.cat(hs, dim=1)[:, :S], {"C": C, "n": n, "m": m}


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    H, hd = cfg.num_heads, _di(cfg) // cfg.num_heads
    z = lambda *s: torch.zeros(lead + (batch, H) + s, device=device)
    return {"C": z(hd, hd), "n": z(hd), "m": z()}


def mlstm_block_fwd(p, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
                    state: Optional[Dict] = None):
    """The mLSTM block; a grouped ``wqkv`` runs q|k|v as one matmul. From
    ``state`` (None: zeros), sequential in decode, chunkwise (chunk
    ``min(attn_chunk, 256)``) otherwise. Returns (x + y, the new state in
    decode and prefill, else None)."""
    B, S, _ = x.shape
    H, di = cfg.num_heads, _di(cfg)
    xn = cm.rmsnorm(p["norm"], x, cfg.norm_eps)
    h = cm.linear(p["up_h"], xn, rc)
    g = cm.linear(p["up_g"], xn, rc)
    if "wqkv" in p:
        q, k, v = cm.grouped_linear(p["wqkv"], h, rc)
    else:
        q, k, v = (cm.linear(p[w], h, rc) for w in ("wq", "wk", "wv"))
    q, k, v = (t.reshape(B, S, H, di // H) for t in (q, k, v))
    log_i, log_f = _mlstm_gates(p, h)
    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    if rc.mode == "decode":
        out, new_state = mlstm_sequential(q, k, v, log_i, log_f, state)
    else:
        out, new_state = mlstm_chunkwise(q, k, v, log_i, log_f, state,
                                         chunk=min(rc.attn_chunk, 256))
    out = out.reshape(B, S, di).to(x.dtype) * F.silu(g)
    y = cm.linear(p["down"], out, rc)
    return x + y, (new_state if rc.mode in ("decode", "prefill") else None)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def make_slstm_block(gen, cfg: ModelConfig, *, device, block_device) -> Any:
    """The block's projections on ``block_device`` (their biases on
    ``device``); the dense gates ``wi``/``wf`` (D, H, biased), the
    recurrent ``rz`` (H, hd, hd) and the norms on ``device``."""
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    d_ffn = int(SLSTM_PF * D) // 8 * 8
    biased = lambda N: cm.make_linear(gen, D, N, device=block_device,
                                      bias=True, bias_device=device)
    return {"norm": cm.make_rmsnorm(D, device),
            "wz": biased(D),
            "wi": cm.make_linear(gen, D, H, device=device, bias=True),
            "wf": cm.make_linear(gen, D, H, device=device, bias=True),
            "wo": biased(D),
            "rz": torch.randn((H, hd, hd), generator=gen, device=device)
            / math.sqrt(hd),
            "out": cm.make_linear(gen, D, D, device=block_device),
            "ffn_norm": cm.make_rmsnorm(D, device),
            "ffn": cm.make_gelu_mlp(gen, D, d_ffn, device=device,
                                    block_device=block_device)}


def slstm_scan(p, z_in, i_in, f_in, o_in, state, H: int, hd: int):
    """The sLSTM over time. *_in (B, S, ...) are the input's
    preactivations; the recurrent term (``rz`` h) is added inside the
    scan. ``rz`` is bf16 in a served tree and h fp32: the einsum runs in
    fp32 (``jnp.einsum`` promotes; the upcast is exact). Returns (h (B,
    S, H, hd) fp32, new state)."""
    B, S, _ = z_in.shape
    rz = p["rz"].float()
    zs, is_, fs, os_ = (t.float() for t in (z_in, i_in, f_in, o_in))
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    run, count = counting.scan_steps(S, zs)   # the dry run: one step
    with counting.repeated(count):
        for t in range(run):
            h, c, n, m = _slstm_step(rz, zs[:, t], is_[:, t], fs[:, t],
                                     os_[:, t], c, n, h, m, H, hd)
            hs.append(h)
    return torch.stack(hs * count, dim=1), {"c": c, "n": n, "h": h, "m": m}


def _slstm_step(rz, z_t, i_t, f_t, o_t, c, n, h, m, H: int, hd: int):
    """One sLSTM step: (h, c, n, m) after it."""
    B = z_t.shape[0]
    rec = torch.einsum("bhk,hvk->bhv", h, rz)
    z = torch.tanh(z_t.reshape(B, H, hd) + rec)
    li = i_t                          # log-space input gate preact
    lf = F.logsigmoid(f_t)            # sigmoid forget gate
    m_new = torch.maximum(lf + m, li)
    i_ = torch.exp(li - m_new)
    f_ = torch.exp(lf + m - m_new)
    c = f_[..., None] * c + i_[..., None] * z
    n = f_[..., None] * n + i_[..., None]
    h = torch.sigmoid(o_t.reshape(B, H, hd)) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Zeros, but ``n`` = 1e-6, as the reference's."""
    shape = lead + (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.full(shape, 1e-6, device=device),
            "h": torch.zeros(shape, device=device),
            "m": torch.zeros(shape[:-1], device=device)}


def slstm_block_fwd(p, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
                    state: Optional[Dict] = None):
    """The sLSTM block then its GELU FFN; ``wi``/``wf`` give fp32
    preactivations. Returns (x, the new state in decode and prefill, else
    None)."""
    B, S, D = x.shape
    H = cfg.num_heads
    xn = cm.rmsnorm(p["norm"], x, cfg.norm_eps)
    z_in = cm.linear(p["wz"], xn, rc)
    i_in = cm.linear(p["wi"], xn, rc, out_dtype=torch.float32)
    f_in = cm.linear(p["wf"], xn, rc, out_dtype=torch.float32)
    o_in = cm.linear(p["wo"], xn, rc)
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    hs, new_state = slstm_scan(p, z_in, i_in, f_in, o_in, state, H, D // H)
    x = x + cm.linear(p["out"], hs.reshape(B, S, D).to(x.dtype), rc)
    h2 = cm.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    x = x + cm.gelu_mlp_fwd(p["ffn"], h2, rc)
    return x, (new_state if rc.mode in ("decode", "prefill") else None)


# ---------------------------------------------------------------------------
# The model: pattern ("mlstm", "slstm") x G groups
# ---------------------------------------------------------------------------


def _blocks(cfg: ModelConfig):
    """(cache/param name, kind) of each block of a group."""
    return [(f"b{i}_{kind}", kind) for i, kind in enumerate(cfg.xlstm_pattern)]


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device,
                block_device) -> Any:
    """Dense params drawn from ``gen``: ``"groups"``, a list of G per-group
    dicts {"b0_mlstm": ..., "b1_slstm": ...}; the block projections on
    ``block_device`` (``"meta"`` keeps only their shapes)."""
    period = len(cfg.xlstm_pattern)
    if cfg.num_layers % period:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple of "
                         f"the pattern's {period} blocks")
    kw = {"device": device, "block_device": block_device}
    groups = [{name: (make_mlstm_block if kind == "mlstm"
                      else make_slstm_block)(gen, cfg, **kw)
               for name, kind in _blocks(cfg)}
              for _ in range(cfg.num_layers // period)]
    return {"embedding": cm.make_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                           device),
            "groups": groups,
            "final_norm": cm.make_rmsnorm(cfg.d_model, device),
            "lm_head": cm.make_linear(gen, cfg.d_model, cfg.padded_vocab,
                                      device=device)}


def _group_fwd(gp, x: torch.Tensor, rc: RunConfig, cfg: ModelConfig,
               cache: Optional[Dict]):
    """One group's blocks. With ``cache`` (this group's slice of each
    leaf) the blocks start from it and their new state is written back
    into it in place."""
    new_cache = {}
    for name, kind in _blocks(cfg):
        st = None if cache is None else cache[name]
        fwd = mlstm_block_fwd if kind == "mlstm" else slstm_block_fwd
        x, ns = fwd(gp[name], x, rc, cfg, st)
        if st is not None and ns is not None:
            for leaf, t in ns.items():
                st[leaf].copy_(t)
        new_cache[name] = ns
    return x, (new_cache if rc.mode in ("decode", "prefill") else None)


def forward(params: Any, tokens: torch.Tensor, rc: RunConfig,
            cfg: ModelConfig, *, positions: Optional[torch.Tensor] = None,
            caches: Optional[Any] = None) -> Tuple[torch.Tensor, Optional[Any]]:
    """tokens (B, S) -> fp32 logits (B, S, padded_vocab) (prefill under
    ``rc.lm_head_last_only``: (B, 1, padded_vocab)) and the caches: a
    fresh stacked cache in prefill; ``caches`` updated in place when
    given; None otherwise. ``positions`` are not read: the state carries
    the position."""
    x = cm.embed(params["embedding"], tokens, cfg.act_dtype)
    made = []
    group = cm.remat_layer(_group_fwd, rc)
    for g, gp in enumerate(params["groups"]):
        cache = (None if caches is None else
                 {name: {n: t[g] for n, t in node.items()}
                  for name, node in caches.items()})
        x, nc = group(gp, x, rc, cfg, cache)
        if caches is None and nc is not None:
            made.append(nc)
    if rc.mode == "prefill" and rc.lm_head_last_only:
        x = x[:, -1:]  # skip the vocab projection of the prompt's tokens
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.lm_head(params["lm_head"], x, rc)
    if caches is not None:
        return logits, caches
    if rc.mode == "prefill":
        return logits, {name: {n: torch.stack([c[name][n] for c in made])
                               for n in made[0][name]}
                        for name in made[0]}
    return logits, None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Dict[str, Any]:
    """The stacked recurrent state of every group (module docstring), as
    the reference's ``init_cache`` makes it: fp32 zeros but sLSTM's ``n``
    = 1e-6. Its size does not depend on ``max_len`` or ``dtype``."""
    lead = (cfg.num_layers // len(cfg.xlstm_pattern),)
    return {name: (init_mlstm_state if kind == "mlstm" else
                   init_slstm_state)(cfg, batch, device, lead)
            for name, kind in _blocks(cfg)}
