"""VQ weights: additive multi-codebook quantized matrices (the weight half
of ``repro/core/vq.py``).

Terminology follows the paper (Tbl. II):
  W      : (K, N) weight matrix
  d      : vector dimension (default 8)
  n      : index bit-width (default 8 -> 2^n = 256 centroids)
  C      : number of additive codebooks
  V      : K // d, height of the index matrix
  I      : (C, V, N) uint8 weight-index matrix
  B      : (C, d, 2^n) codebooks (centroid e is the column B[c, :, e])
  scale  : (N,) per-output-channel scale (fp32)

  W_hat[:, j] = scale[j] * concat_v( sum_c B[c, :, I[c, v, j]] )

A grouped projection family (Wq|Wk|Wv, W_gate|W_up) is ONE wide VQWeight
of shape (K, sum N_i) with one codebook set; ``splits`` records the member
widths (``()`` for an ordinary weight).

A MoE layer's experts are one VQWeight stacked on a leading E axis
(``idx`` (E, C, V, N), ``codebooks`` (E, C, d, 2^n), ``scale`` (E, N)),
as the reference stacks them; ``vq_index`` gives expert e's (K, N)
weight as contiguous views, the layout the kernels take.

``kmeans`` (Lloyd's, k-means++ seeded) draws from an explicit
``torch.Generator`` where the reference splits ``jax.random`` keys, so
its centroids are not the reference's bit for bit; its assignment step
is (``_assign``, over chunks of points so that a full-width matrix never
materializes its whole (P, 256) distance table). ``fit_vq`` fits a
weight with it (greedy residual stages, then alternating refits), the
VQ-Logits head (``core/logits_vq.py``) too.

The KV half (``KVQuantConfig``, ``kv_scale``, ``kv_grid_codebooks``,
``fit_kv_codebooks``, ``kv_encode``, ``kv_decode``) vector-quantizes K/V
cache slices against per-head codebooks; ``fit_kv_codebooks`` runs one
k-means with a leading head axis (``kmeans_batched``) for every head at
once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass
class VQWeight:
    """Quantized (K, N) weight: tensors plus static metadata."""

    idx: torch.Tensor        # (C, V, N) uint8 (n <= 8) or int32 (n > 8)
    codebooks: torch.Tensor  # (C, d, 2^n) fp32
    scale: torch.Tensor      # (N,) fp32
    K: int = 0
    N: int = 0
    d: int = 8
    n: int = 8
    splits: Tuple[int, ...] = ()

    @property
    def C(self) -> int:
        return int(self.codebooks.shape[-3])

    @property
    def V(self) -> int:
        return self.K // self.d

    @property
    def bits_per_weight(self) -> float:
        return self.C * self.n / self.d

    @property
    def lead(self) -> int:
        """Weights stacked on leading axes (E for a MoE layer's experts;
        1 for an ordinary weight)."""
        return int(np.prod(self.idx.shape[:-3], dtype=np.int64))

    def compressed_bytes(self) -> int:
        """Bytes of the indices, the fp32 codebooks and the fp32 scales
        (of every stacked weight)."""
        idx_bytes = self.C * self.V * self.N * (1 if self.n <= 8 else 4)
        cb_bytes = self.C * self.d * (2 ** self.n) * 4
        return self.lead * (idx_bytes + cb_bytes + self.N * 4)


def vq_index(vq: VQWeight, i: int) -> VQWeight:
    """Weight ``i`` of a VQWeight stacked on a leading axis (a MoE
    layer's expert i): views of its indices, codebooks and scale, each
    contiguous when the stack is."""
    return VQWeight(idx=vq.idx[i], codebooks=vq.codebooks[i],
                    scale=vq.scale[i], K=vq.K, N=vq.N, d=vq.d, n=vq.n,
                    splits=vq.splits)


def dequantize(vq: VQWeight) -> torch.Tensor:
    """Reconstruct W_hat (K, N) fp32 — the conventional-VQ baseline."""
    cb = vq.codebooks.float().transpose(-1, -2)        # (C, k, d)
    idx = vq.idx.long()                                # (C, V, N)
    C = cb.shape[0]
    # cents[c, v, j, :] = cb[c, idx[c, v, j], :]
    cents = torch.stack([cb[c][idx[c]] for c in range(C)])  # (C, V, N, d)
    cents = cents.sum(dim=0)                           # (V, N, d)
    V, N, d = cents.shape
    W = cents.permute(0, 2, 1).reshape(V * d, N)
    return W * vq.scale.float()[None, :]


def synthetic_vq(generator: torch.Generator, K: int, N: int, *, d: int = 8,
                 n: int = 8, C: int = 2, splits: Tuple[int, ...] = (),
                 lead: Tuple[int, ...] = (), device=None) -> VQWeight:
    """Random-but-valid VQ weight drawn on ``device`` from ``generator``
    (which must live on the same device): uniform indices, codebooks
    ~ N(0, 1/(K*C)) so W_hat has unit-ish variance, unit scales.
    ``lead`` stacks that many independent weights on leading axes (a
    MoE layer's experts: ``lead=(E,)``)."""
    if splits and sum(splits) != N:
        raise ValueError(f"splits {splits} do not sum to N={N}")
    if K % d:
        raise ValueError(f"K={K} not divisible by d={d}")
    V, k = K // d, 2 ** n
    lead = tuple(lead)
    idx_dtype = torch.uint8 if n <= 8 else torch.int32
    idx = torch.randint(0, k, lead + (C, V, N), generator=generator,
                        device=device, dtype=idx_dtype)
    codebooks = torch.randn(lead + (C, d, k), generator=generator,
                            device=device,
                            dtype=torch.float32) / math.sqrt(K * C)
    scale = torch.ones(lead + (N,), dtype=torch.float32, device=device)
    return VQWeight(idx=idx, codebooks=codebooks, scale=scale, K=K, N=N, d=d,
                    n=n, splits=tuple(splits))


def split_grouped(vq: VQWeight) -> Tuple[VQWeight, ...]:
    """Slice a grouped VQWeight back into its members (shared codebooks,
    per-member index columns and scales)."""
    if not vq.splits:
        return (vq,)
    out = []
    lo = 0
    for width in vq.splits:
        hi = lo + width
        out.append(VQWeight(idx=vq.idx[..., lo:hi], codebooks=vq.codebooks,
                            scale=vq.scale[..., lo:hi], K=vq.K, N=width,
                            d=vq.d, n=vq.n))
        lo = hi
    return tuple(out)


# ---------------------------------------------------------------------------
# k-means (Lloyd) with k-means++ seeding
# ---------------------------------------------------------------------------


# bytes of one chunk's (points, centroids) distance table in ``_assign``
_ASSIGN_TABLE_BYTES = 1 << 30


def _assign(points: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment, points (..., P, d), cents (..., k, d)
    -> (..., P) int32, by the reference's expansion ||c||^2 - 2 p.c
    (||p||^2 is the same for every centroid); ties to the lowest centroid
    id. The points go in chunks whose distance table stays under
    ``_ASSIGN_TABLE_BYTES`` (one chunk, the whole table, below it)."""
    P, k = points.shape[-2], cents.shape[-2]
    lead = int(np.prod(points.shape[:-2], dtype=np.int64))
    step = max(1, _ASSIGN_TABLE_BYTES // (4 * k * lead))
    ct = cents.transpose(-1, -2)
    norms = (cents ** 2).sum(dim=-1).unsqueeze(-2)
    return torch.cat([
        torch.argmin(-2.0 * points[..., lo:lo + step, :] @ ct + norms,
                     dim=-1).to(torch.int32)
        for lo in range(0, P, step)], dim=-1)


def _update(points: torch.Tensor, assign: torch.Tensor, k: int,
            generator: torch.Generator) -> torch.Tensor:
    """The means of each centroid's points, points (..., P, d), assign
    (..., P) -> (..., k, d), each leading index its own set; an empty
    centroid is re-seeded from a random point of its set (so none
    collapses)."""
    lead, (P, d) = points.shape[:-2], points.shape[-2:]
    H, dev = int(np.prod(lead, dtype=np.int64)), points.device
    pts = points.reshape(H, P, d)
    rows = torch.arange(H, device=dev)
    idx = (assign.reshape(H, P).long() + (rows * k)[:, None]).reshape(-1)
    sums = torch.zeros((H * k, d), dtype=points.dtype,
                       device=dev).index_add_(0, idx, pts.reshape(H * P, d))
    counts = torch.bincount(idx, minlength=H * k).to(points.dtype)
    cents = (sums / counts.clamp(min=1.0)[:, None]).reshape(H, k, d)
    rnd = pts[rows[:, None], torch.randint(0, P, (H, k), generator=generator,
                                           device=dev)]
    return torch.where((counts > 0).reshape(H, k, 1), cents,
                       rnd).reshape(*lead, k, d)


# ``torch.multinomial`` draws from at most 2^24 categories: a k-means++
# seed over more points per set is drawn by inverse CDF instead
MULTINOMIAL_MAX_POINTS = 1 << 24
_CDF_CHUNK = 1 << 22      # points a chunk of the fp64 cumulative sum


def _inverse_cdf_draw(dists: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """One index a set of ``dists`` (H, P) fp32 >= 0, drawn with
    probability proportional to its distance: one fp64 uniform u per set
    from ``generator``, the first index whose running fp64 sum exceeds
    u x the total (the sum taken chunk by chunk, ``_CDF_CHUNK`` points at
    a time, twice, the same way: first for the total, then to search), so
    a zero-distance point is never picked; a set whose every distance is
    0 takes floor(u x P), a uniform index. Returns (H,) int64."""
    H, P = dists.shape
    u = torch.rand((H,), generator=generator, device=dists.device,
                   dtype=torch.float64)

    def running():
        run = torch.zeros((H,), dtype=torch.float64, device=dists.device)
        for lo in range(0, P, _CDF_CHUNK):
            c = torch.cumsum(dists[:, lo:lo + _CDF_CHUNK].double(), dim=-1)
            c = c + run[:, None]
            yield lo, c
            run = c[:, -1]

    for _, c in running():
        total = c[:, -1]
    # strictly below the total, so the last point with a distance is hit
    target = torch.minimum(u * total, torch.nextafter(total,
                                                      torch.zeros_like(total)))
    pick = torch.full((H,), P, dtype=torch.int64, device=dists.device)
    for lo, c in running():
        j = torch.searchsorted(c, target[:, None], right=True)[:, 0]
        pick = torch.minimum(pick, torch.where(j < c.shape[1], lo + j,
                                               torch.full_like(j, P)))
    uniform = (u * P).long().clamp(max=P - 1)
    return torch.where(total > 0, pick, uniform)


def kmeans_batched(generator: torch.Generator, points: torch.Tensor, k: int,
                   iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means of H independent fp32 point sets at once,
    ``points`` (H, P, d), in one launch sequence: k-means++ seeding (each
    next centroid drawn with probability proportional to its squared
    distance from the nearest so far, uniformly where every distance is
    0; one ``torch.multinomial`` draws the H sets' next centroids, or
    above ``MULTINOMIAL_MAX_POINTS`` points a set, ``torch.multinomial``'s
    limit, an inverse-CDF draw, ``_inverse_cdf_draw``), then
    ``iters`` assign/update rounds (an empty centroid re-seeded from a
    random point of its set), every draw from ``generator`` (on the
    points' device). Returns (centroids (H, k, d), assignment (H, P)
    int32)."""
    points = points.float()
    H, P, d = points.shape
    dev = points.device
    rows = torch.arange(H, device=dev)
    first = points[rows, torch.randint(0, P, (H,), generator=generator,
                                       device=dev)]           # (H, d)
    cents = torch.zeros((H, k, d), dtype=points.dtype, device=dev)
    cents[:, 0] = first
    dists = ((points - first[:, None]) ** 2).sum(dim=-1)      # (H, P)
    for i in range(1, k):
        if P > MULTINOMIAL_MAX_POINTS:
            pick = _inverse_cdf_draw(dists, generator)
        else:
            total = dists.sum(dim=-1, keepdim=True)
            probs = torch.where(total > 0, dists / total.clamp(min=1e-30),
                                torch.full_like(dists, 1.0 / P))
            pick = torch.multinomial(probs, 1, generator=generator)[:, 0]
        nxt = points[rows, pick]
        cents[:, i] = nxt
        dists = torch.minimum(dists, ((points - nxt[:, None]) ** 2).sum(-1))
    for _ in range(iters):
        cents = _update(points, _assign(points, cents), k, generator)
    return cents, _assign(points, cents)


def kmeans(generator: torch.Generator, points: torch.Tensor, k: int,
           iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means over fp32 ``points`` (P, d): ``kmeans_batched`` of
    one set. Returns (centroids (k, d), assignment (P,) int32)."""
    cents, assign = kmeans_batched(generator, points[None], k, iters)
    return cents[0], assign[0]


# ---------------------------------------------------------------------------
# Additive VQ fit (greedy residual stages + optional alternating refits)
# ---------------------------------------------------------------------------


def fit_vq(generator: torch.Generator,
           W: Union[torch.Tensor, Sequence[torch.Tensor]], *, d: int = 8,
           n: int = 8, C: int = 2, kmeans_iters: int = 20,
           refine_rounds: int = 1) -> VQWeight:
    """Quantize W (K, N) to an additive C-codebook VQ weight on W's
    device, every k-means draw from ``generator`` (on that device).

    The columns are normalized by their rms (``scale``, fp32 (N,)), then
    viewed column-major as (V*N, d) points (the d consecutive elements
    along K of each column). Codebook c is k-means over the residual of
    codebooks < c; ``refine_rounds`` then refit each codebook against the
    residual of all the others, at half the iterations (at least 5).

    Grouped mode: a sequence of matrices of equal K is fitted as ONE
    (K, sum N_i) matrix with one codebook set; ``splits`` records the
    member widths.

    Raises:
      ValueError: grouped members of unequal K, or K not divisible by d.
    """
    splits: Tuple[int, ...] = ()
    if isinstance(W, (list, tuple)):
        Ks = {int(w.shape[0]) for w in W}
        if len(Ks) != 1:
            raise ValueError(f"grouped fit_vq requires equal K, got {Ks}")
        splits = tuple(int(w.shape[1]) for w in W)
        W = torch.cat(list(W), dim=1)
    K, N = W.shape
    if K % d:
        raise ValueError(f"K={K} not divisible by d={d}")
    V, k = K // d, 2 ** n
    W = W.float()
    scale = torch.clamp(torch.sqrt(torch.mean(W * W, dim=0)), min=1e-8)
    pts = (W / scale[None, :]).reshape(V, d, N).transpose(1, 2).reshape(
        V * N, d)
    del W
    codebooks, assigns = [], []
    resid = pts
    for _ in range(C):
        cents, a = kmeans(generator, resid, k, iters=kmeans_iters)
        codebooks.append(cents)
        assigns.append(a)
        resid = resid - cents[a.long()]
    del resid
    for _ in range(refine_rounds):
        for c in range(C):
            others = torch.zeros_like(pts)
            for c2 in range(C):
                if c2 != c:
                    others = others + codebooks[c2][assigns[c2].long()]
            codebooks[c], assigns[c] = kmeans(
                generator, pts - others, k, iters=max(kmeans_iters // 2, 5))
    B = torch.stack([cb.T for cb in codebooks])          # (C, d, k)
    idx_dtype = torch.uint8 if n <= 8 else torch.int32
    I = torch.stack([a.reshape(V, N) for a in assigns]).to(idx_dtype)
    return VQWeight(idx=I, codebooks=B.contiguous(), scale=scale, K=K, N=N,
                    d=d, n=n, splits=splits)


def reconstruction_error(W: torch.Tensor, vq: VQWeight) -> torch.Tensor:
    """Relative Frobenius reconstruction error ||W - W_hat|| / ||W||
    (fp32, 0-d)."""
    W = W.float()
    return (torch.linalg.norm(W - dequantize(vq))
            / torch.linalg.norm(W).clamp(min=1e-30))


# ---------------------------------------------------------------------------
# KV-cache vector quantization
# ---------------------------------------------------------------------------
#
# A (.., Hk, hd) K/V slice stores as uint8 indices (.., Hk, R*G) with
# G = hd // vec_d (R additive residual stages of 256 entries, one uint8
# each) plus ONE fp scale per (token, head). Effective bits per channel
# are 8*R/vec_d: KVQuantConfig(kv_bits=4) is 4-bit KV, kv_bits=2 2-bit.

KV_VARIANTS = ("outlier", "rms")


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """Frozen geometry/variant selector for vector-quantized KV caches.

    Args:
      kv_bits: effective stored bits per K/V channel (4 or 2).
      residual: number of additive codebook stages R (>= 1); 8*R/vec_d
        = kv_bits.
      variant: per-(token, head) scale rule applied before assignment:
        "outlier" divides by the absmax channel, "rms" by 2*rms.
      entries: codebook entries per stage; fixed at 256 (one uint8).

    Raises:
      ValueError: on unknown variant, unsupported kv_bits, entries != 256,
        or a (kv_bits, residual) pair with non-integral vec_d.
    """

    kv_bits: int = 4
    residual: int = 1
    variant: str = "outlier"
    entries: int = 256

    def __post_init__(self):
        if self.kv_bits not in (2, 4):
            raise ValueError(f"kv_bits must be 2 or 4, got {self.kv_bits}")
        if self.entries != 256:
            raise ValueError(
                f"entries is fixed at 256 (uint8 index), got {self.entries}")
        if self.variant not in KV_VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; expected one of {KV_VARIANTS}")
        if self.residual < 1 or (8 * self.residual) % self.kv_bits:
            raise ValueError(
                f"residual={self.residual} does not give integral vec_d at "
                f"kv_bits={self.kv_bits}")

    @property
    def vec_d(self) -> int:
        """Channels per code group (8*R/kv_bits)."""
        return (8 * self.residual) // self.kv_bits

    def groups(self, dim: int) -> int:
        """Code groups per head of width ``dim``; dim must divide by vec_d."""
        if dim % self.vec_d:
            raise ValueError(
                f"head dim {dim} not divisible by vec_d={self.vec_d}")
        return dim // self.vec_d

    def idx_width(self, dim: int) -> int:
        """uint8 indices stored per (token, head): R * groups(dim)."""
        return self.residual * self.groups(dim)


def kv_scale(x: torch.Tensor, variant: str = "outlier") -> torch.Tensor:
    """Per-(token, head) normalization scale over the trailing channel
    axis: fp32 ``x.shape[:-1]``, clamped away from zero."""
    xf = x.float()
    if variant == "outlier":
        s = xf.abs().amax(dim=-1)
    elif variant == "rms":
        s = 2.0 * torch.sqrt(torch.mean(xf * xf, dim=-1))
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return torch.clamp(s, min=1e-8)


def kv_grid_codebooks(num_heads: int, dim: int, kvq: KVQuantConfig, *,
                      device=None) -> torch.Tensor:
    """Deterministic per-head codebooks: a uniform lattice over the
    scale-normalized range [-1, 1]^vec_d, stage r shrunk by levels^-r
    (vec_d=2: a 16-level int4 grid per channel; vec_d=4: 4 levels).
    Returns fp32 (Hk, R, 256, vec_d), the same lattice for every head."""
    vd, R = kvq.vec_d, kvq.residual
    levels = int(round(kvq.entries ** (1.0 / vd)))
    if levels ** vd != kvq.entries:
        raise ValueError(
            f"no integral grid: entries={kvq.entries} has no {vd}-th root "
            "(use fit_kv_codebooks for this geometry)")
    kvq.groups(dim)  # validate divisibility here, not at encode
    axis = np.linspace(-1.0, 1.0, levels, dtype=np.float32)
    grid = np.stack(np.meshgrid(*([axis] * vd), indexing="ij"),
                    axis=-1).reshape(kvq.entries, vd)
    stages = np.stack([grid * float(levels) ** (-r) for r in range(R)])
    return torch.from_numpy(stages).to(device).expand(
        num_heads, R, kvq.entries, vd).contiguous()


def fit_kv_codebooks(generator: torch.Generator, samples: torch.Tensor,
                     kvq: KVQuantConfig, *, kmeans_iters: int = 12
                     ) -> torch.Tensor:
    """Per-head KV codebooks fitted to calibration K/V slices.

    Args:
      generator: the k-means draws' generator (on the samples' device).
      samples: (T, Hk, dim) calibration slices (a prefill's K or V,
        flattened over batch and time).
      kvq: geometry and scale variant to fit.
      kmeans_iters: Lloyd iterations a stage.

    Returns:
      (Hk, R, 256, vec_d) fp32 codebooks: stage r of head h is k-means
      over head h's scale-normalized residual after stages < r, every
      head in one ``kmeans_batched``.
    """
    T, Hk, dim = samples.shape
    G, vd = kvq.groups(dim), kvq.vec_d
    s = kv_scale(samples, kvq.variant)                      # (T, Hk)
    pts = (samples.float() / s[..., None]).reshape(T, Hk, G, vd)
    pts = pts.transpose(0, 1).reshape(Hk, T * G, vd)        # per-head points
    rows = torch.arange(Hk, device=pts.device)[:, None]
    stages = []
    for _ in range(kvq.residual):
        cents, assign = kmeans_batched(generator, pts, kvq.entries,
                                       iters=kmeans_iters)
        stages.append(cents)                                # (Hk, E, vd)
        pts = pts - cents[rows, assign.long()]
    return torch.stack(stages, dim=1)                       # (Hk, R, E, vd)


def kv_encode(x: torch.Tensor, cb: torch.Tensor, variant: str = "outlier"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a K/V slice against per-head codebooks.

    Args:
      x: (..., Hk, dim) fp K or V values.
      cb: (Hk, R, 256, vec_d) codebooks; the geometry is read off its shape.
      variant: scale rule of the KVQuantConfig the codebooks belong to.

    Returns:
      (idx, scale): uint8 indices (..., Hk, R*G) and fp32 per-(token,
      head) scales (..., Hk). Each stage takes the argmin of
      ``|c|^2 - 2 x.c`` (the reference's formula; ``torch.argmin`` keeps
      the first minimum as ``jnp.argmin`` does, so indices agree bit for
      bit away from exact ties).
    """
    Hk, R, E, vd = cb.shape
    lead = x.shape[:-2]
    G = x.shape[-1] // vd
    scale = kv_scale(x, variant)                            # (..., Hk)
    resid = (x.float() / scale[..., None]).reshape(*lead, Hk, G, vd)
    cbf = cb.float()
    h_iota = torch.arange(Hk, device=x.device).reshape(
        (1,) * len(lead) + (Hk, 1))
    idxs = []
    for r in range(R):
        cbr = cbf[:, r]                                     # (Hk, E, vd)
        dots = torch.einsum("...hgc,hec->...hge", resid, cbr)
        d2 = torch.sum(cbr * cbr, dim=-1)                   # (Hk, E)
        a = torch.argmin(d2[:, None, :] - 2.0 * dots, dim=-1)  # (..., Hk, G)
        resid = resid - cbr[h_iota, a]
        idxs.append(a.to(torch.uint8))
    idx = torch.stack(idxs, dim=-2)                         # (..., Hk, R, G)
    return idx.reshape(*lead, Hk, R * G), scale


def kv_decode(idx: torch.Tensor, scale: torch.Tensor, cb: torch.Tensor
              ) -> torch.Tensor:
    """Dequantize-oracle reconstruction of a KV-VQ slice: idx (..., Hk,
    R*G) uint8, scale (..., Hk) any float dtype, cb (Hk, R, 256, vec_d)
    -> fp32 (..., Hk, G*vec_d)."""
    Hk, R, E, vd = cb.shape
    lead = idx.shape[:-2]
    G = idx.shape[-1] // R
    a = idx.reshape(*lead, Hk, R, G).long()
    h_iota = torch.arange(Hk, device=idx.device).reshape(
        (1,) * len(lead) + (Hk, 1, 1))
    r_iota = torch.arange(R, device=idx.device).reshape(
        (1,) * len(lead) + (1, R, 1))
    chosen = cb.float()[h_iota, r_iota, a]                  # (..., Hk, R, G, vd)
    xn = chosen.sum(dim=-3)                                 # (..., Hk, G, vd)
    return xn.reshape(*lead, Hk, G * vd) * scale[..., None].float()
