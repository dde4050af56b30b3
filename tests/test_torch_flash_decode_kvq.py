"""Port of the KV-VQ flash-decode kernel: the wrapper's plain version
(the dequantize oracle) against the JAX wrapper in Pallas interpret mode
(CPU); the kernel's own formulation — scores gathered from the query /
K-codebook table the wrapper builds, V rebuilt from codebook rows after
the softmax, over the reference's padded cache — against the same; and
the CUDA kernel against the plain version on the card. The paged entry
(``flash_decode_kvq_paged``: index and scale arenas and a block table)
likewise: its plain version against the JAX paged wrapper on shuffled
tables with sentinel rows, and on the card the kernel against its plain
version and bitwise against the contiguous kernel over the gathered view.

Tolerance: fp32 rtol=1e-5, atol=1e-5 — the Pallas kernel folds the cache
in blocks with an online softmax and sums the gathered table entries in
its own order, which reassociates the sums. On the card, fp32 outputs are
held to 1e-5 * max|o| and bf16 outputs to 2^-7 * max|o| (one bf16
rounding of the output on either side)."""
import numpy as np
import pytest
import torch

from repro_torch.core.vq import KVQuantConfig, kv_grid_codebooks
from repro_torch.kernels.flash_decode import (flash_decode_kvq,
                                              flash_decode_kvq_paged,
                                              flash_decode_kvq_paged_ref,
                                              flash_decode_kvq_ref)
from repro_torch.kernels.flash_decode.ops import (KVQ_CHUNK, kvq_operands,
                                                  kvq_padded_len, kvq_splits)
from repro_torch.models.common import paged_view
from test_torch_flash_decode import paged_table

torch.set_num_threads(1)


def _inputs(B, S, H, Hk, hd, lengths, kv_bits, residual, seed=0):
    """Random indices, positive scales, random (not grid) K and V
    codebooks, so every index and codebook coordinate matters."""
    rng = np.random.default_rng(seed)
    kvq = KVQuantConfig(kv_bits=kv_bits, residual=residual)
    RG, vd = kvq.idx_width(hd), kvq.vec_d
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k_idx = rng.integers(0, 256, (B, S, Hk, RG)).astype(np.uint8)
    v_idx = rng.integers(0, 256, (B, S, Hk, RG)).astype(np.uint8)
    k_s = rng.uniform(0.5, 2.0, (B, S, Hk)).astype(np.float32)
    v_s = rng.uniform(0.5, 2.0, (B, S, Hk)).astype(np.float32)
    cb_k = rng.standard_normal((Hk, residual, 256, vd)).astype(np.float32)
    cb_v = rng.standard_normal((Hk, residual, 256, vd)).astype(np.float32)
    return (q, k_idx, v_idx, k_s, v_s, np.asarray(lengths, np.int32), cb_k,
            cb_v)


def _jax_wrapper(args, **kw):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_kvq as jax_kvq

    return np.asarray(jax_kvq(*(jnp.asarray(a) for a in args), interpret=True,
                              **kw))


def _kernel_formulation(q, k_idx, v_idx, k_s, v_s, lengths, cb_k, cb_v,
                        chunk=KVQ_CHUNK):
    """What csrc/flash_decode_kvq.cu computes, in plain torch over the
    reference wrapper's operands: score = k_s * sum_j qd[j, k_idx[j]],
    vhat[c] = v_s * sum_r cb_v[r, v_idx[r*G + c//vd], c % vd], padded
    positions holding zero indices and scales, positions past the length
    masked; the padded cache cut into splits of ``chunk`` positions, each
    folded into its own (m, l, acc) over the positions it walks (none past
    the walked length: a neutral (-inf, 0, 0)), then merged in split
    order."""
    qd, ks, vs, cbv = kvq_operands(q, k_s, v_s, cb_k, cb_v)
    B, S, Hk, RG = k_idx.shape
    g, R, vd = qd.shape[2], cbv.shape[1], cbv.shape[3]
    GR, hd = RG // R, q.shape[-1]
    pad = kvq_padded_len(S) - S
    kidx = torch.nn.functional.pad(k_idx.long(), (0, 0, 0, 0, 0, pad))
    vidx = torch.nn.functional.pad(v_idx.long(), (0, 0, 0, 0, 0, pad))
    ks = torch.nn.functional.pad(ks, (0, 0, 0, pad))
    vs = torch.nn.functional.pad(vs, (0, 0, 0, pad))
    Sp = S + pad
    ki = kidx.permute(0, 2, 3, 1)[:, :, None].expand(B, Hk, g, RG, Sp)
    s = qd.gather(-1, ki).sum(dim=3) * ks.permute(0, 2, 1)[:, :, None]
    pos = torch.arange(Sp)[None, :]
    s = torch.where((pos < lengths[:, None])[:, None, None], s,
                    torch.full_like(s, -1e30))
    walked = torch.where(lengths > 0, lengths.clamp(max=Sp), Sp)
    s = torch.where((pos < walked[:, None])[:, None, None], s,
                    torch.full_like(s, -torch.inf))       # (B, Hk, g, Sp)
    c = torch.arange(hd)
    heads = torch.arange(Hk)[None, None, :, None]
    rows = sum(cbv[:, r][heads, vidx[..., r * GR + c // vd], c % vd]
               for r in range(R))                      # (B, Sp, Hk, hd)
    vhat = rows * vs[..., None]
    parts = []
    for lo in range(0, Sp, chunk):
        sk, vk = s[..., lo:lo + chunk], vhat[:, lo:lo + chunk]
        m = sk.amax(dim=-1)
        live = torch.isfinite(m)
        p = torch.exp(sk - torch.where(live, m, 0.0)[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgs,bskd->bkgd", p, vk)))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(mx)
    acc = torch.zeros(mx.shape + (hd,))
    for m, lk, ak in parts:                             # in split order
        f = torch.exp(m - mx)
        l = l + lk * f
        acc = acc + ak * f[..., None]
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, Hk * g, hd).to(q.dtype)


CASES = [  # B, S, H, Hk, hd, lengths, kv_bits, residual
    (2, 24, 4, 4, 32, [24, 7], 4, 1),       # llama2 SMOKE heads
    (3, 40, 8, 2, 32, [1, 40, 17], 4, 1),   # GQA g=4, masked tail
    (2, 40, 6, 1, 64, [33, 40], 2, 1),      # MQA, 2-bit
    (2, 24, 4, 2, 32, [24, 5], 4, 2),       # two residual stages
]


@pytest.mark.parametrize("B,S,H,Hk,hd,lengths,kv_bits,residual", CASES)
def test_plain_matches_jax_pallas_interpret(B, S, H, Hk, hd, lengths,
                                            kv_bits, residual):
    args = _inputs(B, S, H, Hk, hd, lengths, kv_bits, residual)
    want = _jax_wrapper(args, block_s=16)   # three S-blocks, padded tail
    got = flash_decode_kvq(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,Hk,hd,lengths,kv_bits,residual", CASES + [
    (3, 520, 2, 1, 32, [0, 520, 9], 4, 1),  # padded to 1024; an empty row
])
def test_kernel_formulation_matches_jax_pallas_interpret(
        B, S, H, Hk, hd, lengths, kv_bits, residual):
    args = _inputs(B, S, H, Hk, hd, lengths, kv_bits, residual, seed=1)
    want = _jax_wrapper(args)               # the default 512-position block
    got = _kernel_formulation(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk,splits", [(37, 1), (19, 2), (8, 5)])
def test_kernel_formulation_split_merge_matches_jax_pallas_interpret(
        chunk, splits):
    """The split-S merge at 1, 2 and 5 splits: an empty row, a length on a
    chunk boundary (16 = 2 * 8), S = 37 not a multiple of the chunk."""
    args = _inputs(3, 37, 8, 2, 32, [0, 16, 37], 4, 1, seed=2)
    assert kvq_splits(37, chunk) == splits
    want = _jax_wrapper(args)
    got = _kernel_formulation(*(torch.from_numpy(a) for a in args),
                              chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_formulation_splits_over_padding():
    """Five splits over a cache padded from 520 to 1024 positions, with an
    empty row (it averages V over the padding too) and a row ending on a
    chunk boundary."""
    args = _inputs(3, 520, 2, 1, 32, [0, 410, 9], 4, 1, seed=3)
    assert kvq_splits(520, 205) == 5
    want = _jax_wrapper(args)
    got = _kernel_formulation(*(torch.from_numpy(a) for a in args),
                              chunk=205)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_operands_and_no_launch_on_cpu():
    args = [torch.from_numpy(a) for a in
            _inputs(2, 16, 4, 2, 32, [3, 16], 4, 2)]
    qd, ks, vs, cbv = kvq_operands(args[0], args[3].bfloat16(), args[4],
                                   args[6], args[7])
    assert qd.shape == (2, 2, 2, 16, 256) and qd.is_contiguous()
    assert ks.dtype == vs.dtype == cbv.dtype == torch.float32
    assert [kvq_padded_len(s) for s in (16, 512, 513, 1100)] == \
        [16, 512, 1024, 1536]
    assert [kvq_splits(s, 64) for s in (16, 64, 65, 512, 513)] == \
        [1, 1, 2, 8, 16]
    before = flash_decode_kvq.launches
    got = flash_decode_kvq(args[0][:, None], *args[1:])
    assert got.shape == (2, 1, 4, 32)
    assert flash_decode_kvq.launches == before


def _paged_args(B, W, bs, NB, H, Hk, hd, lengths, kv_bits, residual,
                seed=0):
    """Arenas of NB blocks (the contiguous inputs' layout with NB rows of
    bs positions) and a shuffled table with sentinel rows."""
    q, ki, vi, ks, vs, lens, cbk, cbv = _inputs(NB, bs, H, Hk, hd,
                                                [0] * NB, kv_bits, residual,
                                                seed)
    return (q[:B], ki, vi, ks, vs, paged_table(lengths, W, bs, NB, seed),
            np.asarray(lengths, np.int32), cbk, cbv)


PAGED_CASES = [  # B, W, bs, NB, H, Hk, hd, lengths, kv_bits, residual
    (2, 6, 4, 12, 4, 4, 32, [24, 7], 4, 1),        # llama2 SMOKE heads
    (3, 5, 8, 15, 8, 2, 32, [0, 40, 17], 4, 1),    # an empty row, g=4
    (2, 10, 4, 20, 6, 1, 64, [33, 40], 2, 2),      # MQA, 2-bit, two stages
]


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("B,W,bs,NB,H,Hk,hd,lengths,kv_bits,residual",
                         PAGED_CASES)
def test_paged_plain_matches_jax_paged_wrapper(B, W, bs, NB, H, Hk, hd,
                                               lengths, kv_bits, residual,
                                               interpret):
    """The plain paged version against the reference's
    ``flash_decode_kvq_paged`` (its dequantize route and the Pallas kernel
    in interpret mode, whose default S-block pads none of these caches):
    both clamp the sentinel to block NB - 1, so the row of length 0
    matches too."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_kvq_paged as jax_paged

    args = _paged_args(B, W, bs, NB, H, Hk, hd, lengths, kv_bits, residual)
    kw = {"interpret": True} if interpret else {"use_pallas": False}
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in args), **kw))
    got = flash_decode_kvq_paged(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,W,bs,NB,H,Hk,hd,lengths,kv_bits,residual",
                         PAGED_CASES)
def test_paged_plain_is_contiguous_over_the_gathered_view(
        B, W, bs, NB, H, Hk, hd, lengths, kv_bits, residual):
    q, ki, vi, ks, vs, table, lens, cbk, cbv = (
        torch.from_numpy(a) for a in _paged_args(B, W, bs, NB, H, Hk, hd,
                                                 lengths, kv_bits, residual))
    view = lambda a: paged_view(a, table)
    before = flash_decode_kvq_paged.launches
    assert torch.equal(
        flash_decode_kvq_paged(q, ki, vi, ks, vs, table, lens, cbk, cbv),
        flash_decode_kvq(q, view(ki), view(vi), view(ks), view(vs), lens,
                         cbk, cbv))
    assert flash_decode_kvq_paged.launches == before


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(B, S, H, Hk, hd, lengths, kv_bits, residual, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kvq = KVQuantConfig(kv_bits=kv_bits, residual=residual)
    RG = kvq.idx_width(hd)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    idx = lambda: torch.randint(0, 256, (B, S, Hk, RG), generator=g,
                                device="cuda", dtype=torch.uint8)
    scale = lambda: (torch.rand((B, S, Hk), generator=g, device="cuda")
                     + 0.5).bfloat16()
    cb = kv_grid_codebooks(Hk, hd, kvq, device="cuda")
    return (q, idx(), idx(), scale(), scale(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), cb, cb)


def _tol(want):
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, want.float().abs().max().item())
    return 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hk,hd,lengths,kv_bits,residual", [
    (4, 512, 32, 32, 128, [1, 512, 200, 64], 4, 1),  # llama2-7b decode
    (4, 512, 32, 32, 128, [1, 512, 200, 64], 2, 1),
    (3, 300, 32, 8, 128, [300, 5, 150], 4, 1),   # g=4: two head chunks
    (2, 70, 16, 2, 64, [70, 33], 4, 2),          # g=8, two stages
    (2, 600, 4, 4, 32, [0, 600], 2, 1),          # empty row over padding
])
def test_kernel_matches_plain(cuda, B, S, H, Hk, hd, lengths, kv_bits,
                              residual, dtype):
    args = _card(B, S, H, Hk, hd, lengths, kv_bits, residual, dtype)
    before = flash_decode_kvq.launches
    got = flash_decode_kvq(*args)
    torch.cuda.synchronize()
    assert flash_decode_kvq.launches == before + 1
    if lengths[0] == 0:  # the reference averages V over the padded cache
        want = _kernel_formulation(*(a.cpu() for a in args)).to(got.device)
    else:
        want = flash_decode_kvq_ref(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [4, 2])
@pytest.mark.parametrize("H,Hk", [(8, 8), (16, 4), (16, 2)])  # g = 1, 4, 8
def test_kernel_split_edges(cuda, H, Hk, kv_bits):
    """Rows longer than one chunk, lengths on chunk edges, an empty row and
    a row ending one past an edge, against the split formulation."""
    lengths = [2 * KVQ_CHUNK, KVQ_CHUNK, 0, 3 * KVQ_CHUNK + 1]
    args = _card(4, 3 * KVQ_CHUNK + 64, H, Hk, 128, lengths, kv_bits, 1,
                 torch.bfloat16, seed=1)
    before = flash_decode_kvq.launches
    got = flash_decode_kvq(*args)
    torch.cuda.synchronize()
    assert flash_decode_kvq.launches == before + 1
    want = _kernel_formulation(*(a.cpu() for a in args)).to(got.device)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [4, 2])
def test_kernel_bitwise_deterministic(cuda, kv_bits):
    args = _card(4, 512, 32, 32, 128, [1, 512, 77, 300], kv_bits, 1,
                 torch.bfloat16)
    assert torch.equal(flash_decode_kvq(*args), flash_decode_kvq(*args))


def _card_paged(B, W, bs, NB, H, Hk, hd, lengths, kv_bits, dtype, seed=0):
    """Arenas as the engine holds them: uint8 indices, bf16 scales, grid
    codebooks."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kvq = KVQuantConfig(kv_bits=kv_bits)
    RG = kvq.idx_width(hd)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    idx = lambda: torch.randint(0, 256, (NB, bs, Hk, RG), generator=g,
                                device="cuda", dtype=torch.uint8)
    scale = lambda: (torch.rand((NB, bs, Hk), generator=g, device="cuda")
                     + 0.5).bfloat16()
    cb = kv_grid_codebooks(Hk, hd, kvq, device="cuda")
    table = torch.from_numpy(paged_table(lengths, W, bs, NB, seed)).cuda()
    return (q, idx(), idx(), scale(), scale(), table,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), cb, cb)


CARD_PAGED = [  # B, W, bs, NB, H, Hk, hd, lengths, kv_bits
    (4, 32, 16, 128, 32, 32, 128, [1, 512, 200, 64], 4),   # llama2-7b
    (4, 32, 16, 128, 32, 32, 128, [1, 512, 200, 64], 2),
    (4, 32, 16, 90, 32, 32, 128, [0, 512, 257, 300], 4),   # an empty row
    (3, 40, 8, 120, 32, 8, 128, [300, 5, 150], 4),         # g=4, bs 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,W,bs,NB,H,Hk,hd,lengths,kv_bits", CARD_PAGED)
def test_paged_kernel_matches_plain_and_contiguous_kernel(
        cuda, B, W, bs, NB, H, Hk, hd, lengths, kv_bits, dtype):
    """Against its plain version (the row of length 0 included: no
    padding at these S), and bitwise against the contiguous kernel over
    the gathered view."""
    args = _card_paged(B, W, bs, NB, H, Hk, hd, lengths, kv_bits, dtype)
    before = flash_decode_kvq_paged.launches
    got = flash_decode_kvq_paged(*args)
    torch.cuda.synchronize()
    assert flash_decode_kvq_paged.launches == before + 1
    want = flash_decode_kvq_paged_ref(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err
    q, ki, vi, ks, vs, table, lens, cbk, cbv = args
    view = lambda a: paged_view(a, table)
    assert torch.equal(got, flash_decode_kvq(q, view(ki), view(vi), view(ks),
                                             view(vs), lens, cbk, cbv))


@pytest.mark.cuda
def test_paged_kernel_bitwise_deterministic(cuda):
    args = _card_paged(*CARD_PAGED[0], torch.bfloat16)
    assert torch.equal(flash_decode_kvq_paged(*args),
                       flash_decode_kvq_paged(*args))


@pytest.mark.cuda
def test_paged_kernel_rejects_malformed_operands(cuda):
    q, ki, vi, ks, vs, table, lens, cbk, cbv = _card_paged(*CARD_PAGED[3],
                                                           torch.bfloat16)
    bad = {
        "int64 table": (ki, vi, ks, vs, table.long()),
        "table rows != B": (ki, vi, ks, vs, table[:2]),
        "strided table": (ki, vi, ks, vs, table[:, ::2]),
        "scale arena shape": (ki, vi, ks[:-1], vs[:-1], table),
        "index arena dtype": (ki.to(torch.int8), vi.to(torch.int8), ks, vs,
                              table),
        "3-d index arena": (ki[:, 0], vi[:, 0], ks, vs, table),
    }
    for what, (a, b, c, d, t) in bad.items():
        with pytest.raises(ValueError):
            flash_decode_kvq_paged(q, a, b, c, d, t, lens, cbk, cbv)
        assert what
