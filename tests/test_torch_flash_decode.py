"""Port of the flash-decode kernel: the plain PyTorch version against the
JAX wrapper in Pallas interpret mode (CPU); the kernel's own formulation
— the cache split into chunks, each folded into an (m, l, acc) partial
(neutral past the length), the partials merged in split order — against
the Pallas kernel in interpret mode; and the CUDA kernel against the
plain version on the card. The paged entry (``flash_decode_paged``: block
arenas and a block table) likewise: its plain version against the JAX
paged wrapper (plain and interpret mode) on shuffled tables with
sentinel rows, and on the card the kernel against its plain version and
bitwise against the contiguous kernel over the gathered view.

Tolerance: fp32 rtol=1e-5, atol=1e-5 — the online softmax folds the
cache in blocks where the plain version normalizes once, which
reassociates the sums over S; the formulation is held to 1e-5 * max|o|
for the same reason. On the card, fp32 caches are held to 1e-5 and bf16
caches to 2^-7 * max|o| (one bf16 rounding of the output on either
side)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                              flash_decode_paged_ref,
                                              flash_decode_ref)
from repro_torch.kernels.flash_decode.ops import FD_CHUNK, fd_splits
from repro_torch.models.common import paged_view

torch.set_num_threads(1)


def _inputs(B, S, H, Hk, hd, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("B,S,H,Hk,hd,lengths", [
    (3, 48, 8, 2, 32, [1, 48, 20]),     # GQA g=4, lengths 1 and S
    (2, 64, 4, 4, 16, [64, 1]),         # MHA
    (2, 40, 6, 1, 8, [17, 40]),         # MQA, S not a multiple of the block
])
def test_plain_matches_jax_pallas_interpret(B, S, H, Hk, hd, lengths):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode as jax_flash_decode

    q, k, v, lens = _inputs(B, S, H, Hk, hd, lengths)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), block_s=16, interpret=True)
    got = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _kernel_formulation(q, k, v, lengths, chunk=FD_CHUNK):
    """What csrc/flash_decode.cu computes, in plain torch: scores of each
    query head against its kv head's rows, positions past the length
    masked with -1e30 (only a row of length <= 0 walks past it: over all S
    positions); the cache cut into splits of ``chunk`` positions, each
    folded into its own (m, l, acc) over the positions it walks (none past
    the walked length: a neutral (-inf, 0, 0)), then merged in split
    order and divided by max(l, 1e-30)."""
    B, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qg = q.reshape(B, Hk, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(S)[None, :]
    s = torch.where((pos < lengths[:, None])[:, None, None], s,
                    torch.full_like(s, -1e30))
    walked = torch.where(lengths > 0, lengths.clamp(max=S), S)
    s = torch.where((pos < walked[:, None])[:, None, None], s,
                    torch.full_like(s, -torch.inf))       # (B, Hk, g, S)
    parts = []
    for lo in range(0, S, chunk):
        sk, vk = s[..., lo:lo + chunk], v[:, lo:lo + chunk].float()
        m = sk.amax(dim=-1)
        live = torch.isfinite(m)
        p = torch.exp(sk - torch.where(live, m, 0.0)[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgs,bskd->bkgd", p, vk)))
    assert len(parts) == -(-S // chunk)
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(mx)
    acc = torch.zeros(mx.shape + (hd,))
    for m, lk, ak in parts:                             # in split order
        f = torch.exp(m - mx)
        l = l + lk * f
        acc = acc + ak * f[..., None]
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def _pallas(q, k, v, lens, block_s):
    import jax.numpy as jnp
    from repro.kernels.flash_decode.kernel import flash_decode_pallas

    return np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        block_s=block_s, interpret=True))


def _assert_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("H,Hk", [(8, 2), (8, 1)])      # GQA g=4 and g=8
@pytest.mark.parametrize("chunk,splits", [(40, 1), (20, 2), (8, 5)])
def test_kernel_formulation_split_merge_matches_jax_pallas_interpret(
        H, Hk, chunk, splits):
    """The split-S merge at 1, 2 and 5 splits over S = 40: an empty row,
    a length on a chunk edge (16 = 2 * 8) and one past it, an over-long
    length."""
    q, k, v, lens = _inputs(4, 40, H, Hk, 32, [0, 16, 17, 41], seed=1)
    assert -(-40 // chunk) == splits
    want = _pallas(q, k, v, lens, block_s=8)
    got = _kernel_formulation(*(torch.from_numpy(a) for a in
                                (q, k, v, lens)), chunk=chunk)
    _assert_close(got.numpy(), want)


def test_kernel_formulation_at_the_kernel_chunk():
    """The kernel's own chunk (64 positions) over S = 192: three splits,
    lengths on, before and past the first chunk edge and an empty row."""
    q, k, v, lens = _inputs(4, 192, 4, 4, 64, [63, 64, 65, 0], seed=2)
    assert fd_splits(192) == 3 and FD_CHUNK == 64
    want = _pallas(q, k, v, lens, block_s=64)
    got = _kernel_formulation(*(torch.from_numpy(a) for a in
                                (q, k, v, lens)))
    _assert_close(got.numpy(), want)


def test_4d_query_and_no_launch_on_cpu():
    q, k, v, lens = _inputs(2, 16, 4, 2, 8, [3, 16])
    before = flash_decode.launches
    got = flash_decode(torch.from_numpy(q)[:, None], torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(lens))
    assert got.shape == (2, 1, 4, 8)
    assert flash_decode.launches == before


def paged_table(lengths, W, bs, NB, seed=0):
    """(B, W) int32 table: row b owns ceil(len_b / bs) blocks drawn from a
    shuffled pool of NB, the rest of its row the sentinel NB (a row of
    length <= 0 owns none)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(NB)
    table = np.full((len(lengths), W), NB, np.int32)
    i = 0
    for b, n in enumerate(lengths):
        k = min(W, -(-max(n, 0) // bs))
        table[b, :k] = perm[i:i + k]
        i += k
    assert i <= NB
    return table


def _paged_inputs(B, W, bs, NB, H, Hk, hd, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((NB, bs, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, Hk, hd)).astype(np.float32)
    return (q, k, v, paged_table(lengths, W, bs, NB, seed),
            np.asarray(lengths, np.int32))


PAGED_CASES = [  # B, W, bs, NB, H, Hk, hd, lengths
    (3, 4, 8, 12, 8, 2, 32, [1, 32, 20]),       # GQA g=4, a full row
    (4, 5, 4, 16, 4, 4, 16, [0, 17, 3, 20]),    # an empty row: all sentinel
    (2, 10, 4, 40, 6, 1, 8, [40, 9]),           # MQA, S = 40 over 10 blocks
]


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("B,W,bs,NB,H,Hk,hd,lengths", PAGED_CASES)
def test_paged_plain_matches_jax_paged_wrapper(B, W, bs, NB, H, Hk, hd,
                                               lengths, interpret):
    """The plain paged version against the reference's
    ``flash_decode_paged`` (its plain route and the Pallas kernel in
    interpret mode, at its default S-block, which pads none of these
    caches) on a shuffled table whose free positions and empty row read
    the sentinel: both clamp it to block NB - 1, so the row of length 0
    (which averages V over the whole masked view) matches too."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_paged as jax_paged

    args = _paged_inputs(B, W, bs, NB, H, Hk, hd, lengths)
    kw = {"interpret": True} if interpret else {"use_pallas": False}
    want = jax_paged(*(jnp.asarray(a) for a in args), **kw)
    got = flash_decode_paged(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,W,bs,NB,H,Hk,hd,lengths", PAGED_CASES)
def test_paged_plain_is_contiguous_over_the_gathered_view(B, W, bs, NB, H,
                                                          Hk, hd, lengths):
    q, k, v, table, lens = (torch.from_numpy(a) for a in
                            _paged_inputs(B, W, bs, NB, H, Hk, hd, lengths))
    view = lambda a: paged_view(a, table)
    assert torch.equal(flash_decode_paged(q, k, v, table, lens),
                       flash_decode(q, view(k), view(v), lens))
    before = flash_decode_paged.launches
    got = flash_decode_paged(q[:, None], k, v, table, lens)
    assert got.shape == (B, 1, H, hd) and flash_decode_paged.launches == before


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(B, S, H, Hk, hd, lengths, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, Hk, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, Hk, hd), generator=g, device="cuda").to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _tol(want):
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, want.float().abs().max().item())
    return 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hk,hd,lengths", [
    (4, 512, 32, 32, 128, [1, 512, 77, 300]),   # llama2-7b decode
    (3, 300, 32, 8, 128, [300, 5, 150]),        # GQA g=4
    (2, 70, 16, 2, 64, [70, 33]),               # g=8, hd=64
    (2, 40, 4, 4, 32, [0, 41]),                 # empty and over-long lengths
    (4, 130, 8, 8, 32, [63, 64, 65, 0]),        # around a chunk edge, hd=32
    (4, 200, 16, 4, 64, [65, 0, 63, 64]),       # S not a multiple of 64
    (4, 512, 32, 32, 128, [512] * 4),           # every row at max_len
])
def test_kernel_matches_plain(cuda, B, S, H, Hk, hd, lengths, dtype):
    q, k, v, lens = _card(B, S, H, Hk, hd, lengths, dtype)
    before = flash_decode.launches
    got = flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_ref(q, k, v, lens)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [[1, 512, 77, 300], [512] * 4])
def test_kernel_bitwise_deterministic(cuda, lengths, dtype):
    q, k, v, lens = _card(4, 512, 32, 32, 128, lengths, dtype)
    assert torch.equal(flash_decode(q, k, v, lens), flash_decode(q, k, v, lens))


def _card_paged(B, W, bs, NB, H, Hk, hd, lengths, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((NB, bs, Hk, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((NB, bs, Hk, hd), generator=g, device="cuda").to(dtype)
    table = torch.from_numpy(paged_table(lengths, W, bs, NB, seed)).cuda()
    return q, k, v, table, torch.tensor(lengths, dtype=torch.int32,
                                        device="cuda")


CARD_PAGED = [  # B, W, bs, NB, H, Hk, hd, lengths
    (4, 32, 16, 128, 32, 32, 128, [1, 512, 200, 64]),   # llama2-7b serve
    (4, 32, 16, 80, 32, 32, 128, [0, 512, 17, 300]),    # an empty row
    (3, 20, 8, 60, 32, 8, 128, [160, 5, 77]),           # GQA g=4, bs 8
    (2, 9, 16, 18, 16, 2, 64, [144, 65]),               # g=8, S not % 64
    (4, 13, 4, 52, 8, 8, 32, [63, 64, 65, 0]),          # around a chunk edge
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,W,bs,NB,H,Hk,hd,lengths", CARD_PAGED)
def test_paged_kernel_matches_plain_and_contiguous_kernel(
        cuda, B, W, bs, NB, H, Hk, hd, lengths, dtype):
    """Against its plain version (the row of length 0 included), and
    bitwise against the contiguous kernel over the gathered view: the
    same arithmetic, only the rows' addresses come from the table."""
    q, k, v, table, lens = _card_paged(B, W, bs, NB, H, Hk, hd, lengths, dtype)
    before = flash_decode_paged.launches
    got = flash_decode_paged(q, k, v, table, lens)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    want = flash_decode_paged_ref(q, k, v, table, lens)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err
    view = lambda a: paged_view(a, table)
    assert torch.equal(got, flash_decode(q, view(k), view(v), lens))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_bitwise_deterministic(cuda, dtype):
    args = _card_paged(*CARD_PAGED[0], dtype)
    assert torch.equal(flash_decode_paged(*args), flash_decode_paged(*args))


@pytest.mark.cuda
def test_paged_kernel_rejects_malformed_operands(cuda):
    q, k, v, table, lens = _card_paged(*CARD_PAGED[2], torch.bfloat16)
    bad = {
        "int64 table": (q, k, v, table.long(), lens),
        "table rows != B": (q, k, v, table[:2], lens),
        "1-d table": (q, k, v, table[0], lens),
        "strided table": (q, k, v, table[:, ::2], lens),
        "3-d arena": (q, k[:, 0], v[:, 0], table, lens),
        "arena dtype": (q, k.float(), v.float(), table, lens),
        "k, v shapes": (q, k, v[:-1], table, lens),
        "table on the CPU": (q, k, v, table.cpu(), lens),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError):
            flash_decode_paged(*args)
        assert what
