"""Port of the fused EVA matmul: the plain PyTorch version against the JAX
wrapper in Pallas interpret mode (CPU), and the CUDA kernel against the
plain version on the card.

Tolerance: fp32 rtol=1e-5, atol=1e-5 on the CPU — the two sides sum the
C*V lookup terms of each output in different orders. On the card the
kernel is held to 1e-4 * max(1, max|y|): the same reassociation over up
to C*V = 2752 terms (llama2-7b ``down``)."""
import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.core.vq import VQWeight, synthetic_vq
from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.fused_vq_matmul.ops import select_split
from repro_torch.kernels.eva_lookup.ref import lookup_in_kernel_order

torch.set_num_threads(1)


def _inputs(K, N, M, C=2, splits=(), seed=0):
    """numpy inputs and the reference's VQWeight over them (JAX is
    imported here: the card's machine runs the `cuda` tests without it)."""
    from repro.core.vq import VQWeight as JaxVQWeight

    rng = np.random.default_rng(seed)
    V = K // 8
    idx = rng.integers(0, 256, (C, V, N)).astype(np.uint8)
    cb = (rng.standard_normal((C, 8, 256)) / np.sqrt(K * C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jvq = JaxVQWeight(idx=idx, codebooks=cb, scale=scale, K=K, N=N, d=8, n=8,
                      splits=splits)
    return x, jvq


@pytest.mark.parametrize("K,N,M,splits", [
    (296, 100, 1, ()),            # V=37, N=100: ragged against every tile
    (296, 100, 3, ()),
    (256, 192, 3, (64, 64, 64)),  # grouped wqkv-like family
    (512, 96, 1, (32, 64)),       # grouped gu-like family
])
def test_plain_matches_jax_pallas_interpret(K, N, M, splits):
    import jax.numpy as jnp
    from repro.kernels.fused_vq_matmul import fused_vq_matmul as jax_fused

    x, jvq = _inputs(K, N, M, splits=splits)
    want = jax_fused(jnp.asarray(x), jvq, interpret=True, block_v=4,
                     block_n=64, out_dtype=jnp.float32)
    vq = from_jax_params(jvq, device="cpu")
    assert vq.splits == splits and vq.idx.dtype == torch.uint8
    got = fused_vq_matmul(torch.from_numpy(x), vq, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_leading_dims_and_out_dtype():
    x, jvq = _inputs(128, 64, 6)
    vq = from_jax_params(jvq, device="cpu")
    x3 = torch.from_numpy(x).reshape(2, 3, 128).to(torch.bfloat16)
    before = fused_vq_matmul.launches
    y = fused_vq_matmul(x3, vq)
    assert fused_vq_matmul.launches == before  # CPU tensors never launch
    assert y.shape == (2, 3, 64) and y.dtype == torch.bfloat16


DECODE_LINEARS = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


def _assert_tiles_cover(t, M, V, N, C, recompute):
    """A launch shape covers V (each slab in one split, only the last
    cluster's trailing CTAs empty) and N, and fits shared memory."""
    slabs = -(-V // t.vl)
    assert t.mw == tiles.lane_width(M) and t.vl * t.mw == tiles.LINE
    assert t.bn in tiles.COLUMN_TILES and t.bn % 16 == 0
    assert (t.splits - 1) * t.slabs_per_split < slabs + (t.cs - 1) * t.slabs_per_split
    assert t.splits * t.slabs_per_split >= slabs
    assert 1 <= t.cs <= tiles.CS_MAX and t.groups >= 1
    assert t.cols_per_lane >= t.vl and t.cols_per_lane % 8 == 0
    assert 1 <= t.stages <= tiles.STAGES_MAX
    assert t.smem == tiles.smem_bytes(C, t.mw, t.bn, t.stages, recompute)
    assert t.smem <= 227 * 1024
    assert -(-N // t.bn) * t.bn >= N


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("K,N", DECODE_LINEARS)
def test_select_split_covers_v(K, N, M):
    """The fused kernel's tile model at every decode linear of llama2-7b:
    covers V and N, fits 227 KB, and at M <= 4 fills one wave of the card
    with clusters of at most 8 CTAs."""
    t = select_split(M, K // 8, N, C=2, sm_count=132)
    _assert_tiles_cover(t, M, K // 8, N, 2, True)
    assert -(-N // t.bn) * t.splits * -(-M // 4) <= 132


@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("M,V,N", [(1, 37, 100), (2, 5, 1030), (3, 512, 4096),
                                   (5, 1376, 64), (8, 9, 22016), (1, 1376, 5)])
def test_select_split_fits_every_codebook_count(M, V, N, C):
    for recompute in (True, False):
        t = tiles.lookup_tiles(M, V, N, C, 132, recompute)
        _assert_tiles_cover(t, M, V, N, C, recompute)


def test_select_split_follows_cluster_occupancy():
    """Where the card holds fewer clusters than SMs / cs, the model
    counts the waves that costs: with room for one cluster at a time it
    takes one-CTA clusters and no second pass over the card."""
    free = tiles.lookup_tiles(4, 512, 22016, 2, 132, True)
    slots = (132,) + (1,) * (tiles.CS_MAX - 1)
    tight = tiles.lookup_tiles(4, 512, 22016, 2, 132, True, slots * 2)
    assert free.cs > 1 and tight.cs == 1
    assert -(-22016 // tight.bn) * tight.groups <= 132


@pytest.mark.parametrize("recompute", [True, False], ids=["fused", "lookup"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("K,N", DECODE_LINEARS)
def test_candidates_cover_v_and_hold_the_pick(K, N, M, recompute):
    """Every launch shape the tile model prices (and the cost-model sweep
    times on the card) is one the kernels take: it covers V and N and
    fits shared memory; each (tile, cluster size, slabs a CTA) appears
    once, with the fewest clusters; the shape picked is among them."""
    V = K // 8
    seen = set()
    cands = list(tiles.candidates(M, V, N, 2, 132, recompute))
    for t, waves in cands:
        _assert_tiles_cover(t, M, V, N, 2, recompute)
        key = (t.bn, t.cs, t.slabs_per_split)
        assert key not in seen
        seen.add(key)
        assert t.groups == 1 or -(-V // t.vl) > (t.groups - 1) * t.cs * t.slabs_per_split
        assert waves == -(-(-(-N // t.bn) * -(-M // 4) * t.groups) // (132 // t.cs))
    assert tiles.lookup_tiles(M, V, N, 2, 132, recompute) in [t for t, _ in cands]


def _kernel_order_case(M, C, many):
    """(x, jvq, tiles) for the summation-order test: ragged V and N, the
    card's own tile model (one split) or a 4-SM card (several splits,
    clusters and a second pass)."""
    K, N = {1: (296, 100), 2: (264, 1030), 4: (512, 96)}[C]
    x, jvq = _inputs(K, N, M, C=C, seed=M * 10 + C)
    sm = 4 if many else 1
    t = tiles.lookup_tiles(M, K // 8, N, C, sm, True)
    if many:
        slabs = -(-(K // 8) // t.vl)
        t = t._replace(cs=2, groups=2, slabs_per_split=-(-slabs // 4))
    return x, jvq, t


@pytest.mark.parametrize("many", [False, True], ids=["one_split", "splits"])
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("M", [1, 2, 4, 5, 8, 12, 16])
def test_kernel_order_matches_jax_pallas_interpret(M, C, many):
    """The CUDA kernel's summation order (per-lane partials over v, the
    xor butterfly across lanes, clusters in rank order, then groups),
    emulated in plain torch on the plain output codebook, against the
    reference's Pallas kernel in interpret mode: within 1e-4 * max|y|."""
    import jax.numpy as jnp
    from repro.kernels.fused_vq_matmul import fused_vq_matmul as jax_fused

    x, jvq, t = _kernel_order_case(M, C, many)
    V, N = jvq.K // 8, jvq.N
    slabs = -(-V // t.vl)
    assert t.splits * t.slabs_per_split >= slabs
    assert (t.splits > 1) == many
    want = np.asarray(jax_fused(jnp.asarray(x), jvq, interpret=True, block_v=4,
                                block_n=64, out_dtype=jnp.float32))
    vq = from_jax_params(jvq, device="cpu")
    X = torch.from_numpy(x).reshape(M, V, 8)
    O = torch.einsum("mvd,cdk->cmvk", X, vq.codebooks)
    got = lookup_in_kernel_order(O, vq.idx, vq.scale, t).numpy()
    assert got.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("pattern", ["random", "same", "stride_32", "banks"])
@pytest.mark.parametrize("mw", [1, 2, 4])
def test_lookup_layout_conflict_free(mw, pattern):
    """The shared-memory offsets of the kernel's loads and stores, as
    ``tiles`` mirrors them: in every access phase (32 / mw lanes of a
    warp for an mw*4-byte access) the lanes hit distinct bank groups,
    whatever indices they look up: the O lookups, the O slab's stores
    (recompute and copy), and the 16- or 8-byte reads of the index
    rows."""
    rng = np.random.default_rng(mw)
    width = 4 * mw
    phase = 128 // width

    def distinct(offsets):
        offsets = np.asarray(offsets)
        assert (offsets % width == 0).all()
        for p in range(0, 32, phase):
            groups = (offsets[p:p + phase] // width) % phase
            assert len(set(groups.tolist())) == phase, (offsets, p)

    for trial in range(50):
        e = {"random": rng.integers(0, 256, 32),
             "same": np.full(32, rng.integers(0, 256)),
             "stride_32": (np.arange(32) * 32 + trial) % 256,
             "banks": (np.arange(32) * (32 // mw) + trial) % 256}[pattern]
        c = int(rng.integers(0, 4))
        # lookups: lane (row, group) reads its row's slot of entry e[lane]
        distinct([tiles.o_slot_byte(c, int(e[l]), tiles.lane_coords(l, mw)[0], mw)
                  for l in range(32)])
        # O stores: thread t writes row t % vl of entry e (its own e)
        vl = tiles.LINE // mw
        distinct([tiles.o_slot_byte(c, int(e[t]), t % vl, mw) for t in range(32)])
    # index rows: a quarter-warp (16-byte reads) or half-warp (8-byte
    # reads) of lanes on distinct rows at one column run
    for bn in tiles.COLUMN_TILES:
        cpl = bn // (tiles.WARPS * mw)
        rd = 16 if cpl % 16 == 0 else 8
        for warp in range(tiles.WARPS):
            offs = []
            for l in range(32):
                row, cg = tiles.lane_coords(l, mw)
                grp = warp * mw + cg
                offs.append(tiles.index_byte(1, row, grp * cpl, mw, bn))
            offs = np.asarray(offs)
            ph = 128 // rd
            for p in range(0, 32, ph):
                g = (offs[p:p + ph] // rd) % ph
                assert len(set(g.tolist())) == ph, (bn, mw, warp, p)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(K, N, M, C=2, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    vq = synthetic_vq(g, K, N, C=C, device="cuda")
    vq.scale = torch.rand(N, generator=g, device="cuda") + 0.5
    x = torch.randn((M, K), generator=g, device="cuda")
    return x, vq


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4, 8, 12, 16])
@pytest.mark.parametrize("K,N", [(4096, 12288), (4096, 4096), (4096, 22016),
                                 (11008, 4096)])
def test_kernel_matches_plain_full_width(cuda, K, N, M):
    x, vq = _card_case(K, N, M)
    before = fused_vq_matmul.launches
    got = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fused_vq_matmul.launches == before + 1
    want = fused_vq_matmul(x, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


# deepseek-v2-lite-16b's decode linears: wq_kva (N = 3648, ragged at both
# column tiles), wkv_b at M = 4 and at the expand decode's M = slots x
# max_len = 2048 (V = 64), wo, a routed expert's gu and down at its
# capacity M = 1, the shared experts' and the dense first layer's MLPs
DEEPSEEK = [(2048, 3648, 4), (512, 4096, 4), (512, 4096, 2048),
            (2048, 2048, 4), (2048, 2816, 1), (1408, 2048, 1),
            (2048, 5632, 4), (2816, 2048, 4), (2048, 21888, 4),
            (10944, 2048, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", DEEPSEEK)
def test_kernel_matches_plain_at_deepseek_linears(cuda, K, N, M):
    x, vq = _card_case(K, N, M)
    before = fused_vq_matmul.launches
    got = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fused_vq_matmul.launches == before + 1
    want = fused_vq_matmul(x, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M,C", [(296, 100, 3, 2), (296, 102, 9, 2),
                                     (64, 1030, 1, 1), (800, 2048, 17, 4)])
def test_kernel_matches_plain_ragged(cuda, K, N, M, C):
    x, vq = _card_case(K, N, M, C=C)
    got = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    want = fused_vq_matmul(x, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_bitwise_deterministic(cuda):
    x, vq = _card_case(11008, 4096, 4)
    a = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    b = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_widened_indices(cuda):
    x, vq = _card_case(256, 256, 1)
    wide = VQWeight(idx=vq.idx.to(torch.int32), codebooks=vq.codebooks,
                    scale=vq.scale, K=vq.K, N=vq.N)
    with pytest.raises(ValueError):
        fused_vq_matmul(x, wide)
