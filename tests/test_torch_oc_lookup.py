"""Port of the OC-lookup kernel and the two-kernel EVA matmul
(``eva_split_matmul``: vq_gemm, then oc_lookup): the plain PyTorch
versions against the JAX wrappers in Pallas interpret mode (CPU), and the
CUDA kernels against the plain versions on the card.

Tolerance: fp32 rtol=1e-5, atol=1e-5 on the CPU — the two sides sum the
C*V lookup terms of each output in different orders (as
``test_torch_fused_vq_matmul.py``). On the card the kernel is held to
1e-4 * max(1, max|y|): the same reassociation over up to C*V = 2752
terms (llama2-7b ``down``)."""
import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.core.vq import VQWeight, synthetic_vq
from repro_torch.kernels import build
from repro_torch.kernels.fused_vq_matmul import fused_vq_matmul
from repro_torch.kernels.oc_lookup import eva_split_matmul, oc_lookup
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.eva_lookup.ref import lookup_in_kernel_order
from repro_torch.kernels.oc_lookup.ops import select_lookup_split
from repro_torch.kernels.vq_gemm import vq_gemm

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


@pytest.mark.parametrize("K,N,M,C", [
    (296, 100, 1, 2),     # V=37, N=100: ragged against both tiles
    (296, 100, 3, 2),
    (64, 130, 2, 1),
    (160, 64, 4, 4),
])
def test_plain_matches_jax_pallas_interpret(K, N, M, C):
    import jax.numpy as jnp
    from repro.kernels.oc_lookup import oc_lookup as jax_oc_lookup

    x, jvq = _inputs(K, N, M, C)
    rng = np.random.default_rng(1)
    O = rng.standard_normal((C, M, K // 8, 256)).astype(np.float32)
    want = jax_oc_lookup(jnp.asarray(O), jnp.asarray(jvq.idx),
                         jnp.asarray(jvq.scale), block_v=4, block_n=64,
                         interpret=True)
    vq = from_jax_params(jvq, device="cpu")
    assert vq.idx.dtype == torch.uint8
    before = oc_lookup.launches
    got = oc_lookup(torch.from_numpy(O), vq.idx, vq.scale)
    assert oc_lookup.launches == before  # CPU tensors never launch
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("K,N,M,splits", [
    (256, 192, 3, (64, 64, 64)),  # grouped wqkv-like family
    (296, 96, 1, (32, 64)),       # grouped gu-like family, ragged V
])
def test_eva_split_matches_jax_pallas_interpret(K, N, M, splits):
    import jax.numpy as jnp
    from repro.kernels.oc_lookup.ops import eva_split_matmul as jax_split

    x, jvq = _inputs(K, N, M, splits=splits)
    want = jax_split(jnp.asarray(x), jvq, interpret=True,
                     out_dtype=jnp.float32)
    vq = from_jax_params(jvq, device="cpu")
    assert vq.splits == splits
    counts = (vq_gemm.launches, oc_lookup.launches)
    got = eva_split_matmul(torch.from_numpy(x), vq, out_dtype=torch.float32)
    assert (vq_gemm.launches, oc_lookup.launches) == counts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_leading_dims_and_out_dtype():
    x, jvq = _inputs(128, 64, 6)
    vq = from_jax_params(jvq, device="cpu")
    x3 = torch.from_numpy(x).reshape(2, 3, 128).to(torch.bfloat16)
    y = eva_split_matmul(x3, vq)
    assert y.shape == (2, 3, 64) and y.dtype == torch.bfloat16


DECODE_LINEARS = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("K,N", DECODE_LINEARS)
def test_select_lookup_split_covers_v(K, N, M):
    """The lookup kernel's tile model at every decode linear of
    llama2-7b: covers V and N, fits 227 KB with no codebooks or x rows
    in shared memory, and fills at most one wave of the card."""
    V = K // 8
    t = select_lookup_split(M, V, N, C=2, sm_count=132)
    slabs = -(-V // t.vl)
    assert t.mw == tiles.lane_width(M) and t.vl * t.mw == tiles.LINE
    assert t.splits * t.slabs_per_split >= slabs
    assert (t.splits - t.cs) * t.slabs_per_split < slabs
    assert 1 <= t.cs <= tiles.CS_MAX and 1 <= t.stages <= tiles.STAGES_MAX
    assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages, False)
    assert t.smem <= 227 * 1024 and t.cols_per_lane >= t.vl
    assert -(-N // t.bn) * t.splits * -(-M // 4) <= 132


@pytest.mark.parametrize("many", [False, True], ids=["one_split", "splits"])
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("M", [1, 2, 4, 5, 8])
def test_kernel_order_matches_jax_pallas_interpret(M, C, many):
    """The CUDA kernel's summation order (per-lane partials over v, the
    xor butterfly across lanes, clusters in rank order, then groups),
    emulated in plain torch, against the reference's Pallas kernel in
    interpret mode on the same output codebook: within 1e-4 * max|y|,
    at ragged V and N, with one split and with several."""
    import jax.numpy as jnp
    from repro.kernels.oc_lookup import oc_lookup as jax_oc_lookup

    K, N = {1: (296, 100), 2: (264, 1030), 4: (512, 96)}[C]
    V = K // 8
    x, jvq = _inputs(K, N, M, C, seed=M * 10 + C)
    O = np.random.default_rng(M).standard_normal((C, M, V, 256)).astype(np.float32)
    t = select_lookup_split(M, V, N, C, sm_count=1)
    if many:
        slabs = -(-V // t.vl)
        t = t._replace(cs=2, groups=2, slabs_per_split=-(-slabs // 4))
    assert t.splits * t.slabs_per_split * t.vl >= V and (t.splits > 1) == many
    want = np.asarray(jax_oc_lookup(jnp.asarray(O), jnp.asarray(jvq.idx),
                                    jnp.asarray(jvq.scale), block_v=4,
                                    block_n=64, interpret=True))
    vq = from_jax_params(jvq, device="cpu")
    got = lookup_in_kernel_order(torch.from_numpy(O), vq.idx, vq.scale, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


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


def _check_lookup(x, vq):
    O = vq_gemm(x, vq.codebooks)
    before = oc_lookup.launches
    got = oc_lookup(O, vq.idx, vq.scale)
    torch.cuda.synchronize()
    assert oc_lookup.launches == before + 1
    want = oc_lookup(O, vq.idx, vq.scale, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("K,N", [(4096, 12288), (4096, 4096), (4096, 22016),
                                 (11008, 4096)])
def test_kernel_matches_plain_full_width(cuda, K, N, M):
    _check_lookup(*_card_case(K, N, M))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", [(4096, 4096, 1), (11008, 4096, 4),
                                   (296, 1030, 3), (800, 2048, 17)])
def test_kernel_bitwise_equal_to_its_order(cuda, K, N, M):
    """The kernel sums in exactly the order ``lookup_in_kernel_order``
    emulates, for the launch shape it took."""
    x, vq = _card_case(K, N, M)
    O = vq_gemm(x, vq.codebooks)
    got = oc_lookup(O, vq.idx, vq.scale).cpu()
    t = select_lookup_split(M, K // 8, N, vq.C, build.device_sm_count(0),
                            tiles.cluster_slots("oc_lookup", 0, M, vq.C, False))
    want = lookup_in_kernel_order(O.cpu(), vq.idx.cpu(), vq.scale.cpu(), t)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M,C", [(296, 100, 3, 2), (296, 102, 9, 2),
                                     (64, 1030, 1, 1), (800, 2048, 17, 4),
                                     (88, 5, 2, 3)])
def test_kernel_matches_plain_ragged(cuda, K, N, M, C):
    _check_lookup(*_card_case(K, N, M, C=C))


@pytest.mark.cuda
def test_kernel_bitwise_deterministic(cuda):
    x, vq = _card_case(11008, 4096, 4)
    O = vq_gemm(x, vq.codebooks)
    assert torch.equal(oc_lookup(O, vq.idx, vq.scale),
                       oc_lookup(O, vq.idx, vq.scale))


# deepseek-v2-lite-16b's decode linears under the split-pinned planner
# (K, N, M): wq_kva (N = 3648, ragged at both column tiles), wkv_b at the
# expand decode's M = slots x max_len = 2048 (V = 64), wo, a routed
# expert's gu and down at its capacity M = 1, the shared experts' and the
# dense first layer's MLPs
DEEPSEEK = [(2048, 3648, 4), (512, 4096, 2048), (2048, 2048, 4),
            (2048, 2816, 1), (1408, 2048, 1), (2048, 5632, 4),
            (2816, 2048, 4), (2048, 21888, 4), (10944, 2048, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", DEEPSEEK)
def test_kernel_matches_plain_at_deepseek_linears(cuda, K, N, M):
    _check_lookup(*_card_case(K, N, M))


# xlstm-125m's decode linears under the split-pinned planner (K, N, M):
# up_h / up_g, the grouped wq|wk|wv, down, wz / wo / out (N = 768, ragged
# at the 1024-column tile), the FFN's up and down, at M = 4
XLSTM = [(768, 1536, 4), (1536, 4608, 4), (1536, 768, 4), (768, 768, 4),
         (768, 1024, 4), (1024, 768, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", XLSTM)
def test_kernel_matches_plain_at_xlstm_linears(cuda, K, N, M):
    _check_lookup(*_card_case(K, N, M))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", [(4096, 12288, 4)] + DEEPSEEK + XLSTM)
def test_eva_split_matches_plain_and_fused(cuda, K, N, M):
    x, vq = _card_case(K, N, M)
    got = eva_split_matmul(x, vq, out_dtype=torch.float32)
    plain = eva_split_matmul(x, vq, out_dtype=torch.float32, use_kernel=False)
    fused = fused_vq_matmul(x, vq, out_dtype=torch.float32)
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= tol
    assert (got - fused).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_rejects_widened_indices_and_wrong_dtypes(cuda):
    x, vq = _card_case(256, 256, 1)
    O = vq_gemm(x, vq.codebooks)
    with pytest.raises(ValueError):
        oc_lookup(O, vq.idx.to(torch.int32), vq.scale)
    with pytest.raises(ValueError):
        oc_lookup(O.to(torch.bfloat16), vq.idx, vq.scale)
    with pytest.raises(ValueError):
        oc_lookup(O, vq.idx, vq.scale.to(torch.bfloat16))
    wide = VQWeight(idx=vq.idx.to(torch.int32), codebooks=vq.codebooks,
                    scale=vq.scale, K=vq.K, N=vq.N)
    with pytest.raises(ValueError):
        eva_split_matmul(x, wide)
