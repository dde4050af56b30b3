"""Port of the dequant-GEMV kernel: the plain PyTorch version and the
kernel's split-precision arithmetic (``dequant_gemv_split_ref``: bf16
hi/lo parts, exact products summed in fp32) against the JAX wrapper in
Pallas interpret mode (CPU), and the CUDA kernel against the plain
version on the card.

Tolerance: the plain version at fp32 rtol=1e-5, atol=1e-5 on the CPU —
both sides rebuild the same weights exactly and differ only in the
summation order of the K-long dot products. The split arithmetic, and
the kernel on the card, at 1e-4 * max(1, max|y|): the hi/lo parts keep
~16 significant bits of each weight (and of fp32 x), and the card sums
over up to K = 11008 terms (llama2-7b ``down``) in its own order."""
import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.core.ops import dequant_matmul
from repro_torch.core.vq import synthetic_vq
from repro_torch.kernels.dequant_gemv import (dequant_gemv,
                                              dequant_gemv_ref,
                                              dequant_gemv_split_ref)
from repro_torch.kernels.dequant_gemv.ops import launch_shape

torch.set_num_threads(1)


def _inputs(K, N, M, C=2, splits=(), seed=1):
    from repro.core.vq import VQWeight as JaxVQWeight

    rng = np.random.default_rng(seed)
    V = K // 8
    idx = rng.integers(0, 256, (C, V, N)).astype(np.uint8)
    cb = (rng.standard_normal((C, 8, 256)) / np.sqrt(K * C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, JaxVQWeight(idx=idx, codebooks=cb, scale=scale, K=K, N=N, d=8,
                          n=8, splits=splits)


@pytest.mark.parametrize("K,N,M,splits", [
    (296, 100, 1, ()),            # ragged V and N
    (296, 100, 3, ()),
    (256, 192, 3, (64, 64, 64)),  # grouped family
    (128, 200, 16, ()),           # prefill-sized M
])
def test_plain_matches_jax_pallas_interpret(K, N, M, splits):
    import jax.numpy as jnp
    from repro.kernels.dequant_gemv import dequant_gemv as jax_dequant_gemv

    x, jvq = _inputs(K, N, M, splits=splits)
    want = jax_dequant_gemv(jnp.asarray(x), jvq, interpret=True, block_v=4,
                            block_n=64, out_dtype=jnp.float32)
    vq = from_jax_params(jvq, device="cpu")
    before = dequant_gemv.launches
    got = dequant_gemv(torch.from_numpy(x), vq, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert dequant_gemv.launches == before


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_split_precision_matches_jax_pallas_interpret(C, x_dtype):
    """bf16 x: y = x.w_hi + x.w_lo; fp32 x: x_hi.w_hi + x_hi.w_lo +
    x_lo.w_hi — both within the card's tolerance of the fp32 reference."""
    import jax.numpy as jnp
    from repro.kernels.dequant_gemv import dequant_gemv as jax_dequant_gemv

    x, jvq = _inputs(296, 200, 16, C=C, seed=C)
    xt = torch.from_numpy(x)
    if x_dtype == "bfloat16":
        xt = xt.bfloat16()
        x = xt.float().numpy()  # the reference sees the same bf16 values
    want = np.asarray(jax_dequant_gemv(jnp.asarray(x), jvq, interpret=True,
                                       block_v=1, block_n=40,
                                       out_dtype=jnp.float32))
    vq = from_jax_params(jvq, device="cpu")
    got = dequant_gemv_split_ref(xt.reshape(16, 37, 8),
                                 vq.codebooks.transpose(-1, -2), vq.idx,
                                 vq.scale)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= tol
    # the split is what keeps the tolerance: one bf16 product misses it
    w = dequant_gemv_ref(torch.eye(296).reshape(296, 37, 8),
                         vq.codebooks.transpose(-1, -2), vq.idx,
                         torch.ones(200))
    one = (xt.bfloat16().float() @ w.bfloat16().float()) * vq.scale
    assert np.abs(one.numpy() - want).max() > tol


@pytest.mark.parametrize("M,V,N,want", [
    (512, 512, 22016, (256, 1)),   # gu: 344 tiles fill the card
    (512, 512, 4096, (256, 2)),    # wo: 64 tiles, two K splits
    (32, 512, 4096, (32, 8)),      # the smallest bucket: 2 CTAs an SM
    (32, 512, 22016, (32, 1)),     # gu: 172 tiles, no split
    (64, 512, 4096, (64, 8)),      # every served bucket has its tile
    (64, 1376, 4096, (64, 8)),
    (128, 512, 4096, (128, 4)),
    (128, 512, 12288, (128, 1)),
    (256, 512, 12288, (256, 1)),
    (256, 1376, 4096, (256, 4)),   # down
    (1, 37, 1030, (32, 5)),        # ragged: splits stop at 5 stages
    (129, 64, 12288, (256, 1)),
    (63, 8, 100, (64, 1)),         # one stage: no split
])
def test_launch_shape(M, V, N, want):
    assert launch_shape(M, V, N, 132) == want


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
    return torch.randn((M, K), generator=g, device="cuda"), vq


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M,C", [
    (4096, 12288, 512, 2), (4096, 4096, 512, 2), (4096, 22016, 512, 2),
    (11008, 4096, 512, 2),                       # llama2-7b, largest bucket
    (296, 100, 77, 2), (64, 1030, 1, 1), (800, 2048, 65, 4),   # ragged
])
def test_kernel_matches_plain(cuda, K, N, M, C):
    x, vq = _card_case(K, N, M, C=C)
    before = dequant_gemv.launches
    got = dequant_gemv(x, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dequant_gemv.launches == before + 1
    want = dequant_gemv(x, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    alt = dequant_matmul(x, vq, out_dtype=torch.float32)
    assert (alt - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("M", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("K,N", [(4096, 12288), (4096, 4096), (4096, 22016),
                                 (11008, 4096)])   # llama2-7b linears
def test_kernel_bf16_x_matches_plain(cuda, K, N, M):
    """The served dtype: bf16 activations go to the kernel as they are."""
    x, vq = _card_case(K, N, M)
    xb = x.bfloat16()
    before = dequant_gemv.launches
    got = dequant_gemv(xb, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dequant_gemv.launches == before + 1
    want = dequant_gemv(xb, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    # bf16 output: the same sums, rounded once
    assert torch.equal(dequant_gemv(xb, vq), got.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", [
    (2048, 3648, 200), (512, 4096, 200), (2048, 2048, 200),  # attention
    (10944, 2048, 200),                     # first layer's down, V = 1368
    (2048, 2816, 24), (1408, 2048, 24),     # an expert at capacity 24
    (2816, 2048, 200)])                     # the shared experts' down
def test_kernel_bf16_x_matches_plain_at_deepseek_linears(cuda, K, N, M):
    """deepseek-v2-lite-16b's prefill linears of a 200-token prompt."""
    x, vq = _card_case(K, N, M)
    xb = x.bfloat16()
    before = dequant_gemv.launches
    got = dequant_gemv(xb, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dequant_gemv.launches == before + 1
    want = dequant_gemv(xb, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 63, 65, 129])
def test_kernel_tile_edges(cuda, M, dtype):
    """Ragged M, N (not a multiple of 16: byte-wise index rows) and V (the
    last stage holds 5 of 8 index rows), every split count."""
    x, vq = _card_case(296, 1030, M, C=3, seed=M)
    x = x.to(dtype)
    got = dequant_gemv(x, vq, out_dtype=torch.float32)
    want = dequant_gemv(x, vq, out_dtype=torch.float32, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [64, 512])   # with and without K splits
def test_kernel_bitwise_deterministic(cuda, M, dtype):
    x, vq = _card_case(4096, 4096, M)
    x = x.to(dtype)
    assert torch.equal(dequant_gemv(x, vq), dequant_gemv(x, vq))
