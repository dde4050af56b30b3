"""Port of the dequant-GEMV kernel: the plain PyTorch version against the
JAX wrapper in Pallas interpret mode (CPU), and the CUDA kernel against
the plain version on the card.

Tolerance: fp32 rtol=1e-5, atol=1e-5 on the CPU — both sides rebuild the
same weights exactly and differ only in the summation order of the
K-long dot products. On the card: 1e-4 * max(1, max|y|), the same
reassociation over up to K = 11008 terms (llama2-7b ``down``)."""
import numpy as np
import pytest
import torch

from repro_torch.convert import from_jax_params
from repro_torch.core.ops import dequant_matmul
from repro_torch.core.vq import synthetic_vq
from repro_torch.kernels.dequant_gemv import dequant_gemv

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
def test_kernel_bitwise_deterministic(cuda):
    x, vq = _card_case(4096, 4096, 256)
    assert torch.equal(dequant_gemv(x, vq), dequant_gemv(x, vq))
