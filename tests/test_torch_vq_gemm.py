"""Port of the VQ-GEMM kernel (the first half of the two-kernel EVA
split): the plain PyTorch version against the JAX wrapper in Pallas
interpret mode and through its jnp oracle (CPU), and the CUDA kernel
against the plain version on the card.

Tolerance: fp32 rtol=1e-6, atol=1e-6 on the CPU — each output is an
8-term fp32 dot, summed in orders that may differ. On the card the kernel
(fused multiply-adds in the order d = 0..7) is held to
1e-4 * max(1, max|O|) against the plain ``einsum``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.vq_gemm import vq_gemm

torch.set_num_threads(1)


def _inputs(K, M, C, seed=0):
    rng = np.random.default_rng(seed)
    cb = (rng.standard_normal((C, 8, 256)) / np.sqrt(K * C)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, cb


@pytest.mark.parametrize("K,M,C", [
    (296, 3, 2),     # MV = 111: ragged against the 32-row tile
    (256, 1, 1),
    (512, 2, 4),
    (88, 5, 2),      # MV = 55
])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_plain_matches_jax(K, M, C, use_pallas):
    import jax.numpy as jnp
    from repro.kernels.vq_gemm import vq_gemm as jax_vq_gemm

    x, cb = _inputs(K, M, C)
    want = jax_vq_gemm(jnp.asarray(x), jnp.asarray(cb), block_mv=32,
                       interpret=True, use_pallas=use_pallas)
    before = vq_gemm.launches
    got = vq_gemm(torch.from_numpy(x), torch.from_numpy(cb))
    assert vq_gemm.launches == before  # CPU tensors never launch
    assert got.shape == (C, M, K // 8, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_leading_dims_and_dtype():
    x, cb = _inputs(64, 6, 2)
    x3 = torch.from_numpy(x).reshape(2, 3, 64).to(torch.bfloat16)
    O = vq_gemm(x3, torch.from_numpy(cb))
    assert O.shape == (2, 6, 8, 256) and O.dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of d"):
        vq_gemm(torch.zeros(2, 60), torch.from_numpy(cb))


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(K, M, C=2, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cb = torch.randn((C, 8, 256), generator=g, device="cuda") / (K * C) ** 0.5
    x = torch.randn((M, K), generator=g, device="cuda")
    return x, cb


def _check(x, cb):
    before = vq_gemm.launches
    got = vq_gemm(x, cb)
    torch.cuda.synchronize()
    assert vq_gemm.launches == before + 1
    want = vq_gemm(x, cb, use_kernel=False)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("K", [4096, 11008])   # wqkv / wo / gu, down
def test_kernel_matches_plain_full_width(cuda, K, M):
    _check(*_card_case(K, M))


@pytest.mark.cuda
@pytest.mark.parametrize("K,M,C", [(296, 3, 2), (88, 5, 1), (800, 17, 4),
                                   (8, 1, 3)])
def test_kernel_matches_plain_ragged(cuda, K, M, C):
    _check(*_card_case(K, M, C))


@pytest.mark.cuda
def test_kernel_bitwise_deterministic(cuda):
    x, cb = _card_case(11008, 4)
    assert torch.equal(vq_gemm(x, cb), vq_gemm(x, cb))


@pytest.mark.cuda
def test_kernel_rejects_wrong_codebooks(cuda):
    x, cb = _card_case(256, 2)
    for bad in (cb.to(torch.bfloat16), cb[:, :, :128], cb.transpose(1, 2)):
        with pytest.raises(ValueError):
            vq_gemm(x, bad)
