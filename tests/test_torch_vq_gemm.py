"""Port of the VQ-GEMM kernel (the first half of the two-kernel EVA
split): the plain PyTorch version against the JAX wrapper in Pallas
interpret mode and through its jnp oracle (CPU), and the CUDA kernel
against the plain version on the card.

Tolerance: fp32 rtol=1e-6, atol=1e-6 on the CPU — each output is an
8-term fp32 dot, summed in orders that may differ (bf16 x is widened to
fp32 exactly on both sides first). On the card the kernel (fused
multiply-adds in the order d = 0..7) is held to 1e-4 * max(1, max|O|)
against the plain ``einsum``, and with bf16 x bitwise to its own run on
the same values in fp32."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.vq_gemm import vq_gemm
from repro_torch.kernels.vq_gemm.ops import ROWS_MAX, launch_shape

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


@pytest.mark.parametrize("K,M,C", [(296, 3, 2), (256, 1, 1), (512, 2, 4),
                                   (88, 5, 2)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_plain_bf16_x_matches_jax(K, M, C, use_pallas):
    """The served dtype: bf16 x, widened inside the Pallas kernel."""
    import jax.numpy as jnp
    from repro.kernels.vq_gemm import vq_gemm as jax_vq_gemm

    x, cb = _inputs(K, M, C, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jax_vq_gemm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                       jnp.asarray(cb), block_mv=32, interpret=True,
                       use_pallas=use_pallas)
    before = vq_gemm.launches
    got = vq_gemm(xb, torch.from_numpy(cb))
    assert vq_gemm.launches == before
    assert got.shape == (C, M, K // 8, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("MV", [1, 55, 111, 2048, 5504, 131072])
def test_launch_shape_covers_every_row_once(MV, C, sm_count):
    """CTA b writes rows [b * rows, min(MV, (b + 1) * rows)) of every
    codebook (vq_gemm.cu): each (c, row) exactly once, no CTA idle, at
    most ROWS_MAX rows a CTA, and no more CTAs than SMs unless a CTA
    would hold more than ROWS_MAX rows."""
    rows, ctas = launch_shape(MV, sm_count)
    assert 1 <= rows <= ROWS_MAX
    assert ctas <= sm_count or rows == ROWS_MAX
    seen = np.zeros((C, MV), dtype=np.int64)
    for b in range(ctas):
        r0, r1 = b * rows, min(MV, (b + 1) * rows)
        assert r0 < r1
        for c in range(C):
            seen[c, r0:r1] += 1
    assert (seen == 1).all()


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
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [4096, 11008])   # wqkv / wo / gu, down
def test_kernel_matches_plain_full_width(cuda, K, M):
    _check(*_card_case(K, M))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [4096, 11008])
def test_kernel_bf16_x_matches_plain_full_width(cuda, K, M):
    """The served dtype, read as stored: bitwise the fp32 run of the same
    values."""
    x, cb = _card_case(K, M)
    xb = x.to(torch.bfloat16)
    got = _check(xb, cb)
    assert torch.equal(got, vq_gemm(xb.float(), cb))


# deepseek-v2-lite-16b's decode linears under the split-pinned planner:
# (K, M) of wq_kva / wo / shared gu at M = 4, wkv_b at the expand
# decode's M = slots x max_len = 2048 (M x V = 131072 rows of O), a routed
# expert's gu and down at its capacity M = 1, the shared experts' and the
# dense first layer's down
DEEPSEEK = [(2048, 4), (512, 2048), (2048, 1), (1408, 1), (2816, 4),
            (10944, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,M", DEEPSEEK)
def test_kernel_matches_plain_at_deepseek_linears(cuda, K, M, dtype):
    x, cb = _card_case(K, M)
    _check(x.to(dtype), cb)


# xlstm-125m's decode linears under the split-pinned planner: K of
# 768 / 1536 / 1024 (V = 96 / 192 / 128) at M = 4
XLSTM = [(768, 4), (1536, 4), (1024, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,M", XLSTM)
def test_kernel_matches_plain_at_xlstm_linears(cuda, K, M, dtype):
    x, cb = _card_case(K, M)
    _check(x.to(dtype), cb)


@pytest.mark.cuda
def test_kernel_bf16_x_is_one_kernel(cuda):
    from torch.profiler import ProfilerActivity, profile

    x, cb = _card_case(4096, 4)
    xb = x.to(torch.bfloat16)
    vq_gemm(xb, cb)
    torch.cuda.synchronize()
    before = vq_gemm.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vq_gemm(xb, cb)
        torch.cuda.synchronize()
    assert vq_gemm.launches == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "vq_gemm_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_kernel_rejects_misaligned_or_strided_x(cuda):
    x, cb = _card_case(256, 2)
    for dt in (torch.float32, torch.bfloat16):
        flat = x.to(dt).reshape(-1)
        buf = torch.empty(flat.numel() + 8, dtype=dt, device="cuda")
        buf[1:1 + flat.numel()] = flat
        misaligned = buf[1:1 + flat.numel()].reshape(2, 256)
        wide = torch.empty((2, 512), dtype=dt, device="cuda")
        wide[:, :256] = x.to(dt)
        for bad in (misaligned, wide[:, :256]):
            before = vq_gemm.launches
            with pytest.raises(ValueError, match="16-byte aligned"):
                vq_gemm(bad, cb)
            assert vq_gemm.launches == before


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
def test_kernel_bf16_x_bitwise_deterministic(cuda):
    x, cb = _card_case(11008, 4)
    x = x.to(torch.bfloat16)
    assert torch.equal(vq_gemm(x, cb), vq_gemm(x, cb))


@pytest.mark.cuda
def test_kernel_rejects_wrong_codebooks(cuda):
    x, cb = _card_case(256, 2)
    buf = torch.empty(cb.numel() + 4, dtype=cb.dtype, device="cuda")
    buf[1:1 + cb.numel()] = cb.reshape(-1)
    offset = buf[1:1 + cb.numel()].view(cb.shape)  # contiguous, 4 bytes off
    for bad in (cb.to(torch.bfloat16), cb[:, :, :128], cb.transpose(1, 2)):
        with pytest.raises(ValueError):
            vq_gemm(x, bad)
    with pytest.raises(ValueError, match="address mod 16 = 4"):
        vq_gemm(x, offset)
