"""Port of the INT8 prefill GEMM: ``quantize_int8``, ``core.ops.
int8_matmul`` and the kernel wrapper ``int8_matmul_kernel`` (its plain
version on the CPU) against the JAX functions — the wrapper in Pallas
interpret mode — and the CUDA kernel against its plain version on the
card.

Tolerance: none against ``core.ops.int8_matmul`` and on the card.
Quantization is elementwise with round-half-to-even on both sides, the
integer sums are exact (int32 in JAX, float64 holding integers below
2^53 in the port), and the scales are applied as (acc * xs) * ws in fp32
on both sides, so every output is bit-equal. Against the Pallas wrapper
in interpret mode: rtol 1e-6 (8 ulp), where XLA's fused epilogue rounds
the scale products differently (up to 3 ulp seen)."""
import numpy as np
import pytest
import torch

from repro_torch.core.ops import int8_matmul, quantize_int8
from repro_torch.kernels.int8_gemm import (int8_gemm, int8_gemm_ref,
                                           int8_matmul_kernel)

torch.set_num_threads(1)


def _xw(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 127.0]  # round-half cases once scaled
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_int8_bit_equal(axis):
    import jax.numpy as jnp
    from repro.core.ops import quantize_int8 as jax_quantize

    x, _ = _xw(9, 40, 1)
    jq, js = jax_quantize(jnp.asarray(x), axis=axis)
    tq, ts = quantize_int8(torch.from_numpy(x), axis=axis)
    assert tq.dtype == torch.int8 and ts.shape == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,K,N", [(5, 40, 36), (1, 64, 128), (33, 96, 70)])
def test_int8_matmul_matches_reference(M, K, N):
    import jax.numpy as jnp
    from repro.core.ops import int8_matmul as jax_int8_matmul
    from repro.kernels.int8_gemm import int8_matmul_kernel as jax_kernel

    x, w = _xw(M, K, N)
    want = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(int8_matmul(xt, wt).numpy(), want)
    before = int8_gemm.launches
    got = int8_matmul_kernel(xt[None], wt)   # leading dims kept
    assert got.shape == (1, M, N) and int8_gemm.launches == before
    np.testing.assert_array_equal(got[0].numpy(), want)
    # the Pallas wrapper in interpret mode: XLA fuses its (acc * xs) * ws
    # epilogue and rounds some outputs differently (up to 3 ulp seen)
    interp = np.asarray(jax_kernel(jnp.asarray(x), jnp.asarray(w),
                                   block_m=16, block_n=32, block_k=32,
                                   interpret=True))
    np.testing.assert_allclose(got[0].numpy(), interp, rtol=1e-6, atol=0)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card(M, K, N, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda")
    w = torch.randn((K, N), generator=g, device="cuda").bfloat16()
    xq, xs = quantize_int8(x, axis=-1)
    wq, ws = quantize_int8(w, axis=0)
    return xq, wq, xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (256, 4096, 32000),   # the llama2-7b lm_head at a 256-token prefill
    (64, 4096, 32000),
    (77, 200, 130),       # ragged: K and N padded by the wrapper
    (1, 64, 8),
])
def test_kernel_matches_plain(cuda, M, K, N):
    xq, wq, xs, ws = _card(M, K, N)
    before = int8_gemm.launches
    got = int8_gemm(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1 and got.shape == (M, N)
    assert torch.equal(got, int8_gemm_ref(xq, wq, xs, ws))


@pytest.mark.cuda
def test_kernel_bitwise_deterministic(cuda):
    ops = _card(256, 4096, 32000)
    assert torch.equal(int8_gemm(*ops), int8_gemm(*ops))
