"""Port of the INT8 prefill GEMM: ``quantize_int8``, ``core.ops.
int8_matmul`` and the kernel wrapper ``int8_matmul_kernel`` (its plain
version on the CPU) against the JAX functions — the wrapper in Pallas
interpret mode; the kernel's own formulation (y^T = wq^T . xq^T over its
launch shape's tiles, int32 sums in k32 steps, then (acc * xs) * ws)
against the Pallas kernel in interpret mode; its launch shapes; and the
CUDA kernel against its plain version on the card.

Tolerance: none against ``core.ops.int8_matmul`` and on the card.
Quantization is elementwise with round-half-to-even on both sides, the
integer sums are exact (int32 in JAX, float64 holding integers below
2^53 in the port), and the scales are applied as (acc * xs) * ws in fp32
on both sides, so every output is bit-equal. Against the Pallas wrapper
in interpret mode: rtol 1e-6 (8 ulp), where XLA's fused epilogue rounds
the scale products differently (up to 3 ulp seen); the Pallas kernel
called directly rounds them as (acc * xs) * ws, and the formulation is
held bit-equal to it."""
import numpy as np
import pytest
import torch

from repro_torch.core.ops import int8_matmul, quantize_int8
from repro_torch.kernels.int8_gemm import (int8_gemm, int8_gemm_ref,
                                           int8_matmul_kernel)
from repro_torch.kernels.int8_gemm.ops import (COLS_PER_CTA, N_ALIGN,
                                               launch_shape)

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


K_STAGE = 128   # k per pipeline stage of the kernel (one swizzle row)


def _kernel_formulation(xq, wq, xs, ws):
    """What csrc/int8_gemm.cu computes, in plain torch: the launch shape's
    tiles (T tokens x 128 weight columns), zero-filled past M, N and K (to
    whole 128-k stages); y^T = wq^T . xq^T summed in int32 one k32 wgmma
    step at a time, in k order; then y = (float(acc) * xs) * ws."""
    M, K = xq.shape
    N = wq.shape[1]
    T, n_tiles, m_tiles = launch_shape(M, N)
    Kp = -(-K // K_STAGE) * K_STAGE
    xp = torch.zeros((m_tiles * T, Kp), dtype=torch.int32)
    xp[:M, :K] = xq.int()
    wp = torch.zeros((Kp, n_tiles * COLS_PER_CTA), dtype=torch.int32)
    wp[:K, :N] = wq.int()
    yt = torch.zeros((n_tiles * COLS_PER_CTA, m_tiles * T), dtype=torch.int32)
    for k0 in range(0, Kp, 32):
        yt += wp[k0:k0 + 32].T @ xp[:, k0:k0 + 32].T
    acc = yt.T[:M, :N]
    return (acc.float() * xs.float()) * ws.float()


def _int8_operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xq[0, :] = 127                       # the largest sums the inputs allow
    wq[:, 0] = 127
    xs = rng.uniform(1e-3, 5e-2, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 5e-2, (1, N)).astype(np.float32)
    return xq, wq, xs, ws


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (32, 256, 128, 32, 64, 128),    # one token tile, two 128-k stages
    (64, 384, 256, 32, 128, 128),   # two column tiles, three stages
    (16, 96, 48, 16, 16, 32),       # k and columns short of a whole tile
    (300, 160, 32, 60, 32, 32),     # two token tiles of 256
])
def test_kernel_formulation_bit_equal_to_jax_pallas_interpret(
        M, K, N, bm, bn, bk):
    import jax.numpy as jnp
    from repro.kernels.int8_gemm.kernel import int8_gemm_pallas

    ops = _int8_operands(M, K, N)
    want = np.asarray(int8_gemm_pallas(*(jnp.asarray(a) for a in ops),
                                       block_m=bm, block_n=bn, block_k=bk,
                                       interpret=True))
    got = _kernel_formulation(*(torch.from_numpy(a) for a in ops))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_formulation_bit_equal_to_plain_at_ragged_shape():
    """M, K and N that no tile divides (the shapes the reference's Pallas
    kernel refuses): the formulation equals the plain version bit for
    bit."""
    ops = [torch.from_numpy(a) for a in _int8_operands(77, 200, 130)]
    assert torch.equal(_kernel_formulation(*ops), int8_gemm_ref(*ops))


@pytest.mark.parametrize("M,T,m_tiles", [
    (1, 32, 1), (32, 32, 1), (33, 64, 1), (64, 64, 1), (100, 128, 1),
    (128, 128, 1), (200, 256, 1), (256, 256, 1), (300, 256, 2),
])
def test_launch_shape(M, T, m_tiles):
    """The token tile of every served prefill bucket (32, 64, 128, 256),
    of ragged M between them and of M above 256; the llama2-7b lm_head's
    250 column tiles."""
    assert launch_shape(M, 32000) == (T, 250, m_tiles)
    assert launch_shape(M, 1000 + (-1000) % N_ALIGN) == (T, 8, m_tiles)


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
    (32, 4096, 32000),    # the smallest token tile
    (128, 4096, 32000),
    (200, 4096, 32000),   # a ragged token tile of 256
    (300, 512, 1000),     # two token tiles; N padded to 1008, 8 column tiles
])
def test_kernel_matches_plain(cuda, M, K, N):
    xq, wq, xs, ws = _card(M, K, N)
    before = int8_gemm.launches
    got = int8_gemm(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1 and got.shape == (M, N)
    assert torch.equal(got, int8_gemm_ref(xq, wq, xs, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [32, 256])
def test_kernel_bitwise_deterministic(cuda, M):
    ops = _card(M, 4096, 32000)
    assert torch.equal(int8_gemm(*ops), int8_gemm(*ops))
