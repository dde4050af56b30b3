"""Port of the flash-decode kernel: the plain PyTorch version against the
JAX wrapper in Pallas interpret mode (CPU), and the CUDA kernel against
the plain version on the card.

Tolerance: fp32 rtol=1e-5, atol=1e-5 — the online softmax folds the
cache in blocks where the plain version normalizes once, which
reassociates the sums over S. On the card, fp32 caches are held to
1e-5 and bf16 caches to 2^-7 * max|o| (one bf16 rounding of the output
on either side)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref

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


def test_4d_query_and_no_launch_on_cpu():
    q, k, v, lens = _inputs(2, 16, 4, 2, 8, [3, 16])
    before = flash_decode.launches
    got = flash_decode(torch.from_numpy(q)[:, None], torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(lens))
    assert got.shape == (2, 1, 4, 8)
    assert flash_decode.launches == before


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
def test_kernel_bitwise_deterministic(cuda):
    q, k, v, lens = _card(4, 512, 32, 32, 128, [1, 512, 77, 300],
                          torch.bfloat16)
    assert torch.equal(flash_decode(q, k, v, lens), flash_decode(q, k, v, lens))
