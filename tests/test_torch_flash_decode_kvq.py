"""Port of the KV-VQ flash-decode kernel: the wrapper's plain version
(the dequantize oracle) against the JAX wrapper in Pallas interpret mode
(CPU); the kernel's own formulation — scores gathered from the query /
K-codebook table the wrapper builds, V rebuilt from codebook rows after
the softmax, over the reference's padded cache — against the same; and
the CUDA kernel against the plain version on the card.

Tolerance: fp32 rtol=1e-5, atol=1e-5 — the Pallas kernel folds the cache
in blocks with an online softmax and sums the gathered table entries in
its own order, which reassociates the sums. On the card, fp32 outputs are
held to 1e-5 * max|o| and bf16 outputs to 2^-7 * max|o| (one bf16
rounding of the output on either side)."""
import numpy as np
import pytest
import torch

from repro_torch.core.vq import KVQuantConfig, kv_grid_codebooks
from repro_torch.kernels.flash_decode import (flash_decode_kvq,
                                              flash_decode_kvq_ref)
from repro_torch.kernels.flash_decode.ops import kvq_operands, kvq_padded_len

torch.set_num_threads(1)


def _inputs(B, S, H, Hk, hd, lengths, kv_bits, residual, seed=0):
    """Random indices, positive scales, random (not grid) K and V
    codebooks, so every index and codebook coordinate matters."""
    rng = np.random.default_rng(seed)
    kvq = KVQuantConfig(kv_bits=kv_bits, residual=residual)
    RG, vd = kvq.idx_width(hd), kvq.vec_d
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k_idx = rng.integers(0, 256, (B, S, Hk, RG)).astype(np.uint8)
    v_idx = rng.integers(0, 256, (B, S, Hk, RG)).astype(np.uint8)
    k_s = rng.uniform(0.5, 2.0, (B, S, Hk)).astype(np.float32)
    v_s = rng.uniform(0.5, 2.0, (B, S, Hk)).astype(np.float32)
    cb_k = rng.standard_normal((Hk, residual, 256, vd)).astype(np.float32)
    cb_v = rng.standard_normal((Hk, residual, 256, vd)).astype(np.float32)
    return (q, k_idx, v_idx, k_s, v_s, np.asarray(lengths, np.int32), cb_k,
            cb_v)


def _jax_wrapper(args, **kw):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_kvq as jax_kvq

    return np.asarray(jax_kvq(*(jnp.asarray(a) for a in args), interpret=True,
                              **kw))


def _kernel_formulation(q, k_idx, v_idx, k_s, v_s, lengths, cb_k, cb_v):
    """What csrc/flash_decode_kvq.cu computes, in plain torch over the
    wrapper's operands: score = k_s * sum_j qd[j, k_idx[j]], vhat[c] =
    v_s * sum_r cb_v[r, v_idx[r*G + c//vd], c % vd], padded positions
    holding zero indices and scales, masked softmax over S_pad."""
    qd, ks, vs, cbv = kvq_operands(q, k_s, v_s, cb_k, cb_v)
    B, S, Hk, RG = k_idx.shape
    g, R, vd = qd.shape[2], cbv.shape[1], cbv.shape[3]
    GR, hd = RG // R, q.shape[-1]
    pad = kvq_padded_len(S) - S
    kidx = torch.nn.functional.pad(k_idx.long(), (0, 0, 0, 0, 0, pad))
    vidx = torch.nn.functional.pad(v_idx.long(), (0, 0, 0, 0, 0, pad))
    ks = torch.nn.functional.pad(ks, (0, 0, 0, pad))
    vs = torch.nn.functional.pad(vs, (0, 0, 0, pad))
    Sp = S + pad
    ki = kidx.permute(0, 2, 3, 1)[:, :, None].expand(B, Hk, g, RG, Sp)
    s = qd.gather(-1, ki).sum(dim=3) * ks.permute(0, 2, 1)[:, :, None]
    valid = torch.arange(Sp)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)                       # (B, Hk, g, Sp)
    c = torch.arange(hd)
    heads = torch.arange(Hk)[None, None, :, None]
    rows = sum(cbv[:, r][heads, vidx[..., r * GR + c // vd], c % vd]
               for r in range(R))                      # (B, Sp, Hk, hd)
    vhat = rows * vs[..., None]
    o = torch.einsum("bkgs,bskd->bkgd", p, vhat)
    return o.reshape(B, Hk * g, hd).to(q.dtype)


CASES = [  # B, S, H, Hk, hd, lengths, kv_bits, residual
    (2, 24, 4, 4, 32, [24, 7], 4, 1),       # llama2 SMOKE heads
    (3, 40, 8, 2, 32, [1, 40, 17], 4, 1),   # GQA g=4, masked tail
    (2, 40, 6, 1, 64, [33, 40], 2, 1),      # MQA, 2-bit
    (2, 24, 4, 2, 32, [24, 5], 4, 2),       # two residual stages
]


@pytest.mark.parametrize("B,S,H,Hk,hd,lengths,kv_bits,residual", CASES)
def test_plain_matches_jax_pallas_interpret(B, S, H, Hk, hd, lengths,
                                            kv_bits, residual):
    args = _inputs(B, S, H, Hk, hd, lengths, kv_bits, residual)
    want = _jax_wrapper(args, block_s=16)   # three S-blocks, padded tail
    got = flash_decode_kvq(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,Hk,hd,lengths,kv_bits,residual", CASES + [
    (3, 520, 2, 1, 32, [0, 520, 9], 4, 1),  # padded to 1024; an empty row
])
def test_kernel_formulation_matches_jax_pallas_interpret(
        B, S, H, Hk, hd, lengths, kv_bits, residual):
    args = _inputs(B, S, H, Hk, hd, lengths, kv_bits, residual, seed=1)
    want = _jax_wrapper(args)               # the default 512-position block
    got = _kernel_formulation(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_operands_and_no_launch_on_cpu():
    args = [torch.from_numpy(a) for a in
            _inputs(2, 16, 4, 2, 32, [3, 16], 4, 2)]
    qd, ks, vs, cbv = kvq_operands(args[0], args[3].bfloat16(), args[4],
                                   args[6], args[7])
    assert qd.shape == (2, 2, 2, 16, 256) and qd.is_contiguous()
    assert ks.dtype == vs.dtype == cbv.dtype == torch.float32
    assert [kvq_padded_len(s) for s in (16, 512, 513, 1100)] == \
        [16, 512, 1024, 1536]
    before = flash_decode_kvq.launches
    got = flash_decode_kvq(args[0][:, None], *args[1:])
    assert got.shape == (2, 1, 4, 32)
    assert flash_decode_kvq.launches == before


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(B, S, H, Hk, hd, lengths, kv_bits, residual, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kvq = KVQuantConfig(kv_bits=kv_bits, residual=residual)
    RG = kvq.idx_width(hd)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dtype)
    idx = lambda: torch.randint(0, 256, (B, S, Hk, RG), generator=g,
                                device="cuda", dtype=torch.uint8)
    scale = lambda: (torch.rand((B, S, Hk), generator=g, device="cuda")
                     + 0.5).bfloat16()
    cb = kv_grid_codebooks(Hk, hd, kvq, device="cuda")
    return (q, idx(), idx(), scale(), scale(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), cb, cb)


def _tol(want):
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, want.float().abs().max().item())
    return 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hk,hd,lengths,kv_bits,residual", [
    (4, 512, 32, 32, 128, [1, 512, 200, 64], 4, 1),  # llama2-7b decode
    (4, 512, 32, 32, 128, [1, 512, 200, 64], 2, 1),
    (3, 300, 32, 8, 128, [300, 5, 150], 4, 1),   # g=4: qd read through L2
    (2, 70, 16, 2, 64, [70, 33], 4, 2),          # g=8, two stages
    (2, 600, 4, 4, 32, [0, 600], 2, 1),          # empty row over padding
])
def test_kernel_matches_plain(cuda, B, S, H, Hk, hd, lengths, kv_bits,
                              residual, dtype):
    args = _card(B, S, H, Hk, hd, lengths, kv_bits, residual, dtype)
    before = flash_decode_kvq.launches
    got = flash_decode_kvq(*args)
    torch.cuda.synchronize()
    assert flash_decode_kvq.launches == before + 1
    if lengths[0] == 0:  # the reference averages V over the padded cache
        want = _kernel_formulation(*(a.cpu() for a in args)).to(got.device)
    else:
        want = flash_decode_kvq_ref(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
def test_kernel_bitwise_deterministic(cuda):
    args = _card(4, 512, 32, 32, 128, [1, 512, 77, 300], 4, 1,
                 torch.bfloat16)
    assert torch.equal(flash_decode_kvq(*args), flash_decode_kvq(*args))
