"""The dense product's fp32 accumulator (``repro_torch/core/ops.py``,
``fp_matmul``): with lower-precision operands and an fp32 ``out_dtype``
it returns the fp32 accumulator, as the reference's
``preferred_element_type=jnp.float32`` does, never the product rounded to
the operands' dtype and cast back (off by up to 2^-9 of a logit). Held
on the CPU (the product of the upcast operands) directly, through the
planner's ``fp`` backend, the dense and tied LM heads and the VQ-Logits
head's codebook scores; on the card (marked ``cuda``, skipped here) the
``torch.mm(..., out_dtype=torch.float32)`` route against an fp64 product.

No JAX is imported: the ``cuda`` test collects on a machine without it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import logits_vq as lvq
from repro_torch.core import ops
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig
from repro_torch.models import common as cm

torch.set_num_threads(1)
SHAPES = [((4, 256), 384), ((2, 3, 128), 512), ((1, 640), 1000)]


def _operands(lead, N, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(lead, generator=gen).to(torch.bfloat16)
    w = (torch.randn((lead[-1], N), generator=gen) / 8).to(torch.bfloat16)
    return x.to(device), w.to(device)


def _fp32_product(x, w):
    return torch.matmul(x.float(), w.float())


def _assert_accumulator(y, x, w):
    """``y`` is the fp32 product of the bf16 values within 1e-6 of its
    largest value (summation order aside), where the bf16-rounded product
    is not."""
    want = _fp32_product(x, w)
    tol = 1e-6 * want.abs().max().item()
    assert y.dtype == torch.float32 and y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=tol)
    rounded = torch.matmul(x, w).float()
    assert (rounded - want).abs().max().item() > 100 * tol


@pytest.mark.parametrize("lead,N", SHAPES)
def test_fp_matmul_returns_the_fp32_accumulator(lead, N):
    x, w = _operands(lead, N, seed=N)
    _assert_accumulator(ops.fp_matmul(x, w, out_dtype=torch.float32), x, w)
    # other dtypes: torch.matmul cast as asked
    assert torch.equal(ops.fp_matmul(x, w), torch.matmul(x, w))
    xf, wf = x.float(), w.float()
    assert torch.equal(ops.fp_matmul(xf, wf), torch.matmul(xf, wf))


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_planner_fp_backend_and_lm_head_return_fp32(mode):
    """A dense bf16 head (the served ``lm_head``) through
    ``models.common.lm_head``, the planner's ``fp`` backend, in both
    modes; and the tied head through the embedding's transpose."""
    x, w = _operands((2, 1, 256), 640, seed=3)
    rc = RunConfig(mode=mode)
    _assert_accumulator(cm.lm_head({"w": w}, x, rc), x, w)
    tied = cm.lm_head(None, x, rc, emb_params={"emb": w.t().contiguous()})
    _assert_accumulator(tied, x, w)


def test_vq_logits_head_scores_in_fp32():
    """The VQ-Logits head's codebook scores (the gather backend) and its
    expansion (the dequant backend) from bf16 activations: the fp32
    product of the bf16 values, gathered and scaled."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 1, 128), generator=gen).to(torch.bfloat16)
    head = lvq.fit_logits_vq(gen, torch.randn((128, 700), generator=gen),
                             64, iters=2)
    head = lvq.VQLogitsHead(head.codebook.to(torch.bfloat16), head.assign,
                            head.scale)
    want = torch.index_select(_fp32_product(x, head.codebook), -1,
                              head.assign) * head.scale.float()
    for vq_mode in ("eva", "dequant"):
        rc = RunConfig(mode="decode",
                       plan_policy=PlanPolicy(vq_mode=vq_mode))
        got = cm.lm_head({"vql": head}, x, rc)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("lead,N", SHAPES + [((4, 2560), 256000)])
def test_cuda_route_returns_the_fp32_accumulator(lead, N):
    """On the card: ``torch.mm`` with an fp32 ``out_dtype`` over the 2-D
    view of x, against the fp64 product of the same bf16 values within
    1e-5 of its largest value (fp32 sums in cuBLAS's order), where the
    bf16-rounded product is off by more than 1e-4 of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = _operands(lead, N, seed=N, device="cuda")
    y = ops.fp_matmul(x, w, out_dtype=torch.float32)
    want = torch.matmul(x.double(), w.double())
    top = want.abs().max().item()
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert (y.double() - want).abs().max().item() <= 1e-5 * top
    rounded = torch.matmul(x, w).double()
    assert (rounded - want).abs().max().item() > 1e-4 * top
