from repro_torch.kernels.vq_gemm.ops import vq_gemm
from repro_torch.kernels.vq_gemm.ref import vq_gemm_ref
