from repro_torch.kernels.int8_gemm.ops import int8_gemm, int8_matmul_kernel
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref
