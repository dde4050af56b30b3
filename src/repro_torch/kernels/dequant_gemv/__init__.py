from repro_torch.kernels.dequant_gemv.ops import dequant_gemv
from repro_torch.kernels.dequant_gemv.ref import dequant_gemv_ref
from repro_torch.kernels.dequant_gemv.ref import dequant_gemv_split_ref
