from repro_torch.kernels.oc_lookup.ops import eva_split_matmul, oc_lookup
from repro_torch.kernels.oc_lookup.ref import oc_lookup_ref
