from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_kvq,
                                                  flash_decode_kvq_paged,
                                                  flash_decode_paged)
from repro_torch.kernels.flash_decode.ref import (flash_decode_kvq_paged_ref,
                                                  flash_decode_kvq_ref,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref)
