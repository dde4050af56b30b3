"""What the two EVA lookup kernels, ``fused_vq_matmul`` (B1) and
``oc_lookup`` (B5), share: their kernel body (``csrc/eva_lookup.cuh``),
its tile model and shared-memory layout (``tiles.py``) and its summation
order in plain torch (``ref.py``)."""
