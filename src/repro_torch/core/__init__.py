"""Core of the port: VQ weights (``vq``), matmul formulations (``ops``),
plan-once dispatch (``plan``) and the model quantization pass
(``quantize``)."""
