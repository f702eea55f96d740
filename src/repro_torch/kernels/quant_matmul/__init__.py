"""Fused-dequant matmul, the processor-side baseline: B5 quant_matmul
(kernel.py), its plain version (ref.py) and entry points (ops.py)."""
