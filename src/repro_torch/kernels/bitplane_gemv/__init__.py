"""Bit-plane GeMV: B1 gemv_bs, B3 gemv_f (kernel.py) and B2 program_gemv
(program.py), their plain versions (ref.py) and entry points (ops.py)."""
