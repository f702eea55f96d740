"""Flash-decode attention: B4 decode_attention (kernel.py), its plain
version (ref.py) and entry point (ops.py)."""
