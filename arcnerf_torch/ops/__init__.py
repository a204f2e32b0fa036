"""Ops: the fused MLP (kernel A), trunc_exp and the CUDA library loader."""
