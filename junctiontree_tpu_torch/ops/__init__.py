"""Contraction ops: the planned einsum (``semirings``) and the factored
big-clique contraction with its CUDA kernel (``factored_contract``)."""
