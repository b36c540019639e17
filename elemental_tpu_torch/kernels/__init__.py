"""Hand-written Hopper kernels, each beside its plain PyTorch version
(``extend_add``: K1, the multifrontal extend-add)."""
