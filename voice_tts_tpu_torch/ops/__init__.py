"""Hand-written CUDA kernels (K1 fused decode step, K2 anti-aliased snake,
K4 int8 GEMV), each beside its plain PyTorch version."""
