"""Hand-written CUDA kernels (``csrc/attention.cu``, ``csrc/ssd.cu``,
``csrc/uts.cu``) with their plain PyTorch versions; ``ops`` routes
between them."""
