"""Hand-written CUDA attention kernels (``csrc/attention.cu``) with their
plain PyTorch versions; ``ops.attention`` routes between them."""
