"""repro_torch — the serving engine of ``repro`` in PyTorch, with the
attention kernels hand-written in CUDA C++ for Hopper (sm_90a).

Module names follow ``repro``'s so each module's counterpart is easy to
find. The package imports torch and numpy only; it shares no code with
the JAX package. Entry points (``models.init_lm``, ``serve.Engine``,
``weights.params_from_jax``) place their tensors on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
