"""grapevine on PyTorch and CUDA: the port of ``grapevine_tpu`` to an
NVIDIA H100.

The JAX package ``grapevine_tpu`` stays the reference each module here is
held against (same inputs, same u32 words out). This package imports
``torch`` and never ``jax`` or ``grapevine_tpu``. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
