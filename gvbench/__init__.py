"""The benchmark of ``grapevine_tpu_torch`` on an NVIDIA H100 (``gvbench/README.md``)."""
