"""tpuserve_torch: the PyTorch + CUDA port of ``tpuserve`` for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only — never JAX and never the ``tpuserve``
package, which stays beside it as the reference the port is held against.
"""
