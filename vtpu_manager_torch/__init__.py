"""vtpu-manager's tenant side on PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX one (`vtpu_manager/`), laid out like it:
`workloads/` holds the tenant workloads and the hand-written block-attention
kernel, `runtime/` the tenant's view of its limits, and `csrc/shim/` the
CUDA driver-API interposer that enforces a compute-% and a memory cap
inside the tenant process. Entry points run on the card unless the caller
asks for the CPU. Nothing here imports JAX or the JAX package.
"""
