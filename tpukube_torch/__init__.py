"""tpukube on PyTorch and CUDA: the port of the JAX package ``tpukube`` to
NVIDIA Hopper GPUs. Each module mirrors one module of ``tpukube``, which
stays the reference the port is tested against; the port imports nothing
of it.

This slice: NVML discovery (``native``), the device manager's Allocate env
(``device``), and the in-pod Llama forward pass that consumes that env
(``workload``, ``graft``).
"""
