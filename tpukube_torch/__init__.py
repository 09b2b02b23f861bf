"""tpukube on PyTorch and CUDA: the port of the JAX package ``tpukube`` to
NVIDIA Hopper GPUs. Each module mirrors one module of ``tpukube``, which
stays the reference the port is tested against; the port imports nothing
of it.

Ported so far: NVML discovery (``native``), the device manager's Allocate
env (``device``), and the in-pod workloads that consume that env
(``workload``, ``graft``): the Llama decoder served and trained dp×tp over
a ``DeviceMesh``, and the ResNet trained data-parallel.
"""
