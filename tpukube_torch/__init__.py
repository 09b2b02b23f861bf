"""tpukube on PyTorch and CUDA: the port of the JAX package ``tpukube`` to
NVIDIA Hopper GPUs. Each module mirrors one module of ``tpukube``, which
stays the reference the port is tested against; the port imports nothing
of it.

Ported so far: NVML discovery, XID health and telemetry, and the CUDA
driver quota guard (``native``, ``obs``), the device manager's Allocate env
for whole GPUs and vGPU shares (``device``), and the in-pod workloads that
consume that env (``workload``, ``graft``): the Llama decoder served and
trained dp×tp over a ``DeviceMesh``, the ResNet trained data-parallel, and
two serving pods sharing one GPU under their quotas; the scheduler
extender that places pods and gangs before they are allocated, with its
whole HTTP surface, the Kubernetes REST channel and its loops, and the
batch cycle (``sched``, ``sim``, ``apiserver``: host code, no torch); the
daemons and tools as users start them (``python -m tpukube_torch.cli
plugin|syncer|extender|sim|ctl|obs``); and the lint prover over the
port's own tree with the lock-order monitor (``analysis``, ``python -m
tpukube_torch.analysis``). Every module of ``tpukube`` has its port.
"""
