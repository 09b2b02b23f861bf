"""Native bindings (L1): ctypes wrapper over libgpuinfo.so."""

from tpukube_torch.native.gpuinfo import GpuInfo, GpuInfoError, sim_spec  # noqa: F401
