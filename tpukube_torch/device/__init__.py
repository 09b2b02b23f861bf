"""Device abstraction (L2): GPU discovery, device minting, allocation env."""

from tpukube_torch.device.gpu import DeviceError, GpuDeviceManager  # noqa: F401
