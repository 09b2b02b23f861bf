"""The in-pod workload of the port: the Llama decoder and the Allocate-env
consumer."""

from tpukube_torch.workload.llama import (
    Llama,
    LlamaConfig,
    forward,
    init_params,
    loss_fn,
    params_from_numpy,
)
from tpukube_torch.workload.meshenv import (
    PodGpuEnv,
    box_shape,
    device_from_alloc_env,
    mesh_axes_from_box,
)

__all__ = [
    "Llama",
    "LlamaConfig",
    "forward",
    "init_params",
    "loss_fn",
    "params_from_numpy",
    "PodGpuEnv",
    "box_shape",
    "device_from_alloc_env",
    "mesh_axes_from_box",
]
