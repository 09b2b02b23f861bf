"""The in-pod workload of the port: the Llama decoder, its dp×tp training
step and collectives, the ResNet, and the Allocate-env consumer."""

from tpukube_torch.workload import resnet, tp, train
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
    build_mesh,
    build_multislice_mesh,
    device_from_alloc_env,
    mesh_axes_from_box,
    mesh_from_alloc_env,
)
from tpukube_torch.workload.train import init_sharded, make_train_step

__all__ = [
    "Llama",
    "LlamaConfig",
    "forward",
    "init_params",
    "loss_fn",
    "params_from_numpy",
    "PodGpuEnv",
    "box_shape",
    "build_mesh",
    "build_multislice_mesh",
    "device_from_alloc_env",
    "mesh_axes_from_box",
    "mesh_from_alloc_env",
    "init_sharded",
    "make_train_step",
    "resnet",
    "tp",
    "train",
]
