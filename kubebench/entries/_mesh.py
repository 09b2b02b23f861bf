"""The world-1 process group and ``DeviceMesh`` a gang member builds from
its Allocate env (``tpukube_torch.workload.meshenv``): NCCL on the card,
gloo where the benchmark rehearses on the CPU."""

import contextlib
import socket

import torch
import torch.distributed as dist

from tpukube_torch.workload.meshenv import build_mesh, mesh_from_alloc_env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_one(pod):
    backend = "nccl" if pod.device.type == "cuda" else "gloo"
    if pod.device.type == "cuda":
        torch.cuda.set_device(pod.device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        if pod.device.type == "cuda":
            mesh, _ = mesh_from_alloc_env(world_size=1)
        else:
            mesh = build_mesh("cpu", 1, 1)
        yield mesh
    finally:
        dist.destroy_process_group()
