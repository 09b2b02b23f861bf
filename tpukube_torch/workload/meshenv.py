"""Allocate env → CUDA device and ``DeviceMesh`` — the port of
``tpukube/workload/meshenv.py``.

The node agent injects ``CUDA_VISIBLE_DEVICES`` (+ ``CUDA_DEVICE_ORDER``),
``TPU_KUBE_CHIP_COORDS`` / ``TPU_KUBE_MESH_DIMS`` / ``TPU_HBM_LIMIT_BYTES``
at Allocate (:mod:`tpukube_torch.device.gpu`), and the extender the
``TPU_KUBE_GANG_*`` keys of a DCN-spanning gang; this module is the
consumer side inside the pod. Where the reference arranges
``jax.devices()`` into a ``Mesh``, the port arranges the ranks of the
default process group into a ``DeviceMesh``: rank r is the r-th device of
the reference's list. The mesh's device type follows the process group's
backend (NCCL → ``cuda``, gloo → ``cpu``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpukube_torch.device.gpu import (
    DEVICE_ORDER,
    ENV_DEVICE_ORDER,
    ENV_GANG_NUM_SLICES,
    ENV_GANG_SLICE_INDEX,
    ENV_GANG_SLICES,
    ENV_HBM_LIMIT,
    ENV_KUBE_CHIP_COORDS,
    ENV_KUBE_DEVICE_IDS,
    ENV_KUBE_HOST,
    ENV_KUBE_MESH_DIMS,
    ENV_KUBE_SLICE,
    ENV_KUBE_TENANT,
    ENV_VISIBLE_DEVICES,
)


@dataclass(frozen=True)
class PodGpuEnv:
    """The Allocate contract as seen from inside the container."""

    visible_chips: tuple[int, ...]
    device_ids: tuple[str, ...]
    coords: tuple[tuple[int, int, int], ...]
    mesh_dims: tuple[int, int, int]
    host: str
    hbm_limit_bytes: int
    slice_id: str = ""
    # serving-plane tenant this allocation is accounted to ("" without
    # tenancy)
    tenant: str = ""
    # DCN-spanning gang context: how many slices the gang covers and which
    # one this pod is in. 1/0 for single-slice gangs.
    gang_num_slices: int = 1
    gang_slice_index: int = 0
    gang_slices: tuple[str, ...] = ()

    @property
    def spans_dcn(self) -> bool:
        return self.gang_num_slices > 1

    @staticmethod
    def from_env(env: Optional[Mapping[str, str]] = None) -> "PodGpuEnv":
        e = os.environ if env is None else env
        try:
            coords = tuple(
                tuple(int(v) for v in part.split(","))
                for part in e[ENV_KUBE_CHIP_COORDS].split(";")
            )
            gang_slices = tuple(
                s for s in e.get(ENV_GANG_SLICES, "").split(",") if s
            )
            return PodGpuEnv(
                visible_chips=tuple(
                    int(v) for v in e[ENV_VISIBLE_DEVICES].split(",")
                ),
                device_ids=tuple(e[ENV_KUBE_DEVICE_IDS].split(",")),
                coords=coords,  # type: ignore[arg-type]
                mesh_dims=tuple(int(v) for v in e[ENV_KUBE_MESH_DIMS].split(",")),  # type: ignore[arg-type]
                host=e.get(ENV_KUBE_HOST, ""),
                hbm_limit_bytes=int(e.get(ENV_HBM_LIMIT, "0")),
                slice_id=e.get(ENV_KUBE_SLICE, ""),
                tenant=e.get(ENV_KUBE_TENANT, ""),
                gang_num_slices=int(e.get(ENV_GANG_NUM_SLICES, "1")),
                gang_slice_index=int(e.get(ENV_GANG_SLICE_INDEX, "0")),
                gang_slices=gang_slices,
            )
        except KeyError as k:
            raise RuntimeError(
                f"not running under a tpukube allocation: missing env {k}"
            ) from k


def box_shape(coords: Sequence[tuple[int, int, int]]) -> tuple[int, int, int]:
    """Bounding-box shape of a coord set; raises if the set is not exactly a
    full axis-aligned box."""
    xs, ys, zs = ({c[a] for c in coords} for a in range(3))
    shape = (len(xs), len(ys), len(zs))
    n = shape[0] * shape[1] * shape[2]
    if n != len(set(coords)):
        raise ValueError(f"coords are not a full box: {sorted(coords)}")
    for vals in (xs, ys, zs):
        lo, hi = min(vals), max(vals)
        if hi - lo + 1 != len(vals):
            raise ValueError(f"coords are not contiguous: {sorted(coords)}")
    return shape


def mesh_axes_from_box(
    shape: tuple[int, int, int], tp: Optional[int] = None
) -> tuple[int, int]:
    """Map a physical box shape to logical (dp, tp) sizes: tp takes the
    largest box axis unless pinned; dp takes the rest."""
    n = shape[0] * shape[1] * shape[2]
    if tp is None:
        tp = max(shape)
    if tp <= 0 or n % tp:
        raise ValueError(f"tp={tp} does not divide {n} chips")
    return n // tp, tp


def device_from_alloc_env(env: Optional[Mapping[str, str]] = None) -> torch.device:
    """The GPU this process was allocated, as ``cuda:0``.

    Checks that the process sees exactly the allocated GPUs, in NVML's
    order: CUDA reads ``CUDA_VISIBLE_DEVICES`` and ``CUDA_DEVICE_ORDER``
    from the process environment, so those must carry the allocation's
    values, and CUDA must count as many devices as were allocated."""
    e = os.environ if env is None else env
    pe = PodGpuEnv.from_env(e)
    for key in (ENV_VISIBLE_DEVICES, ENV_DEVICE_ORDER):
        if os.environ.get(key) != e.get(key):
            raise RuntimeError(
                f"process env {key}={os.environ.get(key)!r} is not the "
                f"allocation's {e.get(key)!r}"
            )
    if e.get(ENV_DEVICE_ORDER) != DEVICE_ORDER:
        raise RuntimeError(
            f"{ENV_DEVICE_ORDER} must be {DEVICE_ORDER} so CUDA's order is NVML's"
        )
    if not torch.cuda.is_available():
        raise RuntimeError("allocated GPUs but CUDA is not available")
    n = torch.cuda.device_count()
    if n != len(pe.visible_chips):
        raise RuntimeError(
            f"CUDA sees {n} devices, the allocation has {len(pe.visible_chips)}"
        )
    return torch.device("cuda:0")


def build_mesh(device_type: str, dp: int, tp: int) -> DeviceMesh:
    """The default group's ranks as a ``DeviceMesh(("dp", "tp"))``, tp
    fastest. Collective: every rank calls it."""
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def build_multislice_mesh(device_type: str, num_slices: int, dp: int,
                          tp: int) -> DeviceMesh:
    """``DeviceMesh(("dcn", "dp", "tp"))`` for a DCN-spanning gang, ranks
    slice-major: shard only the batch over ``dcn``. Collective."""
    return init_device_mesh(device_type, (num_slices, dp, tp),
                            mesh_dim_names=("dcn", "dp", "tp"))


def mesh_shape_from_alloc_env(
    env: Optional[Mapping[str, str]], world_size: int, tp: Optional[int] = None,
) -> tuple[tuple[str, ...], tuple[int, ...], PodGpuEnv]:
    """The reference's ``mesh_from_alloc_env`` policy, without building
    anything: -> (axis names, axis sizes, PodGpuEnv) for ``world_size``
    ranks.

    A DCN-spanning gang gets ("dcn", "dp", "tp") with one ``dcn`` entry per
    slice, and the ranks must split evenly over the slices. Otherwise the
    gang's box gives (dp, tp); where fewer ranks run than the box has
    chips (a dry run), the mesh folds onto the ranks, and a pinned ``tp``
    must divide them."""
    pe = PodGpuEnv.from_env(env)
    if pe.spans_dcn:
        ns = pe.gang_num_slices
        if world_size % ns:
            raise ValueError(
                f"{world_size} devices do not divide over {ns} slices; a DCN "
                f"mesh needs equal per-slice device counts"
            )
        dp, tp_ = mesh_axes_from_box((world_size // ns, 1, 1), tp)
        return ("dcn", "dp", "tp"), (ns, dp, tp_), pe
    shape = box_shape(pe.coords)
    if world_size < shape[0] * shape[1] * shape[2]:
        dp, tp_ = mesh_axes_from_box((world_size, 1, 1), tp)
    else:
        dp, tp_ = mesh_axes_from_box(shape, tp)
    return ("dp", "tp"), (dp, tp_), pe


def mesh_from_alloc_env(env: Optional[Mapping[str, str]] = None,
                        world_size: Optional[int] = None,
                        tp: Optional[int] = None) -> tuple[DeviceMesh, PodGpuEnv]:
    """One-call consumer: env → (DeviceMesh, PodGpuEnv) over the default
    process group (``world_size`` defaults to its size). Collective."""
    if world_size is None:
        world_size = dist.get_world_size()
    names, sizes, pe = mesh_shape_from_alloc_env(env, world_size, tp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    return mesh, pe


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the CPU, or its current GPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group of ranks that split the batch: ``dp``, or ``("dcn",
    "dp")`` on a multislice mesh, built with ``dist.new_group`` for each tp
    index (every rank creates every group, in the same order). A rank's
    index in the batch is its rank in this group."""
    if "dcn" not in mesh.mesh_dim_names:
        return mesh.get_group("dp")
    ranks = mesh.mesh
    mine = None
    for t in range(ranks.shape[-1]):
        members = ranks[..., t].flatten().tolist()
        group = dist.new_group(members)
        if dist.get_rank() in members:
            mine = group
    return mine
