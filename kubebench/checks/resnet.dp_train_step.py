"""``correct`` for ``resnet.dp_train_step``: the reference follows the
set-up SGD steps from the same weights and images (float32, a block of
rows at a time); the pod's losses, first gradients and changes are held
against its."""

import torch

from kubebench import compare, weights
from kubebench.reference import decoder
from kubebench.reference import resnet as ref


def reference(cell, seed: int, device: torch.device, precision: str = "fp32",
              rows=None) -> dict:
    decoder.precise()
    cfg, t = cell.config, cell.traffic
    params = weights.resnet_params(cfg, seed, device)
    x, y = weights.images(seed, t["pool"], t["batch"], cfg["image_size"],
                          cfg["num_classes"], device)
    x, y = x[:t["check_steps"]], y[:t["check_steps"]]
    if rows is not None:
        x, y = x[:, :rows], y[:, :rows]
    out = ref.train_steps(params, x, y, cfg, t["optimizer"]["lr"], t["check_steps"],
                          t["check_rows_per_block"], precision)
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(
            p - weights.initial_leaf("resnet", cfg, seed, k, device)))
            for k, p in weights.named(params).items()}
    return out


def check(cell, seed: int, reports: list, device: torch.device) -> dict:
    return compare.train_readings(reports[0], reference(cell, seed, device))
