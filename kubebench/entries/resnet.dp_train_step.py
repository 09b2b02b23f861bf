"""Entry ``resnet.dp_train_step``: a data-parallel gang member training the
ResNet with ``tpukube_torch.workload.resnet.make_dp_train_step`` (plain
SGD) over the world-1 mesh of its Allocate env, on a pool of image
batches made in set-up and cycled.

As the decoder's training entry: set-up drives the step through its
first steps on the pool's first batches and reports each step's loss,
each leaf's first gradient ((p0 - p1) / lr) and each leaf's change after
the set-up steps; the window times the same step on the following
batches.
"""


import torch

from kubebench import weights
from kubebench.manifest import load_part
from tpukube_torch.workload import resnet


def port_config(c: dict) -> resnet.ResNetConfig:
    # the port's stem is fixed: a 3x3 stride-1 convolution, no pooling
    if (c["stem_kernel"], c["stem_stride"], c["stem_pool"], c["norm"]) != (3, 1, "none", "group"):
        raise ValueError("the port's ResNet has a 3x3 stride-1 stem, no pool, GroupNorm")
    return resnet.ResNetConfig(
        num_classes=c["num_classes"], width=c["width"], stage_blocks=tuple(c["stage_blocks"]),
        bottleneck=c["bottleneck_expansion"] == 4, groups=c["norm_groups"],
        image_size=c["image_size"])


def run(pod) -> dict:
    t, dev, c = pod.traffic, pod.device, pod.config
    cfg = port_config(c)
    lr = t["optimizer"]["lr"]
    with load_part("entries", "_mesh").world_one(pod) as mesh:
        params = weights.resnet_params(c, pod.seed, dev)
        step = resnet.make_dp_train_step(cfg, mesh, learning_rate=lr)
        images, labels = weights.images(pod.seed, t["pool"], t["batch"], c["image_size"],
                                        c["num_classes"], dev)
        pod.mark("mesh, weights, images")
        start = {k: p.detach().clone() for k, p in weights.named(params).items()}
        losses, first = [], {}
        for i in range(t["setup_steps"]):
            params, loss = step(params, images[i], labels[i])
            losses.append(float(loss))
            with torch.no_grad():
                now = weights.named(params)
                if i == 0:
                    first = {k: float(torch.linalg.vector_norm(start[k] - p)) / lr
                             for k, p in now.items()}
                if i + 1 == t["check_steps"]:
                    change = {k: float(torch.linalg.vector_norm(p - start[k]))
                              for k, p in now.items()}
        del start
        pod.mark("set-up steps")
        pod.sync()
        train_entry = load_part("entries", "llama.train_step")
        return train_entry.window(
            pod, lambda i: step(params, images[i % t["pool"]], labels[i % t["pool"]])[1],
            {"losses": losses, "first_grad": first, "change": change})
