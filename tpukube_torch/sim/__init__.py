"""Simulated fleet around the port's extender (``SimCluster``)."""

from tpukube_torch.sim.harness import SimCluster  # noqa: F401
