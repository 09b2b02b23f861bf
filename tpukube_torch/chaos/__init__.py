"""The control-plane chaos package — for now only the two convergence
checks the kilonode drives raise on (``leaked_reservations``,
``ledger_divergence``), the port's own copies of
``tpukube/chaos/cluster.py``'s. They inject no fault.

The fault injectors (``ChaosApiServer``, ``FaultSchedule``, crash and
maintenance schedules), ``ChaosSimCluster``, ``converge`` and
``replica_crash_recover`` are not ported yet: they come with the chaos
scenarios (ROADMAP.md Queue 1).
"""

from tpukube_torch.chaos.cluster import leaked_reservations, ledger_divergence

__all__ = ["leaked_reservations", "ledger_divergence"]
