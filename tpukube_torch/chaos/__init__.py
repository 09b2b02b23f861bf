"""The control-plane chaos harness — the port's own copy of
``tpukube/chaos/``.

Deterministic, seeded fault injection for the apiserver seams: API errors
(injected 503s, transport timeouts, 410 Gone resyncs), dropped/duplicated
watch events, torn writes (the write lands, the response is lost), slow
responses, and process "crashes" (extender teardown + restart mid-gang,
via the chaos cluster's crash/restart helpers and ``CrashSchedule``'s
journal mutilations).

The schedule draws every fault decision from one seeded RNG in call
order, so a scenario replays the same fault sequence for the same seed,
on either package. Scenarios 8, 9 and 13 drive this end to end and
assert the recovery invariants: zero leaked gang reservations and zero
ledger/apiserver divergence after the dust settles. The maintenance and
spot-churn schedules (``chaos/maintenance.py``) take capacity out of a
live fleet in scenario 15.

Sharded-plane chaos: on a ``planner_replicas > 1`` cluster,
``replica_crash_recover`` kills ONE planner replica mid-flight — e.g.
mid-gang-commit of a two-phase DCN rendezvous — drives the router's
all-or-nothing abort, restarts the replica, and reports the zero-leak
convergence; ``SimCluster.partition_replica``/``heal_replica`` cover the
partition half.
"""

from tpukube_torch.apiserver import transient_api_error
from tpukube_torch.chaos.api import ChaosApiServer
from tpukube_torch.chaos.cluster import (
    ChaosSimCluster,
    converge,
    leaked_reservations,
    ledger_divergence,
    replica_crash_recover,
)
from tpukube_torch.chaos.crash import CrashSchedule
from tpukube_torch.chaos.maintenance import (
    MaintenanceSchedule,
    SpotChurnSchedule,
)
from tpukube_torch.chaos.schedule import ChaosSpec, FaultSchedule

__all__ = [
    "ChaosApiServer",
    "ChaosSimCluster",
    "ChaosSpec",
    "CrashSchedule",
    "FaultSchedule",
    "MaintenanceSchedule",
    "SpotChurnSchedule",
    "converge",
    "leaked_reservations",
    "ledger_divergence",
    "replica_crash_recover",
    "transient_api_error",
]
