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

Not ported yet: ``replica_crash_recover`` (the shard router, ROADMAP
Queue 1 item 5).
"""

from tpukube_torch.apiserver import transient_api_error
from tpukube_torch.chaos.api import ChaosApiServer
from tpukube_torch.chaos.cluster import (
    ChaosSimCluster,
    converge,
    leaked_reservations,
    ledger_divergence,
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
    "transient_api_error",
]
