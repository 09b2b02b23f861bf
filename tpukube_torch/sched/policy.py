"""Priority preemption — the port's own copy of ``tpukube/sched/policy.py``.

BASELINE config 5's scenario: a cluster running low-priority burst
inference pods must yield a CONTIGUOUS slice when a high-priority training
gang arrives. Evicting the right victims to open a contiguous box is
NP-flavored (SURVEY.md §9.3); this is the bounded exact-sweep heuristic:

  1. Victim granularity is a WORKLOAD: a non-gang pod, or an entire gang
     (members + reservation). Gangs are all-or-nothing in death as in
     birth — evicting individual members would strand the rest on a
     broken slice and hand their chips back to the gang's own reservation.
  2. Build a "blocked" grid: unhealthy chips plus every chip of workloads
     whose priority >= the preemptor's. These can never be taken.
  3. Sweep every candidate box of the needed volume/shape over that grid
     (the slicefit summed-area machinery, so the sweep is O(mesh)).
  4. Cost of a box = (sum of victim workload priorities, victim count,
     box surface, -contact): prefer cheap evictions, then few, then a
     compact snug box. Deterministic tie-break on origin.

The extender applies the winning plan in TWO PHASES: at /filter it only
records the victims on the gang's reservation; at the gang's first /bind
it executes them — non-gang victims released and queued for eviction,
gang victims dissolved wholesale. A planned-but-never-bound gang (crash,
higher-priority queue churn) therefore costs no victim its chips: the TTL
sweep drops the reservation and the victims were never touched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import DEFAULT_SLICE, TopologyCoord
from tpukube_torch.sched import slicefit
from tpukube_torch.sched.snapshot import sweep_for


@dataclass(frozen=True)
class Workload:
    """Unit of preemption: one pod, or one whole gang."""

    id: str                      # pod_key, or "gang:<ns>/<name>"
    priority: int                # blocking priority (max member priority)
    cost: int                    # eviction cost (sum of member priorities)
    coords: frozenset[TopologyCoord]  # every chip it holds (gangs include
                                      # their unassigned reserved chips);
                                      # coords are local to slice_id
    pod_keys: tuple[str, ...] = ()
    gang_key: Optional[tuple[str, str]] = None
    slice_id: str = DEFAULT_SLICE  # the ICI domain the chips live in
    tenant: str = ""  # serving-plane owner ("" when tenancy is off)


@dataclass(frozen=True)
class PreemptionPlan:
    coords: list[TopologyCoord]   # the box the gang will take
    victims: list[Workload]       # workloads to evict, deterministic order
    cost_priority_sum: int
    victim_count: int


def find_preemption_plan(
    workloads: list[Workload],
    mesh: MeshSpec,
    unhealthy: set[TopologyCoord],
    total: int,
    shape: Optional[tuple[int, int, int]],
    preemptor_priority: int,
    broken: Optional[set] = None,
    overshare: Optional[dict[str, float]] = None,
) -> Optional[PreemptionPlan]:
    """Cheapest victim set whose eviction opens a contiguous `total`-chip
    box (or the exact `shape`). None when no eligible box exists. Boxes
    spanning a downed ICI link are never candidates — evicting pods cannot
    repair a link, so such a box would be a degraded slice.

    ``overshare`` (the tenancy plane's tenant -> over-entitlement map)
    biases victim choice: at equal priority cost, the box whose victims
    belong to the MOST over-share tenants wins — the lowest-share
    preemptor takes chips back from whoever is furthest over. None (the
    default, and every tenancy-off call) contributes a constant 0.0 to
    the ranking, leaving the ranking without it bit-identical."""
    # A chip may host several workloads (fractional vTPU co-tenants): all
    # of them must be evicted to free it, so the owner map is coord->list.
    owner: dict[TopologyCoord, list[Workload]] = {}
    blocked = set(unhealthy)
    for w in workloads:
        for c in w.coords:
            owner.setdefault(c, []).append(w)
        if w.priority >= preemptor_priority:
            blocked |= w.coords

    # Sweep candidate boxes over a grid where only BLOCKED chips count as
    # occupied — victims' chips look free because evicting them is the
    # plan. The grid is REQUEST-specific (depends on the preemptor's
    # priority), so it rides an ad-hoc sweep built through the snapshot
    # module's constructor seam; origin enumeration and contact scoring
    # still come batched per shape tier from the vectorized sweep.
    candidates = slicefit.iter_free_boxes_in(
        sweep_for(mesh, blocked),
        count=total if shape is None else None,
        shape=shape,
        broken=broken,
    )

    over = overshare or {}
    best: Optional[tuple] = None  # (key, cost, coords, victims)
    for sb in candidates:
        coords = slicefit.box_coords(mesh, sb.box)
        victims = {
            w.id: w for c in coords for w in owner.get(c, ())
        }
        cost = sum(w.cost for w in victims.values())
        # tenant bias: rounded once so float noise can never reorder
        # plans; exactly 0.0 for every box when tenancy is off
        bias = round(
            sum(over.get(w.tenant, 0.0) for w in victims.values()), 9
        )
        key = (
            cost,
            -bias,  # more over-share victims = preferred at equal cost
            len(victims),
            sb.surface,
            sb.contact,  # already negated: lower = snugger
            sb.origin_key,
        )
        if best is None or key < best[0]:
            best = (key, cost, coords,
                    [victims[i] for i in sorted(victims)])
    if best is None:
        return None
    _, cost, coords, victims = best
    return PreemptionPlan(
        coords=coords,
        victims=victims,
        cost_priority_sum=cost,
        victim_count=len(victims),
    )
