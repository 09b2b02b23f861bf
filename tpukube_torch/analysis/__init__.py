"""tpukube-lint — lock-discipline static analysis + runtime race detection.

The control plane is a genuinely concurrent system: RLock-guarded
ledger/gang/extender state mutated from ~10 daemon threads, with the
standing invariant that emitters only ENQUEUE and never do I/O under the
scheduling locks. Nothing used to enforce any of that — one careless
``with self._lock:`` block that writes a file, or that acquires locks in
the wrong order, silently reintroduces the stalled-disk/deadlock bug
class the sink/drain and two-phase-preemption work engineered out. This
package is the enforcement, in the spirit of lockdep and the Go race
detector: machine-checked concurrency discipline, run by the tier-1
tests over the port's own tree and exposed as
``python -m tpukube_torch.analysis``.

Static passes (AST-based, see the per-module docstrings):

  lock-discipline   no blocking I/O lexically inside the scheduling
                    locks of gang.py / extender.py / state.py
  lock-order        lock acquisitions against the declared partial
                    order decision -> pending -> gang -> ledger
  shared-state      registry-declared attributes mutated from daemon
                    threads must be touched under their declared lock
  name-consistency  event reasons, metric series names, and
                    deploy/prometheus-rules.yaml references must
                    resolve against the declared enums/registries
  exception-hygiene broad ``except Exception`` must log, emit an
                    event, re-raise, or carry a justified waiver

Two further passes run on a per-function CFG + path-dataflow engine
(``cfg.py``: branches, loops, try/except/finally, with regions,
return/raise/break/continue edges):

  epoch-discipline  every declared mutation seam in
                    sched/{state,gang}.py (the epoch owners) is
                    followed by an epoch bump on every path before the
                    enclosing lock's ``with`` exits (``epochs.py``;
                    the snapshot cache keys on those epochs)
  reservation-leak  every path from a reservation/preemption-plan
                    acquire in sched/{gang,extender}.py to function
                    exit reaches commit, rollback, or a hand-off —
                    exception edges included (``leaks.py``)

The runtime counterpart of epoch-discipline is the snapshot audit
sentinel (``sched/snapshot.py``, config ``snapshot_audit_rate``):
sampled cache hits rebuild from the ledger and raise on divergence.

Waivers: ``# tpukube: allow(<rule>[, <rule>]) <justification>`` on the
flagged line (or the line above). A waiver without a justification is
itself a lint error (``bare-waiver``), and one that suppresses zero
findings in a full run is stale (``unused-waiver``).
``python -m tpukube_torch.analysis tpukube_torch/ --changed[=REF]`` lints only files changed vs
a git ref for the fast pre-commit loop.

The dynamic half (``lockgraph``) instruments ``threading.Lock``/
``RLock`` creation behind the ``lock_monitor`` config flag, records
acquisition-order edges per thread during sim scenarios and stress
tests, and reports cycles (potential deadlocks) as a lock graph —
lockdep's class-based aggregation, keyed by lock creation site.
"""

from tpukube_torch.analysis.base import (  # noqa: F401
    ALL_RULES,
    Finding,
    SourceFile,
    run_all,
)
