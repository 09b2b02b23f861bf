"""decision-provenance: every refusal/denial seam must record a
DecisionRecord (or carry a justified waiver).

The explain layer is only trustworthy if refusals can never be
silent in it: a pod refused by the tenancy gate, the degraded gate, or
a filter error must leave a provenance stage, else ``obs explain``
answers "unknown" for exactly the pods operators ask about.
This pass holds the refusal seams to that contract SOURCE-level, the
same way name-consistency holds emit() reasons:

  * any function that emits (``emit``/``_emit``/``_emit_event``) or
    delegates (``_refuse``) a REFUSAL reason literal
    (``TenantQuotaDenied``, ``TenantAdmissionShed``, ``DegradedMode``)
    must also contain a provenance record call — a ``.record(...)`` or
    ``.refusal(...)`` invoked on a ``decisions``/``dlog`` receiver —
    or itself delegate to ``_refuse`` (the tenancy plane's recording
    choke point);
  * the registered seam functions (``SEAMS``) are held to the same
    contract even without a literal in their body — ``_refuse``
    forwards its reason as a variable, and ``filter_response`` serves
    planned refusals without emitting at all.

Scoped to the modules that own refusal seams (``sched/extender.py``,
``sched/cycle.py``, ``tenancy/core.py``); new refusal seams elsewhere
join by emitting one of the refusal reasons (name-consistency already
forces the reason into the declared enum).
"""

from __future__ import annotations

import ast
from typing import Optional

from tpukube_torch.analysis.base import Finding, SourceFile

#: event reasons that ARE refusals — emitting one marks the enclosing
#: function as a refusal seam
REFUSAL_REASONS = frozenset({
    "TenantQuotaDenied", "TenantAdmissionShed", "DegradedMode",
})

#: call names whose first literal arg (or reason=) names an event
#: reason (the same surface name-consistency checks) plus the tenancy
#: plane's refusal choke point, which takes the reason first too
REFUSAL_EMITTERS = frozenset({"emit", "_emit", "_emit_event", "_refuse"})

#: a provenance record call: one of these method names ...
RECORD_METHODS = frozenset({"record", "refusal"})
#: ... invoked on a receiver whose trailing name is one of these
#: (``self.decisions.record(...)``, ``dlog.record(...)``, or the
#: extender-qualified ``ext.decisions.record(...)``)
RECORD_RECEIVERS = frozenset({"decisions", "dlog"})

#: calling a recording choke point counts as recording: the tenancy
#: plane's _refuse and the extender's guarded _note_decision helper
#: both record by contract (and both contain a literal record call, so
#: the contract bottoms out)
DELEGATES = frozenset({"_refuse", "_note_decision"})

SCOPE = ("sched/extender.py", "sched/cycle.py", "tenancy/core.py")

#: functions that are refusal seams by REGISTRATION (their reasons are
#: variables, or they answer refusals without emitting): path suffix ->
#: function names that must contain a record call
SEAMS: dict[str, frozenset[str]] = {
    "tenancy/core.py": frozenset({"_refuse"}),
    "sched/cycle.py": frozenset({"filter_response"}),
}


def _call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _literal_reason(call: ast.Call) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "reason" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _is_record_call(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id in DELEGATES
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr in DELEGATES:
        return True
    if fn.attr not in RECORD_METHODS:
        return False
    recv = fn.value
    if isinstance(recv, ast.Name):
        return recv.id in RECORD_RECEIVERS
    if isinstance(recv, ast.Attribute):
        return recv.attr in RECORD_RECEIVERS
    return False


def check_provenance(sf: SourceFile) -> list[Finding]:
    if not sf.in_scope(SCOPE):
        return []
    posix = sf.path.as_posix()
    registered: frozenset[str] = frozenset()
    for suffix, names in SEAMS.items():
        if posix.endswith(suffix):
            registered = names
            break
    findings: list[Finding] = []

    def visit_function(fn: ast.AST) -> None:
        emits_refusal: Optional[int] = None  # first offending line
        records = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _is_record_call(node):
                records = True
            name = _call_name(node)
            if name in REFUSAL_EMITTERS:
                reason = _literal_reason(node)
                if reason in REFUSAL_REASONS and emits_refusal is None:
                    emits_refusal = node.lineno
        is_seam = fn.name in registered
        if (emits_refusal is not None or is_seam) and not records:
            line = emits_refusal if emits_refusal is not None \
                else fn.lineno
            findings.append(Finding(
                "decision-provenance", sf.rel, line,
                f"{fn.name}() is a refusal seam but records no "
                f"DecisionRecord — call decisions.record()/.refusal() "
                f"(or delegate to _refuse) so `obs explain` "
                f"can answer why-denied for the refused pod",
            ))

    for node in sf.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_function(node)
    return findings
