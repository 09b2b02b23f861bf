"""exception-hygiene: broad ``except Exception`` (or bare ``except:``)
handlers in the daemons' hot paths must DO something an operator can
see — log, emit a journal event, or re-raise — or carry a justified
``# tpukube: allow(exception-hygiene) <why>`` waiver. A silent broad
except in a scheduling or plugin path is how a real fault class
(apiserver flake, codec skew, kubelet restart) becomes an invisible
capacity leak.
"""

from __future__ import annotations

import ast

from tpukube_torch.analysis.base import Finding, SourceFile

#: a call to any of these attribute names counts as "the handler
#: surfaced the error": stdlib logger methods + the journal emitters
LOG_METHODS = {
    "debug", "info", "warning", "error", "exception", "critical", "log",
}
EMIT_METHODS = {"emit", "_emit", "_emit_event"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _handles(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in LOG_METHODS | EMIT_METHODS):
            return True
    return False


def check_exceptions(sf: SourceFile) -> list[Finding]:
    findings = []
    for node in sf.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _is_broad(node) and not _handles(node):
            findings.append(Finding(
                "exception-hygiene", sf.rel, node.lineno,
                "broad except swallows the error silently — log it, "
                "emit a journal event, re-raise, or waive with "
                "`# tpukube: allow(exception-hygiene) <why>`",
            ))
    return findings
