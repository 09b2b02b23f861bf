"""tpukube-lint core: findings, waiver pragmas, the source-file model,
and the pass runner.

Every pass is a function ``check(sf: SourceFile) -> list[Finding]``;
``run_all`` walks the requested paths, runs every (or a selected subset
of) pass, applies waivers, and appends the ``bare-waiver`` findings for
malformed pragmas. Passes scope themselves by path suffix (e.g.
lock-discipline only fires on ``sched/gang.py`` / ``sched/extender.py``
/ ``sched/state.py``), which is also what makes them testable against
fixture trees: a snippet written to ``<tmp>/sched/gang.py`` is in scope.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Optional

#: every rule name the runner knows
ALL_RULES: tuple[str, ...] = (
    "lock-discipline",
    "lock-order",
    "shared-state",
    "name-consistency",
    "snapshot-discipline",
    "exception-hygiene",
    "epoch-discipline",
    "reservation-leak",
    "decision-provenance",
    "seam-triple",
    "flag-discipline",
    "unused-waiver",
    "bare-waiver",
)

#: the meta rules lint the waiver mechanism itself — a malformed or
#: stale pragma cannot excuse itself, so neither is waivable
META_RULES: tuple[str, ...] = ("unused-waiver", "bare-waiver")

#: rules a waiver pragma may legitimately name — by NAME, not tuple
#: position: the old ``ALL_RULES[:-1]`` slice silently broke the
#: "known rules" message the day a rule was appended after bare-waiver
WAIVABLE_RULES: tuple[str, ...] = tuple(
    r for r in ALL_RULES if r not in META_RULES
)

WAIVER_RE = re.compile(
    r"#\s*tpukube:\s*allow\(\s*"
    r"(?P<rules>[a-z][a-z0-9-]*(?:\s*,\s*[a-z][a-z0-9-]*)*)\s*\)"
    r"\s*(?P<why>.*)$"
)


@dataclass(frozen=True)
class Finding:
    """One lint violation, anchored to a source line."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


@dataclass(frozen=True)
class Waiver:
    line: int
    rules: tuple[str, ...]
    justification: str


class SourceFile:
    """One parsed source file: AST + the waiver pragmas in its comments."""

    def __init__(self, path, text: Optional[str] = None,
                 rel: Optional[str] = None):
        self.path = Path(path)
        self.rel = rel if rel is not None else str(path)
        self.text = self.path.read_text() if text is None else text
        self.tree = ast.parse(self.text, filename=str(path))
        self._nodes: Optional[list] = None
        self._literals: Optional[frozenset] = None
        if text is None:
            # read from disk: the registry reverse audit reads this
            # file's literals through the same parse (literal_strings)
            _PARSED[_stat_key(self.path)] = self
        self.waivers: dict[int, Waiver] = {}
        for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = WAIVER_RE.search(tok.string)
            if m is None:
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(","))
            self.waivers[tok.start[0]] = Waiver(
                tok.start[0], rules, m.group("why").strip()
            )

    @property
    def nodes(self) -> list:
        """Every node of the tree in ``ast.walk`` order, walked once and
        shared by the passes that scan the whole module."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def in_scope(self, suffixes: Iterable[str]) -> bool:
        posix = self.path.as_posix()
        return any(posix.endswith(s) for s in suffixes)

    def waiver_for(self, rule: str, line: int) -> Optional[Waiver]:
        """The waiver covering a finding at ``line``: same line, or a
        waiver comment on the line directly above (long statements)."""
        for ln in (line, line - 1):
            w = self.waivers.get(ln)
            if w is not None and rule in w.rules:
                return w
        return None


# (resolved path, mtime, size) -> the SourceFile a lint run parsed from
# that file, held weakly: the registry reverse audit reads the literals
# of every module through the run's own parse, and the entry goes with
# the run's SourceFiles
_PARSED: "weakref.WeakValueDictionary[tuple, SourceFile]" = \
    weakref.WeakValueDictionary()


def _stat_key(path: Path) -> tuple:
    st = path.stat()
    return (str(path.resolve()), st.st_mtime_ns, st.st_size)


def _str_constants(nodes) -> frozenset:
    return frozenset(n.value for n in nodes
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str))


def literal_strings(path) -> frozenset:
    """Every string constant of the module at ``path``: from the live
    SourceFile parsed from it as it stands on disk, else parsed here. A
    file that does not parse gives the empty set (its parse-error
    finding is the runner's job)."""
    path = Path(path)
    sf = _PARSED.get(_stat_key(path))
    if sf is not None:
        if sf._literals is None:
            sf._literals = _str_constants(sf.nodes)
        return sf._literals
    try:
        tree = ast.parse(path.read_text())
    except (SyntaxError, ValueError, UnicodeDecodeError):
        return frozenset()
    return _str_constants(ast.walk(tree))


def _passes() -> dict[str, Callable[[SourceFile], list[Finding]]]:
    # imported lazily: the pass modules import from base
    from tpukube_torch.analysis import (
        consistency,
        epochs,
        flags,
        hygiene,
        leaks,
        locks,
        provenance,
        seams,
    )

    return {
        "lock-discipline": locks.check_lock_discipline,
        "lock-order": locks.check_lock_order,
        "shared-state": locks.check_shared_state,
        "name-consistency": consistency.check_names,
        "snapshot-discipline": consistency.check_snapshot_discipline,
        "exception-hygiene": hygiene.check_exceptions,
        "epoch-discipline": epochs.check_epochs,
        "reservation-leak": leaks.check_leaks,
        "decision-provenance": provenance.check_provenance,
        "seam-triple": seams.check_seam_triples,
        "flag-discipline": flags.check_flags,
    }


def iter_source_files(
    paths: Iterable,
) -> tuple[list[SourceFile], list[Finding]]:
    """Every lintable .py under the given files/directories, plus a
    ``parse-error`` finding per file that cannot be tokenized/parsed —
    an unparseable file (mid-edit, conflict markers) must surface as a
    pointed finding, not crash the whole lint run. Generated protobuf
    modules are excluded (not ours to discipline)."""
    out: list[SourceFile] = []
    errors: list[Finding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            if f.name.endswith("_pb2.py"):
                continue
            rel = os.path.relpath(f)
            try:
                out.append(SourceFile(f, rel=rel))
            except (SyntaxError, ValueError, UnicodeDecodeError,
                    tokenize.TokenError) as e:
                line = getattr(e, "lineno", None) or 1
                errors.append(Finding(
                    "parse-error", rel, line,
                    f"file does not parse, no pass can check it: {e}",
                ))
    return out, errors


def changed_paths(paths: Iterable, ref: str = "HEAD") -> list[Path]:
    """The lintable .py files under ``paths`` that differ from git
    ``ref`` (worktree + index) or are untracked — the fast pre-commit
    loop behind ``tpukube-lint --changed``. Raises ``ValueError`` on
    git trouble (not a repo, unknown ref): the CLI maps that to a
    usage error, distinct from findings."""
    import subprocess

    roots = [Path(p).resolve() for p in paths]
    start = roots[0] if roots[0].is_dir() else roots[0].parent

    def _git(cwd: Path, *args: str) -> list[str]:
        proc = subprocess.run(
            ["git", *args], cwd=cwd, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise ValueError(
                f"git {' '.join(args)} failed: "
                f"{proc.stderr.strip() or proc.stdout.strip()}"
            )
        return [ln for ln in proc.stdout.splitlines() if ln]

    top = Path(_git(start, "rev-parse", "--show-toplevel")[0])
    # run the listings from the TOPLEVEL: ls-files --others prints
    # cwd-relative paths and, from a subdirectory, only that subtree —
    # joined to `top` below, a subdir cwd would silently drop exactly
    # the untracked files a pre-commit loop most needs to lint
    names = set(_git(top, "diff", "--name-only", ref, "--"))
    names |= set(_git(top, "ls-files", "--others", "--exclude-standard"))
    out: list[Path] = []
    for name in sorted(names):
        f = (top / name).resolve()
        if f.suffix != ".py" or f.name.endswith("_pb2.py"):
            continue
        if not f.exists():  # deleted vs ref: nothing to lint
            continue
        if any(f == r or r in f.parents for r in roots):
            out.append(f)
    return out


def find_rules_file(paths: Iterable) -> Optional[Path]:
    """Locate deploy/prometheus-rules.yaml relative to the linted tree
    (the deploy/ directory is the package directory's sibling)."""
    for p in paths:
        p = Path(p).resolve()
        for base in (p if p.is_dir() else p.parent, p.parent):
            cand = base / "deploy" / "prometheus-rules.yaml"
            if cand.exists():
                return cand
    return None


def waiver_findings(sf: SourceFile) -> list[Finding]:
    """The waiver mechanism's own lint: a waiver must carry a trailing
    justification and may only name known rules."""
    out = []
    for w in sf.waivers.values():
        if not w.justification:
            out.append(Finding(
                "bare-waiver", sf.rel, w.line,
                f"waiver for ({', '.join(w.rules)}) carries no "
                f"justification — say why the rule does not apply here",
            ))
        for rule in w.rules:
            if rule not in WAIVABLE_RULES:
                out.append(Finding(
                    "bare-waiver", sf.rel, w.line,
                    f"waiver names unknown or unwaivable rule {rule!r} "
                    f"(known: {', '.join(WAIVABLE_RULES)})",
                ))
    return out


def apply_waivers(sf: SourceFile, findings: Iterable[Finding],
                  used: Optional[set] = None) -> list[Finding]:
    """Drop findings covered by a waiver pragma; the meta rules
    (bare-waiver, unused-waiver) are never waivable — a malformed or
    stale pragma cannot excuse itself. ``used`` (when given) collects
    the ``(waiver line, rule)`` pairs that actually suppressed a
    finding — the input of the stale-waiver check."""
    kept: list[Finding] = []
    for f in findings:
        if f.rule in META_RULES:
            kept.append(f)
            continue
        w = sf.waiver_for(f.rule, f.line)
        if w is None:
            kept.append(f)
        elif used is not None:
            used.add((w.line, f.rule))
    return kept


def unused_waiver_findings(sf: SourceFile, used: set,
                           selected: set) -> list[Finding]:
    """Stale-waiver lint: a waiver whose rules all RAN in this
    invocation and suppressed nothing has outlived the code it excused
    — delete it (or fix the rule name). Waivers naming a rule that was
    deselected are skipped: a partial ``--rules`` run proves nothing
    about them. Waivers that only name unknown rules are bare-waiver's
    problem, not staleness."""
    out: list[Finding] = []
    for w in sf.waivers.values():
        considered = [r for r in w.rules
                      if r in WAIVABLE_RULES and r in selected]
        if not considered or len(considered) != len(
                [r for r in w.rules if r in WAIVABLE_RULES]):
            continue
        if any((w.line, r) in used for r in considered):
            continue
        out.append(Finding(
            "unused-waiver", sf.rel, w.line,
            f"waiver for ({', '.join(w.rules)}) suppressed no findings "
            f"in this run — the code it excused is gone; delete the "
            f"pragma so it cannot hide a future regression",
        ))
    return out


def run_all(paths: Iterable, rules: Optional[Iterable[str]] = None,
            rules_file=None) -> list[Finding]:
    """Run the selected passes (default: all) over ``paths`` plus the
    prometheus-rules cross-check, returning unwaived findings sorted by
    (path, line). ``rules_file`` overrides the deploy/ auto-discovery
    (which simply finds nothing on an isolated fixture tree)."""
    selected = set(rules) if rules is not None else set(ALL_RULES)
    unknown = selected - set(ALL_RULES)
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(sorted(unknown))}")
    passes = {k: v for k, v in _passes().items() if k in selected}
    sources, findings = iter_source_files(paths)
    for sf in sources:
        per_file: list[Finding] = []
        for check in passes.values():
            per_file.extend(check(sf))
        if "bare-waiver" in selected:
            per_file.extend(waiver_findings(sf))
        used: set = set()
        kept = apply_waivers(sf, per_file, used)
        if "unused-waiver" in selected:
            kept.extend(unused_waiver_findings(sf, used, selected))
        findings.extend(kept)
    if "name-consistency" in selected:
        from tpukube_torch.analysis import consistency

        if rules_file is None:
            rules_file = find_rules_file(paths)
        if rules_file:
            findings.extend(consistency.check_rules_file(rules_file))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
