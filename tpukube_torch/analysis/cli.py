"""The lint prover's command line (``python -m tpukube_torch.analysis``).

    python -m tpukube_torch.analysis tpukube_torch/   # all passes
    python -m tpukube_torch.analysis --rules lock-order,shared-state \
        tpukube_torch/sched/
    python -m tpukube_torch.analysis --json tpukube_torch/
    python -m tpukube_torch.analysis --list-rules

Exit status: 0 = clean (every finding fixed or carries a justified
waiver), 1 = unwaived findings, 2 = usage error (an unknown rule, an
unreadable path or rules file, a rules file outside the reader's
subset). It imports no YAML library: the rules file goes through
``rulesyaml``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from tpukube_torch.analysis.base import ALL_RULES, run_all

_RULE_DOCS = {
    "lock-discipline": "no blocking I/O under the scheduling locks",
    "lock-order": "acquisitions follow decision -> pending -> gang -> "
                  "ledger",
    "shared-state": "registry-declared attributes touched under their "
                    "declared lock",
    "name-consistency": "event reasons / metric series / "
                        "prometheus-rules refs resolve against the "
                        "declared registries",
    "snapshot-discipline": "occupancy_grid/_Sweep built only in "
                           "sched/snapshot.py (+ slicefit wrappers) — "
                           "hot paths read the epoch cache",
    "exception-hygiene": "broad excepts must log, emit, re-raise, or "
                         "carry a justified waiver",
    "epoch-discipline": "every declared mutation seam is followed by "
                        "an epoch bump on every path before the "
                        "enclosing lock's `with` exits (CFG dataflow)",
    "reservation-leak": "every path from a reservation/preemption-plan "
                        "acquire to function exit reaches commit, "
                        "rollback, or a hand-off — exception edges "
                        "included (CFG dataflow)",
    "decision-provenance": "every refusal/denial seam (tenancy gate, "
                           "degraded gate, filter errors) records a "
                           "DecisionRecord",
    "seam-triple": "every epoch bump in the ledger/gang pairs with a "
                   "delta note AND a journal note on every path before "
                   "the lock region exits; each replayed WAL kind is "
                   "still written somewhere (CFG dataflow)",
    "flag-discipline": "feature-gated subsystems built only under "
                       "their config flag; every seam dereference is "
                       "None-guarded (off-is-off)",
    "unused-waiver": "a waiver that suppressed zero findings is stale "
                     "and must be deleted",
    "bare-waiver": "waiver pragmas must name known rules and carry a "
                   "justification",
}


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpukube-lint",
        description="lock-discipline / concurrency / name-consistency "
                    "static analysis over the tpukube_torch tree",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint (default: the "
                        "tpukube_torch package next to this install)")
    p.add_argument("--rules", default=None, metavar="R1,R2",
                   help="comma-separated subset of rules to run")
    p.add_argument("--rules-file", default=None, metavar="YAML",
                   help="prometheus-rules.yaml to cross-check (default: "
                        "auto-discover deploy/prometheus-rules.yaml "
                        "next to the linted tree)")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="lint only files changed vs a git ref "
                        "(worktree + index + untracked). Write the ref "
                        "as --changed=REF — a bare `--changed` before a "
                        "path would swallow the path as its ref — or "
                        "put paths first: `tpukube-lint tpukube_torch/ "
                        "--changed`. Default ref: HEAD. The fast "
                        "pre-commit loop; tools/check.sh still runs "
                        "the full tree")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="one JSON object per finding")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule names and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule:20s} {_RULE_DOCS[rule]}")
        return 0

    paths = args.paths
    if not paths:
        import tpukube_torch

        paths = [tpukube_torch.__path__[0]]
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        rules_file = args.rules_file
        if args.changed is not None:
            from tpukube_torch.analysis.base import (
                changed_paths,
                find_rules_file,
            )

            if rules_file is None:
                # discover deploy/prometheus-rules.yaml from the
                # ORIGINAL path arguments: the changed-file list that
                # replaces them below has no deploy/ sibling, and the
                # rules cross-check must not silently vanish in
                # changed-only mode
                rules_file = find_rules_file(paths)
            paths = changed_paths(paths, ref=args.changed)
            if not paths and rules_file is None:
                print(f"tpukube-lint: no lintable files changed vs "
                      f"{args.changed}")
                return 0
            # an empty .py list still cross-checks the rules file:
            # "only deploy/prometheus-rules.yaml changed" is exactly
            # when the name-consistency rules check matters most
        findings = run_all(paths, rules=rules, rules_file=rules_file)
    except (ValueError, OSError) as e:
        # unknown rule names, an unreadable path/--rules-file, or a
        # rules yaml outside the reader's subset are USAGE errors (exit
        # 2), distinct from lint findings (exit 1) — CI wrappers key on
        # the difference
        print(f"tpukube-lint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        for f in findings:
            print(json.dumps(f.as_dict(), sort_keys=True))
    else:
        for f in findings:
            print(f)
        n = len(findings)
        print(f"tpukube-lint: {n} finding(s)" if n else
              "tpukube-lint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
