"""CrashSchedule — deterministic crash-at-every-journal-seam chaos, the
port's own copy of ``tpukube/chaos/crash.py``.

The durable-state journal (sched/journal.py) has a small set of
on-disk outcomes a process death can leave behind, each mapping to a
seam in the append/checkpoint pipeline:

  * ``clean``          — died between records; the WAL ends on a
    record boundary (the after-append seam).
  * ``lost_tail``      — died BEFORE the drain thread wrote the last
    enqueued record(s): the mutation applied in memory but never hit
    disk (the before-append seam — the WAL under-reports, and the
    apiserver reconcile must supply the missing truth).
  * ``torn_tail``      — died mid-``write``: the final line is half a
    record (torn write; the loader must truncate, not crash).
  * ``corrupt_tail``   — bit rot / partial sector: the final line
    parses but fails its CRC (the loader must refuse it).
  * ``torn_checkpoint``— died mid-checkpoint-write AFTER the rename
    raced (or the file was later mangled): the checkpoint is
    undecodable, and recovery must fall back to replaying the whole
    WAL — never trust a checkpoint that fails its CRC.

:class:`CrashSchedule` draws one outcome per crash cycle from a single
seeded RNG in call order (the same determinism contract as
:class:`~tpukube_torch.chaos.schedule.FaultSchedule`), and the module's
helpers apply the corresponding mutilation to the journal files AFTER
the sim's ``crash_extender()`` — byte-level, exactly what the loader
will face. Scenario 13 (``python -m tpukube_torch.cli sim 13``) drives
≥8 such cycles under the scenario-8 apiserver storm; the journal tests
drive the ``lost_tail`` seam exhaustively (a crash at EVERY record
boundary).
"""

from __future__ import annotations

import os
from random import Random
from typing import Optional

#: crash outcomes, in draw-partition order (determinism contract)
CRASH_SEAMS = ("clean", "lost_tail", "torn_tail", "corrupt_tail",
               "torn_checkpoint")


class CrashSchedule:
    """Seeded crash-outcome chooser; one draw per crash cycle. The
    first ``len(seams)`` draws are a seeded permutation of ALL seams —
    a storm with at least that many cycles provably exercises every
    outcome — and later draws are uniform."""

    def __init__(self, seed: int,
                 seams: tuple[str, ...] = CRASH_SEAMS) -> None:
        self.seed = seed
        self._rng = Random(seed)
        self._seams = seams
        first = list(seams)
        self._rng.shuffle(first)
        self._first = first
        self.chosen: list[str] = []

    def next_seam(self) -> str:
        if self._first:
            seam = self._first.pop(0)
        else:
            seam = self._seams[self._rng.randrange(len(self._seams))]
        self.chosen.append(seam)
        return seam

    def apply(self, seam: str, wal_path: str) -> None:
        """Mutilate the journal files for one crash outcome (call after
        the process "died" — i.e. after ``crash_extender()``)."""
        if seam == "clean":
            return
        if seam == "lost_tail":
            drop_wal_records(wal_path, drop=1 + self._rng.randrange(2))
        elif seam == "torn_tail":
            tear_wal_tail(wal_path)
        elif seam == "corrupt_tail":
            corrupt_wal_tail(wal_path)
        elif seam == "torn_checkpoint":
            tear_checkpoint(wal_path + ".ckpt")
        else:
            raise ValueError(f"unknown crash seam {seam!r}")


def _read_lines(path: str) -> Optional[list[bytes]]:
    try:
        with open(path, "rb") as f:
            return f.read().splitlines(keepends=True)
    except OSError:
        return None


def drop_wal_records(path: str, drop: int = 1) -> int:
    """Remove the last ``drop`` complete records — the before-append
    crash: mutations applied in memory whose records never hit disk.
    Returns how many were actually dropped."""
    lines = _read_lines(path)
    if not lines:
        return 0
    drop = min(drop, len(lines))
    with open(path, "wb") as f:
        f.writelines(lines[: len(lines) - drop])
    return drop


def tear_wal_tail(path: str) -> bool:
    """Cut the final record mid-line — the torn-write crash. True if a
    line was actually torn."""
    lines = _read_lines(path)
    if not lines:
        return False
    last = lines[-1]
    if len(last) < 4:
        return False
    with open(path, "wb") as f:
        f.writelines(lines[:-1])
        f.write(last[: len(last) // 2])
    return True


def corrupt_wal_tail(path: str) -> bool:
    """Flip bytes inside the final record's CRC digits so the line
    still parses as JSON but fails verification."""
    lines = _read_lines(path)
    if not lines:
        return False
    last = lines[-1].rstrip(b"\n")
    marker = b'"c":'
    at = last.rfind(marker)
    if at < 0:
        return False
    digits = bytearray(last)
    i = at + len(marker)
    while i < len(digits) and digits[i : i + 1].isdigit():
        # 9s-complement each digit: always a DIFFERENT digit, so the
        # crc value provably changes and the line stays valid JSON
        digits[i] = ord("9") - (digits[i] - ord("0"))
        i += 1
    with open(path, "wb") as f:
        f.writelines(lines[:-1])
        f.write(bytes(digits) + b"\n")
    return True


def tear_checkpoint(path: str) -> bool:
    """Truncate the checkpoint mid-byte (a mid-write crash whose rename
    raced, or later corruption): the loader must refuse it and recovery
    must fall back to replaying the whole WAL."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size < 8:
        return False
    with open(path, "rb+") as f:
        f.truncate(size // 2)
    return True
