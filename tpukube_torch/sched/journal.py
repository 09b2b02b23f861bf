"""Durable control-plane state — the port's own copy of
``tpukube/sched/journal.py``: a write-ahead journal plus checkpointed
O(Δ) crash recovery.

The extender keeps all scheduling truth in process memory; without a
journal a crash costs an O(fleet) rebuild from pod annotations. Every
ledger and gang mutation seam already emits a typed record; this module
persists that stream:

  * :class:`StateJournal` — an append-only JSONL WAL. Every ledger /
    gang mutation seam (``ClusterState._note_journal_locked`` /
    ``GangManager._note_journal_locked``) enqueues one typed record;
    a dedicated drain thread owns the file, so the decision lock never
    blocks on disk. Each record carries a CRC32 over its canonical JSON
    — a torn or corrupted tail is DETECTED, truncated, and absorbed by
    the reconcile pass, never silently replayed. The file rotates once
    to ``<path>.1`` at ``max_bytes``; rotation requests a prompt
    checkpoint so the live chain stays coverable.
  * ``Checkpoint`` — a periodic full snapshot (decoded node views +
    allocations + gang reservations + terminating masks + the WAL
    position they cover), captured in memory under the decision lock
    (O(allocs + changed nodes): node entries are memoized per payload)
    and written temp-file-then-``os.replace`` on the drain thread, so
    a crash mid-checkpoint leaves the previous checkpoint intact.
  * :func:`recover_extender` — the warm cold-start: load the latest
    valid checkpoint, replay the WAL tail through the REAL mutators,
    then reconcile against the apiserver only for the divergence set
    (per-node payload compares and per-pod annotation compares; decode
    + commit only what actually moved), then the snapshot audit once.

Failure ladder (degrade, never be wrong): a torn/corrupt WAL tail →
truncate + reconcile; an invalid checkpoint → replay the whole WAL
from empty; a WAL gap (rotation outran checkpoints) or a structurally
undecodable checkpoint → :class:`JournalError`, and the caller falls
back to the legacy full rebuild on a FRESH extender.

``fsync`` policy: ``"off"`` (default) flushes each drain batch to the
OS but never fsyncs; ``"always"`` fsyncs every batch on the journal
thread (never on the decision path). Checkpoints fsync before rename
under either policy.

The record kinds, the canonical JSON, the CRC line form and
``CHECKPOINT_VERSION`` are a file format shared with the reference
byte for byte: for the same decisions both packages write the same WAL,
and each recovers the other's files. The checkpoint head's ``ts`` is
the only clock field.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Optional

from tpukube_torch.core import codec
from tpukube_torch.sched.gang import GangError
from tpukube_torch.sched.state import StateError

log = logging.getLogger("tpukube_torch.journal")

#: checkpoint document schema version (bump on incompatible layout).
#: v2: head line (everything eager) + per-node JSONL lines addressed
#: by the head's node_index — the lazy-restore layout.
CHECKPOINT_VERSION = 2


class JournalError(RuntimeError):
    """The journal cannot produce a trustworthy state (WAL gap,
    undecodable checkpoint): the caller must fall back to the legacy
    full rebuild on a fresh extender — degraded, never wrong."""


def _canon(obj: Any) -> str:
    """Canonical JSON for CRC computation: writer and loader must
    serialize identically (sort_keys + compact separators; Python's
    float repr round-trips exactly through json)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _with_crc(body: str, crc: int) -> str:
    """Append a ``"c"`` field to an already-serialized JSON object."""
    return body[:-1] + ',"c":%d}' % crc


def _ckpt_wal_seq_hint(ckpt_path: str) -> int:
    """The checkpoint's ``wal_seq`` read off the HEAD LINE (the first
    line of the v2 layout; the field sorts last in it, before the
    appended CRC), without parsing the document — a seq lower bound
    for numbering continuity when a landed checkpoint truncated the
    WAL it covered. Node lines never carry the key, so the head line's
    last match is the value."""
    import re

    try:
        with open(ckpt_path, "rb") as f:
            head = f.readline().decode("utf-8", "replace")
    except OSError:
        return 0
    hits = re.findall(r'"wal_seq":(\d+)', head)
    return int(hits[-1]) if hits else 0


def _last_seq_on_disk(path: str) -> int:
    """The last record seq the WAL tail holds (0 for missing/empty).
    Reads a bounded tail chunk and takes the last line that parses —
    a torn final line falls back to the one before it, which is a safe
    LOWER bound never exceeded by valid records."""
    best = _ckpt_wal_seq_hint(path + ".ckpt")
    for p in (f"{path}.1", path):
        try:
            with open(p, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 256 * 1024))
                tail = f.read().decode("utf-8", "replace")
        except OSError:
            continue
        for line in reversed(tail.splitlines()):
            try:
                obj = json.loads(line)
                best = max(best, int(obj["s"]))
                break
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError):
                continue
    return best


class StateJournal:
    """Append-only WAL + checkpoint writer; see the module docstring.

    Thread contract: ``note()`` is called from inside the ledger/gang
    locks and ONLY enqueues (deque append + condition notify). The
    drain thread owns serialization, the file, rotation, and checkpoint
    writes. ``data`` passed to note() must be freshly built and never
    mutated afterwards.
    """

    CKPT_WINDOW = 64      # checkpoint-latency samples for the summary
    RECOVERY_WINDOW = 16  # recovery-latency samples

    def __init__(self, path: str, max_bytes: int = 64 * 1024**2,
                 fsync: str = "off",
                 checkpoint_interval: float = 60.0,
                 events=None, clock=None) -> None:
        from tpukube_torch.core.clock import SYSTEM

        self.path = path
        self.ckpt_path = path + ".ckpt"
        self.max_bytes = max_bytes
        self.fsync = fsync
        self.checkpoint_interval = checkpoint_interval
        self._events = events
        # scheduling-semantic time for the checkpoint cadence (FakeClock
        # compressible in the sim); latency MEASUREMENT stays real-time
        self._clock = clock if clock is not None else SYSTEM
        self._cond = threading.Condition()
        #: ("rec", seq, kind, data) | ("ckpt", doc, waiter) |
        #: ("sync", waiter) in enqueue order
        self._queue: deque = deque()
        self._closed = False
        # seq numbering CONTINUES across incarnations appending to the
        # same WAL (read off the file tail): a restart that skips or
        # fails recovery must never reuse seqs the file already holds —
        # the checkpoint's wal_seq cut depends on monotonicity
        self._seq = _last_seq_on_disk(path)
        # counters (tpukube_journal_* series; reads are lock-cheap)
        self.appends = 0
        self.bytes_total = 0
        self.rotations = 0
        self.checkpoints = 0
        self.replayed_total = 0
        self._ckpt_seconds: deque[float] = deque(maxlen=self.CKPT_WINDOW)
        self._recovery_seconds: deque[float] = deque(
            maxlen=self.RECOVERY_WINDOW)
        self.last_recovery: Optional[dict[str, Any]] = None
        self._ckpt_wanted = False
        self._last_ckpt_req = self._clock.monotonic()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._file = open(path, "a", encoding="utf-8")
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tpukube-journal",
        )
        self._thread.start()

    # -- the hot-path API (called under ledger/gang/decision locks) --------
    def note(self, kind: str, data: dict) -> None:
        """Enqueue one WAL record (non-blocking; dropped after close)."""
        with self._cond:
            if self._closed:
                return
            self._seq += 1
            self._queue.append(("rec", self._seq, kind, data))
            self.appends += 1
            self._cond.notify()

    def sync(self) -> None:
        """Durability barrier: block until every record enqueued before
        this call is flushed (and fsync'd under the ``always`` policy).
        Rare-path only, never per scheduling decision."""
        done = threading.Event()
        with self._cond:
            if self._closed:
                return
            self._queue.append(("sync", done))
            self._cond.notify()
        if not done.wait(timeout=30.0):
            log.error("journal sync barrier did not land within 30s "
                      "(%s)", self.path)

    def seq(self) -> int:
        """Last assigned record seq (the checkpoint's WAL position)."""
        with self._cond:
            return self._seq

    def set_seq(self, seq: int) -> None:
        """Continue numbering after a recovery replayed up to ``seq``."""
        with self._cond:
            self._seq = max(self._seq, int(seq))

    def force_seq(self, seq: int) -> None:
        """Pin numbering to exactly ``seq`` — ONLY safe right after
        ``compact_wal`` rewrote the file to end at ``seq``: a voided
        (corrupt/torn, cut-at-load) record may have carried a higher
        seq that the constructor's tail scan picked up, and leaving it
        would open a permanent gap in front of every future append."""
        with self._cond:
            self._seq = int(seq)

    def checkpoint_due(self, now: float) -> bool:
        with self._cond:
            return (self._ckpt_wanted
                    or now - self._last_ckpt_req
                    >= self.checkpoint_interval)

    def request_checkpoint(self, doc: dict) -> None:
        """Enqueue one checkpoint write (the drain thread serializes
        and lands it AFTER every record already queued, so the doc's
        ``wal_seq`` always covers what precedes it on disk)."""
        with self._cond:
            if self._closed:
                return
            self._ckpt_wanted = False
            self._last_ckpt_req = self._clock.monotonic()
            self._queue.append(("ckpt", doc, None))
            self._cond.notify()

    # -- drain thread ------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                items = list(self._queue)
                self._queue.clear()
                closing = self._closed
            try:
                self._write_out(items)
            except Exception:
                # the daemon keeps scheduling even when its journal
                # disk dies; recovery then degrades to the reconcile
                log.exception("journal drain failed (%s)", self.path)
            if closing:
                return

    def _write_out(self, items: list) -> None:
        f = self._file
        wrote = False
        for item in items:
            if item[0] == "sync":
                # barrier: everything written so far must be durable
                # before the waiter proceeds
                if wrote:
                    f.flush()
                    if self.fsync == "always":
                        os.fsync(f.fileno())
                    wrote = False
                item[1].set()
                continue
            if item[0] == "ckpt":
                if wrote:
                    # records queued before the checkpoint must be ON
                    # DISK before the doc naming their seq lands
                    f.flush()
                try:
                    self._write_checkpoint(item[1])
                finally:
                    if item[2] is not None:
                        item[2].set()  # write_checkpoint_sync waiter
                continue
            _, seq, kind, data = item
            body = _canon({"s": seq, "k": kind, "d": data})
            crc = zlib.crc32(body.encode("utf-8"))
            line = _with_crc(body, crc) + "\n"
            nbytes = len(line.encode("utf-8"))
            if (self.max_bytes > 0 and self._bytes > 0
                    and self._bytes + nbytes > self.max_bytes):
                f.flush()
                f.close()
                try:
                    os.replace(self.path, f"{self.path}.1")
                except OSError:
                    pass  # worst case we truncate in place below
                # append mode, like the constructor's handle: every
                # write lands at EOF regardless of stream position, so
                # a later truncate-to-zero (checkpoint landing) cannot
                # leave a NUL hole in front of the next record
                f = self._file = open(self.path, "a", encoding="utf-8")
                with self._cond:
                    self._bytes = 0
                    self.rotations += 1
                    # the live file no longer reaches back to the last
                    # checkpoint's position: ask for a prompt one
                    self._ckpt_wanted = True
            f.write(line)
            wrote = True
            with self._cond:
                self._bytes += nbytes
                self.bytes_total += nbytes
        if wrote:
            f.flush()
            if self.fsync == "always":
                os.fsync(f.fileno())

    def _write_checkpoint(self, doc: dict) -> None:
        """Land one checkpoint capture: HEAD LINE (CRC'd canonical
        JSON carrying everything eager plus the node_index) followed by
        one JSONL line per node, addressed by head-relative offsets.
        ``("ref", ...)`` entries copy their bytes verbatim from the
        previous checkpoint file (the capture's dup'd fd). A failure
        keeps the previous checkpoint intact — temp file + atomic
        rename, fsync'd."""
        t0 = time.perf_counter()
        head = doc["head"]
        old_fd = doc.get("old_fd")
        try:
            lines: list[bytes] = []
            index: dict[str, list] = {}
            rel = 0
            for e in doc["node_entries"]:
                if e[0] == "line":
                    _, name, line, crc, sid, pcrc, plen = e
                    raw = line.encode("utf-8")
                else:
                    _, name, off, length, crc, sid, pcrc, plen = e
                    if old_fd is None:
                        raise OSError(f"lazy ref for {name} without an "
                                      f"open previous checkpoint")
                    raw = os.pread(old_fd, length, off)
                    if zlib.crc32(raw) != crc:
                        raise OSError(f"stale lazy ref for {name}")
                index[name] = [rel, len(raw), crc, sid, pcrc, plen]
                lines.append(raw + b"\n")
                rel += len(raw) + 1
            head = dict(head)
            head["node_index"] = index
            # total node-line bytes: the loader refuses a checkpoint
            # whose body was torn off even when the head line itself
            # survived intact (head-CRC alone cannot see past itself)
            head["data_bytes"] = rel
            body = _canon(head)
            head_line = (
                _with_crc(body, zlib.crc32(body.encode("utf-8"))) + "\n"
            ).encode("utf-8")
            tmp = self.ckpt_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(head_line)
                f.writelines(lines)
                f.flush()
                # checkpoints always fsync before the atomic rename — a
                # torn checkpoint would silently cost the WHOLE warm
                # path, and one fsync per interval is noise (the
                # per-record policy is where fsync cost actually lives)
                os.fsync(f.fileno())
            os.replace(tmp, self.ckpt_path)
        except OSError:
            # keep the previous checkpoint; the next cadence retries
            log.exception("checkpoint write failed (%s)", self.ckpt_path)
            return
        finally:
            if old_fd is not None:
                try:
                    os.close(old_fd)
                except OSError:
                    pass
        # log truncation: every record on disk right now has seq <= the
        # doc's wal_seq (records are enqueued under the decision lock
        # that captured the doc, and this thread writes in queue
        # order), so the checkpoint covers the whole file — drop it.
        # Recovery's load_wal then reads a short tail instead of the
        # whole history, which is what keeps restart O(Δ).
        f = self._file
        if f is not None:
            f.flush()
            f.truncate(0)
            # reset the stream position too: the handle is append-mode
            # (writes go to EOF either way), but a stale position must
            # never be trusted by anything downstream
            f.seek(0)
        try:
            os.unlink(f"{self.path}.1")
        except OSError:
            pass
        dt = time.perf_counter() - t0
        with self._cond:
            self._bytes = 0
            self.checkpoints += 1
            self._ckpt_seconds.append(dt)
        if self._events is not None:
            try:
                self._events.emit(
                    "CheckpointWritten", obj="journal/checkpoint",
                    message="control-plane checkpoint written (ledger + "
                            "gang reservations + WAL position)",
                )
            except Exception:
                log.exception("event emit failed: CheckpointWritten")

    def write_checkpoint_sync(self, doc: dict) -> None:
        """Checkpoint now and WAIT for it to land. The write still runs
        on the drain thread, IN QUEUE ORDER — the single-writer
        discipline the file depends on: a caller-thread write would
        race the drain's buffered appends around the post-checkpoint
        truncation and could tear a record mid-file (cold-start callers
        enqueue thousands of records right before this)."""
        done = threading.Event()
        with self._cond:
            if self._closed:
                return
            self._ckpt_wanted = False
            self._last_ckpt_req = self._clock.monotonic()
            self._queue.append(("ckpt", doc, done))
            self._cond.notify()
        if not done.wait(timeout=30.0):
            log.error("checkpoint did not land within 30s (%s)",
                      self.ckpt_path)

    def compact_wal(self, records: list[dict]) -> None:
        """Rewrite the live WAL to exactly ``records`` (the valid,
        CRC-verified set a recovery loaded) and drop the rotation: a
        torn/corrupt tail is cut for good (the loader stops at the
        first bad line, so leaving it would shadow future appends),
        and rotated history collapses into one live file. O(tail) —
        the records a recovery replays — and no checkpoint write or
        fsync on the restart-to-serving path. Runs before serving; the
        drain thread is idle."""
        with self._cond:
            if self._file is not None:
                self._file.truncate(0)
                self._file.seek(0)
                total = 0
                for rec in records:
                    body = _canon({"s": rec["s"], "k": rec["k"],
                                   "d": rec["d"]})
                    line = _with_crc(body, rec["c"]) + "\n"
                    self._file.write(line)
                    total += len(line.encode("utf-8"))
                self._file.flush()
                self._bytes = total
        try:
            os.unlink(f"{self.path}.1")
        except OSError:
            pass

    # -- recovery bookkeeping ----------------------------------------------
    def note_recovery(self, stats: dict[str, Any]) -> None:
        with self._cond:
            self.last_recovery = dict(stats)
            self._recovery_seconds.append(stats["recovery_s"])
            self.replayed_total += stats.get("replayed", 0)

    def checkpoint_seconds_snapshot(self) -> list[float]:
        with self._cond:
            return list(self._ckpt_seconds)

    def recovery_seconds_snapshot(self) -> list[float]:
        with self._cond:
            return list(self._recovery_seconds)

    # -- lifecycle ---------------------------------------------------------
    def crash(self) -> None:
        """Simulated process death (sim crash_extender): queued-but-
        undrained records are LOST — exactly what a real crash loses —
        and the file handle closes without flushing the queue."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            for item in self._queue:
                if item[0] == "ckpt" and item[2] is not None:
                    item[2].set()  # never strand a sync waiter
                elif item[0] == "sync":
                    item[1].set()  # barrier waiters neither
            self._queue.clear()
            self._cond.notify()
        self._thread.join(timeout=10.0)
        if self._file is not None:
            self._file.close()
            self._file = None

    def close(self) -> None:
        """Drain what is queued, stop the thread, close the file.
        Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=10.0)
        if self._file is not None:
            self._file.close()
            self._file = None

    def stats(self) -> dict[str, Any]:
        """The /statusz "journal" section."""
        with self._cond:
            last_ckpt = (self._ckpt_seconds[-1]
                         if self._ckpt_seconds else None)
            return {
                "enabled": True,
                "path": self.path,
                "seq": self._seq,
                "appends": self.appends,
                "bytes_total": self.bytes_total,
                "bytes_live": self._bytes,
                "rotations": self.rotations,
                "checkpoints": self.checkpoints,
                "last_checkpoint_s": (round(last_ckpt, 6)
                                      if last_ckpt is not None else None),
                "checkpoint_interval_seconds": self.checkpoint_interval,
                "fsync": self.fsync,
                "replayed_total": self.replayed_total,
                "last_recovery": self.last_recovery,
            }


# -- loading -----------------------------------------------------------------

def load_checkpoint(path: str
                    ) -> Optional[tuple[dict, int, int]]:
    """The checkpoint HEAD plus an open read fd and the node-data
    start offset — (head, fd, data_start) — or None when
    missing/torn/corrupt (recovery then replays the whole WAL from
    empty — the next rung of the failure ladder, not an error). Only
    the head line is read and CRC-verified here; node lines load
    lazily through the fd (each carries its own CRC in the head's
    node_index). CRC verification runs over the RAW head bytes (the
    writer appended ``"c"`` to an already-serialized body), so a
    multi-MB checkpoint is never re-serialized just to check it. The
    CALLER owns the returned fd."""
    try:
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        first = f.readline()
    data_start = len(first)
    text = first.decode("utf-8", "replace").rstrip("\n")
    # written as  <canonical body minus "}"> + ',"c":<crc>}'  — split
    # the trailer off and CRC the body verbatim
    body, sep, trailer = text.rpartition(',"c":')
    if not sep or not trailer.endswith("}") \
            or not trailer[:-1].isdigit():
        log.error("checkpoint %s is torn/corrupt (no CRC trailer); "
                  "ignoring it", path)
        return None
    crc = int(trailer[:-1])
    body += "}"
    if crc != zlib.crc32(body.encode("utf-8")):
        log.error("checkpoint %s fails its CRC; ignoring it", path)
        return None
    try:
        obj = json.loads(body)
    except json.JSONDecodeError as e:
        log.error("checkpoint %s is undecodable past its CRC (%s); "
                  "ignoring it", path, e)
        return None
    if obj.get("v") != CHECKPOINT_VERSION:
        log.error("checkpoint %s has version %r (want %d); ignoring it",
                  path, obj.get("v"), CHECKPOINT_VERSION)
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    if size != data_start + obj.get("data_bytes", -1):
        # body torn off behind an intact head: the node lines the
        # index points at are gone — the whole checkpoint is void
        log.error("checkpoint %s: body is %d byte(s), head promises "
                  "%s; ignoring it", path, size - data_start,
                  obj.get("data_bytes"))
        return None
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as e:
        log.error("checkpoint %s: cannot reopen for lazy reads: %s",
                  path, e)
        return None
    return obj, fd, data_start


def load_wal(path: str) -> tuple[list[dict], dict[str, int]]:
    """WAL records from ``<path>.1`` (the rotation, if any) then
    ``path``, in order, CRC-verified. Reading STOPS at the first torn
    or CRC-failing line of each file — everything after an undecodable
    record is untrusted, and the reconcile pass covers whatever was
    cut. Returns (records, {"torn": n, "bad_crc": n})."""
    records: list[dict] = []
    info = {"torn": 0, "bad_crc": 0}
    for p in (f"{path}.1", path):
        try:
            f = open(p, encoding="utf-8")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    body = _canon({"s": obj["s"], "k": obj["k"],
                                   "d": obj["d"]})
                except (json.JSONDecodeError, KeyError, TypeError):
                    info["torn"] += 1
                    log.warning("%s: torn WAL line after seq %s; "
                                "truncating here", p,
                                records[-1]["s"] if records else 0)
                    break
                if obj.get("c") != zlib.crc32(body.encode("utf-8")):
                    info["bad_crc"] += 1
                    log.warning("%s: WAL record seq %s fails its CRC; "
                                "truncating here", p, obj.get("s"))
                    break
                records.append(obj)
    return records, info


# -- replay ------------------------------------------------------------------

def replay_records(extender, records: list[dict]) -> int:
    """Apply a WAL tail through the real mutators (journal detached by
    the caller, so nothing re-records). A record that fails to apply is
    logged and SKIPPED — the apiserver reconcile owns whatever truth it
    carried; replay must never abort recovery over one record."""
    state, gang = extender.state, extender.gang
    applied = 0
    for rec in records:
        kind, d = rec["k"], rec["d"]
        try:
            if kind == "commit":
                state.commit(codec.decode_alloc(d["a"]))
            elif kind == "release":
                state.release(d["p"])
            elif kind == "node":
                state.upsert_node(d["n"], dict(d["anno"]))
            elif kind == "cordon":
                # drain choreography: cordon/uncordon is a plain ledger
                # mutation — idempotent, unknown names skipped by the
                # mutator itself
                state.set_cordon(list(d["n"]), bool(d["c"]))
            elif kind == "unnodes":
                # un-ingest batch: nodes with live allocations are
                # skipped loudly inside remove_nodes (WAL order places
                # releases first, so replay normally finds them free)
                state.remove_nodes(list(d["n"]))
            elif kind == "nodes":
                # one bulk-ingest batch: replay through the
                # same fast path; per-item errors are logged by the
                # ingest and the reconcile covers them
                for out in state.ingest_nodes([
                    {"name": n, "annotations": dict(a)}
                    for n, a in d["items"]
                ]):
                    if isinstance(out, dict) and out.get("error"):
                        log.error("journal replay: bulk-ingest item "
                                  "failed: %s — the apiserver "
                                  "reconcile covers it", out["error"])
            else:
                gang.apply_journal(rec)
            applied += 1
        except (StateError, GangError, codec.CodecError, KeyError,
                TypeError, ValueError) as e:
            log.error("journal replay: seq %s (%s) failed: %s — the "
                      "apiserver reconcile covers it", rec.get("s"),
                      kind, e)
    return applied


# -- recovery ----------------------------------------------------------------

def _api_call(fn: Callable, what: str, attempts: int = 64):
    """An apiserver read that rides out transient faults (recovery may
    run inside the same storm that killed the process). No backoff
    sleeps: recovery happens before serving, and the chaos tests need
    determinism, not politeness."""
    from tpukube_torch.apiserver import transient_api_error

    last: Optional[Exception] = None
    for _ in range(attempts):
        try:
            return fn()
        except Exception as e:
            if not transient_api_error(e):
                raise
            last = e
    raise JournalError(
        f"apiserver unreachable during recovery ({what}): {last}"
    )


def recover_extender(extender, api) -> dict[str, Any]:
    """The journal-backed cold start: checkpoint + WAL tail + O(Δ)
    apiserver reconcile; see the module docstring. Returns a stats
    dict; raises :class:`JournalError` when the journal cannot produce
    a trustworthy base (the caller then rebuilds a FRESH extender the
    legacy way — a failed recovery may have half-restored state)."""
    from tpukube_torch.core.types import TopologyCoord, canonical_link
    from tpukube_torch.sched.snapshot import ClusterSnapshot, SliceSnapshot

    journal = extender.journal
    if journal is None:
        raise JournalError("recover_extender needs journal_enabled")
    events = extender.events
    t0 = time.perf_counter()
    state, gang = extender.state, extender.gang
    # detach: replayed mutations must not re-record into the WAL
    state.set_journal(None)
    gang.set_journal(None)
    ckpt_fd: Optional[int] = None
    fd_owned = False
    try:
        loaded = load_checkpoint(journal.ckpt_path)
        ckpt: Optional[dict] = None
        data_start = 0
        if loaded is not None:
            ckpt, ckpt_fd, data_start = loaded
            fd_owned = True
        records, wal_info = load_wal(journal.path)
        wal_seq = int(ckpt["wal_seq"]) if ckpt is not None else 0
        tail = [r for r in records if int(r["s"]) > wal_seq]
        expect = wal_seq
        for r in tail:
            expect += 1
            if int(r["s"]) != expect:
                raise JournalError(
                    f"WAL gap: expected seq {expect}, found {r['s']} "
                    f"(rotation outran checkpoints?)"
                )
        restored_allocs = 0
        restored_gangs = 0
        if ckpt is not None:
            node_index = {
                name: [data_start + e[0], e[1], e[2], e[3], e[4], e[5]]
                for name, e in ckpt.get("node_index", {}).items()
            }
            restored_allocs = state.restore_checkpoint(
                ckpt["state"], ckpt_fd, node_index
            )
            fd_owned = False  # ownership moved into the ledger
            restored_gangs = gang.restore_checkpoint(ckpt["gang"])
            snap_doc = ckpt.get("snap")
            if snap_doc is not None and set(snap_doc) == set(
                state.slice_ids()
            ):
                # seed the scheduling snapshot: the first lookups HIT
                # instead of forcing the O(chips) rebuild that would
                # eagerly materialize every lazy node; the audit
                # sentinel (below, and sampled at runtime) holds the
                # seed to ledger truth. The geometry mask is not in the
                # file: it is derived from the restored host maps, as
                # the snapshot build does.
                slices = {}
                for sid, sd in snap_doc.items():
                    slices[sid] = SliceSnapshot(
                        slice_id=sid,
                        mesh=state.slice_mesh(sid),
                        occupied=frozenset(
                            TopologyCoord(*c) for c in sd["occ"]),
                        reserved=frozenset(
                            TopologyCoord(*c) for c in sd["res"]),
                        unhealthy=frozenset(
                            TopologyCoord(*c) for c in sd["unh"]),
                        terminating=frozenset(
                            TopologyCoord(*c) for c in sd["term"]),
                        broken=frozenset(
                            canonical_link(a, b) for a, b in sd["brk"]),
                        used_shares=int(sd["used"]),
                        total_shares=int(sd["total"]),
                        # "crd" is written only when non-empty (drain
                        # off: checkpoint bytes unchanged)
                        cordoned=frozenset(
                            TopologyCoord(*c) for c in sd.get("crd", ())),
                        absent=frozenset(state.absent_coords(sid)),
                    )
                extender.snapshots.seed(ClusterSnapshot(
                    key=extender.snapshots.epoch_key(), slices=slices,
                ))
        replayed = replay_records(extender, tail)
        dropped_pending = gang.finish_replay()
        # reattach BEFORE the reconcile: its mutations are NEW history
        # and must hit the WAL like any other — the compact first cuts
        # any torn/corrupt tail so future appends stay loadable (and
        # prunes checkpoint-covered records: the tail is all a future
        # recovery replays), and the seq pin closes the hole a voided
        # tail record's higher seq would otherwise leave in front of
        # every future append
        journal.compact_wal(tail)
        # never below the checkpoint's position: a WAL compacted by an
        # earlier recovery leaves the tail empty while wal_seq stands
        journal.force_seq(max(
            tail[-1]["s"] if tail else 0, wal_seq,
        ))
        state.set_journal(journal)
        gang.set_journal(journal)
        if wal_info["torn"] or wal_info["bad_crc"]:
            try:
                events.emit(
                    "JournalTruncated", obj="journal/wal", type="Warning",
                    message=f"WAL tail cut at load ({wal_info['torn']} "
                            f"torn, {wal_info['bad_crc']} bad-CRC "
                            f"line(s)); the apiserver reconcile covers "
                            f"the cut records",
                )
            except Exception:
                log.exception("event emit failed: JournalTruncated")

        # seed the capture memo with the restored allocations so the
        # post-recovery checkpoint re-encodes nothing that round-
        # tripped intact
        if ckpt is not None:
            alloc_cache = extender._ckpt_cache.setdefault("allocs", {})
            sigs = ckpt["state"].get("alloc_index", {})
            ledger_now = {a.pod_key: a for a in state.allocations()}
            for obj in ckpt["state"].get("allocs", ()):
                key = obj.get("pod")
                entry = ledger_now.get(key)
                sig = sigs.get(key)
                if entry is not None and sig is not None:
                    alloc_cache[key] = (entry, obj,
                                        (int(sig[0]), int(sig[1])))

        # ---- reconcile: apiserver truth wins, O(divergence) work ----
        # nodes: a payload SIGNATURE COMPARE per node (lazy nodes stay
        # lazy — crc32+length against the checkpoint index, one lock
        # round-trip for the fleet); only changed or unknown nodes pay
        # a decode, via the recorded upsert_node decision the legacy
        # rebuild also uses
        changed_nodes = 0
        node_objs: dict[str, dict] = {}
        node_payloads: dict[str, str] = {}
        for obj in _api_call(api.list_nodes, "list_nodes"):
            meta = obj.get("metadata") or {}
            name = meta.get("name")
            if not name:
                continue
            payload = (meta.get("annotations") or {}).get(
                codec.ANNO_NODE_TOPOLOGY)
            if payload is None:
                continue
            node_objs[name] = obj
            node_payloads[name] = payload
        matching = state.nodes_matching_payloads(node_payloads)
        for name, obj in node_objs.items():
            if name in matching:
                continue
            annotations = dict(
                (obj.get("metadata") or {}).get("annotations") or {})
            out = extender.handle(
                "upsert_node", {"name": name, "annotations": annotations},
            )
            if out.get("error"):
                log.error("recovery: node %s annotation rejected: %s",
                          name, out["error"])
            else:
                changed_nodes += 1
        # pods: the ledger vs the live, bound, non-terminal annotated
        # set — a pod whose alloc annotation still matches its
        # checkpoint signature AND its ledger entry is proven
        # consistent without any decode; only the divergence set runs
        # the legacy lifecycle filter (which decodes and logs loudly)
        from tpukube_torch.apiserver import TERMINAL_PHASES, live_alloc_pods

        alloc_index = (ckpt["state"].get("alloc_index", {})
                       if ckpt is not None else {})
        raw_pods = _api_call(api.list_pods, "list_pods")
        present: set[str] = set()
        ledger = {a.pod_key: a for a in state.allocations()}
        checked: set[str] = set()
        candidates: list[dict] = []
        for p in raw_pods:
            meta = p.get("metadata") or {}
            name = meta.get("name")
            if not name:
                continue
            key = f"{meta.get('namespace', 'default')}/{name}"
            present.add(key)
            annos = meta.get("annotations") or {}
            payload = annos.get(codec.ANNO_ALLOC)
            if not payload:
                continue
            phase = (p.get("status") or {}).get("phase")
            bound = (p.get("spec") or {}).get("nodeName")
            entry = ledger.get(key)
            if entry is None and (phase in TERMINAL_PHASES or not bound):
                # annotation residue with no ledger entry: nothing to
                # reconcile and nothing to log — the legacy filter
                # would only narrate the skip
                continue
            sig = alloc_index.get(key)
            if (entry is not None and sig is not None
                    and phase not in TERMINAL_PHASES
                    and bound == entry.node_name):
                raw = payload.encode("utf-8")
                uid = str(meta.get("uid") or "")
                if (sig[0] == zlib.crc32(raw) and sig[1] == len(raw)
                        and (not entry.uid or not uid
                             or entry.uid == uid)):
                    checked.add(key)
                    continue
            candidates.append(p)
        live: dict[str, tuple[dict, Any]] = {}
        for annos, planned, key in live_alloc_pods(candidates):
            live[key] = (annos, planned)
        stale = sorted(k for k in ledger
                       if k not in live and k not in checked)
        # gangs touched by the divergence set must rebuild WHOLE from
        # the reconciled ledger: a replayed reservation whose member
        # binds were lost with the WAL tail would otherwise shadow the
        # rebuilt truth (collected BEFORE the releases detach members)
        affected_gangs: set[tuple[str, str]] = set()
        res_by_pod: dict[str, tuple[str, str]] = {}
        for res in gang.snapshot():
            for pk in res.assigned:
                res_by_pod[pk] = res.key
        for k in stale:
            if k in res_by_pod:
                affected_gangs.add(res_by_pod[k])
            # recorded release decisions: the journal-restored entry has
            # no live pod behind it (completed / evicted mid-crash)
            extender.handle("release", {"pod_key": k})
        divergent: list[tuple[str, dict]] = []
        for key in sorted(live):
            annos, planned = live[key]
            entry = ledger.get(key)
            if (planned is not None and entry is not None
                    and entry.node_name == planned.node_name
                    and sorted(entry.device_ids)
                    == sorted(planned.device_ids)):
                continue
            if entry is not None:
                extender.handle("release", {"pod_key": key})
            gname = annos.get(codec.ANNO_POD_GROUP)
            if gname:
                affected_gangs.add((key.split("/", 1)[0], gname))
            if key in res_by_pod:
                affected_gangs.add(res_by_pod[key])
            divergent.append((key, annos))
        # ledger first (gang restoration runs below against the FULL
        # reconciled membership — never a divergent-only subset)
        readded = len(state.rebuild_from_pods(
            [annos for _, annos in divergent]
        ))
        # dangling-member scan: every live gang pod with a ledger entry
        # must be ASSIGNED in its group's reservation — a gbound (or the
        # whole gre) lost with the WAL tail otherwise leaves committed
        # members invisible to their gang, the partial-gang-death shape
        # the restore machinery exists to prevent
        assigned_now: dict[tuple[str, str], set] = {}
        for res in gang.snapshot():
            assigned_now[res.key] = set(res.assigned)
        for p in raw_pods:
            meta = p.get("metadata") or {}
            name = meta.get("name")
            annos = meta.get("annotations") or {}
            gname = annos.get(codec.ANNO_POD_GROUP)
            if not name or not gname:
                continue
            ns = meta.get("namespace", "default")
            key = f"{ns}/{name}"
            if state.allocation(key) is None:
                continue
            if key not in assigned_now.get((ns, gname), ()):
                affected_gangs.add((ns, gname))
        for gkey in sorted(affected_gangs):
            gang.drop_reservation(gkey)
        if affected_gangs:
            _restore_affected_gangs(extender, raw_pods, affected_gangs)
        # replayed eviction intents and terminating masks for pods that
        # no longer exist resolve now (their confirm channel died with
        # the old process; a pod that still exists keeps its intent and
        # the fresh executor completes the pre-crash all-or-nothing)
        keep = [p for p in extender.pending_evictions if p in present]
        extender.pending_evictions.clear()
        extender.pending_evictions.extend(keep)
        for pk in gang.terminating_pod_keys():
            if pk not in present:
                extender.handle("victim_gone", {"pod_key": pk})
        divergences = len(stale) + len(divergent)

        # ---- the snapshot audit sentinel, once, riding the audit knob: with
        # snapshot_audit_rate > 0 the recovered snapshot must equal a
        # from-scratch ledger rebuild before serving begins (scenario
        # 13's acceptance runs at rate 1.0; rate 0 keeps the two full
        # O(chips) builds off the restart-to-serving path) ----
        if extender.snapshots.audit_rate > 0.0:
            extender.snapshots.audit_now()
        # request a FRESH checkpoint now (async — the drain thread
        # writes it): a crashy environment must not wait a full
        # checkpoint interval before each incarnation becomes warmly
        # recoverable, or repeated crashes degrade every recovery to
        # whole-WAL replays
        journal.request_checkpoint(extender.checkpoint_doc())
        recovery_s = time.perf_counter() - t0
        # drain the remaining lazy views OFF the serving path: by the
        # time the first full-fleet scan arrives (a structural rebuild,
        # a metrics scrape), the warmer has usually materialized
        # everything already
        _start_warmer(state)
        stats = {
            "mode": "warm",
            "recovery_s": round(recovery_s, 6),
            "checkpoint": ckpt is not None,
            "restored_allocs": restored_allocs,
            "restored_gangs": restored_gangs,
            "replayed": replayed,
            "dropped_pending_reservations": len(dropped_pending),
            "wal_torn": wal_info["torn"],
            "wal_bad_crc": wal_info["bad_crc"],
            "nodes_changed": changed_nodes,
            "pods_diverged": len(divergent),
            "pods_stale": len(stale),
            "pods_readded": readded,
            "divergences": divergences,
        }
        journal.note_recovery(stats)
        try:
            if divergences:
                events.emit(
                    "RecoveryDiverged", obj="journal/recovery",
                    type="Warning",
                    message=f"recovered state diverged from the "
                            f"apiserver on {divergences} pod(s); "
                            f"reconciled",
                )
            events.emit(
                "RecoveryCompleted", obj="journal/recovery",
                message="journal recovery completed "
                        "(checkpoint + WAL replay + reconcile)",
            )
        except Exception:
            log.exception("event emit failed: RecoveryCompleted")
        log.warning(
            "journal recovery: %d alloc(s) + %d gang(s) from the "
            "checkpoint, %d WAL record(s) replayed, %d node(s) + %d "
            "pod(s) reconciled in %.3fs",
            restored_allocs, restored_gangs, replayed, changed_nodes,
            divergences, recovery_s,
        )
        return stats
    except JournalError:
        if fd_owned and ckpt_fd is not None:
            try:
                os.close(ckpt_fd)
            except OSError:
                pass
        raise
    except (KeyError, TypeError, ValueError, AttributeError,
            codec.CodecError, StateError, GangError) as e:
        # a structurally-broken checkpoint/WAL may have half-restored
        # state: the caller must rebuild on a FRESH extender
        if fd_owned and ckpt_fd is not None:
            try:
                os.close(ckpt_fd)
            except OSError:
                pass
        raise JournalError(f"recovery failed: {e}") from e


def _restore_affected_gangs(extender, raw_pods: list[dict],
                            affected: set) -> None:
    """Rebuild the affected groups' reservations from the RECONCILED
    ledger (their stale reservations were dropped): every live member
    with a committed allocation joins, exactly the legacy cold
    rebuild's gang semantics — committed gangs restore with their
    members' chips, mid-assembly gangs re-derive a completable box or
    roll back."""
    state, gang = extender.state, extender.gang
    members: dict[tuple, list] = {k: [] for k in affected}
    specs: dict[tuple, Any] = {}
    for p in raw_pods:
        meta = p.get("metadata") or {}
        name = meta.get("name")
        if not name:
            continue
        ns = meta.get("namespace", "default")
        annos = meta.get("annotations") or {}
        gname = annos.get(codec.ANNO_POD_GROUP)
        if gname is None or (ns, gname) not in members:
            continue
        alloc = state.allocation(f"{ns}/{name}")
        if alloc is None:
            continue
        try:
            group = codec.pod_group_from_annotations(dict(annos))
        except codec.CodecError as e:
            log.warning("gang reconcile: pod %s/%s carries an "
                        "undecodable pod-group annotation (%s)",
                        ns, name, e)
            continue
        if group is None:
            continue
        members[(ns, gname)].append(alloc)
        specs[(ns, gname)] = group
    for key, allocs in members.items():
        if allocs and key in specs:
            gang.restore(key[0], specs[key], allocs)


def _start_warmer(state) -> None:
    """Background materializer for lazily-restored node views: drains
    the fleet in small batches so the steady-state serving path never
    meets a cold node, without the restart paying O(fleet) up front."""
    def run() -> None:
        # brief head start for the restart epilogue and the first
        # webhooks: warming is strictly background work and must not
        # steal interpreter time from restart-to-serving itself
        time.sleep(0.05)
        while state.warm_pending(512):
            pass

    threading.Thread(target=run, daemon=True,
                     name="tpukube-journal-warmer").start()
