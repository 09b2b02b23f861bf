"""Cluster state as the extender sees it (L5 support) — the port's own
copy of ``tpukube/sched/state.py``'s ledger, node views and ingest.

The control plane is deliberately stateless — node truth arrives in ``node-topology`` annotations with each
webhook call, and allocations live in pod annotations. The only in-memory
structure is this ledger of commitments, and it is reconstructible from pod
annotations after an extender restart (``rebuild_from_pods``), which the
tests exercise.

Occupancy accounting is share-granular: a whole-chip node is just the
n=1 case of a vTPU node, so one ledger covers both resources.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import zlib

from tpukube_torch.core import codec
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import (
    DEFAULT_SLICE,
    AllocResult,
    ChipInfo,
    Health,
    Link,
    NodeInfo,
    TopologyCoord,
    canonical_link,
    parse_device_id,
)


log = logging.getLogger("tpukube_torch.state")


#: per-process ledger-incarnation stream: ``allocs_since`` cursors embed
#: (pid, count) so a cursor minted against one ledger incarnation can
#: never read another incarnation's change log as its own — a restarted
#: process gets a fresh pid, a fresh in-process ledger a fresh count,
#: and either way the mismatch degrades to a full read.
_INCARNATIONS = itertools.count(1)


class StateError(RuntimeError):
    pass


@dataclass
class NodeView:
    """One node's decoded annotation + live occupancy, tracked at device-id
    granularity (a count would re-mint a released share's id while its twin
    is still live — ids are the unit of truth, counts are derived).
    ``share_counts`` is a per-chip cache of those derived counts, kept in
    lockstep by add_ids/remove_ids (used_share_count is the hottest call
    of every webhook — parsing ids per query was measurable)."""

    info: NodeInfo
    used_ids: set[str] = field(default_factory=set)
    share_counts: dict[int, int] = field(default_factory=dict)
    # weight each id contributed to share_counts AT COMMIT TIME — release
    # must subtract exactly that, not a recomputation: a node whose
    # shares_per_chip annotation changes under live allocations would
    # otherwise leak counts permanently
    id_weights: dict[str, int] = field(default_factory=dict)
    # verbatim annotation payload this view was decoded from; upsert_node
    # skips re-decoding when a webhook carries the identical string (hot:
    # every /filter and /prioritize re-sends every node's annotations)
    raw_payload: str = ""
    # decoded tpu.qiniu.com/health-summary annotation (obs telemetry),
    # None when the node agent predates it; the /statusz fleet rollup
    # prefers these counts and falls back to chip health otherwise
    health_summary: Optional[dict] = None

    # coord -> chip index, built on first use (views are re-created per
    # decoded annotation, never re-pointed at different chips); the bind
    # path queries this per planned coord — a linear chip scan there was
    # round-2 weak #2
    _coord_index: dict[TopologyCoord, int] = field(default_factory=dict)
    # occupancy version, bumped by add_ids/remove_ids: memoizes the
    # derived free-chip list and free-share total, which every webhook
    # recomputes per node (health changes arrive as NEW views via
    # upsert_node, so version-only invalidation is sound)
    _version: int = 0
    _free_cache: Optional[tuple[int, list[ChipInfo]]] = None
    _free_shares_cache: Optional[tuple[int, int]] = None

    @property
    def shares_per_chip(self) -> int:
        return max(1, self.info.shares_per_chip)

    def chip(self, index: int) -> ChipInfo:
        return self.info.chip_by_index(index)

    def index_at(self, coord: TopologyCoord) -> int:
        if not self._coord_index:
            self._coord_index = {c.coord: c.index for c in self.info.chips}
        try:
            return self._coord_index[coord]
        except KeyError:
            raise StateError(
                f"no chip at {coord} on {self.info.name}"
            ) from None

    def add_ids(self, ids) -> None:
        self._version += 1
        for did in ids:
            i, frac = parse_device_id(did)
            self.used_ids.add(did)
            weight = 1 if frac is not None else self.shares_per_chip
            self.id_weights[did] = weight
            self.share_counts[i] = self.share_counts.get(i, 0) + weight

    def remove_ids(self, ids) -> None:
        self._version += 1
        for did in ids:
            if did not in self.used_ids:
                continue
            i, _ = parse_device_id(did)
            self.used_ids.discard(did)
            weight = self.id_weights.pop(did, 0)
            left = self.share_counts.get(i, 0) - weight
            if left > 0:
                self.share_counts[i] = left
            else:
                self.share_counts.pop(i, None)

    def used_share_count(self, index: int) -> int:
        return self.share_counts.get(index, 0)

    def used_frac_ks(self, index: int) -> set[int]:
        out = set()
        for did in self.used_ids:
            i, frac = parse_device_id(did)
            if i == index and frac is not None:
                out.add(frac[0])
        return out

    def free_shares(self, chip: ChipInfo) -> int:
        if chip.health is not Health.HEALTHY:
            return 0
        return self.shares_per_chip - self.used_share_count(chip.index)

    def total_free_shares(self) -> int:
        cached = self._free_shares_cache
        if cached is not None and cached[0] == self._version:
            return cached[1]
        total = sum(self.free_shares(c) for c in self.info.chips)
        self._free_shares_cache = (self._version, total)
        return total

    def free_chips(self) -> list[ChipInfo]:
        """Chips with ALL shares free (placeable as whole units).
        Shared memoized list — callers must not mutate it."""
        cached = self._free_cache
        if cached is not None and cached[0] == self._version:
            return cached[1]
        out = [
            c
            for c in self.info.chips
            if self.free_shares(c) == self.shares_per_chip
        ]
        self._free_cache = (self._version, out)
        return out


def _health_only_change(a: NodeInfo, b: NodeInfo) -> bool:
    """True when the ONLY difference between two decoded node payloads
    is per-chip health (and at least one chip flipped) — the shape the
    snapshot can absorb as an O(chips-per-node) delta. Anything else
    (links, coords, ids, sharing mode, HBM/core facts, source) is
    structural and keeps the full-rebuild marker."""
    if (a.slice_id != b.slice_id
            or a.shares_per_chip != b.shares_per_chip
            or a.source != b.source
            or len(a.chips) != len(b.chips)
            or set(a.bad_links) != set(b.bad_links)):
        return False
    changed = False
    for ca, cb in zip(a.chips, b.chips):
        if (ca.chip_id != cb.chip_id or ca.index != cb.index
                or ca.coord != cb.coord or ca.hbm_bytes != cb.hbm_bytes
                or ca.num_cores != cb.num_cores):
            return False
        changed |= ca.health is not cb.health
    return changed


#: shared decoder for the probe's raw_decode fast path: json.loads
#: spends two whitespace-regex matches per document on stripping the
#: (for our encoder, never-present) leading/trailing space — at 100k
#: nodes that is 200k regex calls for nothing. Payloads that DO carry
#: surrounding whitespace fall back to json.loads below.
_PROBE_DECODER = json.JSONDecoder()


def _alloc_bytes(allocs: list[AllocResult]) -> int:
    """Wire-shape size of an alloc list (encoded annotation lengths) —
    the honest byte count a remote resync consumer would move. O(n)
    encodes, paid only on resync reads (Δ-sized in steady state)."""
    return sum(len(codec.encode_alloc(a)) for a in allocs)

#: NamedTuple's generated __new__ is a Python-level lambda; at 4 chips
#: per node the probe constructs ~400k coords per 100k-node fleet, so
#: it builds them the way _make does — straight through tuple.__new__.
_TUPLE_NEW = tuple.__new__


#: Health.value -> member (enum __call__ per chip is ~10x a dict hit,
#: and checkpoint restore runs this 40k times at 10k nodes)
_HEALTH_BY_VALUE = {h.value: h for h in Health}


def _node_doc(view: NodeView) -> dict:
    """One node's checkpoint line content (sched/journal.py): the
    DECODED view — chips, health, links, occupancy-independent facts —
    plus the raw payload for divergence compares. Mesh lives in the
    checkpoint head per slice, occupancy in the alloc list."""
    info = view.info
    return {
        "n": info.name,
        "slice": info.slice_id,
        "shares": info.shares_per_chip,
        "source": info.source,
        "chips": [
            [c.chip_id, c.index, list(c.coord), c.hbm_bytes,
             c.num_cores, c.health.value]
            for c in info.chips
        ],
        "bad": [[list(a), list(b)] for a, b in info.bad_links],
        "payload": view.raw_payload,
        "hs": view.health_summary,
    }


def _view_from_doc(doc: dict, mesh: MeshSpec) -> NodeView:
    """Rebuild a NodeView from its checkpoint line (inverse of
    ``_node_doc``; occupancy re-applies separately from the restored
    allocations). ``mesh`` is unused today but pins the contract that
    a node line is only meaningful under its slice's geometry."""
    del mesh
    chips = [
        ChipInfo(chip_id=cid, index=i, coord=TopologyCoord(*coord),
                 hbm_bytes=hbm, num_cores=cores,
                 health=_HEALTH_BY_VALUE[h])
        for cid, i, coord, hbm, cores, h in doc["chips"]
    ]
    info = NodeInfo(
        name=doc["n"], chips=chips,
        shares_per_chip=doc["shares"],
        bad_links=[canonical_link(a, b) for a, b in doc["bad"]],
        slice_id=doc["slice"], source=doc.get("source", ""),
    )
    return NodeView(info=info, raw_payload=doc["payload"],
                    health_summary=doc.get("hs"))


def _probe_node_payload(name: str, payload: str,
                        mesh_memo: Optional[dict] = None) -> dict:
    """Structural probe of a node-topology payload for the bulk ingest
    fast path: runs every validation ``decode_node_topology`` +
    ``node_from_annotations`` enforce — schema version, mesh, chip
    entries (ids/indices/coords/hbm/cores/health values), shares,
    badLinks containment + adjacency, slice id, annotation-vs-node name
    — WITHOUT constructing the ChipInfo/NodeInfo objects (the deferred
    cost lazy materialization pays on first touch). Raises CodecError
    with the same messages the full decode raises, so a malformed
    payload errors at ingest, never silently on first touch."""
    try:
        try:
            obj, end = _PROBE_DECODER.raw_decode(payload)
            if end != len(payload) and payload[end:].strip():
                raise json.JSONDecodeError("Extra data", payload, end)
        except json.JSONDecodeError:
            # leading/trailing whitespace (or junk — which re-raises
            # with loads' message): the tolerant path
            obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise codec.CodecError(f"node-topology: bad JSON: {e}") from e
    codec._check_version(obj, "node-topology")
    try:
        fragment = codec._field(obj, "mesh", "node-topology")
        # a homogeneous fleet repeats one mesh fragment per slice:
        # decode (and validate) it once per distinct fragment. The key
        # covers exactly the fields from_json reads.
        mesh = None
        memo_key = None
        if mesh_memo is not None:
            memo_key = (
                tuple(fragment["dims"]),
                tuple(fragment.get("host_block", (2, 2, 1))),
                tuple(fragment.get("torus", (False, False, False))),
            )
            mesh = mesh_memo.get(memo_key)
        if mesh is None:
            mesh = MeshSpec.from_json(fragment)
            if memo_key is not None:
                mesh_memo[memo_key] = mesh
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, codec.CodecError):
            raise
        raise codec.CodecError(
            f"node-topology: malformed mesh: {e}") from e
    raw_chips = codec._field(obj, "chips", "node-topology")
    if not isinstance(raw_chips, list):
        raise codec.CodecError("node-topology: 'chips' must be a list")
    # ONE pass over the chip entries (this loop runs per chip of the
    # whole fleet): coord construction + every field materialization
    # decodes later, so a malformed entry fails HERE with the decode's
    # message. The "Healthy" string compare is the hot fast path — the
    # enum call validates only the rare non-healthy value (junk raises
    # the decode's exact error).
    coords: list[TopologyCoord] = []
    unhealthy: list[TopologyCoord] = []
    append_coord = coords.append
    try:
        for c in raw_chips:
            x, y, z = c["coord"]
            coord = _TUPLE_NEW(TopologyCoord,
                               (int(x), int(y), int(z)))
            append_coord(coord)
            c["id"]
            int(c["index"])
            int(c["hbm"])
            int(c.get("cores", 2))
            h = c.get("health", "Healthy")
            if h != "Healthy" and Health(h) is not Health.HEALTHY:
                unhealthy.append(coord)
    except (KeyError, TypeError, ValueError) as e:
        raise codec.CodecError(
            f"node-topology: malformed chip entry: {e}") from e
    try:
        shares = int(obj.get("sharesPerChip", 1))
    except (TypeError, ValueError) as e:
        raise codec.CodecError(
            f"node-topology: bad sharesPerChip: {e}") from e
    if shares < 1:
        raise codec.CodecError(
            f"node-topology: sharesPerChip must be >= 1, got {shares}")
    raw_links = obj.get("badLinks", [])
    if not isinstance(raw_links, list):
        raise codec.CodecError("node-topology: 'badLinks' must be a list")
    try:
        bad_links = [canonical_link(a, b) for a, b in raw_links]
    except (TypeError, ValueError) as e:
        raise codec.CodecError(
            f"node-topology: malformed badLinks entry: {e}") from e
    for a, b in bad_links:
        if not (mesh.contains(a) and mesh.contains(b)):
            raise codec.CodecError(
                f"node-topology: badLinks endpoint outside mesh "
                f"{mesh.dims}: {[a.as_list(), b.as_list()]}"
            )
        if b not in mesh.neighbors(a):
            raise codec.CodecError(
                f"node-topology: badLinks pair not ICI-adjacent: "
                f"{[a.as_list(), b.as_list()]}"
            )
    slice_id = obj.get("slice", DEFAULT_SLICE)
    if not isinstance(slice_id, str) or not slice_id:
        raise codec.CodecError(
            f"node-topology: bad slice id {slice_id!r}")
    anno_name = codec._field(obj, "node", "node-topology")
    if anno_name != name:
        raise codec.CodecError(
            f"node-topology annotation names {anno_name!r} but lives "
            f"on {name!r}"
        )
    return {
        "slice": slice_id,
        "mesh": mesh,
        "coords": coords,
        "unhealthy": unhealthy,
        "links": bad_links,
        "shares": shares,
        "healthy_chips": len(coords) - len(unhealthy),
    }


@dataclass
class SliceView:
    """One slice: its mesh geometry plus the data-driven coord->host map
    built from node annotations (host naming is a sim convention, not a
    contract — the annotation's chip coords are the truth)."""

    mesh: MeshSpec
    host_by_coord: dict[TopologyCoord, str] = field(default_factory=dict)
    # a checkpoint restore's lazily-parsed host map (a compact
    # ``x,y,z=name;...`` blob): ClusterState._hosts_locked expands it on
    # first touch. hosts_blob caches the serialized form for checkpoint
    # captures, invalidated on any host-map mutation.
    pending_hosts: Optional[str] = None
    hosts_blob: Optional[str] = None


class ClusterState:
    """Thread-safe ledger: per-slice node views + per-chip share occupancy.

    The extender serves concurrent webhook calls; all mutation goes through
    this object's lock (reservations must be linearizable
    under concurrent filter calls — the gang layer in M7 builds on this).

    A cluster holds one or more ICI slices ("distributed
    communication backend": ICI intra-slice, DCN inter-slice). Chip coords
    are slice-local, so every coord-set accessor takes a slice id; the
    no-argument forms serve the common single-slice cluster and raise on
    ambiguity rather than silently mixing coordinate spaces.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: dict[str, NodeView] = {}
        self._slices: dict[str, SliceView] = {}
        self._allocs: dict[str, AllocResult] = {}  # pod key -> commitment
        # frozen coord->host snapshots handed to hot-path callers; rebuilt
        # lazily after any host-map mutation (annotations rarely change)
        self._hosts_cache: dict[str, dict[TopologyCoord, str]] = {}
        # ledger epoch: bumped by EVERY mutation (node upsert, commit,
        # release — rebuild_from_pods goes through commit). The epoch-
        # cached scheduling snapshot (sched/snapshot.py) keys its
        # validity on this, so a missed bump here would serve stale
        # placements — treat any new mutation path as epoch-bumping.
        self._epoch = 0
        # snapshot delta sink (sched/snapshot.py SnapshotCache, wired
        # by the owning GangManager): every epoch bump pairs with a
        # _note_delta so the cache can advance O(Δ) instead of
        # rebuilding. A bump without a note degrades to a full rebuild
        # (log gap), never to a stale cache.
        self._delta_sink = None
        # durable-state journal (sched/journal.py StateJournal, wired by
        # the Extender when journal_enabled): mutation seams enqueue one
        # typed WAL record each — enqueue only, the file write happens
        # on the journal's drain thread, so this lock never blocks on
        # disk. None (the default) journals nothing.
        self._journal = None
        # Generation-based incremental resync: a monotonically
        # increasing generation stamped on every ALLOC mutation seam
        # (commit/release — exactly the set ``allocations()`` serves),
        # plus a bounded per-generation change log ``allocs_since``
        # answers adds/removes from. The log is None until
        # set_generation_log() sizes it (the Extender wires
        # config.generation_log_capacity; 0 keeps it off) — disabled,
        # allocs_since answers None and consumers keep the full read.
        # A cursor the log cannot cover (gap, restart, overflow) gets a
        # FULL answer — never a stale one. The checkpoint head carries
        # the generation ("gen"), so a warm recovery resumes numbering.
        self._generation = 0
        self._incarnation = f"{os.getpid():x}.{next(_INCARNATIONS):x}"
        self._gen_log: Optional[deque] = None
        # cached sorted node-name tuple, invalidated when the node SET
        # changes (a new node registers / a checkpoint restore) — NOT on
        # occupancy or health churn. node_names() runs per batch cycle;
        # a fresh sorted list per call was O(fleet) per cycle at 10k
        # nodes.
        self._names_cache: Optional[tuple[str, ...]] = None
        # LAZY checkpoint restore (sched/journal.py warm recovery):
        # nodes not yet materialized live as positions into the open
        # checkpoint file — name -> (abs offset, length, line crc,
        # slice id, payload crc, payload len). _view_locked()
        # materializes a view on first touch (an os.pread of one line
        # plus one small parse), so restart-to-serving pays O(Δ), not
        # O(fleet); a background warmer drains the rest off the hot
        # path. _lazy_allocs indexes restored allocations by node so a
        # materialized view recovers its occupancy.
        self._lazy_index: dict[str, tuple] = {}
        self._lazy_fd: Optional[int] = None
        self._lazy_allocs: dict[str, list[AllocResult]] = {}
        # set by retire(): the owning process is done with this ledger
        # (sim crash/stop) — the background warmer must stop instead of
        # materializing an orphan's fleet
        self._retired = False
        # Per-slice occupied-coord sets, maintained INCREMENTALLY at
        # the same seams the snapshot deltas fire from (commit /
        # release / health-only re-annotation / structural upsert), so
        # a forced structural rebuild stops walking every view of the
        # slice (at 10k nodes the walk was the
        # rebuild's dominant term). A slice absent from the dict is
        # UNSEEDED: the first occupied_coords() call derives the set
        # with the full walk (materializing any lazy nodes of the
        # slice) and seeds it. The audit sentinel deliberately bypasses this cache
        # (walk_occupied_coords) so a seam that forgot BOTH its delta
        # and its incremental update still cannot hide from the audit.
        self._occ_cache: dict[str, set[TopologyCoord]] = {}
        # The REMAINING per-slice structural walks, given the same
        # incremental treatment: unhealthy coord sets, broken-link report counts, and
        # the (used, total) share integers. Same seeding/unseeded
        # contract as _occ_cache, same seams (structural upsert,
        # health-only re-annotation, commit, release), and the audit
        # sentinel again re-derives via the walk_* variants so these
        # caches can never hide a missed seam. _broken_cache counts
        # REPORTING VIEWS per canonical link (both endpoint hosts may
        # report one link; the set view is the keys with count > 0).
        self._unhealthy_cache: dict[str, set[TopologyCoord]] = {}
        self._broken_cache: dict[str, dict[Link, int]] = {}
        self._share_cache: dict[str, list[int]] = {}  # sid -> [used, total]
        # Bulk ingestion: nodes ingested through ingest_nodes() live
        # here UNDECODED — name -> (topology payload, full annotation
        # dict, slice id) — until first touch materializes a NodeView
        # (_view_locked). The probe already ran every validation the
        # full decode enforces and extracted the host map + health/link
        # aggregates, so a materialization failure is pathological (and
        # degrades that one node to 'unknown').
        self._lazy_payloads: dict[str, tuple[str, dict[str, str], str]] = {}
        # decode-avoidance counters: a batch item whose payload matches
        # the retained one (a webhook re-send of an unchanged fleet) is
        # a HIT, answered without any parse; a fresh probe is a miss
        self._decode_hits = 0
        self._decode_misses = 0
        # ingest counters (the /statusz "ingest" section + the
        # tpukube_ingest_* series)
        self.ingest_nodes_total = 0
        self.ingest_batches = 0
        self._ingest_seconds: deque[float] = deque(maxlen=64)
        self.ingest_seconds_total = 0.0
        self._warming = False
        # Cordoned node names (the drain plane, sched/drain.py): excluded
        # from every placement sweep while their live allocations keep
        # serving — the drain choreography's first act. Rides the WAL
        # ("cordon" records) and the checkpoint head ("cordoned", only
        # when non-empty, so journal bytes stay byte-identical with the
        # drain plane off). No incremental coord cache: cordons are
        # rare, and the snapshot derives coords on demand
        # (cordoned_coords) for build and audit alike.
        self._cordoned: set[str] = set()
        # decommission counters (the /statusz "ingest" section's twin)
        self.removed_nodes_total = 0
        self.removed_batches = 0

    def set_delta_sink(self, sink) -> None:
        """Attach the snapshot cache's delta log (None detaches)."""
        with self._lock:
            self._delta_sink = sink

    def set_journal(self, journal) -> None:
        """Attach the durable-state journal (None detaches — recovery
        replays with the journal detached so replayed mutations are not
        re-recorded)."""
        with self._lock:
            self._journal = journal

    def _note_journal_locked(self, kind: str, data: dict) -> None:
        """Enqueue one WAL record for the mutation just applied
        (callers hold ``self._lock``; non-blocking — see StateJournal).
        ``data`` must be freshly built and never mutated afterwards:
        the journal serializes it on its drain thread."""
        journal = self._journal
        if journal is not None:
            journal.note(kind, data)

    def _note_delta_locked(self, full: bool = False,
                    slice_id: Optional[str] = None,
                    occupied_add: tuple = (), occupied_remove: tuple = (),
                    used_shares_delta: int = 0,
                    unhealthy_add: tuple = (), unhealthy_remove: tuple = (),
                    total_shares_delta: int = 0, why: str = "") -> None:
        """Record the bump just taken (callers hold ``self._lock`` and
        call this right after ``self._epoch += 1``). Import is lazy and
        one-directional: snapshot.py never imports state."""
        sink = self._delta_sink
        if sink is None:
            return
        from tpukube_torch.sched.snapshot import SnapshotDelta

        sink.note(SnapshotDelta(
            kind="ledger", epoch=self._epoch, full=full,
            slice_id=slice_id, occupied_add=occupied_add,
            occupied_remove=occupied_remove,
            used_shares_delta=used_shares_delta,
            unhealthy_add=unhealthy_add,
            unhealthy_remove=unhealthy_remove,
            total_shares_delta=total_shares_delta, why=why,
        ))

    def epoch(self) -> int:
        """Monotonic mutation counter (the snapshot cache's key half)."""
        with self._lock:
            return self._epoch

    # -- generation-based incremental resync ----------------------
    def set_generation_log(self, capacity: int) -> None:
        """Size (and enable) the per-generation alloc change log; 0
        disables it — ``allocs_since`` then answers None and consumers
        keep the legacy full read. The capacity must exceed the deepest
        alloc churn between two consumer reads (a churn wave's commits
        plus its releases) or steady-state resyncs degrade to full
        reads (counted, never wrong)."""
        with self._lock:
            self._gen_log = deque(maxlen=capacity) if capacity > 0 \
                else None

    def _note_gen_locked(self, kind: str, alloc=None,
                         pod_key: Optional[str] = None) -> None:
        """Stamp one alloc mutation (callers hold ``self._lock`` and
        call this right where the ``_allocs`` map changed)."""
        self._generation += 1
        gen_log = self._gen_log
        if gen_log is not None:
            gen_log.append((
                self._generation, kind,
                alloc if kind == "add" else pod_key,
            ))

    def generation(self):
        """The opaque resync cursor: (ledger incarnation, generation).
        Feed it back into ``allocs_since`` to read only what changed."""
        with self._lock:
            return (self._incarnation, self._generation)

    def allocs_since(self, cursor) -> Optional[dict]:
        """The alloc changes since ``cursor`` (a prior answer's
        ``cursor``, or None to bootstrap). None when the log is
        disabled (legacy full-read consumers); otherwise a dict:

          * ``{"cursor": C, "adds": [AllocResult...], "removes":
            [pod_key...], "bytes": n}`` — the incremental answer;
            apply removes, then adds, to a mirror of the ledger.
          * ``{"cursor": C, "full": [AllocResult...], "bytes": n}`` —
            bootstrap, wrong incarnation (a restart), or a log gap
            (overflow): the full ledger. A gap ALWAYS degrades to this
            — never to a stale or partial answer.

        ``bytes`` is the wire-shape size of the answer (encoded alloc
        lengths) — what a remote consumer would actually move; the
        tpukube_resync_bytes_total feed."""
        with self._lock:
            gen_log = self._gen_log
            if gen_log is None:
                return None
            cur = (self._incarnation, self._generation)
            gen: Optional[int] = None
            if cursor is not None:
                try:
                    inc, gen = cursor[0], int(cursor[1])
                except (TypeError, ValueError, IndexError):
                    gen = None
                else:
                    if inc != self._incarnation or gen > self._generation:
                        gen = None  # another incarnation's cursor
            if gen is None or (
                gen < self._generation
                and (not gen_log or gen_log[0][0] > gen + 1)
            ):
                # bootstrap or gap: the log cannot cover (gen, now]
                allocs = list(self._allocs.values())
                return {"cursor": cur, "full": allocs,
                        "bytes": _alloc_bytes(allocs)}
            # net effect per pod key, in generation order (an add after
            # a remove of the same key is an add, and vice versa)
            merged: dict[str, tuple[str, Optional[AllocResult]]] = {}
            for g, kind, payload in gen_log:
                if g <= gen:
                    continue
                if kind == "add":
                    merged[payload.pod_key] = ("add", payload)
                else:
                    merged[payload] = ("remove", None)
            adds = [a for kind, a in merged.values() if kind == "add"]
            removes = [k for k, (kind, _) in merged.items()
                       if kind == "remove"]
            return {
                "cursor": cur, "adds": adds, "removes": removes,
                "bytes": _alloc_bytes(adds) + sum(
                    len(k) for k in removes),
            }

    # -- lazy materialization (checkpoint warm restore) ---------------------
    def _view_locked(self, name: str) -> Optional[NodeView]:
        """The node's view, materializing it from the open checkpoint
        file on first touch (callers hold ``self._lock``). None for
        unknown nodes OR for a node whose checkpoint line fails its
        CRC — the latter degrades that one node to 'unknown' (its next
        re-annotation re-registers it) instead of crashing recovery."""
        view = self._nodes.get(name)
        if view is not None:
            return view
        lazy = self._lazy_payloads.pop(name, None)
        if lazy is not None:
            # bulk-ingested node: decode the retained annotations on
            # first touch — the probe already ran every validation, so
            # failure here is pathological
            return self._materialize_payload_locked(name, *lazy)
        entry = self._lazy_index.pop(name, None)
        if entry is None:
            return None
        off, length, crc, sid, _pcrc, _plen = entry
        try:
            raw = os.pread(self._lazy_fd, length, off)
        except OSError as e:
            log.error("lazy node %s: checkpoint read failed: %s",
                      name, e)
            self._names_cache = None  # the node SET just shrank
            self._drop_lazy_fd_locked()
            return None
        if zlib.crc32(raw) != crc:
            log.error("lazy node %s: checkpoint line fails its CRC; "
                      "treating the node as unknown until it "
                      "re-annotates", name)
            self._names_cache = None  # the node SET just shrank
            self._drop_lazy_fd_locked()
            return None
        doc = json.loads(raw.decode("utf-8"))
        if "anno" in doc:
            # a checkpoint line captured from a still-lazy bulk-ingest
            # node carries the RAW annotations (never decoded by the
            # capturing process) — decode on touch, same as the
            # in-memory lazy store it round-tripped from
            self._drop_lazy_fd_locked()
            return self._materialize_payload_locked(
                name,
                (doc["anno"] or {}).get(codec.ANNO_NODE_TOPOLOGY, ""),
                dict(doc["anno"] or {}), doc["slice"],
            )
        mesh = self._slices[sid].mesh
        view = _view_from_doc(doc, mesh)
        for alloc in self._lazy_allocs.pop(name, ()):
            # re-apply the restored occupancy exactly as the eager
            # restore would; materialization changes NOTHING observable
            # (the same content was reachable through the lazy doc), so
            # no epoch moves — the seeded snapshot stays valid
            view.add_ids(alloc.device_ids)  # tpukube: allow(epoch-discipline) materialization promotes equivalent state; nothing observable changes, so the snapshot must NOT invalidate
        self._nodes[name] = view  # tpukube: allow(epoch-discipline) see above — cache promotion, not a mutation
        self._drop_lazy_fd_locked()
        return view

    def _drop_lazy_fd_locked(self) -> None:
        """Close the checkpoint fd once nothing lazy remains."""
        if not self._lazy_index and self._lazy_fd is not None:
            try:
                os.close(self._lazy_fd)
            except OSError:
                pass
            self._lazy_fd = None

    def _materialize_payload_locked(
        self, name: str, payload: str, annotations: dict[str, str],
        sid: str,
    ) -> Optional[NodeView]:
        """Materialize one bulk-ingested lazy node from its retained
        annotations (callers hold ``self._lock``; the entry is already
        popped). This is the deferred half of an ingest the probe
        already validated, so a failure here is pathological and
        degrades the node to 'unknown' (its next re-annotation
        re-registers it) exactly like a CRC-failing checkpoint line."""
        del sid
        try:
            info, _mesh = codec.decode_node_topology(payload)
        except codec.CodecError as e:
            log.error("lazy node %s: retained payload fails its full "
                      "decode (%s); treating the node as unknown until "
                      "it re-annotates", name, e)
            self._names_cache = None  # the node SET just shrank
            return None
        if info.name != name:
            log.error("lazy node %s: retained payload names %r; "
                      "treating the node as unknown", name, info.name)
            self._names_cache = None
            return None
        info.annotations = dict(annotations)
        summary = None
        raw_summary = annotations.get(codec.ANNO_HEALTH_SUMMARY)
        if raw_summary:
            try:
                summary = codec.decode_health_summary(raw_summary)
            except codec.CodecError as e:
                # same tolerance as the eager upsert path: a malformed
                # summary never rejects the topology
                log.warning("node %s: undecodable health summary: %s",
                            name, e)
        view = NodeView(info=info, raw_payload=payload,
                        health_summary=summary)
        for alloc in self._lazy_allocs.pop(name, ()):
            # checkpoint-restored occupancy re-applies exactly as the
            # eager restore would; materialization changes NOTHING
            # observable, so no epoch moves (see _view_locked)
            view.add_ids(alloc.device_ids)  # tpukube: allow(epoch-discipline) materialization promotes equivalent state; nothing observable changes, so the snapshot must NOT invalidate
        self._nodes[name] = view  # tpukube: allow(epoch-discipline) see above — cache promotion, not a mutation
        return view

    def _materialize_slice_locked(self, slice_id: Optional[str]) -> None:
        """Materialize every lazy node of one slice (None = all) ahead
        of a whole-slice scan (occupied_coords and friends)."""
        if not self._lazy_index and not self._lazy_payloads:
            return
        for name in [
            n for n, e in self._lazy_index.items()
            if slice_id is None or e[3] == slice_id
        ]:
            self._view_locked(name)
        for name in [
            n for n, e in self._lazy_payloads.items()
            if slice_id is None or e[2] == slice_id
        ]:
            self._view_locked(name)

    def retire(self) -> None:
        """Stop background warming for good (the owner crashed or shut
        down; an orphaned ledger must not keep materializing)."""
        with self._lock:
            self._retired = True

    def lazy_fd_dup(self) -> Optional[int]:
        """A dup of the open checkpoint fd while lazy nodes remain
        (None otherwise) — checkpoint captures hand it to the journal's
        drain thread so ``("ref", ...)`` entries stay readable even if
        the last lazy node materializes (closing the original) before
        the write lands. The caller owns the dup."""
        with self._lock:
            if self._lazy_fd is None or not self._lazy_index:
                return None
            return os.dup(self._lazy_fd)

    def payload_matches(self, name: str, payload: str) -> bool:
        """True when the node's stored topology payload equals
        ``payload`` — WITHOUT materializing a lazy node (recovery's
        reconcile compares every node; only divergent ones may cost
        anything). Lazy checkpoint entries compare by (crc32, length)."""
        with self._lock:
            return self._payload_matches_locked(name, payload)

    def _payload_matches_locked(self, name: str, payload: str) -> bool:
        view = self._nodes.get(name)
        if view is not None:
            return view.raw_payload == payload
        lazy = self._lazy_payloads.get(name)
        if lazy is not None:
            return lazy[0] == payload
        entry = self._lazy_index.get(name)
        if entry is None:
            return False
        raw = payload.encode("utf-8")
        return entry[4] == zlib.crc32(raw) and entry[5] == len(raw)

    def nodes_matching_payloads(
        self, payloads: dict[str, str]
    ) -> set[str]:
        """The names whose stored payload equals the given one, in ONE
        lock round-trip (the recovery reconcile compares the whole
        fleet; 10k separate lock acquisitions were a measurable slice
        of restart-to-serving). Lazy nodes stay lazy."""
        with self._lock:
            nodes = self._nodes
            lazy = self._lazy_index
            crc32 = zlib.crc32
            out: set[str] = set()
            lazy_payloads = self._lazy_payloads
            for name, payload in payloads.items():
                view = nodes.get(name)
                if view is not None:
                    if view.raw_payload == payload:
                        out.add(name)
                    continue
                entry2 = lazy_payloads.get(name)
                if entry2 is not None:
                    if entry2[0] == payload:
                        out.add(name)
                    continue
                entry = lazy.get(name)
                if entry is None:
                    continue
                raw = payload.encode("utf-8")
                if entry[4] == crc32(raw) and entry[5] == len(raw):
                    out.add(name)
            return out

    def _hosts_locked(self, sl: SliceView) -> dict[TopologyCoord, str]:
        """The slice's coord->host map, expanding a checkpoint
        restore's compact pending blob on first touch."""
        if sl.pending_hosts is not None:
            blob, sl.pending_hosts = sl.pending_hosts, None
            hosts = sl.host_by_coord
            for part in blob.split(";"):
                if not part:
                    continue
                coord, _, host = part.partition("=")
                x, y, z = coord.split(",")
                hosts[TopologyCoord(int(x), int(y), int(z))] = host
        return sl.host_by_coord

    # -- node ingestion ----------------------------------------------------
    def upsert_node(self, name: str, annotations: dict[str, str]) -> bool:
        """Decode and store a node's topology annotation. Returns False when
        the node carries no tpukube annotation (not ours to manage)."""
        payload = annotations.get(codec.ANNO_NODE_TOPOLOGY)
        if payload is None:
            return False
        if self.payload_matches(name, payload):
            # unchanged annotation: keep the stored view (a LAZY node
            # compares by crc+length and stays unmaterialized — the
            # hot webhook resend path must not force the fleet in)
            return True
        decoded = codec.node_from_annotations(name, annotations)
        if decoded is None:
            return False
        info, mesh = decoded
        summary = None
        raw_summary = annotations.get(codec.ANNO_HEALTH_SUMMARY)
        if raw_summary:
            try:
                summary = codec.decode_health_summary(raw_summary)
            except codec.CodecError as e:
                # a malformed summary must not reject the topology —
                # the rollup simply falls back to chip health
                log.warning("node %s: undecodable health summary: %s",
                            name, e)
        with self._lock:
            prev = self._view_locked(name)
            if (prev is not None
                    and prev.info.slice_id == info.slice_id
                    and _health_only_change(prev.info, info)):
                # HEALTH-ONLY re-annotation (the health watch's steady
                # churn shape): same chips, same links, same sharing
                # mode — only per-chip health flipped. Emit an
                # O(chips-per-node) snapshot delta instead of the
                # full-rebuild marker a changed payload used to cost
                # (at 40k chips a health flap
                # forced a ~50ms rebuild; WAL replay of health churn
                # degenerated to full rebuilds the same way). The
                # coord->host map is untouched (coords identical), so
                # the claim-validation walk and host-map rewrite of the
                # structural path are skipped too.
                self._apply_health_only_locked(
                    name, prev, info, payload, summary, annotations)
                return True
            sl = self._slices.get(info.slice_id)
            if sl is None:
                sl = self._slices[info.slice_id] = SliceView(mesh=mesh)
                # the slice set feeds snapshot.slice_ids(): bump at the
                # seam itself, not only at the end of the upsert — the
                # validation raises below must not leave a registered
                # slice invisible to the epoch cache (found by
                # tpukube-lint's epoch-discipline pass)
                self._epoch += 1
                # a new slice is structural: the delta path cannot
                # patch a slice the base snapshot never held
                self._note_delta_locked(full=True,
                                 why=f"slice {info.slice_id} registered")
            elif sl.mesh != mesh:
                raise StateError(
                    f"node {name} reports mesh {mesh.dims} for slice "
                    f"{info.slice_id}, which has {sl.mesh.dims} — nodes of "
                    f"one slice must agree on its geometry"
                )
            prev = self._nodes.get(name)
            if prev is not None and prev.info.slice_id != info.slice_id:
                # tpukube: allow(seam-triple) a slice registered by an upsert that then fails validation holds no nodes; the WAL only records successful upserts, so a restart simply never sees the empty slice
                raise StateError(
                    f"node {name} moved from slice {prev.info.slice_id} "
                    f"to {info.slice_id} — drop and re-add the node"
                )
            if (
                prev is not None
                and prev.used_ids
                and prev.info.shares_per_chip != info.shares_per_chip
            ):
                # a sharing-mode switch under live allocations cannot be
                # accounted (committed ids carry the OLD mode's weights;
                # mixing modes double-books chips) — drain the node first
                # tpukube: allow(seam-triple) failed-validation raise: the registered-but-empty slice is deliberately not journaled (records land on success only)
                raise StateError(
                    f"node {name} changed shares_per_chip "
                    f"{prev.info.shares_per_chip} -> {info.shares_per_chip} "
                    f"with {len(prev.used_ids)} live allocations — drain "
                    f"the node before switching sharing mode"
                )
            # validate EVERY claim before mutating anything: a partial
            # apply would leave phantom claims with no owner on error
            hosts = self._hosts_locked(sl)
            for chip in info.chips:
                claimed = hosts.get(chip.coord)
                if claimed is not None and claimed != name:
                    # tpukube: allow(seam-triple) failed-validation raise: the registered-but-empty slice is deliberately not journaled (records land on success only)
                    raise StateError(
                        f"nodes {claimed} and {name} both claim chip "
                        f"{tuple(chip.coord)} in slice {info.slice_id}"
                    )
            if prev is not None:
                for chip in prev.info.chips:
                    if hosts.get(chip.coord) == name:
                        del hosts[chip.coord]
            for chip in info.chips:
                hosts[chip.coord] = name
            sl.hosts_blob = None
            self._hosts_cache.pop(info.slice_id, None)
            view = NodeView(info=info, raw_payload=payload,
                            health_summary=summary)
            if prev is not None:
                view.used_ids = prev.used_ids
                view.share_counts = prev.share_counts
                view.id_weights = prev.id_weights
            else:
                # the node SET changed: the cached name tuple is stale
                self._names_cache = None
            self._nodes[name] = view
            # incremental occupied maintenance for the structural path:
            # ONE node's old contribution leaves, its new one enters —
            # O(chips-per-node), so the full-rebuild the marker below
            # forces stops walking every OTHER view of the slice
            occ_old = tuple(
                c.coord for c in prev.info.chips
                if c.health is not Health.HEALTHY
                or prev.used_share_count(c.index) > 0
            ) if prev is not None else ()
            occ_new = tuple(
                c.coord for c in info.chips
                if c.health is not Health.HEALTHY
                or view.used_share_count(c.index) > 0
            )
            self._occ_apply_locked(info.slice_id, add=occ_new,
                                   remove=occ_old)
            # ... and the same one-node-out/one-node-in transition for
            # the unhealthy/broken/share caches
            used_old, total_old = (self._view_share_counts(prev)
                                   if prev is not None else (0, 0))
            used_new, total_new = self._view_share_counts(view)
            self._aux_apply_locked(
                info.slice_id,
                unhealthy_add=tuple(
                    c.coord for c in info.chips
                    if c.health is not Health.HEALTHY
                ),
                unhealthy_remove=tuple(
                    c.coord for c in prev.info.chips
                    if c.health is not Health.HEALTHY
                ) if prev is not None else (),
                broken_add=tuple(set(info.bad_links)),
                broken_remove=(tuple(set(prev.info.bad_links))
                               if prev is not None else ()),
                used_delta=used_new - used_old,
                total_delta=total_new - total_old,
            )
            self._epoch += 1
            # a STRUCTURALLY changed node payload may move links,
            # topology, or sharing mode — all structural for the
            # snapshot (they shift broken sets and the share totals the
            # delta math assumes constant): full-rebuild marker. The
            # unchanged-payload early return above keeps the hot
            # webhook resend path bump- and delta-free, and the
            # health-only path above keeps health churn O(chips/node).
            self._note_delta_locked(full=True, why=f"node {name} re-annotated")
            self._note_journal_locked(
                "node", {"n": name, "anno": dict(annotations)})
        return True

    def _apply_health_only_locked(
        self, name: str, prev: NodeView, info: NodeInfo, payload: str,
        summary: Optional[dict], annotations: dict[str, str],
    ) -> None:
        """Apply a health-only re-annotation (see upsert_node): swap the
        node view and emit the per-chip transition delta — occupied and
        unhealthy set moves plus the healthy-share capacity change the
        slice's utilization integers carry. Callers hold ``self._lock``
        and have verified ``_health_only_change``."""
        n = prev.shares_per_chip
        occupied_add: list[TopologyCoord] = []
        occupied_remove: list[TopologyCoord] = []
        unhealthy_add: list[TopologyCoord] = []
        unhealthy_remove: list[TopologyCoord] = []
        used_d = total_d = 0
        for old_chip, new_chip in zip(prev.info.chips, info.chips):
            if old_chip.health is new_chip.health:
                continue
            # counted shares on this chip (slice_share_counts caps at n)
            cnt = min(n, prev.used_share_count(new_chip.index))
            if new_chip.health is not Health.HEALTHY:
                unhealthy_add.append(new_chip.coord)
                total_d -= n
                used_d -= cnt
                if cnt == 0:
                    # a free chip turning sick ENTERS occupied (health
                    # holds it); a chip with live shares was there already
                    occupied_add.append(new_chip.coord)
            else:
                unhealthy_remove.append(new_chip.coord)
                total_d += n
                used_d += cnt
                if cnt == 0:
                    occupied_remove.append(new_chip.coord)
        view = NodeView(info=info, raw_payload=payload,
                        health_summary=summary)
        view.used_ids = prev.used_ids
        view.share_counts = prev.share_counts
        view.id_weights = prev.id_weights
        self._nodes[name] = view
        self._occ_apply_locked(info.slice_id, add=tuple(occupied_add),
                               remove=tuple(occupied_remove))
        self._aux_apply_locked(
            info.slice_id,
            unhealthy_add=tuple(unhealthy_add),
            unhealthy_remove=tuple(unhealthy_remove),
            # links are untouched on a health-only change by definition
            used_delta=used_d, total_delta=total_d,
        )
        self._epoch += 1
        self._note_delta_locked(
            slice_id=info.slice_id,
            occupied_add=tuple(occupied_add),
            occupied_remove=tuple(occupied_remove),
            used_shares_delta=used_d,
            unhealthy_add=tuple(unhealthy_add),
            unhealthy_remove=tuple(unhealthy_remove),
            total_shares_delta=total_d,
            why=f"node {name} health re-annotated",
        )
        self._note_journal_locked(
            "node", {"n": name, "anno": dict(annotations)})

    # -- bulk cold-start ingestion -------------------------------------------
    def ingest_nodes(self, items: list[dict]) -> list:
        """Fleet-scale node ingest fast path. Each item is ``{"name":
        ..., "annotations": {...}}``; the result list matches the
        per-item ``upsert_node`` decision responses positionally
        (``{"ours": bool}`` or ``{"error": str}``).

        Semantics match per-item upserts — the parity suite proves the
        resulting ledger/host/occupancy state identical — but the cost
        model is the cold start's: payloads are PROBED (validated +
        host-mapped) without building NodeView objects, the decoded
        views materialize lazily on first touch exactly like the
        checkpoint restore's, the per-slice incremental coord/share
        caches are seeded from the probe aggregates (so the first
        snapshot rebuild is O(slices), not O(fleet)), and the
        epoch/delta/journal seam fires ONCE per batch instead of per
        node. Items naming an already-known node with a CHANGED payload
        are routed through the legacy per-node path (its health-only
        delta and occupancy carry-over semantics own that shape)."""
        t0 = time.perf_counter()
        results: list = [None] * len(items)
        slow: list[int] = []
        with self._lock:
            # phase 1 — probe + validate: reads only, nothing mutated,
            # so a bad item errors without a partial apply
            staged: list[tuple] = []  # (pos, name, payload, annos, probe)
            mesh_memo: dict = {}  # one mesh decode per distinct fragment
            new_slices: dict[str, MeshSpec] = {}
            staged_hosts: dict[str, dict[TopologyCoord, str]] = {}
            agg: dict[str, dict] = {}  # sid -> batch aggregates
            # hot-loop locals (this loop runs per node of the fleet)
            nodes_get = self._nodes.get
            lazyp_get = self._lazy_payloads.get
            lazy_index = self._lazy_index
            slices_get = self._slices.get
            anno_key = codec.ANNO_NODE_TOPOLOGY
            # per-sid (live_hosts, live_get, batch_hosts, agg entry):
            # resolved once per slice, not once per node
            slice_ctx: dict[str, tuple] = {}
            staged_payloads: dict[str, str] = {}  # name staged earlier
            for pos, item in enumerate(items):
                name = item["name"]
                annotations = dict(item.get("annotations") or {})
                payload = annotations.get(anno_key)
                if payload is None:
                    results[pos] = {"ours": False}
                    continue
                view = nodes_get(name)
                if view is not None:
                    if view.raw_payload == payload:
                        self._decode_hits += 1
                        results[pos] = {"ours": True}
                    else:
                        slow.append(pos)
                    continue
                lazy = lazyp_get(name)
                if lazy is not None:
                    if lazy[0] == payload:
                        self._decode_hits += 1
                        results[pos] = {"ours": True}
                    else:
                        slow.append(pos)
                    continue
                if name in lazy_index:
                    if self._payload_matches_locked(name, payload):
                        self._decode_hits += 1
                        results[pos] = {"ours": True}
                    else:
                        slow.append(pos)
                    continue
                earlier = staged_payloads.get(name)
                if earlier is not None:
                    # the SAME node twice in one batch: the per-node
                    # path's second upsert answers unchanged-payload
                    # True / runs the re-annotation path — match it
                    # (the name-string identity trick below only
                    # covers claims within ONE item)
                    if earlier == payload:
                        self._decode_hits += 1
                        results[pos] = {"ours": True}
                    else:
                        slow.append(pos)
                    continue
                self._decode_misses += 1
                try:
                    probe = _probe_node_payload(name, payload,
                                                mesh_memo)
                except codec.CodecError as e:
                    results[pos] = {"error": str(e)}
                    continue
                sid = probe["slice"]
                mesh = probe["mesh"]
                ctx = slice_ctx.get(sid)
                if ctx is None:
                    sl = slices_get(sid)
                    live_hosts = (self._hosts_locked(sl)
                                  if sl is not None else {})
                    a = agg[sid] = {"unhealthy": set(), "links": {},
                                    "total": 0}
                    batch_hosts = staged_hosts[sid] = {}
                    ctx = slice_ctx[sid] = (
                        sl.mesh if sl is not None else None,
                        live_hosts, live_hosts.get,
                        batch_hosts, batch_hosts.setdefault, a,
                    )
                (live_mesh, live_hosts, live_get,
                 batch_hosts, bh_setdefault, a) = ctx
                have_mesh = (live_mesh if live_mesh is not None
                             else new_slices.get(sid))
                # identity first: the memo hands every node of a
                # homogeneous fleet the SAME MeshSpec object, so the
                # dataclass __eq__ runs only on genuine disagreement
                if (have_mesh is not None and have_mesh is not mesh
                        and have_mesh != mesh):
                    results[pos] = {"error": (
                        f"node {name} reports mesh {mesh.dims} for "
                        f"slice {sid}, which has {have_mesh.dims} — "
                        f"nodes of one slice must agree on its geometry"
                    )}
                    continue
                # validate-and-stage in ONE pass (this loop runs per
                # chip of the whole fleet): setdefault stages the claim
                # unless someone staged it first; a conflict unwinds
                # this node's own staged claims (rare) and errors with
                # the per-node path's message. An empty live map (the
                # cold start) skips its per-coord probe entirely.
                claimed_by = None
                if live_hosts:
                    for coord in probe["coords"]:
                        claimed_by = live_get(coord)
                        if claimed_by is None:
                            owner = bh_setdefault(coord, name)
                            if owner is name:
                                continue
                            claimed_by = owner
                        break
                else:
                    for coord in probe["coords"]:
                        owner = bh_setdefault(coord, name)
                        if owner is not name:
                            claimed_by = owner
                            break
                if claimed_by is not None:
                    results[pos] = {"error": (
                        f"nodes {claimed_by} and {name} both claim "
                        f"chip {tuple(coord)} in slice {sid}"
                    )}
                    for coord in probe["coords"]:
                        if batch_hosts.get(coord) is name:
                            del batch_hosts[coord]
                    continue
                if have_mesh is None:
                    new_slices[sid] = mesh
                if probe["unhealthy"]:
                    a["unhealthy"].update(probe["unhealthy"])
                if probe["links"]:
                    for link in set(probe["links"]):
                        a["links"][link] = a["links"].get(link, 0) + 1
                a["total"] += probe["shares"] * probe["healthy_chips"]
                staged_payloads[name] = payload
                staged.append((pos, name, payload, annotations, probe))
            # phase 2 — apply: straight-line mutations, no raises, one
            # deferred epoch/delta/journal seam for the whole batch
            if staged:
                for sid, mesh in new_slices.items():
                    self._slices[sid] = SliceView(mesh=mesh)
                for pos, name, payload, annotations, probe in staged:
                    self._lazy_payloads[name] = (
                        payload, annotations, probe["slice"])
                    results[pos] = {"ours": True}
                for sid, batch_hosts in staged_hosts.items():
                    if not batch_hosts:
                        continue
                    sl = self._slices[sid]
                    self._hosts_locked(sl).update(batch_hosts)
                    sl.hosts_blob = None
                    self._hosts_cache.pop(sid, None)
                    a = agg[sid]
                    if sid in new_slices:
                        # a slice born in this batch is COMPLETE
                        # information: seed the incremental caches so
                        # the first reader never pays the O(slice)
                        # walk that would materialize the lazy fleet
                        self._occ_cache[sid] = set(a["unhealthy"])
                        self._unhealthy_cache[sid] = set(a["unhealthy"])
                        self._broken_cache[sid] = dict(a["links"])
                        self._share_cache[sid] = [0, a["total"]]
                    else:
                        # appending NEW nodes to a live slice: advance
                        # already-seeded caches by the batch aggregates
                        # (fresh nodes hold no shares — pure adds)
                        self._occ_apply_locked(
                            sid, add=tuple(a["unhealthy"]))
                        self._aux_apply_locked(
                            sid,
                            unhealthy_add=tuple(a["unhealthy"]),
                            broken_add=tuple(
                                link for link, n in a["links"].items()
                                for _ in range(n)
                            ),
                            total_delta=a["total"],
                        )
                self._names_cache = None
                self._epoch += 1
                self._note_delta_locked(
                    full=True, why=f"bulk ingest ({len(staged)} nodes)")
                # the note itself no-ops without a journal; the ternary
                # only skips building the O(batch) items list
                self._note_journal_locked("nodes", {"items": [
                    [name, annotations]
                    for _, name, _, annotations, _ in staged
                ] if self._journal is not None else []})
                self.ingest_nodes_total += len(staged)
            self.ingest_batches += 1
            dt = time.perf_counter() - t0
            self._ingest_seconds.append(dt)
            self.ingest_seconds_total += dt
        # known-node changed payloads run the legacy per-node path
        # OUTSIDE the batch lock hold (upsert_node re-acquires; the
        # per-node seams own health-only deltas and occupancy carry)
        for pos in slow:
            item = items[pos]
            try:
                results[pos] = {"ours": self.upsert_node(
                    item["name"], dict(item.get("annotations") or {})
                )}
            except (codec.CodecError, StateError) as e:
                results[pos] = {"error": str(e)}
        return results

    def ingest_stats(self) -> dict:
        """The /statusz "ingest" section: batch counters, decode-cache
        hit rate, and the lazy backlog still awaiting materialization."""
        with self._lock:
            decode = self._decode_hits + self._decode_misses
            last = (self._ingest_seconds[-1]
                    if self._ingest_seconds else None)
            return {
                "nodes_total": self.ingest_nodes_total,
                "batches": self.ingest_batches,
                "seconds_total": round(self.ingest_seconds_total, 6),
                "last_batch_s": (round(last, 6)
                                 if last is not None else None),
                "decode_cache_hits": self._decode_hits,
                "decode_cache_misses": self._decode_misses,
                "decode_cache_hit_rate": (
                    round(self._decode_hits / decode, 4)
                    if decode else None
                ),
                "lazy_pending": (len(self._lazy_index)
                                 + len(self._lazy_payloads)),
            }

    def ingest_seconds_snapshot(self) -> list[float]:
        """Copy of the per-batch ingest-wall window (the /metrics
        summary's values_fn)."""
        with self._lock:
            return list(self._ingest_seconds)

    def warm_pending(self, limit: int = 512) -> int:
        """Materialize up to ``limit`` lazy nodes (checkpoint-restored,
        then bulk-ingested); returns how many remain. Batched so the
        warmer never holds the ledger lock long."""
        with self._lock:
            if self._retired:
                return 0
            batch = list(self._lazy_index)[:limit]
            if len(batch) < limit:
                batch += list(self._lazy_payloads)[:limit - len(batch)]
            for name in batch:
                self._view_locked(name)
            return len(self._lazy_index) + len(self._lazy_payloads)

    def maybe_start_warmer(self) -> None:
        """Start (at most one) background materializer draining the lazy
        store in batches, so the serving path rarely meets a cold node
        and the ingest does not pay the fleet's decode up front."""
        with self._lock:
            if (self._warming or self._retired
                    or not (self._lazy_index or self._lazy_payloads)):
                return
            self._warming = True

        def run() -> None:
            try:
                # a brief head start for the caller's epilogue: warming
                # is strictly background work
                time.sleep(0.05)
                while self.warm_pending(512):
                    pass
            finally:
                with self._lock:
                    self._warming = False

        threading.Thread(target=run, daemon=True,
                         name="tpukube-ingest-warmer").start()

    # -- cordon / decommission (the drain plane) -----------------------------
    def cordoned_nodes(self) -> frozenset:
        """The cordoned node-name set as a frozen copy (one lock
        round-trip for per-request membership checks)."""
        with self._lock:
            return frozenset(self._cordoned)

    def is_cordoned(self, name: str) -> bool:
        with self._lock:
            return name in self._cordoned

    def set_cordon(self, names, cordoned: bool = True) -> list[str]:
        """Cordon (or uncordon) known nodes: their chips leave every
        placement sweep while live allocations keep serving. Unknown
        names are ignored (idempotent — WAL replay may re-apply a
        cordon whose nodes were since removed). Returns the names
        whose state actually changed; one epoch/delta/journal seam per
        changed batch, none when nothing changed."""
        with self._lock:
            # decide first, mutate second: the set write and the epoch
            # bump share every exit path
            changed: list[str] = []
            for name in names:
                if self._slice_of_any_locked(name) is None:
                    continue
                if (name in self._cordoned) != cordoned:
                    changed.append(name)
            if not changed:
                return changed
            if cordoned:
                self._cordoned.update(changed)
            else:
                self._cordoned.difference_update(changed)
            self._epoch += 1
            # a cordon moves whole nodes in/out of the placement mask —
            # structural for the snapshot (rare by design: one marker
            # per drain act, not per chip)
            self._note_delta_locked(
                full=True,
                why=(f"{'cordon' if cordoned else 'uncordon'} "
                     f"{len(changed)} node(s)"))
            self._note_journal_locked(
                "cordon", {"n": sorted(changed), "c": bool(cordoned)})
            return changed

    def _slice_of_any_locked(self, name: str) -> Optional[str]:
        """The slice of a known node, materialized or lazy (None for an
        unknown name); callers hold ``self._lock``."""
        view = self._nodes.get(name)
        if view is not None:
            return view.info.slice_id
        lazy = self._lazy_payloads.get(name)
        if lazy is not None:
            return lazy[2]
        entry = self._lazy_index.get(name)
        return entry[3] if entry is not None else None

    def cordoned_coords(self, slice_id: Optional[str] = None):
        """Chip coords of cordoned nodes in one slice — derived on
        demand (cordons are rare and small; no incremental cache to
        keep honest, so the snapshot's normal build and its audit
        sentinel share this one derivation)."""
        with self._lock:
            sid = self._resolve_sid_locked(slice_id)
            out: set[TopologyCoord] = set()
            if sid is None or not self._cordoned:
                return out
            for name in self._cordoned:
                if self._slice_of_any_locked(name) != sid:
                    continue
                view = self._view_locked(name)
                if view is not None:
                    out.update(c.coord for c in view.info.chips)
            return out

    # -- geometry mask -------------------------------------------------------
    def absent_coords(self, slice_id: Optional[str] = None):
        """Chip coords of the slice's geometry with NO live host claim —
        capacity that left (un-ingest, spot churn) or never arrived (a
        recovery rebuilt from a partially-advertised fleet). Without
        this mask a shrunken slice's departed chips would read as FREE
        in every sweep (phantom capacity: a 16-chip reservation
        "fitting" a 12-chip slice). Derived from the coord->host claim
        map, which every ingest/upsert/remove seam already maintains —
        one derivation shared by the snapshot's normal build and its
        audit sentinel (nothing incremental to keep honest), exactly
        the ``cordoned_coords`` contract. The fully-claimed common case
        is an O(1) length check; only a partially-populated slice pays
        the geometry enumeration."""
        with self._lock:
            sid = self._resolve_sid_locked(slice_id)
            if sid is None:
                return set()
            sl = self._slices.get(sid)
            if sl is None:
                return set()
            hosts = self._hosts_locked(sl)
            if len(hosts) >= sl.mesh.num_chips:
                return set()
            return {c for c in sl.mesh.all_coords() if c not in hosts}

    def remove_nodes(self, names) -> dict:
        """Un-ingest: the inverse of ``ingest_nodes``. Phase 1 probes (a
        node with live allocations is SKIPPED loudly — drain it first;
        unknown names are ignored for replay idempotence), phase 2 drops
        the views/lazy payloads/lazy index entries, clears the host-map
        claims, retires the per-slice incremental caches (the next
        reader re-seeds with one walk — never a full rebuild here), and
        deletes slices left empty. ONE epoch bump + one delta + one
        journal record per batch, the ingest seam's shape. Returns
        ``{"removed": [...], "skipped": {...}, "slices_dropped":
        [...]}``."""
        with self._lock:
            live: set[str] = {a.node_name for a in self._allocs.values()}
            removed: list[str] = []
            skipped: dict[str, str] = {}
            by_slice: dict[str, list[str]] = {}
            for name in names:
                if name in live:
                    skipped[name] = "live allocations"
                    log.error(
                        "remove_nodes: %s still serves live "
                        "allocations — drain it first; skipped", name)
                    continue
                sid = self._slice_of_any_locked(name)
                if sid is None:
                    continue  # unknown: replay idempotence
                removed.append(name)
                by_slice.setdefault(sid, []).append(name)
            if not removed:
                return {"removed": [], "skipped": skipped,
                        "slices_dropped": []}
            gone = set(removed)
            for name in removed:
                self._nodes.pop(name, None)
                self._lazy_payloads.pop(name, None)
                self._lazy_index.pop(name, None)
                self._lazy_allocs.pop(name, None)
                self._cordoned.discard(name)
            dropped: list[str] = []
            for sid in by_slice:
                sl = self._slices.get(sid)
                if sl is None:
                    continue
                hosts = self._hosts_locked(sl)
                for coord in [c for c, h in hosts.items() if h in gone]:
                    del hosts[coord]
                sl.hosts_blob = None
                self._hosts_cache.pop(sid, None)
                # the departed views' contributions to the slice's
                # incremental caches are unknown without materializing
                # them: RETIRE the caches, the next reader re-seeds
                # with one walk
                self._occ_cache.pop(sid, None)
                self._unhealthy_cache.pop(sid, None)
                self._broken_cache.pop(sid, None)
                self._share_cache.pop(sid, None)
                if not hosts:
                    # every claim left with the batch: the slice is
                    # empty — drop it (a future arrival re-registers)
                    dropped.append(sid)
                    del self._slices[sid]
            self._drop_lazy_fd_locked()
            self._names_cache = None
            self.removed_nodes_total += len(removed)
            self.removed_batches += 1
            self._epoch += 1
            self._note_delta_locked(
                full=True, why=f"un-ingest ({len(removed)} nodes)")
            self._note_journal_locked(
                "unnodes", {"n": sorted(removed)})
            return {"removed": removed, "skipped": skipped,
                    "slices_dropped": dropped}

    # -- views -------------------------------------------------------------
    @property
    def mesh(self) -> Optional[MeshSpec]:
        """The sole slice's mesh (single-slice clusters). None before any
        node is known; StateError when several slices exist — callers on a
        multi-slice cluster must name the slice (slice_mesh)."""
        with self._lock:
            if not self._slices:
                return None
            if len(self._slices) > 1:
                raise StateError(
                    f"cluster has {len(self._slices)} slices; use "
                    f"slice_mesh(slice_id)"
                )
            return next(iter(self._slices.values())).mesh

    def slice_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._slices)

    def slice_mesh(self, slice_id: str) -> MeshSpec:
        with self._lock:
            sl = self._slices.get(slice_id)
            if sl is None:
                raise StateError(f"unknown slice {slice_id!r}")
            return sl.mesh

    def host_at(self, slice_id: str, coord: TopologyCoord) -> Optional[str]:
        """Node owning a chip coord within a slice (annotation-derived)."""
        with self._lock:
            sl = self._slices.get(slice_id)
            if sl is None:
                return None
            return self._hosts_locked(sl).get(coord)

    def hosts_by_coord(self, slice_id: str) -> dict[TopologyCoord, str]:
        """Snapshot of a slice's coord->node map — one lock round-trip for
        callers that look up many coords (the per-node gang hot path).
        The returned dict is a shared frozen snapshot: do NOT mutate it."""
        with self._lock:
            cached = self._hosts_cache.get(slice_id)
            if cached is not None:
                return cached
            sl = self._slices.get(slice_id)
            snap = dict(self._hosts_locked(sl)) if sl is not None else {}
            self._hosts_cache[slice_id] = snap
            return snap

    def slice_of_node(self, name: str) -> Optional[str]:
        with self._lock:
            view = self._nodes.get(name)
            if view is not None:
                return view.info.slice_id
            lazy = self._lazy_payloads.get(name)
            if lazy is not None:
                return lazy[2]
            entry = self._lazy_index.get(name)
            return entry[3] if entry is not None else None

    def node(self, name: str) -> Optional[NodeView]:
        with self._lock:
            return self._view_locked(name)

    def node_names(self) -> tuple[str, ...]:
        """Sorted node names as a SHARED frozen tuple, cached until the
        node set itself changes (per-cycle callers — the batch planner,
        /healthz, statusz — must not pay an O(fleet) sort-and-copy for
        a set that moves only when nodes register)."""
        with self._lock:
            names = self._names_cache
            if names is None:
                names = self._names_cache = tuple(sorted(
                    set(self._nodes) | set(self._lazy_index)
                    | set(self._lazy_payloads)
                ))
            return names

    def _slice_views_locked(self, slice_id: Optional[str]) -> list[NodeView]:
        """Node views of one slice — or of the WHOLE cluster only when it is
        single-slice (mixing coord sets across slices would be meaningless;
        raise instead). Callers hold ``self._lock`` (the ``_locked``
        naming is the contract tpukube-lint's shared-state pass keys on)."""
        if slice_id is None and len(self._slices) > 1:
            raise StateError(
                "coord sets are slice-local; pass slice_id on a "
                f"{len(self._slices)}-slice cluster"
            )
        # a whole-slice scan needs every view, including lazily-restored
        # ones (the background warmer usually got here first)
        self._materialize_slice_locked(slice_id)
        return [
            v for v in self._nodes.values()
            if slice_id is None or v.info.slice_id == slice_id
        ]

    def _occ_apply_locked(self, slice_id: str,
                          add: tuple = (), remove: tuple = ()) -> None:
        """Advance the slice's incremental occupied set by the same
        transition tuples the snapshot delta for this seam carries
        (callers hold ``self._lock``). Unseeded slices stay unseeded —
        the first reader pays the walk once."""
        cached = self._occ_cache.get(slice_id)
        if cached is None:
            return
        cached.difference_update(remove)
        cached.update(add)

    def _aux_apply_locked(self, slice_id: str, *,
                          unhealthy_add: tuple = (),
                          unhealthy_remove: tuple = (),
                          broken_add: tuple = (),
                          broken_remove: tuple = (),
                          used_delta: int = 0,
                          total_delta: int = 0) -> None:
        """Advance the slice's incremental unhealthy/broken/share-count
        caches by one seam's transitions (callers hold ``self._lock``;
        same contract as ``_occ_apply_locked`` — unseeded slices stay
        unseeded, the first reader pays the walk once). ``broken_*``
        are per-VIEW link report transitions: the count map tracks how
        many node views currently report each canonical link."""
        unhealthy = self._unhealthy_cache.get(slice_id)
        if unhealthy is not None:
            unhealthy.difference_update(unhealthy_remove)
            unhealthy.update(unhealthy_add)
        counts = self._broken_cache.get(slice_id)
        if counts is not None:
            for link in broken_remove:
                n = counts.get(link, 0) - 1
                if n <= 0:
                    counts.pop(link, None)
                else:
                    counts[link] = n
            for link in broken_add:
                counts[link] = counts.get(link, 0) + 1
        shares = self._share_cache.get(slice_id)
        if shares is not None:
            shares[0] += used_delta
            shares[1] += total_delta

    @staticmethod
    def _view_share_counts(view: NodeView) -> tuple[int, int]:
        """One view's (used, total) share contribution over its healthy
        chips — the per-node term both the walk and the structural-
        upsert transition math use."""
        n = view.shares_per_chip
        used = total = 0
        for chip in view.info.chips:
            if chip.health is Health.HEALTHY:
                total += n
                used += min(n, view.used_share_count(chip.index))
        return used, total

    def _walk_occupied_locked(
        self, slice_id: Optional[str]
    ) -> set[TopologyCoord]:
        """Derive a slice's occupied set the original way: walk every
        view (callers hold ``self._lock``)."""
        out: set[TopologyCoord] = set()
        for view in self._slice_views_locked(slice_id):
            for chip in view.info.chips:
                if (
                    chip.health is not Health.HEALTHY
                    or view.used_share_count(chip.index) > 0
                ):
                    out.add(chip.coord)
        return out

    def walk_occupied_coords(
        self, slice_id: Optional[str] = None
    ) -> set[TopologyCoord]:
        """``occupied_coords`` WITHOUT the incremental cache — the
        audit sentinel's independent derivation (sched/snapshot.py
        audit builds): a seam that forgot both its snapshot delta and
        its incremental occupied update must still diverge loudly
        against a ground-truth walk, so the audit never reads the very
        cache it is meant to check."""
        with self._lock:
            return self._walk_occupied_locked(slice_id)

    def occupied_coords(self, slice_id: Optional[str] = None) -> set[TopologyCoord]:
        """Coords unusable for a whole-chip/gang placement: any chip with
        used shares, plus unhealthy chips. Served from the per-slice
        incremental set (seeded by one walk, then advanced at every
        mutation seam) — the returned set is the caller's copy."""
        with self._lock:
            sid = slice_id
            if sid is None:
                # the no-argument form serves single-slice clusters and
                # raises on ambiguity (matching _slice_views_locked)
                if len(self._slices) > 1:
                    raise StateError(
                        "coord sets are slice-local; pass slice_id on "
                        f"a {len(self._slices)}-slice cluster"
                    )
                if not self._slices:
                    return set()
                sid = next(iter(self._slices))
            cached = self._occ_cache.get(sid)
            if cached is None:
                cached = self._walk_occupied_locked(sid)
                self._occ_cache[sid] = cached
            return set(cached)

    def _resolve_sid_locked(self, slice_id: Optional[str]) -> Optional[str]:
        """The no-argument form of the per-slice coord accessors serves
        single-slice clusters and raises on ambiguity (matching
        ``_slice_views_locked``); None = no slices registered yet."""
        if slice_id is not None:
            return slice_id
        if len(self._slices) > 1:
            raise StateError(
                "coord sets are slice-local; pass slice_id on a "
                f"{len(self._slices)}-slice cluster"
            )
        if not self._slices:
            return None
        return next(iter(self._slices))

    def _walk_unhealthy_locked(
        self, slice_id: Optional[str]
    ) -> set[TopologyCoord]:
        return {
            chip.coord
            for view in self._slice_views_locked(slice_id)
            for chip in view.info.chips
            if chip.health is not Health.HEALTHY
        }

    def walk_unhealthy_coords(
        self, slice_id: Optional[str] = None
    ) -> set[TopologyCoord]:
        """``unhealthy_coords`` WITHOUT the incremental cache — the
        audit sentinel's independent derivation (see
        ``walk_occupied_coords``)."""
        with self._lock:
            return self._walk_unhealthy_locked(slice_id)

    def unhealthy_coords(self, slice_id: Optional[str] = None) -> set[TopologyCoord]:
        """Coords of unhealthy chips, served from the per-slice
        incremental set (seeded by one walk, advanced at the health
        and structural seams) — the returned set is the caller's copy."""
        with self._lock:
            sid = self._resolve_sid_locked(slice_id)
            if sid is None:
                return set()
            cached = self._unhealthy_cache.get(sid)
            if cached is None:
                cached = self._walk_unhealthy_locked(sid)
                self._unhealthy_cache[sid] = cached
            return set(cached)

    def _walk_broken_locked(
        self, slice_id: Optional[str]
    ) -> dict[Link, int]:
        counts: dict[Link, int] = {}
        for view in self._slice_views_locked(slice_id):
            # distinct links per view: the count is "how many views
            # report this link", the unit the upsert transitions move
            for link in set(view.info.bad_links):
                counts[link] = counts.get(link, 0) + 1
        return counts

    def walk_broken_links(
        self, slice_id: Optional[str] = None
    ) -> set[Link]:
        """``broken_links`` WITHOUT the incremental cache (the audit
        sentinel's derivation)."""
        with self._lock:
            return set(self._walk_broken_locked(slice_id))

    def broken_links(self, slice_id: Optional[str] = None) -> set[Link]:
        """Downed ICI links, unioned over node reports. Both endpoint
        hosts may report the same link; the incremental cache counts
        reporting views per canonical link (a link leaves the set only
        when its LAST reporter withdraws it)."""
        with self._lock:
            sid = self._resolve_sid_locked(slice_id)
            if sid is None:
                return set()
            counts = self._broken_cache.get(sid)
            if counts is None:
                counts = self._walk_broken_locked(sid)
                self._broken_cache[sid] = counts
            return set(counts)

    def _walk_share_counts_locked(self, slice_id: str) -> list[int]:
        total = used = 0
        for view in self._slice_views_locked(slice_id):
            u, t = self._view_share_counts(view)
            used += u
            total += t
        return [used, total]

    def walk_slice_share_counts(self, slice_id: str) -> tuple[int, int]:
        """``slice_share_counts`` WITHOUT the incremental cache (the
        audit sentinel's derivation)."""
        with self._lock:
            used, total = self._walk_share_counts_locked(slice_id)
            return used, total

    def slice_share_counts(self, slice_id: str) -> tuple[int, int]:
        """(used, total) shares over healthy capacity of ONE slice —
        the integer pair the snapshot carries so ledger deltas can
        advance utilization in O(1) (total only moves on health or
        topology changes). Served from the per-slice incremental pair,
        seeded by one walk and advanced at the commit/release/health/
        structural seams — structural rebuilds stop walking every view
       ."""
        with self._lock:
            shares = self._share_cache.get(slice_id)
            if shares is None:
                shares = self._walk_share_counts_locked(slice_id)
                self._share_cache[slice_id] = shares
            return shares[0], shares[1]

    def slice_utilization(self, slice_id: str) -> float:
        """Allocated share fraction over healthy capacity of ONE slice —
        the gang layer's bin-pack signal for slice choice."""
        used, total = self.slice_share_counts(slice_id)
        return used / total if total else 0.0

    def allocation(self, pod_key: str) -> Optional[AllocResult]:
        with self._lock:
            return self._allocs.get(pod_key)

    def allocations(self) -> list[AllocResult]:
        with self._lock:
            return list(self._allocs.values())

    # -- utilization (north-star metric feed) ------------------------------
    def utilization(self) -> float:
        """Allocated share fraction over healthy capacity, 0..1 —
        summed from the per-slice incremental share counts (seeded by
        one walk per slice, advanced at every seam), so a metrics
        scrape stops walking every chip of the fleet per pull and a
        lazily-ingested fleet is counted without materializing it."""
        with self._lock:
            used = total = 0
            for sid in self._slices:
                shares = self._share_cache.get(sid)
                if shares is None:
                    shares = self._walk_share_counts_locked(sid)
                    self._share_cache[sid] = shares
                used += shares[0]
                total += shares[1]
            return used / total if total else 0.0

    def priority_of(self, pod_key: str) -> int:
        """Pod priority as committed (AllocResult carries it, and it is
        persisted in the alloc annotation, so preemption protection survives
        an extender restart). 0 for unknown pods."""
        with self._lock:
            alloc = self._allocs.get(pod_key)
            return alloc.priority if alloc is not None else 0

    # -- commit / release --------------------------------------------------
    def commit(self, alloc: AllocResult) -> None:
        """Record a bind: devices of one pod on one node. ``alloc.priority``
        is the single source of priority truth (no side table to diverge)."""
        with self._lock:
            if alloc.pod_key in self._allocs:
                raise StateError(f"{alloc.pod_key} already has an allocation")
            view = self._view_locked(alloc.node_name)
            if view is None:
                raise StateError(f"bind to unknown node {alloc.node_name}")
            n = view.shares_per_chip
            # validate first, then apply (no partial commit)
            adding: set[str] = set()
            pending_shares: dict[int, int] = {}
            for did in alloc.device_ids:
                index, frac = parse_device_id(did)
                chip = view.chip(index)
                if chip.health is not Health.HEALTHY:
                    raise StateError(f"{did}: chip unhealthy")
                if did in view.used_ids or did in adding:
                    raise StateError(f"{did}: device id already allocated")
                if frac is not None and not 0 <= frac[0] < n:
                    raise StateError(f"{did}: share index out of range")
                want = n if frac is None else 1
                have = view.free_shares(chip) - pending_shares.get(index, 0)
                if have < want:
                    raise StateError(f"{did}: insufficient free shares")
                adding.add(did)
                pending_shares[index] = pending_shares.get(index, 0) + want
            # occupied-set transitions for the snapshot delta: a chip
            # enters `occupied` when its used shares leave zero (all
            # committed chips are healthy — validated above — so the
            # used-share change equals the full added weight)
            newly_occupied = tuple(
                view.chip(index).coord
                for index in pending_shares
                if view.used_share_count(index) == 0
            )
            view.add_ids(adding)
            self._allocs[alloc.pod_key] = alloc
            self._note_gen_locked("add", alloc=alloc)
            self._occ_apply_locked(view.info.slice_id, add=newly_occupied)
            # all committed chips are healthy (validated above), so the
            # counted share delta is exactly the added weight
            self._aux_apply_locked(
                view.info.slice_id,
                used_delta=sum(pending_shares.values()),
            )
            self._epoch += 1
            self._note_delta_locked(
                slice_id=view.info.slice_id,
                occupied_add=newly_occupied,
                used_shares_delta=sum(pending_shares.values()),
                why=f"commit {alloc.pod_key}",
            )
            self._note_journal_locked(
                "commit", {"a": codec.encode_alloc(alloc)})

    def release(self, pod_key: str) -> Optional[AllocResult]:
        """Pod gone (deleted/preempted): free its shares."""
        with self._lock:
            # look up before popping: the unknown-pod path mutates
            # nothing, so it owes no epoch bump (tpukube-lint
            # epoch-discipline checks every path after a seam write)
            alloc = self._allocs.get(pod_key)
            if alloc is None:
                return None
            self._allocs.pop(pod_key, None)
            self._note_gen_locked("remove", pod_key=pod_key)
            view = self._view_locked(alloc.node_name)
            if view is None:
                # node view gone: its chips are in no slice's occupied
                # set either — an empty delta keeps the chain whole
                self._epoch += 1
                self._note_delta_locked(why=f"release {pod_key} (node gone)")
                self._note_journal_locked("release", {"p": pod_key})
                return alloc
            # snapshot delta: shares removed from HEALTHY chips reduce
            # the slice's used count (unhealthy chips were never counted
            # — nor do they leave `occupied`, which health holds)
            used_delta = 0
            indices: set[int] = set()
            for did in alloc.device_ids:
                if did not in view.used_ids:
                    continue
                index, _ = parse_device_id(did)
                indices.add(index)
                if view.chip(index).health is Health.HEALTHY:
                    used_delta -= view.id_weights.get(did, 0)
            view.remove_ids(alloc.device_ids)
            freed = tuple(
                view.chip(index).coord
                for index in sorted(indices)
                if view.used_share_count(index) == 0
                and view.chip(index).health is Health.HEALTHY
            )
            self._occ_apply_locked(view.info.slice_id, remove=freed)
            self._aux_apply_locked(view.info.slice_id,
                                   used_delta=used_delta)
            self._epoch += 1
            self._note_delta_locked(
                slice_id=view.info.slice_id,
                occupied_remove=freed,
                used_shares_delta=used_delta,
                why=f"release {pod_key}",
            )
            self._note_journal_locked("release", {"p": pod_key})
            return alloc

    # -- restart story -----------------------------------------------------
    def rebuild_from_pods(
        self, pods: list[dict[str, str]]
    ) -> list[tuple[dict[str, str], AllocResult]]:
        """Reconstruct the ledger from pod alloc annotations (each item is
        one pod's annotation dict). Returns (annotations, alloc) pairs so
        callers building further state (gang restore) keep the association
        structurally — positional re-pairing against the input would break
        silently the day this method skips one more pod."""
        restored: list[tuple[dict[str, str], AllocResult]] = []
        for annotations in pods:
            payload = annotations.get(codec.ANNO_ALLOC)
            if not payload:
                continue
            # a real cluster can hold annotations we did not write
            # (malformed edits, pods bound to vanished nodes): one bad
            # pod must not abort the whole rebuild. LOUD skips — until
            # reconciled the ledger under-counts the skipped pod's chips.
            try:
                alloc = codec.decode_alloc(payload)
            except codec.CodecError as e:
                # undecodable payloads carry no pod key; log a snippet so
                # the operator can find the offending annotation
                log.error("rebuild: undecodable alloc annotation (%s): "
                          "%.120s", e, payload)
                continue
            try:
                self.commit(alloc)
            except StateError as e:
                log.error("rebuild: skipping %s (%s) — the ledger "
                          "under-counts its chips until reconciled",
                          alloc.pod_key, e)
                continue
            restored.append((annotations, alloc))
        return restored

    # -- durable-state checkpoint (sched/journal.py) -------------------------
    def checkpoint_doc(self, cache: dict) -> tuple[dict, list]:
        """The ledger as a Checkpoint: a HEAD fragment (slice meshes,
        compact host blobs, alloc objects + their payload signatures)
        plus per-node LINE entries the journal writes after the head —
        so a warm restore parses the small head eagerly and each node
        line lazily on first touch (``_view_locked``).

        ``cache`` memoizes per-node serialized lines keyed on payload
        identity, so steady-state captures cost O(allocs + changed
        nodes), not O(fleet). A still-LAZY node yields a ``("ref", ...)``
        entry naming its bytes in the PREVIOUS checkpoint file — the
        journal's drain thread copies them verbatim (this capture runs
        under the decision lock and must not read disk). Runs under
        ``self._lock``; serialization of changed nodes happens here (in
        memory), disk belongs to the drain thread."""
        node_cache = cache.setdefault("nodes", {})
        alloc_cache = cache.setdefault("allocs", {})
        with self._lock:
            entries: list[tuple] = []
            for name, view in self._nodes.items():
                cached = node_cache.get(name)
                if cached is not None and cached[0] is view.raw_payload:
                    entries.append(cached[1])
                    continue
                line = json.dumps(_node_doc(view),
                                  separators=(",", ":"))
                raw_payload = view.raw_payload.encode("utf-8")
                entry = ("line", name, line,
                         zlib.crc32(line.encode("utf-8")),
                         view.info.slice_id,
                         zlib.crc32(raw_payload), len(raw_payload))
                node_cache[name] = (view.raw_payload, entry)
                entries.append(entry)
            for name, (payload, annotations, sid) in \
                    self._lazy_payloads.items():
                # a still-lazy bulk-ingest node rides as its RAW
                # annotations (this capture must not decode the fleet);
                # the loader keeps it lazy and decodes on first touch
                cached = node_cache.get(name)
                if cached is not None and cached[0] is payload:
                    entries.append(cached[1])
                    continue
                line = json.dumps(
                    {"n": name, "slice": sid, "anno": annotations},
                    separators=(",", ":"))
                raw_payload = payload.encode("utf-8")
                entry = ("line", name, line,
                         zlib.crc32(line.encode("utf-8")), sid,
                         zlib.crc32(raw_payload), len(raw_payload))
                node_cache[name] = (payload, entry)
                entries.append(entry)
            for name, le in self._lazy_index.items():
                off, length, crc, sid, pcrc, plen = le
                entries.append(("ref", name, off, length, crc, sid,
                                pcrc, plen))
            allocs = []
            alloc_index: dict[str, tuple[int, int]] = {}
            for key, alloc in self._allocs.items():
                cached = alloc_cache.get(key)
                if cached is None or cached[0] is not alloc:
                    payload = codec.encode_alloc(alloc).encode("utf-8")
                    cached = alloc_cache[key] = (
                        alloc, codec.alloc_obj(alloc),
                        (zlib.crc32(payload), len(payload)),
                    )
                allocs.append(cached[1])
                alloc_index[key] = cached[2]
            head = {
                "epoch": self._epoch,
                # the alloc generation rides the checkpoint so a warm
                # recovery resumes the numbering (never regresses)
                "gen": self._generation,
                "slices": {
                    sid: [list(sl.mesh.dims), list(sl.mesh.host_block),
                          list(sl.mesh.torus)]
                    for sid, sl in self._slices.items()
                },
                "hosts": {sid: self._hosts_blob_locked(sl)
                          for sid, sl in self._slices.items()},
                "allocs": allocs,
                "alloc_index": {k: list(v)
                                for k, v in alloc_index.items()},
            }
            if self._cordoned:
                # only when non-empty: checkpoint bytes stay identical
                # with the drain plane off
                head["cordoned"] = sorted(self._cordoned)
            return head, entries

    def _hosts_blob_locked(self, sl: SliceView) -> str:
        """The slice's host map as the compact checkpoint blob, cached
        until the map mutates (a still-pending blob round-trips
        verbatim — no expansion just to re-serialize)."""
        if sl.pending_hosts is not None:
            return sl.pending_hosts
        if sl.hosts_blob is None:
            sl.hosts_blob = ";".join(
                f"{c[0]},{c[1]},{c[2]}={h}"
                for c, h in sl.host_by_coord.items()
            )
        return sl.hosts_blob

    def restore_checkpoint(self, head: dict, fd: Optional[int],
                           node_index: dict[str, list]) -> int:
        """Rebuild the ledger from a Checkpoint HEAD onto a fresh
        instance (recovery's warm path): slices and allocations
        eagerly, node views LAZILY — ``node_index`` positions each
        node's line inside the open checkpoint file ``fd`` (ownership
        transfers here; closed when the last lazy node materializes).
        Unlike ``commit``, alloc application skips health validation:
        the checkpoint recorded reality at capture time — a chip that
        sickened later must not drop a running pod from the ledger.
        Returns the allocations restored; raises StateError on a
        non-fresh ledger (recovery constructs a new extender, never
        restores over one)."""
        with self._lock:
            if (self._nodes or self._allocs or self._lazy_index
                    or self._lazy_payloads):
                raise StateError(
                    "restore_checkpoint requires a fresh ledger"
                )
            self._epoch = int(head.get("epoch", 0))
            self._generation = int(head.get("gen", 0))
            self._cordoned = set(head.get("cordoned", ()))
            for sid, (dims, block, torus) in head["slices"].items():
                self._slices[sid] = SliceView(
                    mesh=MeshSpec(
                        dims=tuple(int(d) for d in dims),
                        host_block=tuple(int(b) for b in block),
                        torus=tuple(bool(t) for t in torus),
                    ),
                    pending_hosts=head["hosts"].get(sid, ""),
                )
            self._lazy_fd = fd
            for name, entry in node_index.items():
                off, length, crc, sid, pcrc, plen = entry
                self._lazy_index[name] = (off, length, crc, sid,
                                          pcrc, plen)
            restored = 0
            for obj in head["allocs"]:
                try:
                    alloc = codec.alloc_from_obj(obj)
                except codec.CodecError as e:
                    log.error("checkpoint restore: undecodable alloc "
                              "(%s)", e)
                    continue
                if (alloc.node_name not in self._lazy_index
                        and alloc.node_name not in self._nodes):
                    log.error("checkpoint restore: %s names unknown node "
                              "%s; skipped", alloc.pod_key,
                              alloc.node_name)
                    continue
                self._allocs[alloc.pod_key] = alloc
                # occupancy re-applies at materialization (the alloc
                # list is the occupancy's single home — node lines
                # deliberately carry none, so the per-payload line
                # cache never goes stale under churn)
                self._lazy_allocs.setdefault(
                    alloc.node_name, []).append(alloc)
                restored += 1
            self._names_cache = None
            self._epoch += 1
            self._note_delta_locked(full=True, why="checkpoint restore")
            return restored
