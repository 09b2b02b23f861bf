"""Configuration of the port's node agent and scheduler extender.

Its own copy of the fields of ``tpukube/core/config.py`` that the device
manager, the device plugin and the extender's default path read, with
the same names, the same config file and ``TPUKUBE_<FIELD>`` environment
overlay, and the same defaults. The default backend is ``"real"``
(NVML): a node agent runs against its GPUs unless asked for the sim.

The machines the port runs on have no YAML parser, so :func:`read_yaml`
reads the subset of YAML a deploy ConfigMap's ``config.yaml`` uses: a
flat mapping of ``key: scalar`` lines with comments and blank lines, and
one-line flow sequences (``[8, 1, 1]``) of ints or bools for the tuple
fields. Scalars resolve as PyYAML's ``safe_load`` resolves them (YAML
1.1: ints in their decimal, octal, hex, binary and base-60 forms, floats
with a dot, ``yes/no/on/off/true/false``, quoted and plain strings).
Anything else (nesting, block lists, anchors, tags, block scalars,
several documents, a null) raises ValueError naming the line.

:func:`write_yaml` writes a mapping in that subset (the per-replica
config the shard router hands each worker daemon it spawns).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, fields, replace
from typing import Any, Mapping, Optional

from tpukube_torch.core.mesh import MeshSpec

# One H100 SXM5: 80 GB of HBM3, 132 SMs; eight of them to an HGX node.
DEFAULT_HBM_BYTES = 80 * 1024**3
DEFAULT_SMS = 132

ENV_PREFIX = "TPUKUBE_"


@dataclass(frozen=True)
class GpuKubeConfig:
    # resources: a node advertises whole GPUs or shares of them, never both
    resource_tpu: str = "qiniu.com/tpu"
    resource_vtpu: str = "qiniu.com/vtpu"
    shares_per_chip: int = 1  # >1 mints vGPU shares (e.g. 2 or 4)
    # the ICI-domain name of the reference; here the NVLink domain
    slice_id: str = "slice-0"
    backend: str = "real"  # real (NVML) | sim
    # explicit libnvidia-ml path for the real backend; empty = the loader's
    # libnvidia-ml.so.1
    nvml_path: str = ""
    # real-backend health watch: "" = the native default (xid), or
    # xid|liveness|off — see native/gpuinfo.h gpuinfo_probe
    probe_mode: str = ""
    # sim topology (used when backend == "sim")
    sim_mesh_dims: tuple[int, int, int] = (8, 1, 1)
    sim_host_block: tuple[int, int, int] = (8, 1, 1)
    sim_torus: tuple[bool, bool, bool] = (False, False, False)
    # chip-coord origin of this host's block ("x,y,z"); empty = derive it
    # from the host name's host-i-j-k convention
    sim_host_origin: str = ""
    hbm_bytes_per_chip: int = DEFAULT_HBM_BYTES
    cores_per_chip: int = DEFAULT_SMS

    # node agent / device plugin (deviceplugin/v1beta1 over unix sockets)
    device_plugin_dir: str = "/var/lib/kubelet/device-plugins"
    kubelet_socket: str = "kubelet.sock"  # within device_plugin_dir
    plugin_socket: str = "tpukube.sock"  # within device_plugin_dir
    health_poll_seconds: float = 5.0

    # the retry policy (core/retry.py) of the seams a Retrier is wired
    # into: the plugin's kubelet registration, the REST channel's requests
    retry_max_attempts: int = 5
    retry_base_delay_seconds: float = 0.1
    retry_max_delay_seconds: float = 5.0
    retry_jitter: float = 0.5  # fraction of each delay randomized away
    retry_deadline_seconds: float = 30.0  # overall wall budget (0 = none)
    # per-attempt transport-timeout cap (0 = the transport's own default)
    retry_attempt_timeout_seconds: float = 0.0
    # apiserver circuit breaker (core/retry.py CircuitBreaker):
    # failure_threshold consecutive transport/5xx failures open the
    # circuit; requests then fail fast for reset_seconds before
    # half-open probing. 0 disables the breaker (the default).
    circuit_failure_threshold: int = 0
    circuit_reset_seconds: float = 30.0
    circuit_half_open_probes: int = 1
    # chaos harness (tpukube_torch/chaos/): deterministic fault-schedule
    # seed for the sim's chaos scenarios (8, 9, 13). 0 = chaos off; the
    # scenario code falls back to its own fixed seed.
    chaos_seed: int = 0

    # scheduler extender
    extender_host: str = "0.0.0.0"
    extender_port: int = 12345
    score_mode: str = "topology"  # topology | binpack | spread
    reservation_ttl_seconds: float = 30.0
    # decision trace: in-memory ring size (0 disables) and an optional
    # JSONL sink, rotated once at trace_sink_max_bytes (0 = unlimited)
    trace_capacity: int = 4096
    trace_path: str = ""
    trace_sink_max_bytes: int = 256 * 1024**2
    # structured event journal (obs/events.py); capacity 0 disables
    events_capacity: int = 4096
    events_path: str = ""
    events_sink_max_bytes: int = 64 * 1024**2
    # snapshot audit sentinel: on this fraction of scheduling-path cache
    # hits, rebuild the snapshot from the ledger and raise on divergence
    snapshot_audit_rate: float = 0.0
    # incremental snapshot maintenance (O(delta) advance per epoch)
    snapshot_delta_enabled: bool = True
    # batched node upserts with lazy decode on first touch
    bulk_ingest_enabled: bool = True
    # Generation-based incremental resync: the ledger stamps a
    # generation on every alloc mutation and keeps a bounded
    # per-generation change log; allocs_since(cursor) then serves a
    # churn wave's resync as O(changed-allocs) adds/removes instead of
    # the full ledger. The capacity must exceed the deepest alloc churn
    # between two resync reads (commits + releases of one wave) — a gap
    # degrades to a counted FULL read, never a stale answer. 0 disables
    # the log (full reads; no tpukube_resync_* series render).
    generation_log_capacity: int = 65536

    # Batched scheduling cycles (sched/cycle.py SchedulingCycle): when
    # batch_enabled is true the extender admits pending pods into a
    # scheduling queue, plans a whole batch against one epoch-pinned
    # snapshot per cycle, and answers /filter, /prioritize and /bind from
    # the plan. false keeps the per-pod webhook path: nothing
    # batch-related is constructed.
    batch_enabled: bool = False
    # most pods planned per cycle; the rest wait for the next cycle
    batch_max_pods: int = 64
    # minimum seconds between full batch replans (0 = plan on every
    # webhook that misses the plan)
    cycle_interval_seconds: float = 0.0
    # answer /filter and /prioritize from the plan: the feasible set is
    # the planned node alone (the placement is unchanged); requires
    # batch_enabled
    filter_from_plan: bool = False

    # Durable control-plane state (sched/journal.py): with
    # journal_enabled the extender appends every ledger/gang mutation to
    # a CRC'd JSONL write-ahead log at journal_path (written by a drain
    # thread: the decision lock never blocks on disk) and captures a
    # checkpoint every checkpoint_interval_seconds; a restarted extender
    # then recovers O(changes since the checkpoint) instead of the
    # O(fleet) rebuild from pod annotations. false constructs nothing.
    journal_enabled: bool = False
    journal_path: str = ""
    # WAL size cap: at the cap the file rotates once to <path>.1 and a
    # prompt checkpoint is requested (0 = uncapped)
    journal_max_bytes: int = 64 * 1024**2
    checkpoint_interval_seconds: float = 60.0
    # "off" flushes each drain batch to the OS; "always" fsyncs every
    # batch. Checkpoints fsync before their atomic rename either way.
    journal_fsync: str = "off"

    # Multi-tenant serving plane (tenancy/). With tenancy_enabled the
    # extender attaches a TenantPlane: tenant ids from the
    # tenancy_label pod label (unlabeled pods belong to
    # tenancy_default_tenant), per-tenant quota enforcement at
    # admission, DRF ordering of the batch scheduling queue,
    # tenant-aware preemption victim bias, and SLO-burn shedding of
    # low-priority bursts. false (the default) constructs NOTHING —
    # placements, /metrics exposition, and alloc annotations stay
    # byte-identical to the behavior without the plane.
    tenancy_enabled: bool = False
    tenancy_label: str = "tpu.qiniu.com/tenant"
    tenancy_default_tenant: str = "default"
    # per-tenant caps: "teamA=chips:16,hbm:0.25;teamB=chips:8" —
    # chips are whole-chip equivalents (vGPU shares count 1/n), hbm a
    # fraction of total cluster HBM. Empty = no quotas (fairness and
    # shedding still apply).
    tenancy_quotas: str = ""
    # SLO-aware admission: while any DEFAULT_SLOS burn rate over the
    # sliding window reaches this page threshold (obs/slo.py
    # MULTIWINDOW_ALERTS' page burn), low-priority non-gang admissions
    # from over-share tenants are shed with a TenantAdmissionShed
    # journal event. 0 disables shedding (quotas still enforce).
    tenancy_burn_threshold: float = 14.4
    tenancy_burn_window_seconds: float = 60.0
    # only pods at or below this priority are ever shed (burst
    # inference traffic; committed training gangs are never shed)
    tenancy_shed_priority_max: int = 0

    # Decision provenance (obs/decisions.py). With decisions_enabled the
    # extender keeps a bounded, sampled ring of per-pod stage events
    # (admit -> queue wait -> cycle pin -> candidate pruning -> gang /
    # preemption -> tenancy verdict -> bind), serves them on /explain,
    # the /statusz "decisions" section and `obs explain`, and turns on
    # cycle phase profiling (tpukube_cycle_phase_seconds). false (the
    # default) builds NOTHING: no stage is built, no series renders,
    # placements and exposition stay byte-identical.
    decisions_enabled: bool = False
    decisions_capacity: int = 8192
    # fraction of pods sampled into the ring, selected by a seeded hash
    # of the pod key — 0.01 on a kilonode fleet keeps 1% of pods FULLY
    # explained
    decisions_sample_rate: float = 1.0
    decisions_seed: int = 0
    # optional JSONL sink for `obs explain --file` (size-capped like the
    # trace/events sinks)
    decisions_path: str = ""
    decisions_sink_max_bytes: int = 64 * 1024**2

    # Capacity analytics & demand forensics (obs/capacity.py). With
    # capacity_enabled the extender keeps a bounded flight-recorder ring
    # of periodic fleet samples (per-slice utilization / fragmentation /
    # largest-free-box, queue depth, tenant shares), root-causes every
    # failed/deferred plan into the stranded-demand taxonomy (fragmented
    # / capacity / quota / shed / unhealthy / dcn-ineligible / draining)
    # and serves /capacity + /capacity/probe. Samples ride the
    # scheduling clock and the snapshot's observer view. false (the
    # default) constructs nothing: no recorder, no series, placements
    # and exposition stay byte-identical.
    capacity_enabled: bool = False
    capacity_sample_interval_seconds: float = 30.0
    # flight-recorder ring depth (samples, not bytes)
    capacity_samples: int = 2048
    # optional JSONL sample sink for `obs capacity --merge` (size-capped
    # like the trace/events sinks)
    capacity_path: str = ""
    capacity_sink_max_bytes: int = 64 * 1024**2

    # Graceful drain / decommission (sched/drain.py). With drain_enabled
    # the extender attaches a DrainCoordinator: cordon a node/slice
    # (excluded from every placement sweep while live allocations keep
    # serving), migrate-or-preempt residents through the preemption
    # victim machinery and the eviction executor under a bounded
    # disruption budget, then release and un-ingest (the inverse of
    # ingest_nodes: one epoch/delta/journal seam per batch). false (the
    # default) constructs nothing: placements, exposition and journal
    # bytes stay byte-identical.
    drain_enabled: bool = False
    # most resident evictions per drain tick (the disruption budget)
    drain_max_concurrent_moves: int = 4
    # most evictions charged to ONE tenant per drain tick (0 = no
    # per-tenant budget; only meaningful with tenancy attribution)
    drain_tenant_budget: int = 0

    # Autoscaler loop (sched/autoscale.py). With autoscale_enabled the
    # extender attaches an Autoscaler that grows the fleet against queue
    # depth + tenant SLO burn (bulk ingest of provisioned slices) and
    # shrinks it by driving drains when utilization idles below the
    # floor. Requires drain_enabled: scale-down IS a drain. false (the
    # default) constructs nothing.
    autoscale_enabled: bool = False
    # queue depth at/above which a scale-up fires (SLO page burn also
    # triggers one regardless of depth)
    autoscale_up_queue_depth: int = 8
    # fleet utilization below which a scale-down drain is considered
    autoscale_down_utilization: float = 0.25
    # slice-count bounds the loop never crosses
    autoscale_min_slices: int = 1
    autoscale_max_slices: int = 16
    # scheduling-clock seconds between scale actions (either direction)
    autoscale_cooldown_seconds: float = 120.0

    # Slice-partitioned control plane (sched/shard.py): >1 runs N
    # planner replicas behind a ShardRouter — each replica a full
    # Extender owning a disjoint slice set, with its own ledger, gang
    # manager, snapshot chain, queue and journal segment
    # (<journal_path>.r<i>). Gangs that fit no single replica go
    # through the router's two-phase rendezvous. 1 (the default) is
    # the unsharded planner, byte for byte.
    planner_replicas: int = 1
    # How the router reaches its replicas: inprocess (Extender objects
    # in the router's process, direct dispatch) or subprocess (one
    # planner daemon per replica, ``shard-worker``, over HTTP).
    shard_transport: str = "inprocess"
    # Wire codec of the router's /worker/* calls (sched/wirecodec.py):
    # json (the default and the parity oracle: compact JSON bodies) or
    # binary (TKW1 frames, negotiated per request through Content-Type
    # and Accept, so a JSON-only worker degrades its replica to JSON).
    # Placements are the same either way. Meaningful only over the
    # subprocess transport.
    wire_codec: str = "json"
    # binary payloads of at least this many encoded bytes are compressed
    # (kept raw when compression does not shrink them)
    wire_compress_min_bytes: int = 1024
    # dynamic lock-order detector (tpukube_torch.analysis.lockgraph):
    # when true, threading.Lock/RLock created by the port's code are
    # wrapped to record acquisition-order edges; `cli sim` attaches the
    # resulting lock graph (edges + deadlock cycles) to its result JSON,
    # SimCluster and each shard-worker daemon install it for their
    # lives. Off by default: nothing is patched and lock creation is
    # untouched.
    lock_monitor: bool = False

    def sim_mesh(self) -> MeshSpec:
        return MeshSpec(
            dims=self.sim_mesh_dims,
            host_block=self.sim_host_block,
            torus=self.sim_torus,
        )

    def plugin_socket_path(self) -> str:
        return os.path.join(self.device_plugin_dir, self.plugin_socket)

    def kubelet_socket_path(self) -> str:
        return os.path.join(self.device_plugin_dir, self.kubelet_socket)


_TUPLE_FIELDS = {"sim_mesh_dims", "sim_host_block", "sim_torus"}


# keys of the reference's config the port has no plane for (the TPU
# backend's): a config file that sets one is refused, naming the plane
_UNPORTED_KEYS = {
    "libtpu_path": "the TPU backend (the port's real backend is NVML: "
                   "nvml_path)",
    "real_torus": "the TPU backend (an NVLink domain has no torus)",
}


def _coerce(name: str, raw: Any, current):
    """A field's value from a string (the environment, a plain YAML
    string) or from an already-typed YAML value, as the reference
    coerces both."""
    if name in _TUPLE_FIELDS:
        if isinstance(raw, str):
            raw = [p for p in raw.replace("x", ",").split(",") if p != ""]
        elif not isinstance(raw, (list, tuple)):
            raise ValueError(f"config {name}: need 3 values, got {raw!r}")
        if isinstance(current[0], bool):
            vals = tuple(
                v if isinstance(v, bool)
                else str(v).lower() in ("1", "true", "yes")
                for v in raw
            )
        else:
            vals = tuple(int(v) for v in raw)
        if len(vals) != 3:
            raise ValueError(f"config {name}: need 3 values, got {vals!r}")
        return vals
    if isinstance(raw, (list, tuple)):
        raise ValueError(f"config {name}: a sequence for a scalar field")
    t = type(current)
    if t is bool:
        return raw if isinstance(raw, bool) else str(raw).lower() in (
            "1", "true", "yes")
    return t(raw)


# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), keyed as it
# keys them by the scalar's first character, in its order
_Y_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                     r"FALSE|on|On|ON|off|Off|OFF)$")
_Y_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_Y_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_Y_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_Y_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_Y_RESOLVERS = (
    ("bool", _Y_BOOL, "yYnNtTfFoO"),
    ("float", _Y_FLOAT, "-+0123456789."),
    ("int", _Y_INT, "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", _Y_NULL, "~nN"),
    ("timestamp", _Y_TIMESTAMP, "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)
_Y_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:[ \t]+(.*))?$")
_Y_ESCAPES = {"0": "\0", "t": "\t", "n": "\n", "r": "\r", '"': '"',
              "/": "/", "\\": "\\", " ": " "}


def _y_base60(value: str, digit) -> Any:
    total = 0 * digit("0")
    base = 1
    for part in reversed(value.split(":")):
        total += digit(part) * base
        base *= 60
    return total


def _y_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _y_base60(value, int)
    return sign * int(value)


def _y_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _y_base60(value, float)
    return sign * float(value)


def _y_plain(text: str, where: str) -> Any:
    """A plain scalar, resolved as PyYAML's safe_load resolves it."""
    for kind, pattern, first in _Y_RESOLVERS:
        if text[:1] not in first and not (kind == "null" and not text):
            continue
        if not pattern.match(text):
            continue
        if kind == "bool":
            return text.lower() in ("yes", "true", "on")
        if kind == "float":
            return _y_float(text)
        if kind == "int":
            try:
                return _y_int(text)
            except ValueError:
                raise ValueError(f"{where}: bad integer {text!r}") from None
        raise ValueError(f"{where}: a YAML {kind} ({text!r}) is not a "
                         f"config value")
    return text


def _y_quoted(text: str, where: str) -> tuple[str, str]:
    """A quoted scalar at the start of ``text``: (its value, the rest of
    the line after the closing quote)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            width = {"x": 2, "u": 4, "U": 8}.get(esc)
            if width is not None:
                digits = text[i + 2:i + 2 + width]
                if len(digits) != width or not re.fullmatch(
                        r"[0-9A-Fa-f]+", digits):
                    raise ValueError(f"{where}: bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            if esc not in _Y_ESCAPES:
                raise ValueError(f"{where}: unsupported escape \\{esc}")
            out.append(_Y_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"{where}: unterminated {quote}-quoted string "
                     f"(multi-line scalars are not supported)")


def _y_strip_comment(rest: str, where: str) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"{where}: unexpected text {rest!r} after a value")


def _y_value(text: str, where: str) -> Any:
    """The value half of a ``key: value`` line (leading space gone)."""
    if text[:1] in ("'", '"'):
        value, rest = _y_quoted(text, where)
        _y_strip_comment(rest, where)
        return value
    if text[:1] == "[":
        close = text.find("]")
        if close < 0:
            raise ValueError(f"{where}: a flow sequence must close on its "
                             f"line")
        _y_strip_comment(text[close + 1:], where)
        inner = text[1:close]
        if any(c in inner for c in "[]{}'\"#"):
            raise ValueError(f"{where}: only flow sequences of plain ints "
                             f"or bools are supported")
        items = [p.strip() for p in inner.split(",")] if inner.strip() else []
        values = [_y_plain(p, where) for p in items]
        if any(not isinstance(v, (int, bool)) for v in values):
            raise ValueError(f"{where}: only flow sequences of ints or "
                             f"bools are supported, got {values!r}")
        return values
    # a comment starts at a '#' after whitespace (or at the value's start)
    m = re.search(r"(?:^|[ \t])#", text)
    plain = (text[:m.start()] if m else text).strip()
    if plain[:1] and plain[:1] in "{&*!|>%@`-?:,]}" and not (
            plain[:1] in "-?:" and len(plain) > 1 and plain[1] not in " \t"):
        raise ValueError(f"{where}: {plain[:1]!r} starts a YAML form the "
                         f"config reader does not support (nesting, block "
                         f"lists, anchors, aliases, tags, block scalars)")
    if ": " in plain or plain.endswith(":") or ":\t" in plain:
        raise ValueError(f"{where}: nested mappings are not supported")
    return _y_plain(plain, where)


def read_yaml(path: str) -> dict[str, Any]:
    """The flat ``key: value`` mapping of a config file in the YAML
    subset above (an empty file is the empty mapping; a key given twice
    keeps its last value, as ``safe_load`` does)."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    doc: dict[str, Any] = {}
    started = False
    for n, line in enumerate(lines, 1):
        where = f"{path}:{n}"
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if line.rstrip() == "---" or line.startswith("--- "):
            if started or line.strip() != "---":
                raise ValueError(f"{where}: several documents (or content "
                                 f"after ---) are not supported")
            started = True
            continue
        started = True
        if line[0] in " \t":
            raise ValueError(f"{where}: indented line: nesting and "
                             f"multi-line values are not supported")
        if line.startswith(("- ", "...", "%")) or line == "-":
            raise ValueError(f"{where}: block lists, document ends and "
                             f"directives are not supported")
        m = _Y_KEY.match(line.rstrip())
        if m is None:
            raise ValueError(f"{where}: top level must be a mapping of "
                             f"'key: value' lines")
        key, text = m.group(1), (m.group(2) or "")
        if not text.strip() or text.strip().startswith("#"):
            raise ValueError(f"{where}: {key} has no value (a YAML null is "
                             f"not a config value)")
        doc[key] = _y_value(text, where)
    return doc


def _y_scalar(value: Any) -> str:
    """``value`` as a scalar :func:`read_yaml` reads back as itself, or as
    the string :func:`load_config`'s coercion turns into it."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        # quoted: a float's repr may lack the dot YAML 1.1 needs
        # ("1e-05"); the field's coercion parses the string
        value = repr(value)
    if not isinstance(value, str):
        raise ValueError(f"not a config scalar: {value!r}")
    # double-quoted, with only the escapes the reader knows
    out = value.replace("\\", "\\\\").replace('"', '\\"')
    for raw, esc in (("\n", "\\n"), ("\t", "\\t"), ("\r", "\\r"),
                     ("\0", "\\0")):
        out = out.replace(raw, esc)
    if any(ord(c) < 0x20 for c in out):
        raise ValueError(f"control character in config string {value!r}")
    return f'"{out}"'


def write_yaml(path: str, doc: Mapping[str, Any]) -> None:
    """Write ``doc`` (a flat mapping of scalars and tuples or lists of ints
    or bools) as a config file :func:`read_yaml` reads back."""
    lines = []
    for key, value in doc.items():
        if not _Y_KEY.match(f"{key}:"):
            raise ValueError(f"not a config key: {key!r}")
        if isinstance(value, (list, tuple)):
            text = "[" + ", ".join(_y_scalar(v) for v in value) + "]"
            if any(not isinstance(v, (int, bool)) for v in value):
                raise ValueError(f"{key}: only ints or bools in a sequence")
        else:
            text = _y_scalar(value)
        lines.append(f"{key}: {text}\n")
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(lines)


def _file_updates(path: str) -> dict[str, Any]:
    known = {f_.name for f_ in fields(GpuKubeConfig)}
    updates = {}
    for key, value in read_yaml(path).items():
        if key not in known:
            plane = _UNPORTED_KEYS.get(key)
            if plane is not None:
                raise ValueError(f"{path}: config key {key!r}: {plane} is "
                                 f"not ported yet")
            raise ValueError(f"{path}: unknown config key {key!r}")
        updates[key] = value
    return updates


def load_config(yaml_path: Optional[str] = None,
                env: Optional[Mapping[str, str]] = None) -> GpuKubeConfig:
    """defaults < the config file (:func:`read_yaml`) < env
    (TPUKUBE_<UPPER_FIELD_NAME>)."""
    cfg = GpuKubeConfig()
    updates: dict[str, Any] = _file_updates(yaml_path) if yaml_path else {}
    env = os.environ if env is None else env
    for f_ in fields(cfg):
        env_key = ENV_PREFIX + f_.name.upper()
        if env_key in env:
            updates[f_.name] = env[env_key]
    for k, v in list(updates.items()):
        updates[k] = _coerce(k, v, getattr(cfg, k))
    cfg = replace(cfg, **updates)
    if cfg.shares_per_chip < 1:
        raise ValueError("shares_per_chip must be >= 1")
    if cfg.backend not in ("sim", "real"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.probe_mode not in ("", "xid", "liveness", "off"):
        raise ValueError(f"unknown probe_mode {cfg.probe_mode!r}")
    if cfg.sim_host_origin:
        parts = cfg.sim_host_origin.split(",")
        if len(parts) != 3 or not all(p.strip().lstrip("-").isdigit() for p in parts):
            raise ValueError(
                f"sim_host_origin must be 'x,y,z', got {cfg.sim_host_origin!r}"
            )
    if not cfg.slice_id:
        raise ValueError("slice_id must be non-empty")
    if not 0 < cfg.extender_port < 65536:
        raise ValueError(f"extender_port {cfg.extender_port} out of range")
    if cfg.health_poll_seconds <= 0 or cfg.reservation_ttl_seconds <= 0:
        raise ValueError("poll/ttl intervals must be positive")
    if cfg.score_mode not in ("topology", "binpack", "spread"):
        raise ValueError(f"unknown score_mode {cfg.score_mode!r}")
    if (cfg.trace_sink_max_bytes < 0 or cfg.events_capacity < 0
            or cfg.events_sink_max_bytes < 0):
        raise ValueError(
            "trace_sink_max_bytes, events_capacity, and "
            "events_sink_max_bytes must be >= 0"
        )
    if cfg.retry_max_attempts < 1:
        raise ValueError("retry_max_attempts must be >= 1")
    if cfg.retry_base_delay_seconds <= 0 or cfg.retry_max_delay_seconds <= 0:
        raise ValueError("retry delays must be positive")
    if cfg.retry_max_delay_seconds < cfg.retry_base_delay_seconds:
        raise ValueError(
            "retry_max_delay_seconds must be >= retry_base_delay_seconds"
        )
    if not 0.0 <= cfg.retry_jitter < 1.0:
        raise ValueError("retry_jitter must be in [0, 1)")
    if cfg.retry_deadline_seconds < 0:
        raise ValueError("retry_deadline_seconds must be >= 0 (0 = none)")
    if cfg.retry_attempt_timeout_seconds < 0:
        raise ValueError(
            "retry_attempt_timeout_seconds must be >= 0 (0 = transport "
            "default)"
        )
    if cfg.circuit_failure_threshold < 0:
        raise ValueError(
            "circuit_failure_threshold must be >= 0 (0 = disabled)"
        )
    if cfg.circuit_reset_seconds <= 0:
        raise ValueError("circuit_reset_seconds must be positive")
    if cfg.circuit_half_open_probes < 1:
        raise ValueError("circuit_half_open_probes must be >= 1")
    if cfg.chaos_seed < 0:
        raise ValueError("chaos_seed must be >= 0 (0 = chaos off)")
    if not 0.0 <= cfg.snapshot_audit_rate <= 1.0:
        raise ValueError(
            "snapshot_audit_rate must be in [0, 1] (0 = audit off)"
        )
    if cfg.batch_max_pods < 1:
        raise ValueError("batch_max_pods must be >= 1")
    if cfg.generation_log_capacity < 0:
        raise ValueError(
            "generation_log_capacity must be >= 0 (0 = incremental "
            "resync off)"
        )
    if cfg.journal_enabled and not cfg.journal_path:
        # a journal with nowhere to write would provide no durability
        raise ValueError("journal_enabled requires journal_path")
    if cfg.journal_path and not cfg.journal_enabled:
        raise ValueError(
            "journal_path is set but journal_enabled is false — "
            "enable the journal or drop the path"
        )
    if cfg.journal_fsync not in ("off", "always"):
        raise ValueError(
            f"unknown journal_fsync {cfg.journal_fsync!r} (off | always)"
        )
    if cfg.journal_max_bytes < 0:
        raise ValueError("journal_max_bytes must be >= 0 (0 = uncapped)")
    if cfg.checkpoint_interval_seconds <= 0:
        raise ValueError("checkpoint_interval_seconds must be positive")
    if cfg.decisions_path and not cfg.decisions_enabled:
        raise ValueError(
            "decisions_path is set but decisions_enabled is false — "
            "enable decision provenance or drop the path"
        )
    if cfg.decisions_enabled and cfg.decisions_capacity < 1:
        raise ValueError("decisions_capacity must be >= 1 when enabled")
    if not 0.0 <= cfg.decisions_sample_rate <= 1.0:
        raise ValueError("decisions_sample_rate must be in [0, 1]")
    if cfg.decisions_seed < 0 or cfg.decisions_sink_max_bytes < 0:
        raise ValueError(
            "decisions_seed and decisions_sink_max_bytes must be >= 0"
        )
    if cfg.tenancy_quotas and not cfg.tenancy_enabled:
        # quotas without the plane would be silently unenforced — an
        # operator who wrote caps believes they are live; fail loudly
        raise ValueError(
            "tenancy_quotas is set but tenancy_enabled is false — "
            "enable tenancy or drop the quotas"
        )
    if cfg.tenancy_enabled:
        if not cfg.tenancy_label or not cfg.tenancy_default_tenant:
            raise ValueError(
                "tenancy_label and tenancy_default_tenant must be "
                "non-empty"
            )
        # surface quota-spec mistakes at config load, not at the first
        # webhook (lazy import: tenancy is only pulled in when used;
        # parse_quotas raises ValueError with the offending fragment)
        from tpukube_torch.tenancy import parse_quotas

        parse_quotas(cfg.tenancy_quotas)
    if cfg.tenancy_burn_threshold < 0:
        raise ValueError(
            "tenancy_burn_threshold must be >= 0 (0 = no SLO shedding)"
        )
    if cfg.tenancy_burn_window_seconds <= 0:
        raise ValueError("tenancy_burn_window_seconds must be positive")
    if cfg.cycle_interval_seconds < 0:
        raise ValueError(
            "cycle_interval_seconds must be >= 0 (0 = plan on demand)"
        )
    if cfg.filter_from_plan and not cfg.batch_enabled:
        raise ValueError(
            "filter_from_plan requires batch_enabled — without the "
            "batch planner there is no cycle plan to answer from"
        )
    if cfg.capacity_path and not cfg.capacity_enabled:
        raise ValueError(
            "capacity_path is set but capacity_enabled is false — "
            "enable capacity analytics or drop the path"
        )
    if cfg.capacity_enabled and cfg.capacity_samples < 1:
        raise ValueError("capacity_samples must be >= 1 when enabled")
    if cfg.capacity_enabled and cfg.capacity_sample_interval_seconds <= 0:
        raise ValueError(
            "capacity_sample_interval_seconds must be positive"
        )
    if cfg.capacity_sink_max_bytes < 0:
        raise ValueError("capacity_sink_max_bytes must be >= 0")
    if cfg.drain_max_concurrent_moves < 1:
        raise ValueError("drain_max_concurrent_moves must be >= 1")
    if cfg.drain_tenant_budget < 0:
        raise ValueError(
            "drain_tenant_budget must be >= 0 (0 = no per-tenant cap)"
        )
    if cfg.autoscale_enabled and not cfg.drain_enabled:
        # scale-down IS a drain: an autoscaler without the drain
        # choreography would silently never shrink
        raise ValueError(
            "autoscale_enabled requires drain_enabled — scale-down "
            "drives the drain choreography"
        )
    if cfg.autoscale_up_queue_depth < 1:
        raise ValueError("autoscale_up_queue_depth must be >= 1")
    if not 0.0 <= cfg.autoscale_down_utilization <= 1.0:
        raise ValueError(
            "autoscale_down_utilization must be in [0, 1]"
        )
    if cfg.autoscale_min_slices < 1:
        raise ValueError("autoscale_min_slices must be >= 1")
    if cfg.autoscale_max_slices < cfg.autoscale_min_slices:
        raise ValueError(
            "autoscale_max_slices must be >= autoscale_min_slices"
        )
    if cfg.autoscale_cooldown_seconds < 0:
        raise ValueError("autoscale_cooldown_seconds must be >= 0")
    if cfg.planner_replicas < 1:
        raise ValueError("planner_replicas must be >= 1")
    if cfg.shard_transport not in ("inprocess", "subprocess"):
        raise ValueError(
            f"unknown shard_transport {cfg.shard_transport!r} "
            f"(inprocess | subprocess)"
        )
    if cfg.wire_codec not in ("json", "binary"):
        raise ValueError(
            f"unknown wire_codec {cfg.wire_codec!r} (json | binary)"
        )
    if cfg.wire_compress_min_bytes < 0:
        raise ValueError("wire_compress_min_bytes must be >= 0")
    if cfg.planner_replicas > 1 and cfg.tenancy_quotas:
        # each replica's TenantLedger sees only its own slice set, so a
        # cluster-wide chip cap split across N replicas would silently
        # enforce N x the written quota — refuse at load rather than
        # under-enforce (same contract as quotas-without-the-plane)
        raise ValueError(
            "tenancy_quotas with planner_replicas > 1 is not yet "
            "shard-aware (each replica would enforce the full cap "
            "against its own slices) — run quotas unsharded, or drop "
            "them for the sharded plane"
        )
    return cfg
