"""Declared wire-schema registry, a copy of ``dynamo_tpu/runtime/wire.py``
trimmed to the frames the port sends: the DCP request plane (envelope,
ack, stats reply), the server's pushes (watch, msg, req), the
disaggregated prefill queue's job, the KV transfer plane (bulk, chunk,
abort, ack) and the TCP call-home response plane (hello, data, complete,
err, ctrl). The frames are byte for byte the reference's, so a port
process and a reference process talk to each other.

Each frame is declared once with field name, type, required/optional and
since-version. Encode sites pass headers through :func:`checked`, decode
sites through :func:`decoded`; both are identity functions unless
``DYN_WIRE_VALIDATE`` is set, when they check real traffic against the
table. The blackbox frame is not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

from .config import env_bool


class WireError(RuntimeError):
    """Base class for wire-schema violations."""


class WireValidationError(WireError):
    """A frame's content contradicts its declared schema."""


class UnknownWireFrame(WireError):
    """A frame (or header) matches no registered schema."""


class WireVersionMismatch(WireError):
    """Peer sent a frame stamped with a schema version newer than ours."""


# type name (as written in declarations) -> accepted Python types.
# ``None`` values always pass (an explicit-null field is treated as absent).
_TYPES: Dict[str, tuple] = {
    "str": (str,),
    "int": (int,),
    "float": (int, float),
    "bool": (bool,),
    "bytes": (bytes, bytearray, memoryview),
    "list": (list, tuple),
    "dict": (dict,),
    "any": (object,),
}


@dataclass(frozen=True)
class WireField:
    name: str
    type: str          # key into _TYPES
    required: bool
    since: int         # frame version that introduced the field
    doc: str


@dataclass(frozen=True)
class WireFrame:
    name: str
    version: int
    doc: str
    # discriminator hints for frame inference: key -> expected value, or
    # key -> None meaning "key must be present" (any value)
    when: Dict[str, object]
    fields: Tuple[WireField, ...]

    @property
    def field_names(self) -> frozenset:
        return frozenset(f.name for f in self.fields)

    @property
    def required_names(self) -> frozenset:
        return frozenset(f.name for f in self.fields if f.required)

    def field(self, name: str) -> Optional[WireField]:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    def matches(self, header: dict) -> bool:
        """Discriminator + shape test used by frame inference."""
        for key, want in self.when.items():
            if key not in header:
                return False
            if want is not None and header.get(key) != want:
                return False
        keys = set(header)
        return self.required_names <= keys and keys <= self.field_names


FRAMES: Dict[str, WireFrame] = {}


def register_frame(name: str, *, version: int = 1, doc: str = "",
                   when: Optional[dict] = None,
                   fields: Sequence[tuple] = ()) -> str:
    """Declare one wire frame; returns ``name`` so module constants double
    as registry keys. ``fields`` rows are literal tuples
    ``(name, type, "required"|"optional", since_version, doc)``."""
    fs = tuple(WireField(n, t, mode == "required", since, fdoc)
               for n, t, mode, since, fdoc in fields)
    FRAMES[name] = WireFrame(name=name, version=version, doc=doc,
                             when=dict(when or {}), fields=fs)
    return name


def frame_version(name: str) -> int:
    return FRAMES[name].version


def validation_enabled() -> bool:
    """Debug validation knob (DYN_WIRE_VALIDATE; default off)."""
    return env_bool("DYN_WIRE_VALIDATE")


def _check_types(frame: WireFrame, header: dict) -> None:
    for f in frame.fields:
        val = header.get(f.name)
        if val is None:
            continue
        if not isinstance(val, _TYPES[f.type]):
            raise WireValidationError(
                f"frame {frame.name!r} field {f.name!r} expects {f.type}, "
                f"got {type(val).__name__}")


def _validate_encode(frame: WireFrame, header: dict) -> None:
    unknown = set(header) - frame.field_names
    if unknown:
        raise WireValidationError(
            f"frame {frame.name!r} encoded with undeclared field(s) "
            f"{sorted(unknown)}; declare them in dynamo_tpu_torch/runtime/wire.py")
    missing = frame.required_names - set(header)
    if missing:
        raise WireValidationError(
            f"frame {frame.name!r} encoded without required field(s) "
            f"{sorted(missing)}")
    for key, want in frame.when.items():
        if want is not None and header.get(key) != want:
            raise WireValidationError(
                f"frame {frame.name!r} expects {key}={want!r}, "
                f"got {header.get(key)!r}")
    _check_types(frame, header)


def _validate_decode(frames: Iterable[WireFrame], header: dict) -> None:
    """Receiver-side check: unknown keys and wrong types fail; *absent*
    fields never do (absent-field = legacy peer, accepted by policy)."""
    frames = list(frames)
    known = frozenset().union(*(f.field_names for f in frames))
    unknown = set(header) - known
    if unknown:
        names = "/".join(f.name for f in frames)
        raise WireValidationError(
            f"frame {names} decoded with undeclared field(s) "
            f"{sorted(unknown)}; declare them in dynamo_tpu_torch/runtime/wire.py")
    # type-check each present field against the first frame declaring it
    for key in header:
        for f in frames:
            fld = f.field(key)
            if fld is not None:
                _check_types(f, {key: header[key]})
                break


def checked(frame: str, header: dict) -> dict:
    """Encode-site anchor: validates ``header`` against the registered
    frame when ``DYN_WIRE_VALIDATE`` is on; identity otherwise."""
    if validation_enabled():
        _validate_encode(FRAMES[frame], header)
    return header


def decoded(frame: Union[str, Tuple[str, ...]], header: dict) -> dict:
    """Decode-site anchor (see :func:`checked`); ``frame`` may be a tuple
    when one receive path handles several frame shapes."""
    if validation_enabled():
        names = (frame,) if isinstance(frame, str) else frame
        _validate_decode([FRAMES[n] for n in names], header)
    return header


def infer_frame(header: dict) -> WireFrame:
    """Match a raw header to exactly one registered frame (the codec's
    debug hook)."""
    candidates = [f for f in FRAMES.values() if f.matches(header)]
    if len(candidates) > 1:
        # prefer frames with an explicit discriminator over shape-only hits
        strong = [f for f in candidates if f.when]
        if len(strong) == 1:
            candidates = strong
    if not candidates:
        raise UnknownWireFrame(
            f"header with keys {sorted(header)} matches no registered wire "
            f"frame; declare it in dynamo_tpu_torch/runtime/wire.py")
    if len(candidates) > 1:
        raise UnknownWireFrame(
            f"header with keys {sorted(header)} is ambiguous between "
            f"frames {sorted(f.name for f in candidates)}")
    return candidates[0]


def validate_outgoing(header: dict) -> None:
    """codec.encode/encode_parts debug hook: every frame leaving through
    the two-part codec must match a registered schema."""
    _validate_encode(infer_frame(header), header)


# ------------------------------------------------------------- the registry
#
# Field rows: (name, type, "required"|"optional", since, doc).

# --- DCP request plane (runtime/component.py) ------------------------------

DCP_REQUEST_ENVELOPE = register_frame(
    "dcp.request_envelope", version=3,
    doc="Request-plane envelope a Client sends to a served endpoint; the "
        "response streams back over the TCP call-home connection named in "
        "`conn`.",
    fields=[
        ("req_id", "str", "required", 1, "request/context id (rid)"),
        ("conn", "dict", "required", 1,
         "TcpConnectionInfo {address, subject} for the call-home stream"),
        ("payload", "bytes", "required", 1, "msgpack-packed request body"),
        ("trace", "dict", "optional", 2,
         "dyntrace ctx {trace_id, span_id}; absent = not sampled"),
        ("deadline_ms", "int", "optional", 3,
         "remaining end-to-end budget in ms at send time (each hop "
         "re-stamps what is left); absent = no deadline"),
    ])

DCP_REQUEST_ACK = register_frame(
    "dcp.request_ack", version=1,
    doc="Worker's request-plane acceptance reply (responses themselves "
        "arrive over TCP).",
    fields=[
        ("accepted", "bool", "required", 1, "request admitted to a worker"),
        ("instance_id", "int", "optional", 1,
         "serving instance's lease id (diagnostic; not consumed)"),
    ])

DCP_STATS_REPLY = register_frame(
    "dcp.stats_reply", version=1,
    doc="Per-instance stats-plane scrape reply (metrics aggregator, KV "
        "router and planner all consume `data` as ForwardPassMetrics).",
    fields=[
        ("instance_id", "int", "optional", 1, "lease id (diagnostic)"),
        ("subject", "str", "optional", 1, "instance subject (diagnostic)"),
        ("inflight", "int", "optional", 1,
         "requests in flight on the instance (diagnostic)"),
        ("data", "dict", "required", 1,
         "stats_handler() payload (ForwardPassMetrics superset)"),
    ])

DCP_PUSH_WATCH = register_frame(
    "dcp.push_watch", version=1,
    doc="Server push: one KV prefix-watch event.",
    when={"push": "watch"},
    fields=[
        ("push", "str", "required", 1, "push discriminator: 'watch'"),
        ("watch_id", "int", "required", 1, "client-chosen watch id"),
        ("event", "str", "required", 1, "'put' | 'delete'"),
        ("key", "str", "required", 1, "KV key"),
        ("value", "bytes", "optional", 1, "new value; absent on delete"),
    ])

DCP_PUSH_MSG = register_frame(
    "dcp.push_msg", version=1,
    doc="Server push: one pub/sub delivery.",
    when={"push": "msg"},
    fields=[
        ("push", "str", "required", 1, "push discriminator: 'msg'"),
        ("sid", "int", "required", 1, "subscription id"),
        ("subject", "str", "required", 1, "published subject"),
        ("payload", "bytes", "required", 1, "published body"),
    ])

DCP_PUSH_REQ = register_frame(
    "dcp.push_req", version=1,
    doc="Server push: one request-plane delivery expecting a reply.",
    when={"push": "req"},
    fields=[
        ("push", "str", "required", 1, "push discriminator: 'req'"),
        ("sid", "int", "required", 1, "subscription id"),
        ("subject", "str", "required", 1, "request subject"),
        ("payload", "bytes", "required", 1, "request body"),
        ("reply", "int", "required", 1, "server-side reply-routing id"),
    ])

# --- disaggregated prefill queue (llm/disagg/protocols.py) -----------------

PREFILL_REMOTE_REQUEST = register_frame(
    "prefill.remote_request", version=3,
    doc="One queued remote-prefill job (decode worker -> prefill queue -> "
        "any prefill worker).",
    fields=[
        ("request_id", "str", "required", 1, "decode-side request id"),
        ("token_ids", "list", "required", 1, "full prompt token ids"),
        ("sampling", "dict", "required", 1, "SamplingOptions dict"),
        ("eos_token_ids", "list", "required", 1, "stop-token ids"),
        ("page_ids", "list", "required", 1,
         "DECODE-side pool pages reserved for the prompt KV"),
        ("skip_pages", "int", "required", 1,
         "leading pages already valid on the decode side (prefix hits)"),
        ("engine_id", "int", "required", 1,
         "decode engine instance id (transfer-endpoint lookup key)"),
        ("trace_ctx", "dict", "optional", 2,
         "dyntrace ctx of the decode-side request; absent = no parent"),
        ("deadline_ms", "int", "optional", 3,
         "remaining request budget in ms at enqueue time; the prefill "
         "worker drops jobs whose budget is spent and caps its ack "
         "waits by what remains. Absent = no deadline"),
    ])

# --- KV transfer plane (llm/disagg/transfer.py) ----------------------------

KV_TRANSFER_BULK = register_frame(
    "kv_transfer.bulk", version=2,
    doc="Legacy single-frame KV payload: all pages + the first sampled "
        "token in one two-part message (chunk_pages=0).",
    fields=[
        ("request_id", "str", "required", 1, "decode-side request id"),
        ("page_ids", "list", "required", 1, "destination pool pages"),
        ("shape", "list", "required", 1, "[L, n, KV, page_size, hd]"),
        ("dtype", "str", "required", 1,
         "ORIGINAL pool dtype to restore into (even when quantized)"),
        ("k_len", "int", "required", 1, "byte length of the K half"),
        ("first_token", "int", "required", 1, "remotely sampled first token"),
        ("quant", "str", "optional", 1, "'int8' when compressed"),
        ("trace", "dict", "optional", 2, "dyntrace ctx {trace_id, span_id}"),
        ("v", "int", "optional", 2, "frame schema version; absent = 1"),
    ])

KV_TRANSFER_CHUNK = register_frame(
    "kv_transfer.chunk", version=2,
    doc="One streamed KV chunk; the final chunk (chunk_idx == n_chunks-1) "
        "is the commit and carries the first token.",
    when={"kind": "chunk"},
    fields=[
        ("kind", "str", "required", 1, "frame discriminator: 'chunk'"),
        ("request_id", "str", "required", 1, "decode-side request id"),
        ("chunk_idx", "int", "required", 1, "0-based chunk index"),
        ("n_chunks", "int", "required", 1, "total chunks in the stream"),
        ("page_ids", "list", "required", 1, "destination pages this chunk"),
        ("shape", "list", "required", 1, "[L, n, KV, page_size, hd]"),
        ("dtype", "str", "required", 1, "ORIGINAL pool dtype"),
        ("k_len", "int", "required", 1, "byte length of the K half"),
        ("quant", "str", "optional", 1, "'int8' when compressed"),
        ("first_token", "int", "optional", 1, "commit chunk only"),
        ("trace", "dict", "optional", 2, "commit chunk only; dyntrace ctx"),
        ("v", "int", "optional", 2, "frame schema version; absent = 1"),
    ])

KV_TRANSFER_ABORT = register_frame(
    "kv_transfer.abort", version=2,
    doc="Sender-side teardown: drop the stream's partial state and fail "
        "the decode-side waiter now.",
    when={"kind": "abort"},
    fields=[
        ("kind", "str", "required", 1, "frame discriminator: 'abort'"),
        ("request_id", "str", "required", 1, "stream being aborted"),
        ("v", "int", "optional", 2, "frame schema version; absent = 1"),
    ])

KV_TRANSFER_ACK = register_frame(
    "kv_transfer.ack", version=2,
    doc="Receiver's per-frame acknowledgement, demultiplexed by "
        "request_id on the sender.",
    when={"ok": None},
    fields=[
        ("ok", "bool", "required", 1, "frame ingested successfully"),
        ("request_id", "str", "required", 1, "ack demux key"),
        ("chunk_idx", "int", "optional", 1,
         "echo of the acked chunk (diagnostic)"),
        ("committed", "bool", "optional", 1,
         "set on the ack of a committed final chunk"),
        ("error", "str", "optional", 1, "failure detail when ok=false"),
        ("conn_lost", "bool", "optional", 1,
         "client-synthesized on connection loss (never on the wire)"),
        ("v", "int", "optional", 2, "frame schema version; absent = 1"),
    ])

# --- TCP call-home response plane (runtime/tcp.py) -------------------------

TCP_HELLO = register_frame(
    "tcp.hello", version=1,
    doc="Worker->caller handshake naming the pending stream.",
    when={"t": "hello"},
    fields=[
        ("t", "str", "required", 1, "frame discriminator: 'hello'"),
        ("subject", "str", "required", 1, "pending-stream uuid"),
    ])

TCP_DATA = register_frame(
    "tcp.data", version=1,
    doc="One streamed response item (body = packed Annotated envelope).",
    when={"t": "data"},
    fields=[("t", "str", "required", 1, "frame discriminator: 'data'")])

TCP_COMPLETE = register_frame(
    "tcp.complete", version=1,
    doc="End-of-stream sentinel.",
    when={"t": "complete"},
    fields=[("t", "str", "required", 1, "frame discriminator: 'complete'")])

TCP_ERR = register_frame(
    "tcp.err", version=1,
    doc="Stream-fatal error sentinel.",
    when={"t": "err"},
    fields=[
        ("t", "str", "required", 1, "frame discriminator: 'err'"),
        ("message", "str", "required", 1, "error detail"),
        ("kind", "str", "optional", 1,
         "worker-side exception class name (maps client errors to 4xx)"),
    ])

TCP_CTRL = register_frame(
    "tcp.ctrl", version=1,
    doc="Caller->worker control frame on the full-duplex stream.",
    when={"t": "ctrl"},
    fields=[
        ("t", "str", "required", 1, "frame discriminator: 'ctrl'"),
        ("kind", "str", "required", 1, "'stop' | 'kill'"),
    ])

BLACKBOX_CAPTURE = register_frame(
    "blackbox.capture", version=1,
    doc="dynablack incident fan-out on the `<namespace>.blackbox.capture` "
        "pub/sub subject. The tripping worker broadcasts an origin "
        "announcement (no `rings`); each sibling replies on the same "
        "subject with its shadow rings attached so all rings merge under "
        "one incident id. Optional plane: peers that never subscribe "
        "simply don't contribute (dynaflow compat policy).",
    when={"event": "blackbox.capture"},
    fields=[
        ("event", "str", "required", 1,
         "frame discriminator: 'blackbox.capture'"),
        ("incident_id", "str", "required", 1,
         "incident id all contributions merge under"),
        ("trigger", "str", "required", 1,
         "tripping trigger name (slo_burn_rate, breaker_open, ...)"),
        ("worker_label", "str", "required", 1,
         "sender's worker label (echo suppression + contribution origin)"),
        ("at_ms", "float", "optional", 1,
         "originator's capture wall time (epoch ms; diagnostic)"),
        ("rings", "dict", "optional", 1,
         "sender's shadow rings {label: {anchors, events}}; absent on "
         "the originating broadcast, present on contributions"),
    ])
