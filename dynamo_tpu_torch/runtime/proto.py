"""Declared lifecycle state machines of the failure protocols, a copy of
``dynamo_tpu/runtime/proto.py``.

Every safety-critical concurrent state machine of the serving stack
(request lifecycle, worker drain, circuit breaker, revive journal, KV
transfer stream, planner P/D shift) is declared once, as a pure literal,
with the reference's states, edges, guards, invariants and docs, literal
for literal (one doc names the transfer plane without the reference's
history), so the two registries compare equal.

The serving code marks each transition of such a machine with an
anchor: a call ``proto.step(machine, from, to)``, which validates the
transition against the registry when ``DYN_PROTO_VALIDATE`` is set and
is a no-op otherwise, or a comment of the form
``# proto: <machine> <from>[|<from>...]-><to>`` beside a plain store.
An undeclared transition raises :class:`ProtocolError` under validation.
The reference's static conformance pass and model checker over these
declarations read only ``dynamo_tpu/``; they do not run over the port.

Keep every ``register_protocol(...)`` argument a literal: the
declarations are data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

from .config import env_bool


class ProtocolError(RuntimeError):
    """A runtime transition contradicts the declared protocol."""


@dataclass(frozen=True)
class ProtoEdge:
    frm: str
    to: str
    name: str
    when: Tuple[Tuple[str, tuple], ...]   # var -> allowed values
    set: Tuple[Tuple[str, object], ...]   # var -> new value (or "+1")
    doc: str


@dataclass(frozen=True)
class ProtoMachine:
    name: str
    doc: str
    states: Tuple[str, ...]
    initial: str
    terminal: Tuple[str, ...]
    lock: Optional[str]
    owners: Tuple[Tuple[str, str], ...]
    edges: Tuple[ProtoEdge, ...]
    vars: Tuple[Tuple[str, tuple], ...]
    init: Tuple[Tuple[str, object], ...]
    env: Tuple[ProtoEdge, ...]            # frm/to empty on env transitions
    invariants: Tuple[dict, ...]
    depth: int

    @property
    def edge_pairs(self) -> frozenset:
        return frozenset((e.frm, e.to) for e in self.edges)

    def has_edge(self, frm: str, to: str) -> bool:
        return (frm, to) in self.edge_pairs


PROTOCOLS: Dict[str, ProtoMachine] = {}


def _norm_when(when: Optional[dict]) -> Tuple[Tuple[str, tuple], ...]:
    out = []
    for k, v in sorted((when or {}).items()):
        vals = tuple(v) if isinstance(v, (tuple, list)) else (v,)
        out.append((k, vals))
    return tuple(out)


def _norm_edge(e: dict, env: bool = False) -> ProtoEdge:
    return ProtoEdge(
        frm="" if env else e["from"], to="" if env else e["to"],
        name=e.get("name") or (f"{e.get('from')}->{e.get('to')}"),
        when=_norm_when(e.get("when")),
        set=tuple(sorted((e.get("set") or {}).items())),
        doc=e.get("doc", ""))


def register_protocol(name: str, *, doc: str = "",
                      states: Sequence[str] = (), initial: str = "",
                      terminal: Sequence[str] = (),
                      lock: Optional[str] = None,
                      owners: Sequence[tuple] = (),
                      edges: Sequence[dict] = (),
                      vars: Optional[dict] = None,
                      init: Optional[dict] = None,
                      env: Sequence[dict] = (),
                      invariants: Sequence[dict] = (),
                      depth: int = 64) -> str:
    """Declare one lifecycle protocol; returns ``name`` so module
    constants double as registry keys."""
    sts = tuple(states)
    if initial not in sts:
        raise ValueError(f"protocol {name!r}: initial {initial!r} "
                         f"not in states")
    term = tuple(terminal)
    for t in term:
        if t not in sts:
            raise ValueError(f"protocol {name!r}: terminal {t!r} "
                             f"not in states")
    es = tuple(_norm_edge(e) for e in edges)
    for e in es:
        if e.frm not in sts or e.to not in sts:
            raise ValueError(f"protocol {name!r}: edge {e.name!r} uses "
                             f"undeclared state(s)")
        if e.frm in term:
            raise ValueError(f"protocol {name!r}: edge {e.name!r} leaves "
                             f"terminal state {e.frm!r}")
    PROTOCOLS[name] = ProtoMachine(
        name=name, doc=doc, states=sts, initial=initial, terminal=term,
        lock=lock, owners=tuple((str(m), str(a)) for m, a in owners),
        edges=es,
        vars=tuple(sorted((k, tuple(v)) for k, v in (vars or {}).items())),
        init=tuple(sorted((init or {}).items())),
        env=tuple(_norm_edge(e, env=True) for e in env),
        invariants=tuple(dict(i) for i in invariants),
        depth=int(depth))
    return name


def validation_enabled() -> bool:
    """Debug validation knob (DYN_PROTO_VALIDATE; default off)."""
    return env_bool("DYN_PROTO_VALIDATE")


def step(machine: str, frm: Union[str, Tuple[str, ...]], to: str) -> None:
    """Transition anchor at a protocol-state mutation site: a no-op
    unless ``DYN_PROTO_VALIDATE`` is set, else raises
    :class:`ProtocolError` on a transition the registry does not
    declare."""
    if not validation_enabled():
        return
    m = PROTOCOLS.get(machine)
    if m is None:
        raise ProtocolError(f"unknown protocol machine {machine!r}")
    froms = (frm,) if isinstance(frm, str) else tuple(frm)
    for f in froms:
        if f not in m.states or to not in m.states:
            raise ProtocolError(
                f"protocol {machine!r}: unknown state in {f!r}->{to!r}")
        if not m.has_edge(f, to):
            raise ProtocolError(
                f"protocol {machine!r}: transition {f!r}->{to!r} is not "
                f"declared — add the edge in runtime/proto.py or fix the "
                f"call site")


# ------------------------------------------------------------ the registry
#
# Every argument is a literal, as in the reference: the registry is data
# that equals the reference's machine for machine.

REQUEST_LIFECYCLE = register_protocol(
    "request.lifecycle",
    doc="One request through the engine scheduler: admission queue -> "
        "chunked prefill -> decode -> terminal finish/timeout/cancel, "
        "plus dynarevive mid-stream failover (resumed) and KV-pressure "
        "preemption (decode back to the admission queue). The "
        "environment injects client kills and worker deaths.",
    states=("admitted", "prefill", "decode", "resumed",
            "finished", "timeout", "cancelled"),
    initial="admitted",
    terminal=("finished", "timeout", "cancelled"),
    lock="loop",
    owners=(("engine/jax_engine.py", "finished"),),
    vars={"killed": (False, True), "worker_dead": (False, True)},
    init={"killed": False, "worker_dead": False},
    edges=(
        {"from": "admitted", "to": "prefill", "name": "dispatch_prefill",
         "doc": "scheduler admits the sequence (pages reserved)"},
        {"from": "prefill", "to": "decode", "name": "first_token",
         "doc": "prompt KV complete; first token sampled"},
        {"from": "decode", "to": "admitted", "name": "preempt",
         "doc": "KV pool exhausted: pages released, sequence requeued"},
        {"from": "prefill", "to": "finished", "name": "finish_at_prefill",
         "doc": "zero-budget / stop hit on the first sampled token"},
        {"from": "decode", "to": "finished", "name": "finish",
         "doc": "eos / stop / length budget reached"},
        {"from": "admitted", "to": "timeout", "name": "expire_admitted",
         "doc": "deadline spent while queued"},
        {"from": "prefill", "to": "timeout", "name": "expire_prefill"},
        {"from": "decode", "to": "timeout", "name": "expire_decode"},
        {"from": "admitted", "to": "cancelled", "name": "cancel_admitted",
         "when": {"killed": True}},
        {"from": "prefill", "to": "cancelled", "name": "cancel_prefill",
         "when": {"killed": True}},
        {"from": "decode", "to": "cancelled", "name": "cancel_decode",
         "when": {"killed": True}},
        {"from": "admitted", "to": "finished", "name": "reject_admitted",
         "doc": "admission-time reject (over-capacity prompt): the "
                "error finish is emitted without a prefill"},
        {"from": "prefill", "to": "resumed", "name": "revive_prefill",
         "when": {"worker_dead": True, "killed": False},
         "doc": "upstream died mid-prefill; the frontend journal "
                "re-dispatches to a sibling"},
        {"from": "decode", "to": "resumed", "name": "revive_decode",
         "when": {"worker_dead": True, "killed": False}},
        {"from": "resumed", "to": "prefill", "name": "redispatch",
         "when": {"killed": False}, "set": {"worker_dead": False},
         "doc": "resume prompt (prompt + emitted) lands on a sibling"},
        {"from": "resumed", "to": "cancelled", "name": "cancel_resumed",
         "when": {"killed": True},
         "doc": "the client died while the resume was being routed: "
                "should_resume's context.stopped check drops it"},
    ),
    env=(
        {"name": "client_kill", "when": {"killed": False},
         "set": {"killed": True},
         "doc": "SSE client disconnect / ctrl kill frame"},
        {"name": "worker_death", "when": {"worker_dead": False},
         "set": {"worker_dead": True},
         "doc": "serving worker crashes mid-stream"},
    ),
    invariants=(
        {"name": "no-resume-after-kill",
         "never_fire": {"edges": ("revive_prefill", "revive_decode",
                                  "redispatch"),
                        "when": {"killed": True}},
         "doc": "no resume decision or re-dispatch may ever be enabled "
                "for a request whose client is gone — the guards that "
                "revive.should_resume's context.stopped check implements"},
        {"name": "killed-request-terminates",
         "never_stable": {"killed": True,
                          "state": ("admitted", "prefill", "decode",
                                    "resumed")},
         "doc": "after a client kill the protocol always has a cancel "
                "path enabled — no killed request can wedge non-terminal"},
    ),
    depth=64)


SERVE_DRAIN = register_protocol(
    "serve_handle.drain",
    doc="ServeHandle graceful-drain lifecycle (dynarevive): live -> "
        "draining (discovery record deleted FIRST, then new dispatches "
        "nacked while in-flight streams finish and the stats plane keeps "
        "answering with draining=1) -> stopped. worker.kill chaos turns "
        "either live state into the wedged-process `dead` shape.",
    states=("live", "draining", "stopped", "dead"),
    initial="live",
    terminal=("stopped", "dead"),
    lock="loop",
    owners=(("runtime/component.py", "draining"),
            ("runtime/component.py", "_dead")),
    vars={"discovery": ("present", "deleted")},
    init={"discovery": "present"},
    edges=(
        {"from": "live", "to": "live", "name": "withdraw_discovery",
         "set": {"discovery": "deleted"},
         "doc": "begin_drain deletes the discovery record before any "
                "nack can be issued"},
        {"from": "live", "to": "draining", "name": "enter_draining",
         "when": {"discovery": "deleted"},
         "doc": "the nack flag flips only after the discovery delete "
                "completed (delete-before-nack ordering)"},
        {"from": "draining", "to": "draining", "name": "nack_request",
         "doc": "a request that still reaches the subjects gets a typed "
                "accepted=False nack"},
        {"from": "live", "to": "stopped", "name": "stop",
         "set": {"discovery": "deleted"},
         "doc": "fast teardown (SIGINT): unsubscribe + withdraw"},
        {"from": "draining", "to": "stopped", "name": "stop_after_drain"},
        {"from": "live", "to": "dead", "name": "worker_kill",
         "doc": "chaos worker.kill: planes go silent, lease + discovery "
                "record stay behind"},
        {"from": "draining", "to": "dead", "name": "worker_kill_draining"},
    ),
    env=(),
    invariants=(
        {"name": "delete-before-nack",
         "never_fire": {"edges": ("nack_request",),
                        "when": {"discovery": "present"}},
         "doc": "a draining worker must never nack while routers can "
                "still discover it — the nacked client would re-pick the "
                "same instance until its retry budget dies"},
    ),
    depth=32)


BREAKER = register_protocol(
    "breaker",
    doc="CircuitBreaker (dynaguard): closed -> open after N consecutive "
        "failures -> a SINGLE half-open probe (granted every "
        "probe_every-th denial or on clock expiry) -> closed on probe "
        "success / straight back to open on probe failure. The probe "
        "permit is a slot: release_probe() hands it back when the "
        "caller picked a different instance.",
    states=("closed", "open", "half_open"),
    initial="closed",
    terminal=(),
    lock="loop",
    owners=(("runtime/guard.py", "state"),),
    vars={"probe": (0, 1, 2)},
    init={"probe": 0},
    edges=(
        {"from": "closed", "to": "closed", "name": "success",
         "doc": "a success in closed resets the failure count"},
        {"from": "closed", "to": "open", "name": "trip",
         "doc": "threshold consecutive failures"},
        {"from": "open", "to": "open", "name": "deny",
         "doc": "an open breaker answers allow()=False and counts the "
                "denial toward the probe cadence"},
        {"from": "open", "to": "half_open", "name": "grant_probe",
         "when": {"probe": 0}, "set": {"probe": "+1"},
         "doc": "probe cadence due: ONE permit converts to half-open"},
        {"from": "half_open", "to": "half_open", "name": "probe_regrant",
         "when": {"probe": 0}, "set": {"probe": "+1"},
         "doc": "a released permit may be re-granted — never a second "
                "concurrent one"},
        {"from": "half_open", "to": "half_open", "name": "release_probe",
         "when": {"probe": 1}, "set": {"probe": 0},
         "doc": "the caller picked another instance: slot returned"},
        {"from": "half_open", "to": "closed", "name": "probe_success",
         "set": {"probe": 0}},
        {"from": "half_open", "to": "open", "name": "probe_failure",
         "set": {"probe": 0}},
        {"from": "open", "to": "closed", "name": "reset",
         "set": {"probe": 0},
         "doc": "external evidence of recovery (fresh discovery put)"},
    ),
    env=(),
    invariants=(
        {"name": "single-probe", "never": {"probe": 2},
         "doc": "two concurrent half-open probes would double-load a "
                "recovering instance; every grant edge is guarded on "
                "probe==0"},
        {"name": "probe-only-half-open",
         "never": {"state": ("closed", "open"), "probe": (1, 2)},
         "doc": "a probe permit cannot outlive the half-open state"},
    ),
    depth=32)


REVIVE_JOURNAL = register_protocol(
    "revive.journal",
    doc="One ReviveJournal entry (dynarevive): opened at dispatch, "
        "closed EXACTLY ONCE at finish AND on client kill (the "
        "Context.on_kill hook) so the bounded ring holds one entry per "
        "in-flight request — leak-proof under abandonment. Ring "
        "overflow / eviction only clears resumability, never "
        "correctness.",
    states=("open", "closed"),
    initial="open",
    terminal=("closed",),
    lock="loop",
    owners=(("runtime/revive.py", "resumable"),),
    vars={"request": ("streaming", "finished", "killed"),
          "resumable": (True, False), "closes": (0, 1, 2)},
    init={"request": "streaming", "resumable": True, "closes": 0},
    edges=(
        {"from": "open", "to": "open", "name": "overflow",
         "set": {"resumable": False},
         "doc": "journal token bound exceeded: the request loses "
                "resumability, never correctness"},
        {"from": "open", "to": "open", "name": "evict",
         "set": {"resumable": False},
         "doc": "ring capacity eviction (leak-bug backstop)"},
        {"from": "open", "to": "closed", "name": "close_on_finish",
         "when": {"request": "finished"}, "set": {"closes": "+1"},
         "doc": "eager close at the finish chunk (consumers abandon the "
                "stream there; the generator finalizer would leak until "
                "GC)"},
        {"from": "open", "to": "closed", "name": "close_on_kill",
         "when": {"request": "killed"}, "set": {"closes": "+1"},
         "doc": "the processor registers journal close on Context.on_kill"},
        {"from": "open", "to": "closed", "name": "close_final",
         "when": {"request": ("finished", "killed")},
         "set": {"closes": "+1"},
         "doc": "the generate() finally backstop"},
    ),
    env=(
        {"name": "finish", "when": {"request": "streaming"},
         "set": {"request": "finished"}},
        {"name": "client_kill", "when": {"request": "streaming"},
         "set": {"request": "killed"}},
    ),
    invariants=(
        {"name": "close-exactly-once", "never": {"closes": 2},
         "doc": "every close edge leaves `open`, so a second close is "
                "unrepresentable (pop is idempotent in code)"},
        {"name": "closed-after-finish",
         "never_stable": {"request": ("finished", "killed"),
                          "state": "open"},
         "doc": "no terminal request may leave its entry open once the "
                "protocol quiesces — the leak the eager/on_kill/finally "
                "closes exist to prevent"},
    ),
    depth=32)


KV_TRANSFER_STREAM = register_protocol(
    "kv_transfer.stream",
    doc="Receiver-side KV transfer stream (the chunked plane): chunks "
        "inject in order, the final chunk is the commit that resolves "
        "the decode-side waiter; sender aborts and connection drops "
        "fail the waiter fast, and payloads arriving after terminal "
        "state are dropped by the late-write guard (the pages may "
        "belong to another request by then).",
    states=("streaming", "committed", "aborted", "failed"),
    initial="streaming",
    terminal=("committed", "aborted", "failed"),
    lock="loop",
    owners=(("llm/disagg/transfer.py", "committed"),
            ("llm/disagg/transfer.py", "failed")),
    vars={"conn": ("up", "down"), "resolved": (0, 1, 2)},
    init={"conn": "up", "resolved": 0},
    edges=(
        {"from": "streaming", "to": "committed", "name": "commit",
         "when": {"conn": "up"}, "set": {"resolved": "+1"},
         "doc": "final chunk ingested with all chunks received: waiter "
                "resolves with the first token"},
        {"from": "streaming", "to": "aborted", "name": "abort",
         "set": {"resolved": "+1"},
         "doc": "sender abort frame: drop partial state, fail the "
                "waiter now"},
        {"from": "streaming", "to": "failed", "name": "fail",
         "set": {"resolved": "+1"},
         "doc": "inject error / incomplete stream / unknown-request "
                "late-write guard"},
        {"from": "streaming", "to": "failed", "name": "fail_on_drop",
         "when": {"conn": "down"}, "set": {"resolved": "+1"},
         "doc": "connection dropped mid-stream: the uncommitted stream "
                "fails instead of idling out the prefill timeout"},
    ),
    env=(
        {"name": "conn_drop", "when": {"conn": "up"},
         "set": {"conn": "down"}},
    ),
    invariants=(
        {"name": "resolve-exactly-once", "never": {"resolved": 2},
         "doc": "the decode-side waiter resolves exactly once — every "
                "resolving edge leaves `streaming` (the st.committed "
                "re-checks in code)"},
        {"name": "fail-fast-on-drop",
         "never_stable": {"state": "streaming", "conn": "down"},
         "doc": "a dead connection must never leave a stream parked in "
                "`streaming` (the decode side would idle out its full "
                "prefill timeout)"},
    ),
    depth=32)


PD_SHIFT = register_protocol(
    "planner.pd_shift",
    doc="dynaslo P/D rebalance control loop: the planner publishes at "
        "most one pd_shift advisory per cooldown (TTFT vs ITL burn "
        "pressure), the fleet controller actuates it by flipping ONE "
        "donor worker's role in place, and the cooldown gate readmits "
        "the next decision only after it expires.",
    states=("idle", "advisory", "actuated"),
    initial="idle",
    terminal=(),
    lock="loop",
    owners=(),
    vars={"cooldown": (False, True)},
    init={"cooldown": False},
    edges=(
        {"from": "idle", "to": "advisory", "name": "publish_shift",
         "when": {"cooldown": False}, "set": {"cooldown": True},
         "doc": "decide_pd: one side's SLO budget burns while the other "
                "has slack"},
        {"from": "advisory", "to": "actuated", "name": "actuate_flip",
         "doc": "fleet controller flips the newest donor-role worker"},
        {"from": "advisory", "to": "idle", "name": "no_donor",
         "doc": "no worker holds the donor role: advisory expires "
                "without actuation"},
        {"from": "actuated", "to": "idle", "name": "cooldown_gate",
         "doc": "decide_pd's shift_cooldown_s gate readmits decisions"},
    ),
    env=(
        {"name": "cooldown_expire",
         "when": {"state": "idle", "cooldown": True},
         "set": {"cooldown": False}},
    ),
    invariants=(
        {"name": "one-shift-per-cooldown",
         "never": {"state": ("advisory", "actuated"), "cooldown": False},
         "doc": "a second advisory can never be decided while one is in "
                "flight — the publish edge sets the cooldown atomically"},
    ),
    depth=32)
