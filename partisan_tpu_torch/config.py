"""Static configuration — the port's own copy of ``partisan_tpu/config.py``.

Importing ``partisan_tpu.config`` runs ``partisan_tpu/__init__``, which
imports JAX and flax, so the port keeps this copy; field for field it
equals the reference's (``tests/test_torch_config.py`` pins names,
defaults and the env/mapping tiers).  ``use_pallas_route`` is kept so the
two dataclasses match, but ``True`` raises: see its comment.

Mirrors the reference's config system (``src/partisan_config.erl:37-151`` and
``include/partisan.hrl``) as a frozen dataclass: reads are attribute lookups on
an immutable object that is closed over by jitted step functions, which is the
JAX-idiomatic analog of the reference's compiled-module globals
(``src/partisan_mochiglobal.erl`` — deliberately NOT ported, see SURVEY §7.4).

Timer cadences in the reference are wall-clock milliseconds
(``include/partisan.hrl:28,58-59``); the simulator is round-synchronous, so we
express every cadence in *rounds*.  With the default mapping of 1 round = 1 s:
periodic gossip 10 s -> 10 rounds, connection retry / retransmit / plumtree
lazy tick 1 s -> 1 round, shuffle + exchange 10 s -> 10 rounds, random
promotion 5 s -> 5 rounds.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen simulation config.

    Field defaults follow ``partisan_config:init/0``
    (``src/partisan_config.erl:37-151``) where a corresponding key exists, and
    ``include/partisan.hrl`` constants otherwise.  ARWL/PRWL follow the config
    init values (5/30), not the module fallbacks (6/6) — ``partisan_sup``
    always runs ``partisan_config:init`` first (see SURVEY §7.3).
    """

    # --- cluster shape -----------------------------------------------------
    n_nodes: int = 64                  # N virtual nodes (rows of the state arrays)

    # --- HyParView (partisan_hyparview_peer_service_manager.erl:310-312) ---
    max_active_size: int = 6
    min_active_size: int = 3
    max_passive_size: int = 30
    arwl: int = 5                      # active random-walk length  (partisan_config.erl:103)
    prwl: int = 30                     # passive random-walk length (partisan_config.erl:104)
    shuffle_k_active: int = 3          # k_active()  (hyparview :1559-1562)
    shuffle_k_passive: int = 4         # k_passive() (hyparview :1563-1565)
    shuffle_interval: int = 10         # passive_view_maintenance, 10 s (hyparview :27)
    random_promotion_interval: int = 5  # 5 s (hyparview :28)

    # --- gossip / membership strategies ------------------------------------
    fanout: int = 5                    # ?FANOUT (partisan.hrl:5)
    periodic_interval: int = 10        # ?PERIODIC_INTERVAL 10000 ms (partisan.hrl:28)
    scamp_c: int = 5                   # ?SCAMP_C_VALUE (partisan.hrl:31)
    scamp_message_window: int = 10     # ?SCAMP_MESSAGE_WINDOW (partisan.hrl:32)
    scamp_exact_keep_probability: bool = True
    # ^ the reference quantizes SCAMP's keep probability to a biased coin
    #   (scamp_v2 :292-296, 352-360); True uses the paper's 1/(1+|view|),
    #   False reproduces the reference's 0.4 coin for behavioural parity.
    scamp_paper_fanout: bool = True
    # ^ True: a contact receiving a NEW subscription fans copies to its whole
    #   partial view + c extras (the SCAMP paper's subscription algorithm,
    #   which yields the (c+1)·ln N view-size fixed point).  False: the
    #   reference's shape — the *joiner* fans over its own (trivial) view
    #   (v1 :51-100, v2 :64-117), so every join injects only ~3 walks.
    scamp_walker_slots: int = 8
    # ^ C: per-subject concurrent walk-copy slots in the DENSE SCAMP
    #   re-layout (models/scamp_dense.walker_caps).  The walker plane's two
    #   reverse_select sorts run over N·C slots, so C trades join fan-out
    #   fidelity for throughput: 8 (default) truncates a typical join fan
    #   (mean view ~4 + scamp_c extras, counted in walk_truncated) and
    #   runs ~55-60% faster on chip than 16, with views settling thinner
    #   (mean 3.6-3.8 vs 4.3-5.6 at 2^16) but weak connectivity unchanged
    #   (99.59% vs 99.6% reached, results.csv round 4).  Raise back toward
    #   16 when a workload needs the fatter-view equilibrium more than the
    #   throughput; tests/test_scamp_dense.py's engine-matched parity band
    #   red-lines below ~6.

    # --- plumtree (partisan.hrl:58-59, plumtree_broadcast.erl) --------------
    lazy_tick_period: int = 1          # 1 s
    exchange_tick_period: int = 10     # 10 s
    broadcast_start_exchange_limit: int = 1
    broadcast_heartbeat_interval: int = 10  # plumtree_backend heartbeats, 10 s

    # --- messaging QoS ------------------------------------------------------
    parallelism: int = 1               # ?PARALLELISM (partisan.hrl:16): k lanes per edge
    channels: Tuple[str, ...] = ("undefined",)  # ?CHANNELS (partisan.hrl:19)
    monotonic_channels: Tuple[str, ...] = ()    # {monotonic, C} channels keep-latest
    retransmit_interval: int = 1       # retransmit timer 1 s (pluggable :1299-1301)
    retransmit_backoff_factor: int = 1
    # ^ interval multiplier per retransmission ATTEMPT (the self-healing
    #   leg): attempt k waits interval * factor^k rounds.  The
    #   reference re-sends everything outstanding on a FIXED 1 s timer
    #   (pluggable :905-942); 1 (default) reproduces that bit-for-bit,
    #   2 halves retransmit pressure per surviving loss under sustained
    #   faults (tests/test_chaos.py asserts the reduction at 20% loss).
    retransmit_backoff_max: int = 0    # interval ceiling in rounds (0 = none)
    retransmit_jitter: int = 0
    # ^ deterministic per-(node, slot, attempt) jitter in [0, jitter]
    #   extra rounds, desynchronizing cluster-wide retransmit storms
    #   after a heal; hash-derived, so runs stay replayable.  0 = off.
    retransmit_max_attempts: int = 0
    # ^ give-up threshold: a slot retransmitted this many times is
    #   DEAD-LETTERED — freed and counted (dead_lettered, surfaced via
    #   health_counters/telemetry) instead of retried forever.  0 (the
    #   reference's shape: retry until acked) = never give up.
    connection_retry_interval: int = 1  # reconnect tick 1 s (pluggable :1304-1306)
    relay_ttl: int = 5                 # ?RELAY_TTL (partisan.hrl:9)
    keepalive_interval: int = 2        # rounds between active-view keepalives
    keepalive_ttl: int = 8             # rounds without keepalive => link dead
    # ^ the failure-detection analog of the reference's TCP keepalive +
    #   linked-process EXIT pruning (partisan_socket.erl:17-19, SURVEY §5.3):
    #   the simulator's transport can drop messages (inbox overflow), so
    #   dead/one-sided active edges are detected by keepalive expiry instead
    #   of socket death.
    ingress_delay: int = 0             # server-side receive sleep, in rounds
    egress_delay: int = 0              # client-side send sleep, in rounds
    # ^ partisan_peer_service_server.erl:85-90 / _client.erl:88-93.  In a
    #   round-synchronous simulator both collapse to extra rounds in
    #   flight, applied once at emission (their sum); the two knobs are
    #   kept distinct so each reference config group maps to its own
    #   field (with_ingress_delay / with_egress_delay).
    broadcast: bool = False            # tree-based transitive relay when disconnected
    distance_enabled: bool = False     # ?DISTANCE_ENABLED (partisan.hrl:40)
    distance_interval: int = 10        # ping/pong distance metrics (pluggable :852-873)

    # --- simulator capacities (fixed shapes; SURVEY §7.3 "dynamic sparsity")
    # (per-handler emission caps live on each protocol class, which alone
    # knows its fan-out; only the shared routing cap lives here)
    inbox_cap: int = 16                # max messages a node processes per round
    auto_tune: bool = True
    # ^ derive the engine performance knobs below (node_emit_cap,
    #   deliver_gather_cap) from N when they are unset, so a naive
    #   Config(n_nodes=...) hits the measured-optimal program shape the
    #   way the reference runs its whole suite on config defaults
    #   (test/partisan_SUITE.erl).  See engine.autotune for the rule;
    #   False = the knobs mean exactly what they say (None = unbounded /
    #   gated-dense).  Explicitly-set knobs always win over the rule.
    node_emit_cap: Optional[int] = None
    # ^ per-node emission budget per round (handler + tick emissions
    #   combined): when set, the engine collects emissions with a
    #   RUNNING-OFFSET write into a fixed [N, C] region instead of
    #   materializing the [N, K*E] worst-case buffer and argsorting it —
    #   the dominant engine cost for wide-emit protocols (SCAMP at
    #   N=1024 carried ~1.5M mostly-empty slots through that sort; the
    #   offset collect moves ~N*C).  The carry buffer shrinks to
    #   N*(C+4) as well (engine.default_out_cap).  Entry order per node
    #   is slot-major with tick emissions last — identical to the
    #   unbounded path, so per-connection FIFO semantics are unchanged;
    #   per-node overflow is counted in out_dropped, never silent.
    #   None = unbounded (exact worst-case shapes).
    deliver_gate: bool = True
    # ^ False removes the per-(slot, type) emptiness conds from the
    #   deliver loop: every handler runs full-batch every slot.  The
    #   gates are what make SMALL-N rounds cheap (skip absent types), but
    #   the branch machinery dominates XLA *compile* time at scale — on
    #   TPU the gated HyParView program at N=4096 did not finish
    #   compiling in 10 min, while the ungated one is a flat fusable
    #   pipeline.  Rule of thumb: gate on CPU/small N, ungate for big-N
    #   TPU runs.  (Measured later: with the batched cluster() fix, the
    #   gated program compiles fine on TPU and gated+gather beats ungated
    #   at N=4096 — 18 vs 11 rounds/s — so prefer gated unless compile
    #   time is the problem.)  False takes precedence over
    #   deliver_gather_cap: without gates there is no sparse branch, so
    #   the gather knob is ignored.
    deliver_gather_cap: Optional[int] = None
    # ^ sparse-delivery gather width G: when set (and < n_nodes), each
    #   (inbox-slot, msg-type) dispatch gathers only the <= G receiving node
    #   rows and runs the handler over those, falling back to the dense
    #   full-batch path when more than G nodes hold that type this slot.
    #   Steady-state gossip touches few nodes per type per round, so this
    #   turns the deliver phase from O(N · handlers-present) into
    #   O(G · handlers-present) — the big-N engine knob (BASELINE round-1
    #   notes).  None = always dense (bit-identical results either way;
    #   handlers see the same per-node PRNG keys on both paths).
    use_pallas_route: bool = False
    # ^ in the reference, routes the dense rounds' sorts through its
    #   Pallas kernels.  The port always does: ops/route_kernel takes the
    #   K1/K2 CUDA kernels for a CUDA tensor and their plain PyTorch
    #   versions for a CPU tensor (bit-identical, as the reference's
    #   twins are).  The field stays so the dataclasses match, and True
    #   is refused (__post_init__), since it would select nothing.

    # --- workload / SLO plane (workload/, Dean & Barroso tail-at-scale) -----
    slo_deadline_rounds: int = 16
    # ^ request deadline in rounds for SLO accounting: a completion with
    #   latency <= deadline counts rpc_slo_ok, else rpc_slo_violated
    #   (counted device-side at reply delivery, workload/latency.py).
    shed_token_rate_milli: int = 0
    # ^ admission-control token refill, milli-tokens per round per node
    #   (1000 = 1 admitted request/round sustained).  0 = shedding OFF —
    #   the workload plane bypasses the bucket entirely.
    shed_token_burst_milli: int = 4000
    # ^ token bucket cap (burst size), milli-tokens.
    shed_max_outstanding: int = 0
    # ^ per-node outstanding-promise cap at admission: a new request is
    #   shed when this many calls are already in flight.  0 = no cap.

    # --- verification-harness flags (env tier, partisan_config.erl:37-151) --
    tag: Optional[str] = None          # node tag (client/server), TAG env
    replaying: bool = False            # trace replay mode, REPLAY env (:78-85)
    shrinking: bool = False            # relaxed replay matching, SHRINKING env (:88-94)
    trace_file: Optional[str] = None   # TRACE_FILE env (trace_orchestrator :450-457)

    # --- determinism --------------------------------------------------------
    seed: int = 1                      # per-node keys derive from this (support :163-166)

    def __post_init__(self) -> None:
        if self.use_pallas_route:
            raise ValueError(
                "use_pallas_route=True selects nothing in the port: a CUDA "
                "tensor always takes the routing kernels (K1, K2) and a "
                "CPU tensor their plain versions; leave it False")

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def channel_index(self, name: str) -> int:
        """Channel name -> lane index (names live host-side only, SURVEY §5.6)."""
        return self.channels.index(name)


DEFAULT = Config()


# Reference manager module names -> port manager keys, so the PEER_SERVICE
# env var accepts the exact values partisan_SUITE exports (e.g.
# ``PEER_SERVICE=partisan_hyparview_peer_service_manager``,
# test/partisan_support.erl:35-81) as well as our short names.
_MANAGER_ALIASES = {
    "partisan_pluggable_peer_service_manager": "full",
    "partisan_default_peer_service_manager": "full",
    "partisan_hyparview_peer_service_manager": "hyparview",
    "partisan_hyparview_xbot_peer_service_manager": "hyparview",
    "partisan_client_server_peer_service_manager": "client_server",
    "partisan_static_peer_service_manager": "static",
}


def env_overrides(environ: Optional[Mapping[str, str]] = None
                  ) -> Dict[str, Any]:
    """The OS-env tier of the reference's three-tier config system
    (``partisan_config:init/0``, src/partisan_config.erl:37-151): keys set
    in the environment supersede app-level overrides, which supersede the
    dataclass defaults.  Handled keys and their reference read sites:

      PEER_SERVICE  manager selection (:42-48) — returned under the
                    reserved key ``"peer_service"`` for the port
                    server's ``start``, translated from
                    reference module names via _MANAGER_ALIASES
      TAG           node tag (:67-75)
      REPLAY        replay mode (:78-85)
      SHRINKING     shrinking mode (:88-94)
      TRACE_FILE    trace output path (trace_orchestrator :450-457)

    The reference treats the literal string "false" as unset for all four
    flag keys (``os:getenv(Key, "false")`` with a "false" guard clause);
    any other set value enables REPLAY/SHRINKING.  That quirk is
    preserved.
    """
    env = os.environ if environ is None else environ
    out: Dict[str, Any] = {}
    ps = env.get("PEER_SERVICE", "false")
    if ps != "false":
        out["peer_service"] = _MANAGER_ALIASES.get(ps, ps)
    tag = env.get("TAG", "false")
    if tag != "false":
        out["tag"] = tag
    if env.get("REPLAY", "false") != "false":
        out["replaying"] = True
    if env.get("SHRINKING", "false") != "false":
        out["shrinking"] = True
    tf = env.get("TRACE_FILE")
    if tf:
        out["trace_file"] = tf
    return out


def from_mapping(m: Optional[Mapping[str, Any]] = None,
                 environ: Optional[Mapping[str, str]] = None,
                 **kw: Any) -> Config:
    """Build a Config from a dict of overrides (the `partisan_config:set`
    analog used by the test harness, cf. test/partisan_support.erl:109-330).

    The OS-env tier (``env_overrides``) is applied on top, mirroring
    ``partisan_config:init/0`` priority: env > app overrides > defaults.
    Pass ``environ={}`` to disable it (hermetic tests).  The
    ``peer_service`` env key is not a Config field — it is consumed by the
    port server (bridge/port_server.cmd_start) before this call.
    """
    merged = dict(m or {})
    merged.update(kw)
    env = env_overrides(environ)
    env.pop("peer_service", None)
    merged.update(env)
    return dataclasses.replace(DEFAULT, **merged)
