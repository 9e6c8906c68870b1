"""Node configuration (reference: config/config.go:73-1135).

The port reads the consensus and mempool sections (consensus/,
mempool/), and the p2p and blocksync sections where a node is wired by
hand (p2p/, blocksync/); the rest waits for the node (config_file.py's
TOML with it).

The master ``Config`` has the reference's 9 sections; consensus timeouts
follow config.go:908-945. ``test_config()`` mirrors ``TestConfig()``
(config.go:106) — millisecond timeouts so in-process consensus nets
converge fast.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

_MS = 1_000_000  # ns per ms

# Registry of every COMETBFT_* environment knob the port reads (the
# JAX package's catalog less the knobs of modules the port does not have
# yet). tests/test_torch_imports.py holds it to the knobs the package's
# code reads, so adding an env read and documenting it are one change.
# Keys are knob names, values are one-line operator docs.
ENV_KNOBS: dict[str, str] = {
    "COMETBFT_TPU_KERNEL": (
        "verify-kernel flavor: auto (default) | pallas | xla (4-bit) | "
        "pallas8 | xla8 (8-bit); anything else raises (ops/verify.py)"
    ),
    "COMETBFT_TPU_PUBKEY_CACHE": (
        "expanded-pubkey device arena: 1 (default) | 0 to disable "
        "(ops/verify.py)"
    ),
    "COMETBFT_TPU_PRESTAGE": (
        "warm the pubkey arena at enter-new-round: auto (default, "
        "CUDA only) | 1 force | 0 off (ops/verify.py)"
    ),
    "COMETBFT_TPU_SHARD": (
        "multi-GPU sharding of a batch: auto (default, two or more "
        "CUDA devices) | 1 force | 0 off (ops/verify.py)"
    ),
    "COMETBFT_TPU_HOST_THRESHOLD": (
        "batch size below which verification stays on host; overrides "
        "the seed cut and its fit (crypto/batch.py)"
    ),
    "COMETBFT_TPU_DEADLOCK": (
        "1 swaps every libs/sync mutex for a deadlock-detecting "
        "instrumented lock (the go-deadlock build-tag analog)"
    ),
    "COMETBFT_TPU_DEADLOCK_TIMEOUT": (
        "seconds a waiter stalls before the deadlock tier dumps all "
        "thread stacks (default 30; libs/sync.py)"
    ),
    "COMETBFT_TPU_LOCK_ORDER": (
        "lock-order sanitizer: off (default) | record accumulates the "
        "observed acquisition-order edges | enforce raises LockOrderError "
        "on an edge absent from the static lock-order graph (libs/sync.py; "
        "graph from `python -m cometbft_tpu.devtools.lint --graph`)"
    ),
    "COMETBFT_TPU_LOCK_ORDER_GRAPH": (
        "path override for the static lock-order graph that enforce mode "
        "validates against (default: the lockorder.json shipped in "
        "devtools/lint/graph; libs/sync.py)"
    ),
    "COMETBFT_TPU_LOCKSET": (
        "lockset sanitizer: off (default) | record samples (field, "
        "held-lock names) at accessor seams | enforce raises LocksetError "
        "when a seam runs without the field's statically inferred guard "
        "fully held (libs/sync.py; guards from `python -m "
        "cometbft_tpu.devtools.lint --fields`)"
    ),
    "COMETBFT_TPU_LOCKSET_FIELDS": (
        "path override for the guarded-field artifact that enforce mode "
        "validates against (default: the fieldguards.json shipped in "
        "devtools/lint/graph; libs/sync.py)"
    ),
    "COMETBFT_TPU_LOCKPROF": (
        "lock-contention profiler (libs/lockprof): auto (default, on "
        "while a node runs — refcounted in node boot) | 1/on force | "
        "0/off kill switch; feeds lock_wait_seconds{lock}, "
        "/debug/contention and the lock_contended watchdog"
    ),
    "COMETBFT_TPU_LOCKPROF_SLOW_MS": (
        "lock wait/hold duration past which the profiler emits an "
        "EV_LOCK flight-ring row naming the blocking holder's acquire "
        "site, and the lock_contended watchdog's windowed-p99 trip "
        "threshold (default 50; libs/lockprof.py)"
    ),
    "COMETBFT_TPU_FAIL": (
        "named crash point for fault-injection tests — the process "
        "dies hard when execution reaches it (libs/fail.py)"
    ),
    "COMETBFT_TPU_PIPELINE": (
        "pipelined commit chain (consensus/pipeline.py): save-block + "
        "WAL EndHeight fsync + app commit move onto an ordered "
        "commit-writer worker behind a durability barrier — auto "
        "(default: on for live nodes, inline for sim-driven FSMs) | "
        "1/on force | inline run jobs synchronously on the FSM thread "
        "| 0/off fully serial reference chain"
    ),
    "COMETBFT_TPU_SPEC_EXEC": (
        "speculative block execution at prevote time "
        "(consensus/pipeline.py): auto (default — on when the ABCI "
        "client supports the snapshot/restore speculation extension) "
        "| 1/on force | 0/off; a precommit win consumes the memoized "
        "FinalizeBlock instead of re-executing"
    ),
    "COMETBFT_TPU_TRACE": (
        "span/event tracer: off (default) | on/1 — consensus "
        "height/round/step spans, verify phase events, mempool/p2p/"
        "blocksync/WAL events into the in-memory ring (libs/trace.py; "
        "also /debug/trace on the pprof server)"
    ),
    "COMETBFT_TPU_TRACE_FILE": (
        "JSONL sink path for the tracer — records tee to a rotating "
        "libs/autofile Group when tracing is on (libs/trace.py)"
    ),
    "COMETBFT_TPU_TRACE_RING": (
        "trace ring-buffer capacity in records (default 8192; "
        "libs/trace.py)"
    ),
    "COMETBFT_TPU_DEVSTATS": (
        "device telemetry (libs/devstats): 1/on enables "
        "device-memory + pubkey-arena sampling and "
        "host<->device transfer counters; default off (a node "
        "auto-enables it when it starts a Prometheus listener)"
    ),
    "COMETBFT_TPU_PROM_ADDR": (
        "Prometheus scrape-listener address (tcp://host:port or "
        ":port); when set (or instrumentation.prometheus in config) "
        "the node serves the metrics registry at GET /metrics on a "
        "dedicated libs/devstats.PrometheusServer"
    ),
    "COMETBFT_TPU_NET": (
        "network-plane telemetry (libs/netstats): auto (default — on "
        "while a node runs, refcounted like devstats/health) | 1 "
        "force-on process-wide | 0 off (per-peer/per-channel stats, "
        "queue gauges, gossip-lag SLI all dark; the disabled path is "
        "allocation-free)"
    ),
    "COMETBFT_TPU_NET_STAMP": (
        "provenance stamping of p2p messages (libs/netstats): 1 "
        "(default — the node advertises the netstamp capability and "
        "stamps toward peers that advertise it back) | 0 withdraws "
        "the advertisement; wire compat with unstamped peers is "
        "negotiated, never sniffed"
    ),
    "COMETBFT_TPU_NET_TOPK": (
        "peers exported with their own p2p_peer_rate_bytes{peer} "
        "label value, ranked by traffic, before aggregating into "
        "'other' (default 8 — bounds scrape cardinality; "
        "libs/netstats.py)"
    ),
    "COMETBFT_TPU_COALESCE": (
        "cross-caller verify coalescer: auto (default, node starts it "
        "on accelerator backends) | 1 force | 0 off (crypto/coalesce.py)"
    ),
    "COMETBFT_TPU_COALESCE_WINDOW_US": (
        "coalescer deadline window in microseconds before a sub-size "
        "window flushes (default 500; crypto/coalesce.py)"
    ),
    "COMETBFT_TPU_COALESCE_MAX_LANES": (
        "lanes that trigger an immediate coalescer size flush / the "
        "per-window cap (default 1024; crypto/coalesce.py)"
    ),
    "COMETBFT_TPU_COALESCE_MIN_DEVICE_LANES": (
        "pin the lane count above which coalescer windows go to the "
        "device; unset defers to the live host/device crossover "
        "(crypto/batch.host_batch_threshold) — sub-cutover windows "
        "still coalesce into one host MSM (crypto/coalesce.py)"
    ),
    "COMETBFT_TPU_COALESCE_INFLIGHT": (
        "device verify windows dispatched but not yet materialized "
        "across the executor + readback drain thread (default 2 — the "
        "double buffer: window N's d2h overlaps window N+1's execute; "
        "crypto/coalesce.py)"
    ),
    "COMETBFT_TPU_HASH_INFLIGHT": (
        "hash-plane analog of COMETBFT_TPU_COALESCE_INFLIGHT: device "
        "hash windows in flight across the executor + readback drain "
        "thread (default 2; crypto/hashplane.py)"
    ),
    "COMETBFT_TPU_HASH": (
        "cross-caller SHA-256 hash plane: auto (default, node starts "
        "it on accelerator backends) | 1 force | 0 off "
        "(crypto/hashplane.py)"
    ),
    "COMETBFT_TPU_HASH_WINDOW_US": (
        "hash-plane deadline window in microseconds before a sub-size "
        "window flushes (default 500; crypto/hashplane.py)"
    ),
    "COMETBFT_TPU_HASH_MAX_LANES": (
        "lanes that trigger an immediate hash-plane size flush / the "
        "per-window cap (default 2048; crypto/hashplane.py)"
    ),
    "COMETBFT_TPU_HASH_MIN_DEVICE_LANES": (
        "pin the lane count above which a hash window's block buckets "
        "go to the device; unset defers to the per-bucket adaptive "
        "crossover seeded at ~2048 total SHA blocks per window "
        "(crypto/hashplane.py)"
    ),
    "COMETBFT_TPU_HEALTH": (
        "consensus flight recorder + SLO watchdogs (libs/health): auto "
        "(default — on while a node runs, refcounted like devstats) | "
        "1 force-on process-wide | 0 off (kill switch: no recording, "
        "no watchdogs, no black-box bundles)"
    ),
    "COMETBFT_TPU_HEALTH_RING": (
        "flight-recorder ring capacity in events (default 4096; "
        "libs/health.py)"
    ),
    "COMETBFT_TPU_ADAPTIVE_THRESHOLD": (
        "adaptive host/device batch crossover from measured timings: "
        "auto (default, accelerator-only) | 1 force | 0 static seed "
        "only; a COMETBFT_TPU_HOST_THRESHOLD pin always wins "
        "(crypto/batch.py AdaptiveCrossover)"
    ),
    "COMETBFT_TPU_HEALTH_DISK_EWMA": (
        "window (in fsyncs) of the WAL fsync-latency EWMA behind the "
        "disk_degraded state and the slow_disk watchdog (default 8; "
        "alpha = 2/(window+1), consensus/wal.py)"
    ),
    "COMETBFT_TPU_HEALTH_DISK_MS": (
        "fsync-EWMA milliseconds at which the node enters "
        "disk_degraded — propose timeouts widen, the slow_disk "
        "watchdog trips a black-box bundle; clears below half the "
        "threshold (hysteresis; default 50, consensus/wal.py)"
    ),
    "COMETBFT_TPU_LEDGER": (
        "device-time ledger (libs/devledger): per-(plane, caller) "
        "attribution of the shared verify/hash coalescer planes — "
        "auto (default, on while a node runs, refcounted like "
        "devstats/health) | 1 force-on process-wide | 0 off (the "
        "record path is a single flag check)"
    ),
    "COMETBFT_TPU_LEDGER_STARVE_MS": (
        "consensus-starvation watchdog threshold: consensus-caller "
        "verify queue-wait p99 in milliseconds above which — while "
        "other callers dominate the window's lane share — the "
        "consensus_starved watchdog trips and writes a black-box "
        "bundle (default 50; <=0 disables; libs/health.py)"
    ),
}


@dataclass(slots=True)
class BaseConfig:
    home: str = "~/.cometbft-tpu"
    moniker: str = "anonymous"
    proxy_app: str = "kvstore"  # in-process app name or tcp://|unix:// addr
    abci: str = "local"  # local | socket
    db_backend: str = "file"  # file | mem
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    # When set (tcp://host:port or unix:///path), the node LISTENS here
    # for a remote signer instead of using the file PV
    # (config.go PrivValidatorListenAddr; privval/signer_*.go).
    priv_validator_laddr: str = ""
    node_key_file: str = "config/node_key.json"
    block_sync: bool = True
    state_sync: bool = False
    log_level: str = "info"  # debug | info | error | none

    def resolve(self, path: str) -> str:
        p = os.path.expanduser(path)
        return p if os.path.isabs(p) else os.path.join(
            os.path.expanduser(self.home), p
        )


@dataclass(slots=True)
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit_ns: int = 10_000 * _MS
    max_body_bytes: int = 1_000_000
    pprof_laddr: str = ""
    # operator-only routes (dial_seeds/dial_peers/unsafe_flush_mempool):
    # rpc/core/routes.go AddUnsafeRoutes, config.go RPC.Unsafe
    unsafe: bool = False


@dataclass(slots=True)
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    flush_throttle_timeout_ns: int = 100 * _MS
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    pex: bool = True
    seed_mode: bool = False
    allow_duplicate_ip: bool = False
    handshake_timeout_ns: int = 20_000 * _MS
    dial_timeout_ns: int = 3_000 * _MS


@dataclass(slots=True)
class MempoolConfig:
    recheck: bool = True
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 1024 * 1024 * 1024
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1024 * 1024


@dataclass(slots=True)
class StateSyncConfig:
    enable: bool = False
    rpc_servers: list[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period_ns: int = 168 * 3600 * 1_000_000_000  # 1 week
    discovery_time_ns: int = 15_000 * _MS
    chunk_request_timeout_ns: int = 10_000 * _MS
    chunk_fetchers: int = 4


@dataclass(slots=True)
class BlockSyncConfig:
    version: str = "v0"
    # bytes/sec floor for peers with pending block requests; peers
    # trickling below it are evicted (blocksync/pool.go:133 minRecvRate).
    # 0 disables rate eviction.
    min_recv_rate: int = 7680


@dataclass(slots=True)
class ConsensusConfig:
    wal_file: str = "data/cs.wal/wal"
    # timeouts (config.go:908-945); _delta grows per round
    timeout_propose_ns: int = 3_000 * _MS
    timeout_propose_delta_ns: int = 500 * _MS
    timeout_prevote_ns: int = 1_000 * _MS
    timeout_prevote_delta_ns: int = 500 * _MS
    timeout_precommit_ns: int = 1_000 * _MS
    timeout_precommit_delta_ns: int = 500 * _MS
    timeout_commit_ns: int = 1_000 * _MS
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval_ns: int = 0
    peer_gossip_sleep_duration_ns: int = 100 * _MS
    peer_query_maj23_sleep_duration_ns: int = 2_000 * _MS
    double_sign_check_height: int = 0

    def propose_timeout(self, round_: int) -> float:
        """Seconds; grows linearly with round (state.go proposeTimeout)."""
        return (
            self.timeout_propose_ns + round_ * self.timeout_propose_delta_ns
        ) / 1e9

    def prevote_timeout(self, round_: int) -> float:
        return (
            self.timeout_prevote_ns + round_ * self.timeout_prevote_delta_ns
        ) / 1e9

    def precommit_timeout(self, round_: int) -> float:
        return (
            self.timeout_precommit_ns
            + round_ * self.timeout_precommit_delta_ns
        ) / 1e9

    def commit_timeout(self) -> float:
        return self.timeout_commit_ns / 1e9


@dataclass(slots=True)
class StorageConfig:
    discard_abci_responses: bool = False


@dataclass(slots=True)
class TxIndexConfig:
    indexer: str = "kv"  # kv | sqlite (external-DB sink) | null


@dataclass(slots=True)
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    max_open_connections: int = 3
    namespace: str = "cometbft"


@dataclass(slots=True)
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(
        default_factory=InstrumentationConfig
    )


def default_config() -> Config:
    return Config()


def test_config() -> Config:
    """Millisecond consensus timeouts (config.go TestConfig:106)."""
    c = Config()
    c.consensus = replace(
        c.consensus,
        timeout_propose_ns=40 * _MS,
        timeout_propose_delta_ns=1 * _MS,
        timeout_prevote_ns=10 * _MS,
        timeout_prevote_delta_ns=1 * _MS,
        timeout_precommit_ns=10 * _MS,
        timeout_precommit_delta_ns=1 * _MS,
        timeout_commit_ns=10 * _MS,
        skip_timeout_commit=True,
        peer_gossip_sleep_duration_ns=5 * _MS,
        peer_query_maj23_sleep_duration_ns=250 * _MS,
    )
    return c
