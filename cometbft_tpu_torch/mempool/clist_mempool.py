"""CList mempool (reference: mempool/clist_mempool.go:26-671).

Tx pool on a concurrent list so per-peer broadcast routines can tail it.
``check_tx`` pushes through the async ABCI mempool connection; the global
response callback admits valid txs (``resCbFirstTime:373``). After every
block commit, ``update`` removes committed txs and re-checks the remainder
(``resCbRecheck:438``). Consensus gets ``TxsAvailable`` edge signals.

``device`` (default the GPU; raises without one) is only checked at
construction, as the other entry points check theirs: the mempool itself
launches nothing. Its keys go through the hash plane the caller has
pushed, if any (crypto/hashplane), and that plane's device decides where
they run (1 KiB and larger txs in X4 windows); with none pushed, hashlib.
The tx-lifecycle sensor hooks (libs/txtrace, libs/netstats) come with
those modules.
"""

from __future__ import annotations

import threading

from ..libs import health as libhealth
from ..libs import metrics as libmetrics
from ..libs import sync as libsync
from ..libs import trace as libtrace
from dataclasses import dataclass, field

from ..abci import types as abci
from ..config import MempoolConfig
from ..crypto import hashplane
from ..libs.clist import CList
from ..ops import verify as ov
from .cache import LRUTxCache, NopTxCache


def TxKey(tx: bytes) -> bytes:
    # routed through the device hash plane when one is up: concurrent
    # CheckTx threads' key hashes coalesce into shared SHA-256 windows
    # (large txs only — small keys stay on the host hash; digests are
    # identical either way); ledger-attributed to the mempool tenant
    from ..libs import devledger

    with devledger.caller_class("mempool"):
        return hashplane.hash_bytes(tx)


class MempoolError(Exception):
    pass


class TxInCacheError(MempoolError):
    pass


class MempoolFullError(MempoolError):
    pass


@dataclass(slots=True)
class MempoolTx:
    tx: bytes
    height: int  # height when validated
    gas_wanted: int = 0
    senders: set = field(default_factory=set)  # peer ids that sent it
    # the tx key, computed ONCE at CheckTx ingress and threaded through
    # every later cache/map touch — a 1 MB tx must never pay a second
    # SHA-256 on the remove/recheck paths
    key: bytes = b""
    # admission stamp (libs/health ring clock, so the age is
    # virtual-domain-consistent under simnet): the clist is FIFO, so
    # the front element's stamp is the pool's oldest — the
    # mempool_oldest_age_seconds gauge and the tx_starved watchdog
    time_ns: int = 0


class CListMempool:
    def __init__(
        self,
        config: MempoolConfig,
        proxy_app,  # mempool-connection ABCI client
        height: int = 0,
        pre_check=None,
        post_check=None,
        *,
        device="cuda",
    ):
        ov.resolve_device(device)
        self.config = config
        self.proxy_app = proxy_app
        self.height = height
        self.pre_check = pre_check
        self.post_check = post_check
        self.txs = CList()
        self.tx_map: dict[bytes, object] = {}  # TxKey -> CElement
        self.cache = (
            LRUTxCache(config.cache_size)
            if config.cache_size > 0
            else NopTxCache()
        )
        # Consensus lock: held across Commit so no CheckTx races app state
        self._update_mtx = libsync.RLock("mempool.update")
        self._size_bytes = 0
        self._recheck_cursor = None  # next element expecting a recheck result
        self._recheck_end = None
        self._txs_available: threading.Event | None = None
        self._notified_txs_available = False
        self._pending_senders: dict[bytes, str] = {}
        # tx bytes -> key for in-flight CheckTx requests: the async
        # response callback only receives the tx back, and re-deriving
        # the key there would re-hash up to max_tx_bytes per response
        # (the call-count test in tests/test_hashplane.py pins ONE
        # TxKey per CheckTx). Entries live exactly as long as a
        # _pending_senders entry would.
        self._pending_tx_keys: dict[bytes, bytes] = {}
        proxy_app.set_response_callback(self._global_cb)

    # -- config hooks ------------------------------------------------------

    def enable_txs_available(self) -> None:
        self._txs_available = threading.Event()

    def txs_available(self) -> threading.Event:
        return self._txs_available

    # -- sizes -------------------------------------------------------------

    def size(self) -> int:
        return len(self.txs)

    def size_bytes(self) -> int:
        with self._update_mtx:
            return self._size_bytes

    def oldest_age_s(self) -> float:
        """Age of the oldest admitted-uncommitted tx (0.0 = empty).
        Lock-free racy read of the clist front — the tx_starved
        watchdog polls this from its check tick, which must not
        contend with the update lock."""
        el = self.txs.front()
        if el is None:
            return 0.0
        t = el.value.time_ns
        if not t:
            return 0.0
        age = (libhealth.now_ns() - t) / 1e9
        return age if age > 0 else 0.0

    def oldest_entries(self, n: int = 8) -> list[tuple[bytes, float]]:
        """The ``n`` oldest pending txs as ``(key, age_s)`` — the
        starved keys a tx_starved black-box bundle names."""
        now = libhealth.now_ns()
        out: list[tuple[bytes, float]] = []
        for el in self.txs:
            memtx = el.value
            age = (now - memtx.time_ns) / 1e9 if memtx.time_ns else 0.0
            out.append((memtx.key, age if age > 0 else 0.0))
            if len(out) >= n:
                break
        return out

    def is_full(self, tx_len: int) -> MempoolFullError | None:
        if (
            self.size() >= self.config.size
            or tx_len + self.size_bytes() > self.config.max_txs_bytes
        ):
            return MempoolFullError(
                f"mempool full: {self.size()} txs, {self.size_bytes()}B"
            )
        return None

    # -- CheckTx ingress (clist_mempool.go:247) ----------------------------

    def check_tx(self, tx: bytes, cb=None, sender: str = "") -> None:
        # Size gate and tx hash OUTSIDE the update lock (cometlint
        # CLNT009 discipline): TxKey is SHA-256 over up to max_tx_bytes
        # (1 MB) of peer-controlled bytes — pure compute that must not
        # serialize concurrent CheckTx against commit's Update window.
        if len(tx) > self.config.max_tx_bytes:
            raise MempoolError(
                f"tx too large: {len(tx)} > {self.config.max_tx_bytes}"
            )
        key = TxKey(tx)
        if libtrace.enabled():  # before the lock: pure ring append
            libtrace.event(
                "mempool.checktx", bytes=len(tx), sender=sender
            )
        with self._update_mtx:  # cometlint: disable=CLNT009 -- async CheckTx dispatch under the update lock is the reference behavior (clist_mempool.go:247); the dispatch union overapproximates which app method runs
            if self.pre_check is not None:
                self.pre_check(tx)
            err = self.is_full(len(tx))
            if err is not None:
                raise err
            if not self.cache.push(key):
                # Seen before: record the extra sender for gossip dedup.
                el = self.tx_map.get(key)
                if el is not None and sender:
                    el.value.senders.add(sender)
                raise TxInCacheError(key.hex())
            # first-seen only (mempool/metrics.go TxSizeBytes): duplicates
            # and rejected-before-cache txs must not shift the histogram
            libmetrics.node_metrics().mempool_tx_size.observe(len(tx))
            if sender:
                self._pending_senders[key] = sender
            self._pending_tx_keys[tx] = key
            try:
                reqres = self.proxy_app.check_tx_async(
                    abci.RequestCheckTx(tx=tx, type=abci.CheckTxType.NEW)
                )
            except BaseException:
                # a failed dispatch means no response callback will
                # ever pop these — each leaked tx-key entry pins up to
                # max_tx_bytes of tx bytes, so clean up at the failure
                # site (the cache entry stays, matching the reference's
                # seen-tx semantics)
                self._pending_tx_keys.pop(tx, None)
                self._pending_senders.pop(key, None)
                raise
            if cb is not None:
                reqres.set_callback(cb)

    def _global_cb(self, req, res) -> None:
        """proxy_app's global callback. Routed by the REQUEST type, not by
        whether a recheck is in flight — a NEW response racing a recheck
        window must not consume the recheck cursor."""
        if req.type == abci.CheckTxType.RECHECK:
            self._res_cb_recheck(req, res)
        else:
            self._res_cb_first_time(req, res)

    def _res_cb_first_time(self, req, res) -> None:
        tx = req.tx
        with self._update_mtx:
            # the key was computed at CheckTx ingress; a socket client
            # round-trips the tx bytes so the map lookup is by value (a
            # dict hash, not another SHA-256). The TxKey fallback only
            # fires for responses whose ingress predates this process
            # (never in practice — the map is cleared with the pool).
            # The pop itself must happen under the update lock: every
            # other _pending_tx_keys access (check_tx insert, flush
            # clear) is guarded, and a socket client delivers this
            # callback from its recv thread — popping lock-free races a
            # concurrent flush() and can resurrect a just-cleared entry.
            key = self._pending_tx_keys.pop(tx, None)
            libsync.lockset_note("CListMempool._pending_tx_keys")
            if key is None:
                key = TxKey(tx)
            post_ok = True
            if self.post_check is not None:
                try:
                    self.post_check(tx, res)
                except Exception:
                    post_ok = False
            if res.code == abci.OK and post_ok:
                if self.is_full(len(tx)) is not None:
                    self.cache.remove(key)
                    self._pending_senders.pop(key, None)
                    return
                sender = self._pending_senders.pop(key, "")
                memtx = MempoolTx(
                    tx=tx,
                    height=self.height,
                    gas_wanted=res.gas_wanted,
                    key=key,
                    time_ns=libhealth.now_ns(),
                )
                if sender:
                    memtx.senders.add(sender)
                el = self.txs.push_back(memtx)
                self.tx_map[key] = el
                self._size_bytes += len(tx)
                if libtrace.enabled():
                    libtrace.event(
                        "mempool.admit", bytes=len(tx), code=res.code
                    )
                self._notify_txs_available()
            else:
                if libtrace.enabled():
                    libtrace.event(
                        "mempool.reject", bytes=len(tx), code=res.code
                    )
                libmetrics.node_metrics().mempool_failed_txs.inc()
                self._pending_senders.pop(key, None)
                if not self.config.keep_invalid_txs_in_cache:
                    self.cache.remove(key)

    def _res_cb_recheck(self, req, res) -> None:
        libmetrics.node_metrics().mempool_rechecks.inc()
        with self._update_mtx:
            el = self._recheck_cursor
            if el is None:
                return
            # responses come back in recheck submission order
            if el.value.tx != req.tx:
                # out-of-sync; drop cursor to stop recheck gracefully
                self._recheck_cursor = None
                return
            if res.code != abci.OK:
                key = el.value.key  # == TxKey(req.tx): el.value.tx matched
                self._remove_tx_el(el)
                if not self.config.keep_invalid_txs_in_cache:
                    self.cache.remove(key)
            if el is self._recheck_end:
                self._recheck_cursor = None
                if self.size() > 0:
                    self._notify_txs_available()
            else:
                self._recheck_cursor = el.next()

    # -- reap (clist_mempool.go ReapMaxBytesMaxGas) ------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        with self._update_mtx:
            out, total_bytes, total_gas = [], 0, 0
            for el in self.txs:
                memtx = el.value
                if max_bytes > -1 and total_bytes + len(memtx.tx) > max_bytes:
                    break
                if max_gas > -1 and total_gas + memtx.gas_wanted > max_gas:
                    break
                out.append(memtx.tx)
                total_bytes += len(memtx.tx)
                total_gas += memtx.gas_wanted
            return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._update_mtx:
            out = []
            for el in self.txs:
                if 0 <= n <= len(out):
                    break
                out.append(el.value.tx)
            return out

    # -- consensus integration ---------------------------------------------

    def lock(self) -> None:
        self._update_mtx.acquire()

    def unlock(self) -> None:
        self._update_mtx.release()

    def flush(self) -> None:
        with self._update_mtx:
            for el in list(self.txs):
                self.txs.remove(el)
            self.tx_map.clear()
            self._size_bytes = 0
            self.cache.reset()
            self._recheck_cursor = None
            self._pending_tx_keys.clear()

    def _remove_tx_el(self, el) -> None:
        self.txs.remove(el)
        # admitted txs always carry their ingress key; the TxKey
        # fallback guards hand-constructed entries in tests
        self.tx_map.pop(el.value.key or TxKey(el.value.tx), None)
        self._size_bytes -= len(el.value.tx)

    def remove_tx_by_key(self, key: bytes) -> None:
        with self._update_mtx:
            el = self.tx_map.get(key)
            if el is not None:
                self._remove_tx_el(el)

    def update(
        self,
        height: int,
        txs: list[bytes],
        tx_results: list,
        pre_check=None,
        post_check=None,
    ) -> None:
        """Called with the lock HELD, inside BlockExecutor.Commit
        (clist_mempool.go Update:584)."""
        self.height = height
        self._notified_txs_available = False
        if pre_check is not None:
            self.pre_check = pre_check
        if post_check is not None:
            self.post_check = post_check
        # committed txs arrive keyless from the block — derive all
        # their keys as ONE batch (hash_many routes to the device
        # plane only when that wins, and per-tx routed tickets inside
        # the commit critical section would pay a round trip each)
        from ..libs import devledger

        with devledger.caller_class("mempool"):
            keys = hashplane.hash_many(txs)
        for tx, key, res in zip(txs, keys, tx_results):
            if res.code == abci.OK:
                self.cache.push(key)  # committed: never re-admit
            elif not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            self.remove_tx_by_key(key)
        if self.size() > 0:
            if self.config.recheck:
                self._recheck_txs()
            else:
                self._notify_txs_available()

    def _recheck_txs(self) -> None:
        # No sync flush here: we hold _update_mtx and the socket client's
        # recv thread needs it to process the recheck responses — a
        # synchronous flush would deadlock (the reference uses FlushAsync,
        # clist_mempool.go:476). Requests are written eagerly.
        self._recheck_cursor = self.txs.front()
        self._recheck_end = self.txs.back()
        for el in self.txs:
            self.proxy_app.check_tx_async(
                abci.RequestCheckTx(
                    tx=el.value.tx, type=abci.CheckTxType.RECHECK
                )
            )

    def _notify_txs_available(self) -> None:
        if self._txs_available is not None and not self._notified_txs_available:
            self._notified_txs_available = True
            self._txs_available.set()
