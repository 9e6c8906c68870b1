"""The canonical in-process test application (reference:
abci/example/kvstore/kvstore.go:552).

Transactions are ``key=value`` byte strings; ``val:<pubkey_hex>!<power>``
transactions update the validator set (the mechanism consensus tests use
to exercise validator-set changes). App hash commits to the total tx
count, matching the reference's size-based hash, so two nodes diverge the
moment they disagree on history. State persists to a KV db under a
dedicated prefix — restart + handshake-replay tests depend on it.
"""

from __future__ import annotations

import json
import struct
from ..libs import sync as libsync

from ..libs import db as dbm
from . import types as abci
from .application import BaseApplication

_STATE_KEY = b"kvstore:state"
_KV_PREFIX = b"kvstore:k:"
VALIDATOR_TX_PREFIX = b"val:"


class KVStoreApplication(BaseApplication):
    def __init__(self, db: dbm.DB | None = None, snapshot_interval: int = 5):
        self.db = db if db is not None else dbm.MemDB()
        self._mtx = libsync.Mutex("abci.kvstore._mtx")
        self._staged: dict[bytes, bytes] = {}
        self._val_updates: list[abci.ValidatorUpdate] = []
        self._validators: dict[str, int] = {}  # pubkey hex -> power
        # Point-in-time snapshots taken at commit every snapshot_interval
        # heights (reference: test/e2e/app snapshots). A LIVE dump would
        # race block production: the chunk served later must match the
        # app hash advertised for that height exactly.
        self.snapshot_interval = snapshot_interval
        self._snapshots: dict[int, tuple[bytes, bytes]] = {}  # h -> (hash, blob)
        self._restore_target = None  # accepted OfferSnapshot, if any
        raw = self.db.get(_STATE_KEY)
        if raw:
            st = json.loads(raw)
            self.height = st["height"]
            self.size = st["size"]
            self.app_hash = bytes.fromhex(st["app_hash"])
            self._validators = st.get("validators", {})
        else:
            self.height = 0
            self.size = 0
            self.app_hash = b""

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _parse_tx(tx: bytes) -> tuple[bytes, bytes] | None:
        if b"=" not in tx:
            return None
        k, _, v = tx.partition(b"=")
        if not k:
            return None
        return k, v

    @staticmethod
    def _parse_validator_tx(tx: bytes) -> abci.ValidatorUpdate | None:
        # val:<pubkey_hex>!<power>
        body = tx[len(VALIDATOR_TX_PREFIX) :]
        if b"!" not in body:
            return None
        pk_hex, _, power = body.partition(b"!")
        try:
            pk = bytes.fromhex(pk_hex.decode())
            return abci.ValidatorUpdate("ed25519", pk, int(power))
        except ValueError:
            return None

    def _compute_app_hash(self) -> bytes:
        return struct.pack(">Q", self.size)

    # -- Info/Query --------------------------------------------------------

    def info(self, req):
        with self._mtx:
            return abci.ResponseInfo(
                data=json.dumps({"size": self.size}),
                version="kvstore-tpu/1",
                app_version=1,
                last_block_height=self.height,
                last_block_app_hash=self.app_hash,
            )

    def query(self, req):
        with self._mtx:
            value = self.db.get(_KV_PREFIX + req.data)
            return abci.ResponseQuery(
                code=abci.OK,
                key=req.data,
                value=value or b"",
                log="exists" if value is not None else "does not exist",
                height=self.height,
            )

    # -- Mempool -----------------------------------------------------------

    def check_tx(self, req):
        tx = req.tx
        if tx.startswith(VALIDATOR_TX_PREFIX):
            ok = self._parse_validator_tx(tx) is not None
        else:
            ok = self._parse_tx(tx) is not None
        if ok:
            return abci.ResponseCheckTx(code=abci.OK, gas_wanted=1)
        return abci.ResponseCheckTx(code=1, log="invalid tx format")

    # -- Consensus ---------------------------------------------------------

    def init_chain(self, req):
        with self._mtx:
            for vu in req.validators:
                self._validators[vu.pub_key_bytes.hex()] = vu.power
        return abci.ResponseInitChain(app_hash=self._compute_app_hash())

    def process_proposal(self, req):
        for tx in req.txs:
            bad_val = tx.startswith(VALIDATOR_TX_PREFIX) and (
                self._parse_validator_tx(tx) is None
            )
            if bad_val or (
                not tx.startswith(VALIDATOR_TX_PREFIX)
                and self._parse_tx(tx) is None
            ):
                return abci.ResponseProcessProposal(
                    status=abci.ProcessProposalStatus.REJECT
                )
        return abci.ResponseProcessProposal(
            status=abci.ProcessProposalStatus.ACCEPT
        )

    def finalize_block(self, req):
        with self._mtx:
            self._staged = {}
            self._val_updates = []
            results = []
            for tx in req.txs:
                if tx.startswith(VALIDATOR_TX_PREFIX):
                    vu = self._parse_validator_tx(tx)
                    if vu is None:
                        results.append(
                            abci.ExecTxResult(code=1, log="bad val tx")
                        )
                        continue
                    self._val_updates.append(vu)
                    self._validators[vu.pub_key_bytes.hex()] = vu.power
                    results.append(abci.ExecTxResult(code=abci.OK))
                    continue
                parsed = self._parse_tx(tx)
                if parsed is None:
                    results.append(abci.ExecTxResult(code=1, log="bad tx"))
                    continue
                k, v = parsed
                self._staged[k] = v
                self.size += 1
                results.append(
                    abci.ExecTxResult(
                        code=abci.OK,
                        events=[
                            abci.Event(
                                "app",
                                [
                                    abci.EventAttribute(
                                        "key", k.decode(errors="replace"), True
                                    ),
                                    abci.EventAttribute("creator", "kvstore"),
                                ],
                            )
                        ],
                    )
                )
            self.height = req.height
            self.app_hash = self._compute_app_hash()
            return abci.ResponseFinalizeBlock(
                tx_results=results,
                validator_updates=list(self._val_updates),
                app_hash=self.app_hash,
            )

    # -- speculation extension (consensus/pipeline.py) ---------------------
    #
    # finalize_block mutates exactly these fields and touches no storage
    # (persistence happens in commit), so a snapshot/restore pair over
    # them makes speculative execution state-neutral: speculate →
    # restore(pre) leaves the app bit-identical, and a winning
    # speculation replays as restore(post) + commit.

    def snapshot_spec_state(self) -> dict:
        with self._mtx:
            return {
                "staged": dict(self._staged),
                "val_updates": list(self._val_updates),
                "validators": dict(self._validators),
                "height": self.height,
                "size": self.size,
                "app_hash": self.app_hash,
            }

    def restore_spec_state(self, token: dict) -> None:
        with self._mtx:
            self._staged = dict(token["staged"])
            self._val_updates = list(token["val_updates"])
            self._validators = dict(token["validators"])
            self.height = token["height"]
            self.size = token["size"]
            self.app_hash = token["app_hash"]

    def _stage_state(self, batch) -> None:
        batch.set(
            _STATE_KEY,
            json.dumps(
                {
                    "height": self.height,
                    "size": self.size,
                    "app_hash": self.app_hash.hex(),
                    "validators": self._validators,
                }
            ).encode(),
        )

    def commit(self, req=None):
        with self._mtx:  # cometlint: disable=CLNT009 -- Commit persists the app state; the app mutex is its atomicity boundary
            batch = self.db.new_batch()
            for k, v in self._staged.items():
                batch.set(_KV_PREFIX + k, v)
            self._stage_state(batch)
            batch.write()
            self._staged = {}
            if (
                self.snapshot_interval > 0
                and self.height % self.snapshot_interval == 0
            ):
                self._snapshots[self.height] = (
                    self.app_hash,
                    self._dump_state_blob(),
                )
                for h in sorted(self._snapshots)[:-2]:
                    del self._snapshots[h]  # keep the 2 most recent
            retain = self.height - 500 if self.height > 500 else 0
            return abci.ResponseCommit(retain_height=max(retain, 0))

    # -- Snapshots (whole state in one chunk) ------------------------------

    def _dump_state_blob(self) -> bytes:
        kvs = {
            k[len(_KV_PREFIX) :].hex(): v.hex()
            for k, v in self.db.iterator(
                _KV_PREFIX, dbm.prefix_end(_KV_PREFIX)
            )
        }
        return json.dumps(
            {
                "height": self.height,
                "size": self.size,
                "validators": self._validators,
                "kvs": kvs,
            }
        ).encode()

    def list_snapshots(self, req):
        with self._mtx:
            return abci.ResponseListSnapshots(
                snapshots=[
                    abci.Snapshot(
                        height=h, format=1, chunks=1, hash=hash_
                    )
                    for h, (hash_, _) in sorted(self._snapshots.items())
                ]
            )

    def load_snapshot_chunk(self, req):
        with self._mtx:
            snap = self._snapshots.get(req.height)
            if snap is None:
                return abci.ResponseLoadSnapshotChunk(chunk=b"")
            return abci.ResponseLoadSnapshotChunk(chunk=snap[1])

    def offer_snapshot(self, req):
        if req.snapshot.format != 1:
            return abci.ResponseOfferSnapshot(
                result=abci.OfferSnapshotResult.REJECT_FORMAT
            )
        # Wrong chunk count is THIS snapshot's defect, not the format's: a
        # bogus advertisement must not poison every valid format-1 snapshot
        # via the pool's reject_format.
        if req.snapshot.chunks != 1:
            return abci.ResponseOfferSnapshot(
                result=abci.OfferSnapshotResult.REJECT
            )
        # This app's snapshot hash IS its app hash: verify against the
        # light-client-trusted value the engine passes us (the app-side
        # check the ABCI contract prescribes).
        if req.app_hash and req.snapshot.hash != req.app_hash:
            return abci.ResponseOfferSnapshot(
                result=abci.OfferSnapshotResult.REJECT
            )
        self._restore_target = req.snapshot
        return abci.ResponseOfferSnapshot(
            result=abci.OfferSnapshotResult.ACCEPT
        )

    def apply_snapshot_chunk(self, req):
        # Chunks come from untrusted peers: validate EVERYTHING before any
        # mutation — a half-applied parse failure would leave the app
        # inconsistent and poison a later blocksync-from-genesis.
        try:
            st = json.loads(req.chunk)
            height = int(st["height"])
            size = int(st["size"])
            validators = dict(st["validators"])
            kvs = {
                bytes.fromhex(k): bytes.fromhex(v)
                for k, v in st["kvs"].items()
            }
        except (ValueError, KeyError, TypeError, AttributeError):
            return abci.ResponseApplySnapshotChunk(
                result=abci.ApplySnapshotChunkResult.REJECT_SNAPSHOT
            )
        if (
            self._restore_target is not None
            and height != self._restore_target.height
        ):
            return abci.ResponseApplySnapshotChunk(
                result=abci.ApplySnapshotChunkResult.REJECT_SNAPSHOT
            )
        st = {
            "height": height,
            "size": size,
            "validators": validators,
            "kvs": {k.hex(): v.hex() for k, v in kvs.items()},
        }
        with self._mtx:  # cometlint: disable=CLNT009 -- snapshot-chunk restore writes the app DB; atomic under the app mutex
            batch = self.db.new_batch()
            for k_hex, v_hex in st["kvs"].items():
                batch.set(_KV_PREFIX + bytes.fromhex(k_hex), bytes.fromhex(v_hex))
            self.height = st["height"]
            self.size = st["size"]
            self._validators = st["validators"]
            self.app_hash = self._compute_app_hash()
            self._stage_state(batch)
            batch.write()
        return abci.ResponseApplySnapshotChunk(
            result=abci.ApplySnapshotChunkResult.ACCEPT
        )
