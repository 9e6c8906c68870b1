"""Evidence pool (reference: evidence/pool.go:30-574).

Pending evidence lives in the DB (and on a clist for gossip) until a
block commits it; committed markers prevent resubmission. Consensus
reports conflicting votes here (``report_conflicting_votes``, pool.go:180
— called from tryAddVote); the proposer reaps with ``pending_evidence``.

``device`` (default the GPU; raises without one) is resolved at
construction and is where ``verify`` checks a light-client attack's
commit (evidence/verify).
"""

from __future__ import annotations

from ..libs import sync as libsync

from ..libs import db as dbm
from ..libs.clist import CList
from ..ops import verify as ov
from ..types import serialization as ser
from ..types.evidence import DuplicateVoteEvidence, EvidenceError
from .verify import verify_evidence

_PENDING = b"evP:"
_COMMITTED = b"evC:"


def _key(prefix: bytes, ev) -> bytes:
    return prefix + b"%020d:" % ev.height() + ev.hash()


class EvidencePool:
    def __init__(self, db: dbm.DB, state_store, block_store, *,
                 device="cuda"):
        ov.resolve_device(device)
        self.device = device
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self._mtx = libsync.Mutex("evidence.pool._mtx")
        self.evidence_list = CList()  # gossip tail
        self._in_list: dict[bytes, object] = {}  # hash -> CElement
        # load persisted pending evidence into the gossip list
        for key, raw in self.db.iterator(_PENDING, dbm.prefix_end(_PENDING)):
            ev = ser.loads(raw)
            self._in_list[ev.hash()] = self.evidence_list.push_back(ev)

    # -- queries -----------------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> list:
        """pool.go PendingEvidence — for block proposal."""
        out, total = [], 0
        for el in self.evidence_list:
            ev = el.value
            size = len(ser.dumps(ev))
            if max_bytes >= 0 and total + size > max_bytes:
                break
            out.append(ev)
            total += size
        return out

    def is_pending(self, ev) -> bool:
        return self.db.has(_key(_PENDING, ev))

    def is_committed(self, ev) -> bool:
        return self.db.has(_key(_COMMITTED, ev))

    # -- ingress -----------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """pool.go:135 AddEvidence: dedup → verify → persist → gossip."""
        with self._mtx:  # cometlint: disable=CLNT009 -- byzantine evidence is rare; verify+persist must be atomic for dedup
            if self.is_pending(ev) or self.is_committed(ev):
                return
            self.verify(ev)
            self._add_pending_locked(ev)

    def _add_pending_locked(self, ev) -> None:
        self.db.set_sync(_key(_PENDING, ev), ser.dumps(ev))
        self._in_list[ev.hash()] = self.evidence_list.push_back(ev)

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """pool.go:180 — from consensus on ConflictingVoteError. Builds the
        DuplicateVoteEvidence against the validator set at that height."""
        with self._mtx:  # cometlint: disable=CLNT009 -- conflicting-vote reports are rare; build+persist atomic under the pool mutex
            state = self.state_store.load()
            if state is None:
                return
            val_set = self.state_store.load_validators(vote_a.height)
            if val_set is None:
                return
            block_meta = (
                self.block_store.load_block_meta(vote_a.height)
                if self.block_store
                else None
            )
            time_ns = (
                block_meta.header.time_ns
                if block_meta is not None
                else state.last_block_time_ns
            )
            try:
                ev = DuplicateVoteEvidence.from_conflicting_votes(
                    vote_a, vote_b, time_ns, val_set
                )
            except EvidenceError:
                return
            if self.is_pending(ev) or self.is_committed(ev):
                return
            self._add_pending_locked(ev)

    # -- block validation hook (BlockExecutor) -----------------------------

    def verify(self, ev) -> None:
        state = self.state_store.load()
        if state is None:
            raise EvidenceError("no state to verify evidence against")
        val_set = self.state_store.load_validators(ev.height())
        if val_set is None:
            raise EvidenceError(
                f"no validator set stored for height {ev.height()}"
            )
        verify_evidence(ev, state, val_set, device=self.device)

    def check_evidence(self, evidence_list) -> None:
        """pool.go:193 CheckEvidence — full verification of a proposed
        block's evidence; duplicates within the block are rejected."""
        seen = set()
        for ev in evidence_list or ():
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            if self.is_committed(ev):
                raise EvidenceError("evidence was already committed")
            if not self.is_pending(ev):
                self.verify(ev)

    # -- post-commit -------------------------------------------------------

    def update(self, state, evidence_list) -> None:
        """pool.go Update — mark committed, drop from pending, prune."""
        with self._mtx:  # cometlint: disable=CLNT009 -- commit-time evidence pruning is once per height
            for ev in evidence_list or ():
                self.db.set(_key(_COMMITTED, ev), b"\x01")
                self._remove_pending(ev)
            self._prune_expired(state)

    def _remove_pending(self, ev) -> None:
        self.db.delete(_key(_PENDING, ev))
        el = self._in_list.pop(ev.hash(), None)
        if el is not None:
            self.evidence_list.remove(el)

    def _prune_expired(self, state) -> None:
        params = state.consensus_params.evidence
        for el in list(self.evidence_list):
            ev = el.value
            if (
                state.last_block_height - ev.height()
                > params.max_age_num_blocks
                and state.last_block_time_ns - ev.time_ns()
                > params.max_age_duration_ns
            ):
                self._remove_pending(ev)
