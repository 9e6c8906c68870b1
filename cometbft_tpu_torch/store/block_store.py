"""Persistent block store (reference: store/store.go:38-656).

Stores blocks *as part sets* (the gossip unit), plus per-height metadata,
the canonical commit for each block (extracted from the next block's
LastCommit), the latest seen commit, and extended commits when vote
extensions are enabled. A hash→height index serves lookups by block hash.

Key layout (fixed-width heights so raw-byte iteration is height order):
``BM:<h>`` meta | ``P:<h>:<i>`` part | ``C:<h>`` commit | ``SC`` seen
commit | ``EC:<h>`` extended commit | ``BH:<hash>`` height | ``BS`` state.
"""

from __future__ import annotations

import json
from ..libs import sync as libsync

from ..libs import db as dbm
from ..libs import fail as libfail
from ..types import serialization as ser
from ..types.block import Block, BlockID, BlockMeta, Commit
from ..types.part_set import Part, PartSet


def _h(prefix: bytes, height: int) -> bytes:
    return prefix + b"%020d" % height


class BlockStore:
    def __init__(self, db: dbm.DB):
        self.db = db
        self._mtx = libsync.RLock("store.block_store._mtx")
        raw = db.get(b"BS")
        if raw:
            st = json.loads(raw)
            self._base, self._height = st["base"], st["height"]
        else:
            self._base, self._height = 0, 0

    # -- bookkeeping -------------------------------------------------------

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return 0 if self._height == 0 else self._height - self._base + 1

    def _save_state(self, batch) -> None:
        batch.set(
            b"BS",
            json.dumps({"base": self._base, "height": self._height}).encode(),
        )

    # -- save --------------------------------------------------------------

    def save_block(
        self, block: Block, part_set: PartSet, seen_commit: Commit
    ) -> None:
        # slow-disk injection point (libs/fail delay_point): the simnet
        # gray-failure scenarios charge virtual latency here, modeling a
        # store volume that persists blocks slowly but successfully
        libfail.delay_point("store-write")
        with self._mtx:  # cometlint: disable=CLNT009 -- block persistence is atomic under the store mutex; once per height
            self._save_block_locked(block, part_set, seen_commit, None)

    def save_block_with_extended_commit(
        self, block: Block, part_set: PartSet, seen_ext_commit
    ) -> None:
        with self._mtx:  # cometlint: disable=CLNT009 -- extended-commit save shares save_block's atomicity contract
            self._save_block_locked(
                block, part_set, seen_ext_commit.to_commit(), seen_ext_commit
            )

    def _save_block_locked(
        self, block, part_set, seen_commit, ext_commit
    ) -> None:
        height = block.header.height
        if self._height > 0 and height != self._height + 1:
            raise ValueError(
                f"cannot save block {height}, expected {self._height + 1}"
            )
        batch = self.db.new_batch()
        block_id = BlockID(block.hash(), part_set.header)
        meta = BlockMeta(
            block_id=block_id,
            block_size=sum(len(p.bytes_) for p in part_set.parts),
            header=block.header,
            num_txs=len(block.data.txs),
        )
        batch.set(_h(b"BM:", height), ser.dumps(meta))
        for part in part_set.parts:
            batch.set(
                _h(b"P:", height) + b":%06d" % part.index, ser.dumps(part)
            )
        if block.last_commit is not None:
            batch.set(_h(b"C:", height - 1), ser.dumps(block.last_commit))
        batch.set(b"SC", ser.dumps(seen_commit))
        if ext_commit is not None:
            batch.set(_h(b"EC:", height), ser.dumps(ext_commit))
        batch.set(b"BH:" + block_id.hash, b"%d" % height)
        if self._base == 0:
            self._base = height
        self._height = height
        libsync.lockset_note("BlockStore._height")
        self._save_state(batch)
        batch.write_sync()

    def save_seen_commit(self, seen_commit: Commit) -> None:
        self.db.set_sync(b"SC", ser.dumps(seen_commit))

    # -- load --------------------------------------------------------------

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self.db.get(_h(b"BM:", height))
        return ser.loads(raw) if raw else None

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self.db.get(_h(b"P:", height) + b":%06d" % index)
        return ser.loads(raw) if raw else None

    def load_block(self, height: int) -> Block | None:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        buf = []
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            buf.append(part.bytes_)
        return ser.loads(b"".join(buf))

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        raw = self.db.get(b"BH:" + block_hash)
        return self.load_block(int(raw)) if raw else None

    def load_block_meta_by_hash(self, block_hash: bytes):
        """Meta-only hash lookup: one small read via the BH: index —
        header consumers must not pay the O(parts) full-block reassembly."""
        raw = self.db.get(b"BH:" + block_hash)
        return self.load_block_meta(int(raw)) if raw else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit FOR block ``height`` (from block height+1)."""
        raw = self.db.get(_h(b"C:", height))
        return ser.loads(raw) if raw else None

    def load_seen_commit(self) -> Commit | None:
        raw = self.db.get(b"SC")
        return ser.loads(raw) if raw else None

    def load_block_extended_commit(self, height: int):
        raw = self.db.get(_h(b"EC:", height))
        return ser.loads(raw) if raw else None

    # -- prune -------------------------------------------------------------

    def delete_block(self, height: int) -> None:
        """Remove the block at ``height`` — only the TIP may be removed
        (rollback --hard).

        The NEW tip's canonical commit (``C:<height-1>``) must survive —
        it arrived inside the deleted block as its LastCommit and becomes
        the new seen commit, so a restarted node can still reconstruct
        rs.last_commit and propose."""
        with self._mtx:  # cometlint: disable=CLNT009 -- delete_block rewrites base/height atomically; rare rollback path
            if height != self._height:
                raise ValueError(
                    f"can only delete the tip block ({self._height}), "
                    f"got {height}"
                )
            meta = self.load_block_meta(height)
            block = self.load_block(height)
            batch = self.db.new_batch()
            if meta is not None:
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_h(b"P:", height) + b":%06d" % i)
                batch.delete(b"BH:" + meta.block_id.hash)
            batch.delete(_h(b"BM:", height))
            batch.delete(_h(b"EC:", height))
            if block is not None and block.last_commit is not None:
                batch.set(b"SC", ser.dumps(block.last_commit))
            self._height = height - 1
            if self._base > self._height:
                self._base = self._height
            self._save_state(batch)
            batch.write()

    def prune_blocks(self, retain_height: int) -> int:
        """Delete blocks below ``retain_height``; returns number pruned
        (store/store.go:293). Keeps the commit chain above the new base."""
        with self._mtx:  # cometlint: disable=CLNT009 -- pruning updates base/height atomically; operator-paced
            if retain_height <= self._base:
                return 0
            if retain_height > self._height:
                raise ValueError("cannot prune beyond store height")
            pruned = 0
            batch = self.db.new_batch()
            for height in range(self._base, retain_height):
                meta = self.load_block_meta(height)
                if meta is None:
                    continue
                batch.delete(_h(b"BM:", height))
                batch.delete(b"BH:" + meta.block_id.hash)
                batch.delete(_h(b"C:", height - 1))
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_h(b"P:", height) + b":%06d" % i)
                batch.delete(_h(b"EC:", height))
                pruned += 1
            self._base = retain_height
            self._save_state(batch)
            batch.write_sync()
            return pruned
