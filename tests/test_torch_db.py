"""The port's key-value store (libs/db.py), fault points (libs/fail.py)
and tagged-JSON codec (libs/jsoncodec.py) against the JAX package's, op
for op: MemDB and FileDB contents and ranges, FileDB's log bytes on disk,
its torn-tail truncation, bad-magic refusal, batch atomicity and
compaction, and prefix_end. Seeded random ops drive both packages alike;
everything must be equal, the files byte for byte.
"""

import os
import random

import pytest

from cometbft_tpu.libs import db as rdb
from cometbft_tpu.libs import fail as rfail
from cometbft_tpu.libs import jsoncodec as rcodec
from cometbft_tpu_torch.libs import db as tdb
from cometbft_tpu_torch.libs import fail as tfail
from cometbft_tpu_torch.libs import jsoncodec as tcodec

SEED = 14


def _ops(seed, n=400):
    """Seeded mutations: set, set_sync, delete and batches over a small
    key space (so overwrites and deletes hit live keys)."""
    rng = random.Random(seed)
    keys = [bytes([rng.randrange(256) for _ in range(rng.randrange(1, 4))])
            for _ in range(40)] + [b"\xff", b"\xff\xff", b"a\xff"]
    ops = []
    for _ in range(n):
        r = rng.random()
        k = rng.choice(keys)
        if r < 0.5:
            ops.append(("set", k, rng.randbytes(rng.randrange(0, 64))))
        elif r < 0.6:
            ops.append(("set_sync", k, rng.randbytes(rng.randrange(0, 8))))
        elif r < 0.8:
            ops.append(("delete", k, b""))
        else:
            ops.append(("batch", [(rng.random() < 0.7, rng.choice(keys),
                                   rng.randbytes(rng.randrange(0, 16)))
                                  for _ in range(rng.randrange(0, 6))], b""))
    return ops


def _apply(db, ops):
    for op, k, v in ops:
        if op == "batch":
            b = db.new_batch()
            for is_set, bk, bv in k:
                if is_set:
                    b.set(bk, bv)
                else:
                    b.delete(bk)
            b.write()
        else:
            getattr(db, op)(*((k, v) if op != "delete" else (k,)))


def _view(db):
    """Everything a caller can read: the contents, a few ranges both ways
    and point lookups."""
    out = [list(db.iterator())]
    for lo, hi in ((None, None), (b"\x10", b"\x80"), (b"a", None),
                   (None, b"\x05"), (b"\x80", b"\x10")):
        out.append(list(db.iterator(lo, hi)))
        out.append(list(db.reverse_iterator(lo, hi)))
    out.append([(k, db.get(k), db.has(k)) for k in (b"", b"\x00", b"\xff")])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_memdb_random_ops_equal_reference(seed):
    ops = _ops(SEED + seed)
    r, t = rdb.MemDB(), tdb.MemDB()
    _apply(r, ops)
    _apply(t, ops)
    assert _view(t) == _view(r)


@pytest.mark.parametrize("seed", range(3))
def test_filedb_random_ops_equal_reference_on_disk(tmp_path, seed):
    """The same ops give the same contents and the same log bytes (the
    same compactions on the way), and both reopen to the same store."""
    ops = _ops(SEED + 10 + seed)
    rp, tp = str(tmp_path / "r.db"), str(tmp_path / "t.db")
    r, t = rdb.FileDB(rp, compact_factor=2), tdb.FileDB(tp, compact_factor=2)
    _apply(r, ops)
    _apply(t, ops)
    assert _view(t) == _view(r)
    r.close()
    t.close()
    with open(rp, "rb") as f, open(tp, "rb") as g:
        assert g.read() == f.read()
    r, t = rdb.FileDB(rp), tdb.FileDB(tp)
    assert _view(t) == _view(r)
    r.close()
    t.close()


def _log(path, mod):
    db = mod.FileDB(path, compact_factor=10_000)
    db.set_sync(b"base", b"1")
    db.set(b"k", b"v" * 10)
    b = db.new_batch()
    b.set(b"x", b"1")
    b.set(b"y", b"2")
    b.delete(b"base")
    b.write_sync()
    db.delete(b"k")
    db.close()


@pytest.mark.parametrize("cut", [1, 3, 5, 9, 13, 17, 30])
def test_torn_tail_truncates_as_reference(tmp_path, cut):
    """A log cut short at its tail reopens to the last whole record, the
    torn bytes truncated from the file, exactly as the reference; a batch
    is one record, so it replays whole or not at all."""
    rp, tp = str(tmp_path / "r.db"), str(tmp_path / "t.db")
    _log(rp, rdb)
    _log(tp, tdb)
    size = os.path.getsize(rp)
    assert os.path.getsize(tp) == size
    for p in (rp, tp):
        with open(p, "r+b") as f:
            f.truncate(size - cut)
    r, t = rdb.FileDB(rp), tdb.FileDB(tp)
    assert list(t.iterator()) == list(r.iterator())
    if t.get(b"x") is None:
        assert t.get(b"y") is None
    else:
        assert t.get(b"y") == b"2" and t.get(b"base") is None
    r.close()
    t.close()
    assert os.path.getsize(tp) == os.path.getsize(rp) < size
    with open(rp, "rb") as f, open(tp, "rb") as g:
        assert g.read() == f.read()


@pytest.mark.parametrize("content", [
    b"NKV1\n" + b"\x00" * 20,  # the native engine's magic
    b"\x00\x01\x02 not a database \xff" * 4,
    b"FKV2\nxx",
])
def test_bad_magic_raises_and_leaves_the_file(tmp_path, content):
    """A file of another format raises ValueError in both packages, and
    neither truncates it: no fallback to an empty store."""
    for mod in (rdb, tdb):
        p = tmp_path / f"{mod.__name__}.db"
        p.write_bytes(content)
        with pytest.raises(ValueError, match="not a FileDB file"):
            mod.FileDB(str(p))
        assert p.read_bytes() == content


@pytest.mark.parametrize("n", [1, 3, 4])
def test_magic_prefix_is_an_empty_store(tmp_path, n):
    """A strict prefix of the magic (a crash before it was durable) is an
    empty database in both packages; what is written next reads back."""
    for mod in (rdb, tdb):
        p = tmp_path / f"{mod.__name__}.db"
        p.write_bytes(b"FKV1\n"[:n])
        db = mod.FileDB(str(p))
        assert list(db.iterator()) == []
        db.set_sync(b"k", b"v")
        db.close()
        db = mod.FileDB(str(p))
        assert db.get(b"k") == b"v"
        db.close()
    assert ((tmp_path / f"{tdb.__name__}.db").read_bytes()
            == (tmp_path / f"{rdb.__name__}.db").read_bytes())


def test_batch_is_atomic_and_fsynced_as_one_record(tmp_path):
    """A batch appends one record whose bytes equal the reference's; a
    batch with nothing in it appends an empty record in both."""
    sizes = {}
    for mod in (rdb, tdb):
        p = str(tmp_path / f"{mod.__name__}.db")
        db = mod.FileDB(p)
        before = os.path.getsize(p)
        b = db.new_batch()
        b.set(b"a", b"1")
        b.delete(b"b")
        b.set(b"c", b"")
        b.write()
        mid = os.path.getsize(p)
        db.new_batch().write()
        sizes[mod] = (before, mid, os.path.getsize(p))
        assert db.get(b"a") == b"1" and db.get(b"c") == b""
        db.close()
    assert sizes[tdb] == sizes[rdb]
    with open(str(tmp_path / f"{rdb.__name__}.db"), "rb") as f, open(
            str(tmp_path / f"{tdb.__name__}.db"), "rb") as g:
        assert g.read() == f.read()


@pytest.mark.parametrize("explicit", [False, True])
def test_compaction_equals_reference(tmp_path, explicit):
    """Overwriting one hot key compacts the log (automatically past the
    factor, or on compact()), to the same bytes as the reference, and
    keeps every live key."""
    files = {}
    for mod in (rdb, tdb):
        p = str(tmp_path / f"{mod.__name__}.db")
        db = mod.FileDB(p, compact_factor=10_000 if explicit else 4)
        for i in range(400):
            db.set(b"hot", bytes([i % 256]) * 300)
        db.set(b"cold", b"keep")
        grown = os.path.getsize(p)
        if explicit:
            db.compact()
        assert os.path.getsize(p) < grown or not explicit
        assert db.get(b"hot") == bytes([399 % 256]) * 300
        assert db.get(b"cold") == b"keep"
        db.close()
        files[mod] = open(p, "rb").read()
    assert files[tdb] == files[rdb]
    # 400 appends of the hot key would be ~123 KB: compacted, the log
    # holds the live records (explicit) or stays under the 64 KiB floor
    # of the automatic trigger plus one record
    assert len(files[tdb]) < (1_000 if explicit else (1 << 16) + 400)


@pytest.mark.parametrize("prefix", [b"abc", b"a\xff", b"\xff", b"\xff\xff",
                                    b"", b"\x00", b"k:\xfe\xff"])
def test_prefix_end_equals_reference(prefix):
    assert tdb.prefix_end(prefix) == rdb.prefix_end(prefix)


def test_prefix_iteration_covers_exactly_the_prefix():
    keys = [b"k", b"k:", b"k:\x00", b"k:\xff\xff", b"k;", b"j\xff", b"l"]
    for mod in (rdb, tdb):
        db = mod.MemDB()
        for k in keys:
            db.set(k, k)
    got = [k for k, _ in db.iterator(b"k:", tdb.prefix_end(b"k:"))]
    assert got == [b"k:", b"k:\x00", b"k:\xff\xff"]


def test_fail_points_follow_the_reference(monkeypatch):
    """An armed point calls the in-process handler in both packages; a
    delay point calls its handler, and both are free when unset."""
    for mod in (rfail, tfail):
        hits = []
        monkeypatch.setattr(mod, "_target", "")
        mod.fail_point("exec-after-finalize")  # unarmed: nothing
        mod.set_handler(hits.append)
        mod.set_target("exec-after-finalize")
        mod.fail_point("exec-after-save-responses")
        mod.fail_point("exec-after-finalize")
        mod.set_delay_handler(hits.append)
        mod.delay_point("store-write")
        mod.set_delay_handler(None)
        mod.delay_point("store-write")
        mod.set_handler(None)
        mod.set_target("")
        assert hits == ["exec-after-finalize", "store-write"], mod
    assert tfail.ENV_VAR == rfail.ENV_VAR


def test_jsoncodec_bytes_equal_reference():
    """The codec's encoding rules (class tags, hex bytes, IntEnums as
    ints, dicts, tuples, underscore fields skipped) give the reference's
    bytes, and decode restores tuples and enums from the field types."""
    import dataclasses
    import enum

    class Kind(enum.IntEnum):
        A = 1
        B = 2

    def make(mod):
        @dataclasses.dataclass
        class Rec:
            kind: Kind
            pair: tuple[int, int]
            data: bytes
            nested: dict
            _cache: bytes = b"skipped"

        c = mod.Codec()
        c.register(Rec)
        c.register_adapter(complex, "cx", lambda z: [z.real, z.imag],
                           lambda v: complex(*v))
        return c, Rec

    rc, rrec = make(rcodec)
    tc, trec = make(tcodec)
    value = dict(kind=Kind.B, pair=(3, 4), data=b"\x00\xff",
                 nested={"a": [1, None, True, 2.5], b"k": complex(1, 2)})
    blob = rc.dumps(rrec(**value))
    assert tc.dumps(trec(**value)) == blob
    back = tc.loads(blob)
    assert back.kind is Kind.B and back.pair == (3, 4)
    assert back.nested == value["nested"] and back._cache == b"skipped"

    @dataclasses.dataclass
    class Unregistered:
        x: int

    for c in (rc, tc):
        with pytest.raises(TypeError, match="unregistered"):
            c.dumps(Unregistered(1))

