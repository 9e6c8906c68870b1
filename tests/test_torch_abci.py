"""The port's ABCI layer (abci/types, application, codec, kvstore,
client; proxy) and its event plumbing (libs/pubsub, types/event_bus)
against the JAX package's: the kvstore, local-client and proxy cases of
tests/test_abci.py run on both packages alike and every response must be
equal field for field (compared through each package's ABCI codec, which
writes every field); the codec's frames byte for byte; queries and
published events alike.
"""

import dataclasses
import hashlib
import io

import pytest

from cometbft_tpu import proxy as rproxy
from cometbft_tpu.abci import codec as rcodec
from cometbft_tpu.abci import kvstore as rkv
from cometbft_tpu.abci import types as rabci
from cometbft_tpu.abci.client import LocalClient as RLocalClient
from cometbft_tpu.libs import db as rdb
from cometbft_tpu.libs import pubsub as rpubsub
from cometbft_tpu.types import event_bus as rbus
from cometbft_tpu_torch import proxy as tproxy
from cometbft_tpu_torch.abci import codec as tcodec
from cometbft_tpu_torch.abci import kvstore as tkv
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.abci.client import LocalClient as TLocalClient
from cometbft_tpu_torch.libs import db as tdb
from cometbft_tpu_torch.libs import pubsub as tpubsub
from cometbft_tpu_torch.types import event_bus as tbus

REF = dict(abci=rabci, kv=rkv, db=rdb, codec=rcodec, proxy=rproxy,
           client=RLocalClient)
PORT = dict(abci=tabci, kv=tkv, db=tdb, codec=tcodec, proxy=tproxy,
            client=TLocalClient)


def _finalize(pkg, app, height, txs):
    abci = pkg["abci"]
    return app.finalize_block(abci.RequestFinalizeBlock(
        txs=txs, decided_last_commit=abci.CommitInfo(round=0),
        misbehavior=[], hash=b"\x01" * 32, height=height, time_ns=0,
        next_validators_hash=b"", proposer_address=b""))


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages; the lists of
    responses it returns must be equal through each package's codec."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        out[name] = [pkg["codec"]._to_jsonable(r) if dataclasses.is_dataclass(
            r) else r for r in scenario(pkg, *args)]
    assert out["port"] == out["ref"]
    return out["port"]


def _check_tx(pkg):
    app = pkg["kv"].KVStoreApplication()
    return [app.check_tx(pkg["abci"].RequestCheckTx(tx=tx)) for tx in (
        b"a=1", b"no-equals", b"=v", b"val:" + b"aa" * 32 + b"!5",
        b"val:zz!5", b"val:aa", b"")]


def _finalize_commit_query(pkg):
    abci = pkg["abci"]
    app = pkg["kv"].KVStoreApplication()
    out = [_finalize(pkg, app, 1, [b"name=satoshi", b"bad", b"=x",
                                   b"k=v=w", b"\xff\x01=edge"])]
    out.append(app.commit())
    for key in (b"name", b"missing", b"k", b"\xff\x01"):
        out.append(app.query(abci.RequestQuery(data=key)))
    out.append(app.info(abci.RequestInfo()))
    out.append(_finalize(pkg, app, 2, [b"b=2"]))
    out.append(app.commit())
    out.append(app.info(abci.RequestInfo()))
    return out


def _validator_updates(pkg):
    app = pkg["kv"].KVStoreApplication()
    pk = b"\xaa" * 32
    return [_finalize(pkg, app, 1, [b"val:" + pk.hex().encode() + b"!7",
                                    b"val:" + pk.hex().encode() + b"!0",
                                    b"val:nothex!3", b"x=y"]),
            app.process_proposal(pkg["abci"].RequestProcessProposal(
                txs=[b"val:zz!1"], proposed_last_commit=pkg[
                    "abci"].CommitInfo(round=0), misbehavior=[], hash=b"",
                height=1, time_ns=0, next_validators_hash=b"",
                proposer_address=b"")),
            app.process_proposal(pkg["abci"].RequestProcessProposal(
                txs=[b"a=b", b"val:" + pk.hex().encode() + b"!2"],
                proposed_last_commit=pkg["abci"].CommitInfo(round=0),
                misbehavior=[], hash=b"", height=1, time_ns=0,
                next_validators_hash=b"", proposer_address=b""))]


def _snapshot(pkg, keys):
    abci = pkg["abci"]
    src = pkg["kv"].KVStoreApplication(snapshot_interval=1)
    out = [_finalize(pkg, src, 1, keys), src.commit(),
           src.list_snapshots(abci.RequestListSnapshots())]
    snaps = out[-1].snapshots
    chunk = src.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(
        height=1, format=1, chunk=0))
    out.append(chunk)
    dst = pkg["kv"].KVStoreApplication()
    out.append(dst.offer_snapshot(abci.RequestOfferSnapshot(
        snapshot=snaps[0], app_hash=src.app_hash)))
    out.append(dst.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(
        index=0, chunk=chunk.chunk)))
    out.append(dst.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(
        index=0, chunk=b"{not json")))
    out.append(dst.offer_snapshot(abci.RequestOfferSnapshot(
        snapshot=dataclasses.replace(snaps[0], format=2), app_hash=b"")))
    out.append(dst.offer_snapshot(abci.RequestOfferSnapshot(
        snapshot=snaps[0], app_hash=b"\x00" * 8)))
    out.append(dst.info(abci.RequestInfo()))
    for k in keys:
        out.append(dst.query(abci.RequestQuery(data=k.partition(b"=")[0])))
    return out


def test_kvstore_check_tx_equals_reference():
    assert [r["code"] for r in _both(_check_tx)] == [0, 1, 1, 0, 1, 1, 1]


def test_kvstore_finalize_commit_query_equals_reference():
    out = _both(_finalize_commit_query)
    assert out[2]["value"] == {"__b": b"satoshi".hex()}


def test_kvstore_app_hash_tracks_size_as_reference():
    def scenario(pkg):
        app = pkg["kv"].KVStoreApplication()
        hashes = []
        for h, txs in enumerate(([b"a=1"], [b"b=2", b"c=3"], [], [b"x"]),
                                start=1):
            hashes.append(_finalize(pkg, app, h, txs).app_hash)
            app.commit()
        return hashes
    hashes = _both(scenario)
    # the hash is the tx count: an empty block and a bad tx keep it
    assert hashes == [(n).to_bytes(8, "big") for n in (1, 3, 3, 3)]


def test_kvstore_validator_updates_equal_reference():
    out = _both(_validator_updates)
    assert [u["power"] for u in out[0]["validator_updates"]] == [7, 0]
    assert out[1]["status"] == 2 and out[2]["status"] == 1


@pytest.mark.parametrize("keys", [[b"x=1", b"y=2"], [b"\xff\x01=edge"],
                                  [b"k%d=%d" % (i, i) for i in range(20)]])
def test_kvstore_snapshot_roundtrip_equals_reference(keys):
    out = _both(_snapshot, keys)
    assert out[5]["result"] == 1  # ACCEPT


def test_kvstore_persistence_and_info_equal_reference(tmp_path):
    """FileDB-backed apps: the app hash and data survive a reopen, and
    the app database's file equals the reference's byte for byte."""
    def scenario(pkg):
        abci, dbm = pkg["abci"], pkg["db"]
        path = str(tmp_path / f"{pkg['kv'].__name__}.db")
        db = dbm.FileDB(path)
        app = pkg["kv"].KVStoreApplication(db)
        out = [_finalize(pkg, app, 1, [b"k=v", b"val:" + b"ab" * 32 +
                                       b"!4"]), app.commit()]
        db.close()
        db2 = dbm.FileDB(path)
        app2 = pkg["kv"].KVStoreApplication(db2)
        out += [app2.info(abci.RequestInfo()),
                app2.query(abci.RequestQuery(data=b"k"))]
        db2.close()
        out.append(open(path, "rb").read().hex())
        return out
    out = _both(scenario)
    assert out[2]["last_block_height"] == 1


def test_kvstore_speculation_restores_the_app_as_reference():
    """The local client's snapshot/finalize/restore sandwich leaves the
    app as it was, and applying the post token then Commit persists the
    same state as a plain FinalizeBlock."""
    def scenario(pkg):
        abci = pkg["abci"]
        app = pkg["kv"].KVStoreApplication()
        client = pkg["client"](app)
        client.start()
        req = abci.RequestFinalizeBlock(
            txs=[b"s=1", b"t=2"], decided_last_commit=abci.CommitInfo(0),
            misbehavior=[], hash=b"", height=1, time_ns=0,
            next_validators_hash=b"", proposer_address=b"")
        assert client.supports_speculation()
        resp, post = client.speculate_finalize(req)
        before = client.info(abci.RequestInfo())
        client.apply_speculation(post)
        out = [resp, before, client.commit(), client.info(abci.RequestInfo()),
               client.query(abci.RequestQuery(data=b"t"))]
        client.stop()
        return out
    out = _both(scenario)
    assert out[1]["last_block_height"] == 0
    assert out[3]["last_block_height"] == 1


def test_local_client_sync_and_async_equal_reference():
    def scenario(pkg):
        abci = pkg["abci"]
        client = pkg["client"](pkg["kv"].KVStoreApplication())
        client.start()
        got = []
        client.set_response_callback(lambda req, res: got.append(res))
        out = [client.check_tx(abci.RequestCheckTx(tx=b"a=1"))]
        rr = client.check_tx_async(abci.RequestCheckTx(tx=b"b"))
        out.append(rr.wait(1))
        later = []
        rr.set_callback(later.append)
        out += got + later + [client.echo("x")]
        client.stop()
        return out
    out = _both(scenario)
    assert len(out) == 5 and out[1]["code"] == 1


def test_proxy_four_connections_equal_reference():
    def scenario(pkg):
        abci = pkg["abci"]
        app = pkg["kv"].KVStoreApplication()
        conns = pkg["proxy"].AppConns(pkg["proxy"].local_client_creator(app))
        conns.start()
        clients = (conns.consensus, conns.mempool, conns.query,
                   conns.snapshot)
        assert all(c is not None and c.is_running() for c in clients)
        assert len({id(c.mtx) for c in clients}) == 1  # one shared mutex
        out = [conns.mempool.check_tx(abci.RequestCheckTx(tx=b"a=1")),
               conns.consensus.finalize_block(abci.RequestFinalizeBlock(
                   txs=[b"a=1"], decided_last_commit=abci.CommitInfo(0),
                   misbehavior=[], hash=b"\x03" * 32, height=1, time_ns=0,
                   next_validators_hash=b"", proposer_address=b"")),
               conns.consensus.commit(),
               conns.query.query(abci.RequestQuery(data=b"a")),
               conns.snapshot.list_snapshots(abci.RequestListSnapshots())]
        conns.stop()
        assert not any(c.is_running() for c in clients)
        return out
    out = _both(scenario)
    assert out[3]["value"] == {"__b": b"1".hex()}


def test_proxy_client_error_reaches_on_error_as_reference():
    for pkg in (REF, PORT):
        seen = []
        conns = pkg["proxy"].AppConns(
            pkg["proxy"].local_client_creator(pkg["kv"].KVStoreApplication()),
            on_error=seen.append)
        conns.start()
        err = RuntimeError("transport gone")
        conns.consensus._on_error(err)
        assert seen == [err]
        conns.stop()


def _requests(abci):
    """One instance of every request and response the protocol carries."""
    vu = abci.ValidatorUpdate("ed25519", b"\x01" * 32, 5)
    ci = abci.CommitInfo(1, [abci.VoteInfo(abci.Validator(b"\x02" * 20, 3),
                                           2)])
    mis = [abci.Misbehavior(abci.MisbehaviorType.DUPLICATE_VOTE,
                            abci.Validator(b"\x03" * 20, 4), 7, 8, 9)]
    snap = abci.Snapshot(3, 1, 1, b"\x04" * 8, b"m")
    ev = [abci.Event("app", [abci.EventAttribute("key", "v", True)])]
    return [
        ("info", abci.RequestInfo("v", 11, 8, "2.0.0")),
        ("info", abci.ResponseInfo("d", "v", 1, 2, b"\x05")),
        ("query", abci.RequestQuery(b"k", "/p", 3, True)),
        ("query", abci.ResponseQuery(0, "l", "i", 1, b"k", b"v", None, 2)),
        ("check_tx", abci.RequestCheckTx(b"a=1", abci.CheckTxType.RECHECK)),
        ("check_tx", abci.ResponseCheckTx(1, b"d", "l", events=ev)),
        ("init_chain", abci.RequestInitChain(5, "c", None, [vu], b"{}", 1)),
        ("init_chain", abci.ResponseInitChain(None, [vu], b"\x06")),
        ("prepare_proposal", abci.RequestPrepareProposal(
            100, [b"t"], abci.ExtendedCommitInfo(0, [abci.ExtendedVoteInfo(
                abci.Validator(b"\x07" * 20, 1), b"x", b"y", 2)]), mis, 4, 5,
            b"\x08", b"\x09")),
        ("prepare_proposal", abci.ResponsePrepareProposal([b"t"])),
        ("process_proposal", abci.RequestProcessProposal(
            [b"t"], ci, mis, b"h", 4, 5, b"n", b"p")),
        ("process_proposal", abci.ResponseProcessProposal(
            abci.ProcessProposalStatus.REJECT)),
        ("extend_vote", abci.RequestExtendVote(b"h", 3, 4, [b"t"], ci)),
        ("extend_vote", abci.ResponseExtendVote(b"ext")),
        ("verify_vote_extension", abci.RequestVerifyVoteExtension(
            b"h", b"a", 2, b"e")),
        ("verify_vote_extension", abci.ResponseVerifyVoteExtension(
            abci.VerifyVoteExtensionStatus.ACCEPT)),
        ("finalize_block", abci.RequestFinalizeBlock(
            [b"t"], ci, mis, b"h", 4, 5, b"n", b"p")),
        ("finalize_block", abci.ResponseFinalizeBlock(
            ev, [abci.ExecTxResult(0, b"d", events=ev)], [vu], None, b"a")),
        ("commit", abci.RequestCommit()),
        ("commit", abci.ResponseCommit(7)),
        ("list_snapshots", abci.RequestListSnapshots()),
        ("list_snapshots", abci.ResponseListSnapshots([snap])),
        ("offer_snapshot", abci.RequestOfferSnapshot(snap, b"\x0a")),
        ("offer_snapshot", abci.ResponseOfferSnapshot(
            abci.OfferSnapshotResult.REJECT_FORMAT)),
        ("load_snapshot_chunk", abci.RequestLoadSnapshotChunk(3, 1, 0)),
        ("load_snapshot_chunk", abci.ResponseLoadSnapshotChunk(b"c")),
        ("apply_snapshot_chunk", abci.RequestApplySnapshotChunk(0, b"c",
                                                                "peer")),
        ("apply_snapshot_chunk", abci.ResponseApplySnapshotChunk(
            abci.ApplySnapshotChunkResult.RETRY, [1], ["p"])),
    ]


@pytest.mark.parametrize("i", range(len(_requests(tabci))))
def test_codec_frame_equals_reference_and_round_trips(i):
    """encode_frame of each message is the reference's bytes, and
    read_frame gives back an equal message with its enums restored."""
    method, msg = _requests(tabci)[i]
    rmethod, rmsg = _requests(rabci)[i]
    frame = tcodec.encode_frame(method, msg)
    assert frame == rcodec.encode_frame(rmethod, rmsg)
    got_method, got = tcodec.read_frame(io.BytesIO(frame))
    assert got_method == method and got == msg
    for f in dataclasses.fields(got):
        assert type(getattr(got, f.name)) is type(getattr(msg, f.name))


def test_codec_rejects_oversized_and_truncated_frames():
    frame = tcodec.encode_frame("echo", tabci.RequestCommit())
    assert tcodec.read_frame(io.BytesIO(b"")) is None
    with pytest.raises(EOFError):
        tcodec.read_frame(io.BytesIO(frame[:-3]))
    huge = bytes([0x80 | 0x7F, 0x80 | 0x7F, 0x80 | 0x7F, 0x7F])
    with pytest.raises(ValueError, match="exceeds limit"):
        tcodec.read_frame(io.BytesIO(huge))
    with pytest.raises(TypeError):
        tcodec._to_jsonable(object())


QUERIES = ["tm.event = 'NewBlock'", "tx.height > 5 AND tx.height <= 10",
           "abci.owner.name CONTAINS 'ana'", "tx.hash EXISTS",
           "transfer.amount > 100", "block.time >= TIME 2024-01-01T00:00:00Z",
           "a.b = 'x' AND c.d < 3.5"]
EVENTS = [{"tm.event": ["NewBlock"]}, {"tm.event": ["Tx"]}, {},
          {"tx.height": ["7"]}, {"tx.height": ["5", "10"]},
          {"abci.owner.name": ["banana"]}, {"tx.hash": ["deadbeef"]},
          {"transfer.amount": ["7", "250"]}, {"transfer.amount": ["x"]},
          {"block.time": ["2024-06-01T00:00:00Z"]},
          {"a.b": ["x"], "c.d": ["3"]}, {"a.b": ["x"], "c.d": ["4"]}]


@pytest.mark.parametrize("q", QUERIES)
def test_pubsub_query_matches_as_reference(q):
    tq, rq = tpubsub.Query.parse(q), rpubsub.Query.parse(q)
    assert str(tq) == str(rq)
    assert [tq.matches(e) for e in EVENTS] == [rq.matches(e) for e in EVENTS]
    assert tq == tpubsub.Query.parse(q) and hash(tq) == hash(
        tpubsub.Query.parse(q))


@pytest.mark.parametrize("bad", ["= 'x'", "tm.event =", "a = 'x' OR b = 'y'",
                                 "a CONTAINS 5", "a = TIME 5", "a AND"])
def test_pubsub_query_syntax_errors_as_reference(bad):
    for mod in (rpubsub, tpubsub):
        with pytest.raises(mod.QuerySyntaxError):
            mod.Query.parse(bad)


def test_pubsub_server_flow_as_reference():
    for mod in (rpubsub, tpubsub):
        s = mod.Server()
        q = mod.Query.parse("tm.event = 'Tx'")
        sub = s.subscribe("c", q)
        with pytest.raises(mod.AlreadySubscribedError):
            s.subscribe("c", q)
        slow = s.subscribe("slow", mod.Empty(), capacity=1)
        s.publish("tx", {"tm.event": ["Tx"]})
        s.publish("block", {"tm.event": ["NewBlock"]})
        assert sub.out.get_nowait().data == "tx" and sub.out.empty()
        assert slow.canceled.is_set() and slow.cancel_reason == \
            "slow subscriber"
        assert s.num_clients() == 1 and s.num_client_subscriptions("c") == 1
        s.unsubscribe("c", q)
        with pytest.raises(mod.NotSubscribedError):
            s.unsubscribe("c", q)
        last = s.subscribe("d", mod.Empty())
        s.stop()
        assert last.canceled.is_set() and s.num_clients() == 0


def _bus_events(bus_mod, abci):
    """What an EventBus publishes for each typed publisher: (data type,
    the composite-key event map) in publish order."""
    bus = bus_mod.EventBus()
    bus.start()
    pubsub = rpubsub if bus_mod is rbus else tpubsub
    sub = bus.subscribe("all", pubsub.Empty(), capacity=None)
    ev = [abci.Event("app", [abci.EventAttribute("key", "k1", True),
                             abci.EventAttribute("creator", "kv")])]

    @dataclasses.dataclass
    class Header:
        height: int

    @dataclasses.dataclass
    class Blk:
        header: Header

    resp = abci.ResponseFinalizeBlock(events=ev)
    bus.publish_new_block(bus_mod.EventDataNewBlock(Blk(Header(4)), b"id",
                                                    resp))
    bus.publish_new_block_header(bus_mod.EventDataNewBlockHeader(Header(4)))
    bus.publish_new_block_events(bus_mod.EventDataNewBlockEvents(4, ev, 1))
    bus.publish_tx(bus_mod.EventDataTx(4, 0, b"k1=v", abci.ExecTxResult(
        events=ev)))
    bus.publish_validator_set_updates(
        bus_mod.EventDataValidatorSetUpdates([]))
    bus.publish_new_round_step(bus_mod.EventDataRoundState(4, 0, "Propose"))
    bus.publish_vote(bus_mod.EventDataVote(None))
    out = []
    while not sub.out.empty():
        m = sub.out.get_nowait()
        out.append((type(m.data).__name__, m.events))
    assert bus.num_clients() == 1
    bus.stop()
    assert sub.canceled.is_set()
    bus_mod.NopEventBus().publish_tx(None)
    return out


def test_event_bus_publishes_as_reference():
    got = _bus_events(tbus, tabci)
    assert got == _bus_events(rbus, rabci)
    assert [e["tm.event"] for _, e in got] == [
        ["NewBlock"], ["NewBlockHeader"], ["NewBlockEvents"], ["Tx"],
        ["ValidatorSetUpdates"], ["NewRoundStep"], ["Vote"]]
    assert got[3][1]["tx.hash"] == [hashlib.sha256(b"k1=v").hexdigest()
                                    .upper()]
    assert got[3][1]["app.key"] == ["k1"]
    assert str(tbus.QUERY_TX) == str(rbus.QUERY_TX)
