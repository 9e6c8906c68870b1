"""The port's reactors against the JAX package's, on the CPU.

* consensus/reactor.PeerState: the port's and the reference's, each with
  a random.Random of one seed, through one seeded sequence of round steps,
  valid blocks, proposals, block parts, has-votes, vote-set bits and vote
  picks: the same mirror of the peer and the same votes picked.
* Four port validators over localhost TCP (chip_smoke.net_burst on the
  CPU) reach height 3 with identical blocks, and txs checked at node 3
  are committed and queried at node 1.
* What a peer's bytes cause is dropped or punished as in the reference:
  bad evidence and a message of nested JSON stop the peer (the reference's
  switch stops it too), a full mempool drops the tx. A device fault,
  marked where it left the device path (libs/devicefault), inside
  add_evidence or check_tx is not the peer's: the switch fail-stops the
  node through on_fatal and keeps the peer, where the reference's switch
  stops the peer.
"""

import random
import types

import pytest

from cometbft_tpu.consensus import messages as rcmsgs
from cometbft_tpu.consensus import reactor as rcreactor
from cometbft_tpu.evidence import reactor as rereactor
from cometbft_tpu.libs import bits as rbits
from cometbft_tpu.mempool import reactor as rmreactor
from cometbft_tpu.mempool.clist_mempool import MempoolError as RMempoolError
from cometbft_tpu.p2p import switch as rswitch
from cometbft_tpu.types.evidence import EvidenceError as REvidenceError
from cometbft_tpu_torch.blocksync import messages as tbsmsgs
from cometbft_tpu_torch.consensus import messages as tcmsgs
from cometbft_tpu_torch.consensus import reactor as tcreactor
from cometbft_tpu_torch.evidence import reactor as tereactor
from cometbft_tpu_torch.libs import bits as tbits
from cometbft_tpu_torch.libs import devicefault
from cometbft_tpu_torch.mempool import reactor as tmreactor
from cometbft_tpu_torch.mempool.clist_mempool import MempoolError
from cometbft_tpu_torch.p2p import switch as tswitch
from cometbft_tpu_torch.types import serialization as tser
from cometbft_tpu_torch.types.evidence import EvidenceError
from test_torch_smoke import _chip_smoke

PREVOTE, PRECOMMIT = 1, 2


def _bits(ba):
    return None if ba is None else [ba.get_index(i) for i in range(ba.size())]


def _mirror(ps):
    return (ps.height, ps.round, int(ps.step), ps.proposal,
            ps.proposal_block_parts_header, _bits(ps.proposal_block_parts),
            ps.proposal_pol_round, ps.last_commit_round,
            _bits(ps.last_commit),
            {r: _bits(b) for r, b in sorted(ps.prevotes.items())},
            {r: _bits(b) for r, b in sorted(ps.precommits.items())})


def _ops(seed, n_vals=7, steps=160):
    """One seeded sequence of PeerState calls, as package-neutral tuples."""
    rng = random.Random(seed)
    ops = []
    h = 1
    for _ in range(steps):
        kind = rng.choice(("step", "step", "valid", "proposal", "part",
                           "vote", "vote", "vote", "bits", "pick", "pick"))
        if kind == "step":
            h = max(1, h + rng.choice((0, 0, 1, -1)))
            ops.append(("step", h, rng.randrange(0, 3), rng.randrange(1, 9),
                        rng.randrange(-1, 2)))
        elif kind == "valid":
            ops.append(("valid", h + rng.choice((0, 0, 1)),
                        rng.randrange(0, 3), rng.randrange(1, 6),
                        [rng.random() < 0.5 for _ in range(5)],
                        rng.random() < 0.3))
        elif kind == "proposal":
            ops.append(("proposal", h, rng.randrange(0, 3),
                        rng.randrange(1, 6), rng.randrange(-1, 2)))
        elif kind == "part":
            ops.append(("part", h, rng.randrange(0, 3), rng.randrange(0, 5)))
        elif kind == "vote":
            ops.append(("vote", h - rng.choice((0, 0, 1)),
                        rng.randrange(-1, 3), rng.choice((PREVOTE, PRECOMMIT)),
                        rng.randrange(0, n_vals), n_vals))
        elif kind == "bits":
            ops.append(("bits", h, rng.randrange(0, 3),
                        rng.choice((PREVOTE, PRECOMMIT)),
                        [rng.random() < 0.5 for _ in range(n_vals)],
                        [rng.random() < 0.5 for _ in range(n_vals)]
                        if rng.random() < 0.7 else None))
        else:
            ops.append(("pick", h - rng.choice((0, 0, 1)),
                        rng.randrange(0, 3), rng.choice((PREVOTE, PRECOMMIT)),
                        [rng.random() < 0.6 for _ in range(n_vals)]))
    return ops


def _run_peer_state(reactor, msgs, bits, ops, seed):
    def ba(flags):
        out = bits.BitArray(len(flags))
        for i, f in enumerate(flags):
            out.set_index(i, f)
        return out
    ps = reactor.PeerState(rng=random.Random(seed))
    trace = []
    for op in ops:
        kind, picked = op[0], None
        if kind == "step":
            _, h, r, step, lcr = op
            ps.apply_new_round_step(msgs.NewRoundStepMessage(
                h, r, step, last_commit_round=lcr))
        elif kind == "valid":
            _, h, r, total, flags, commit = op
            ps.apply_new_valid_block(msgs.NewValidBlockMessage(
                h, r, ("psh", total), ba(flags), commit))
        elif kind == "proposal":
            _, h, r, total, pol = op
            ps.set_has_proposal(types.SimpleNamespace(
                height=h, round=r, pol_round=pol,
                block_id=types.SimpleNamespace(
                    part_set_header=types.SimpleNamespace(total=total))))
        elif kind == "part":
            ps.set_has_block_part(*op[1:])
        elif kind == "vote":
            ps.set_has_vote(*op[1:])
        elif kind == "bits":
            _, h, r, t, flags, ours = op
            ps.apply_vote_set_bits(msgs.VoteSetBitsMessage(
                h, r, t, votes=ba(flags)), None if ours is None else ba(ours))
        else:
            _, h, r, t, have = op
            votes = types.SimpleNamespace(
                height=h, round=r, signed_msg_type=t,
                size=lambda n=len(have): n,
                get_by_index=lambda i, have=have: ("vote", i) if have[i]
                else None)
            picked = ps.pick_vote_to_send(votes)
        trace.append((picked, _mirror(ps)))
    return trace


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_peer_state_equals_the_reference_over_one_sequence(seed):
    ops = _ops(seed)
    ours = _run_peer_state(tcreactor, tcmsgs, tbits, ops, seed)
    theirs = _run_peer_state(rcreactor, rcmsgs, rbits, ops, seed)
    assert ours == theirs
    assert any(p is not None for p, _ in ours)


def test_four_validators_over_tcp_commit_with_identical_blocks(
        tmp_path, monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "NET_BURST_HEIGHTS", 3)
    monkeypatch.setattr(cs, "NET_BURST_TXS", 4)
    out = cs.net_burst(tmp_path, device="cpu")
    assert min(out["heights"]) >= 3 and out["peers"] == [3, 1, 1, 1]
    assert out["txs"] == 4


class _Peer:
    def __init__(self, pid):
        self.id = pid
        self.persistent = False
        self.outbound = False
        self.socket_addr = ""
        self.stopped = False

    def is_running(self):
        return not self.stopped

    def stop(self):
        self.stopped = True


class _Pool:
    def __init__(self, exc=None):
        self.exc = exc
        self.evidence_list = []

    def add_evidence(self, ev):
        if self.exc is not None:
            raise self.exc


class _Mempool:
    def __init__(self, exc=None):
        self.exc = exc

    def check_tx(self, tx, sender=""):
        if self.exc is not None:
            raise self.exc


def _switch(sw_mod, ev_mod, mp_mod, cs_mod, pool, mempool):
    sw = sw_mod.Switch(transport=None)
    sw.add_reactor("MEMPOOL", mp_mod.MempoolReactor(
        types.SimpleNamespace(broadcast=False), mempool))
    sw.add_reactor("EVIDENCE", ev_mod.EvidenceReactor(pool))
    cs = types.SimpleNamespace(config=types.SimpleNamespace(
        peer_gossip_sleep_duration_ns=10**8,
        peer_query_maj23_sleep_duration_ns=10**9))
    sw.add_reactor("CONSENSUS", cs_mod.ConsensusReactor(cs))
    sw.fatal = []
    sw.on_fatal = sw.fatal.append
    return sw


def _deliver(sw, ch, msg):
    peer = _Peer("peer-under-test")
    sw._peers[peer.id] = peer
    sw._on_peer_receive(ch, peer, msg)
    return sw.get_peer(peer.id) is None  # stopped and removed


NESTED = b"[" * 200_000 + b"]" * 200_000
SOME_EVIDENCE = tser.dumps(tbsmsgs.StatusRequestMessage())  # decodes


@pytest.mark.parametrize("case,ch,msg,pool_exc,mp_exc,stopped", [
    ("bad evidence bytes", 0x38, b"not json", None, None, True),
    ("evidence the pool refuses", 0x38, SOME_EVIDENCE,
     "evidence", None, True),
    ("nested JSON on the consensus channel", 0x20, NESTED, None, None, True),
    ("a tx the mempool refuses", 0x30, b"tx", None, "mempool", False),
    ("a tx whose check raises", 0x30, b"tx", None, "recursion", True),
])
def test_a_peers_bad_bytes_are_handled_as_in_the_reference(
        case, ch, msg, pool_exc, mp_exc, stopped):
    for sw_mod, ev_mod, mp_mod, cs_mod, ev_err, mp_err in (
            (tswitch, tereactor, tmreactor, tcreactor, EvidenceError,
             MempoolError),
            (rswitch, rereactor, rmreactor, rcreactor, REvidenceError,
             RMempoolError)):
        excs = {"evidence": ev_err("invalid"), "mempool": mp_err("full"),
                "recursion": RecursionError("nested"), None: None}
        sw = _switch(sw_mod, ev_mod, mp_mod, cs_mod, _Pool(excs[pool_exc]),
                     _Mempool(excs[mp_exc]))
        assert _deliver(sw, ch, msg) is stopped, (case, sw_mod.__name__)
        assert sw.fatal == []


@pytest.mark.parametrize("where", ["add_evidence", "check_tx"])
@pytest.mark.parametrize("exc", [ValueError, RuntimeError, TimeoutError])
def test_a_device_fault_fail_stops_and_blames_no_peer(where, exc):
    fault = devicefault.mark(exc("CUDA error: launch failed"),
                             "ed25519 batch verify")
    pool = _Pool(fault if where == "add_evidence" else None)
    mempool = _Mempool(fault if where == "check_tx" else None)
    sw = _switch(tswitch, tereactor, tmreactor, tcreactor, pool, mempool)
    ch, msg = (0x38, SOME_EVIDENCE) if where == "add_evidence" else (
        0x30, b"tx")
    assert _deliver(sw, ch, msg) is False
    assert sw.fatal == [fault]
    # the reference's switch blames the peer for the same exception
    rsw = _switch(rswitch, rereactor, rmreactor, rcreactor,
                  _Pool(pool.exc), _Mempool(mempool.exc))
    assert _deliver(rsw, ch, msg) is True


def test_a_fault_marked_under_a_cause_chain_still_fail_stops():
    inner = devicefault.mark(RuntimeError("readback timed out"),
                             "hash plane")
    try:
        try:
            raise inner
        except RuntimeError as e:
            raise EvidenceError("could not verify") from e
    except EvidenceError as e:
        outer = e
    sw = _switch(tswitch, tereactor, tmreactor, tcreactor, _Pool(outer),
                 _Mempool())
    assert _deliver(sw, 0x38, SOME_EVIDENCE) is False
    assert sw.fatal == [outer]
