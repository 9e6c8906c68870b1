"""The port's mempool (cometbft_tpu_torch/mempool, libs/clist) against the
JAX package's, on the same seeded inputs, exactly.

Both CListMempools sit on their own package's kvstore behind a local ABCI
client; the port's runs with ``device="cpu"``, so its tx keys go through
hashlib as the reference's do without a routed hash plane.
"""

import random

import pytest

from cometbft_tpu import abci as rabci
from cometbft_tpu import config as rconfig
from cometbft_tpu.abci.client import LocalClient as RLocalClient
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.libs.clist import CList as RCList
from cometbft_tpu.mempool import CListMempool as RMempool
from cometbft_tpu.mempool import LRUTxCache as RLRU
from cometbft_tpu.mempool import TxKey as RTxKey
from cometbft_tpu_torch import abci as tabci
from cometbft_tpu_torch import config as tconfig
from cometbft_tpu_torch.abci.client import LocalClient as TLocalClient
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as TKVStore
from cometbft_tpu_torch.libs.clist import CList as TCList
from cometbft_tpu_torch.mempool import CListMempool as TMempool
from cometbft_tpu_torch.mempool import LRUTxCache as TLRU
from cometbft_tpu_torch.mempool import TxKey as TTxKey

SEED = 15


# -- CList -----------------------------------------------------------------


def _clist_trace(cls, ops):
    """Apply ``ops`` to a fresh ``cls`` list; the values front to back,
    back to front and the length after each op."""
    cl = cls()
    els = []
    trace = []
    for op, arg in ops:
        if op == "push":
            els.append(cl.push_back(arg))
        elif els:
            el = els.pop(arg % len(els))
            trace.append(("removed", cl.remove(el), el.removed))
        fwd, el = [], cl.front()
        while el is not None:
            fwd.append(el.value)
            el = el.next()
        back, el = [], cl.back()
        while el is not None:
            back.append(el.value)
            el = el.prev()
        trace.append((len(cl), fwd, back, [e.value for e in cl]))
    return trace


def test_clist_semantics_equal_the_reference():
    rng = random.Random(SEED)
    ops = [("push", rng.randrange(1000)) if rng.random() < 0.6
           else ("remove", rng.randrange(1000)) for _ in range(300)]
    assert _clist_trace(TCList, ops) == _clist_trace(RCList, ops)


def test_clist_wait_and_limit():
    for cls in (RCList, TCList):
        cl = cls(max_length=2)
        assert cl.front_wait(timeout=0.01) is None
        a = cl.push_back("a")
        assert cl.front_wait(timeout=0.01) is a
        assert a.next_wait(timeout=0.01) is None
        b = cl.push_back("b")
        assert a.next_wait(timeout=0.01) is b
        with pytest.raises(Exception):
            cl.push_back("c")
        cl.remove(a)
        assert a.removed and cl.front() is b


# -- the mempool -----------------------------------------------------------


def _pools(size=None, cache_size=None, max_tx_bytes=None, recheck=True,
           keep_invalid=False):
    out = []
    for cfgmod, client_cls, app_cls, pool_cls, kw in (
            (rconfig, RLocalClient, RKVStore, RMempool, {}),
            (tconfig, TLocalClient, TKVStore, TMempool, {"device": "cpu"})):
        cfg = cfgmod.MempoolConfig(recheck=recheck,
                                   keep_invalid_txs_in_cache=keep_invalid)
        if size is not None:
            cfg.size = size
        if cache_size is not None:
            cfg.cache_size = cache_size
        if max_tx_bytes is not None:
            cfg.max_tx_bytes = max_tx_bytes
        app = app_cls()
        client = client_cls(app)
        client.start()
        out.append((pool_cls(cfg, client, **kw), app, client))
    return out


def _seeded_txs(n, rng):
    """Valid kvstore txs, duplicates, malformed ones and oversized ones,
    shuffled."""
    txs = []
    for i in range(n):
        r = rng.random()
        if r < 0.55:
            txs.append(b"k%03d=%s" % (i, bytes(rng.randrange(97, 123)
                                               for _ in range(rng.randrange(
                                                   1, 40)))))
        elif r < 0.7 and txs:
            txs.append(rng.choice(txs))  # a duplicate
        elif r < 0.85:
            txs.append(b"no-equals-sign-%d" % i)  # the kvstore rejects it
        else:
            txs.append(b"big%d=" % i + b"x" * rng.randrange(200, 400))
    return txs


def _check_all(pool, txs):
    """(outcome, key) of each tx through check_tx: "ok" or the exception's
    class name and message."""
    out = []
    for tx in txs:
        try:
            pool.check_tx(tx, sender="peer%d" % (len(tx) % 3))
            outcome = "ok"
        except Exception as e:  # noqa: BLE001 - compared across packages
            outcome = (type(e).__name__, str(e))
        out.append((outcome, pool.size(), pool.size_bytes()))
    return out


def _state(pool):
    return ([el.value.tx for el in pool.txs],
            sorted((k, sorted(el.value.senders)) for k, el in
                   pool.tx_map.items()),
            pool.size_bytes(), pool.height)


def test_check_tx_outcomes_keys_and_reaps_equal_the_reference():
    rng = random.Random(SEED)
    txs = _seeded_txs(160, rng)
    (rp, _, rc), (tp, _, tc) = _pools(size=60, max_tx_bytes=300)
    try:
        assert [TTxKey(tx) for tx in txs] == [RTxKey(tx) for tx in txs]
        assert _check_all(tp, txs) == _check_all(rp, txs)
        assert tp.size() == 60  # the full mempool refused the rest
        assert _state(tp) == _state(rp)
        for max_bytes, max_gas in ((-1, -1), (0, -1), (500, -1), (-1, 7),
                                   (1_000, 20), (10_000, -1)):
            assert (tp.reap_max_bytes_max_gas(max_bytes, max_gas)
                    == rp.reap_max_bytes_max_gas(max_bytes, max_gas))
        for n in (-1, 0, 1, 13, 60, 100):
            assert tp.reap_max_txs(n) == rp.reap_max_txs(n)
        assert tp.is_full(1) is not None and rp.is_full(1) is not None
    finally:
        rc.stop()
        tc.stop()


@pytest.mark.parametrize("recheck,keep_invalid", [(True, False),
                                                 (False, True)])
def test_update_with_recheck_equals_the_reference(recheck, keep_invalid):
    """A block commits some pending txs (one of them failed in the app),
    and the rest are rechecked against an app whose CheckTx now refuses
    one of them."""
    rng = random.Random(SEED + 1)
    txs = [b"u%02d=%d" % (i, rng.randrange(10**6)) for i in range(24)]
    pools = _pools(recheck=recheck, keep_invalid=keep_invalid)
    try:
        for pool, app, _ in pools:
            for tx in txs:
                pool.check_tx(tx)
        committed = txs[:8] + [b"never=seen"]
        outs = []
        for (pool, app, _), abci in zip(pools, (rabci, tabci)):
            real = app.check_tx

            def refuse(req, real=real, abci=abci):
                if req.tx == txs[10]:
                    return abci.ResponseCheckTx(code=3, log="now invalid")
                return real(req)
            app.check_tx = refuse
            results = [abci.ExecTxResult(code=0 if i != 3 else 5)
                       for i in range(len(committed))]
            pool.lock()
            try:
                pool.update(1, committed, results)
            finally:
                pool.unlock()
            again = []
            for tx in (txs[3], txs[4], txs[10], b"never=seen"):
                try:
                    pool.check_tx(tx)
                    again.append("ok")
                except Exception as e:  # noqa: BLE001
                    again.append(type(e).__name__)
            outs.append((_state(pool), again, pool.reap_max_txs(-1)))
        assert outs[1] == outs[0]
    finally:
        for _, _, client in pools:
            client.stop()


def test_lru_cache_eviction_equals_the_reference():
    rng = random.Random(SEED + 2)
    caches = (RLRU(16), TLRU(16))
    trace = ([], [])
    for _ in range(400):
        key = b"%d" % rng.randrange(40)
        op = rng.random()
        for cache, out in zip(caches, trace):
            if op < 0.6:
                out.append(cache.push(key))
            elif op < 0.8:
                cache.remove(key)
                out.append(None)
            else:
                out.append(cache.has(key))
    assert trace[1] == trace[0]
    assert list(caches[1]._map) == list(caches[0]._map)


def test_a_small_cache_lets_an_evicted_tx_back_in_as_the_reference():
    """With a 4-key cache, a tx whose key was evicted is admitted again
    once it left the pool; one still cached is refused."""
    outs = []
    for (pool, _, client), abci in zip(_pools(cache_size=4),
                                       (rabci, tabci)):
        try:
            seen = _check_all(pool, [b"e%d=1" % i for i in range(6)])
            pool.lock()
            pool.update(1, [b"e0=1"], [abci.ExecTxResult(code=0)])
            pool.unlock()
            seen += _check_all(pool, [b"e0=1", b"e5=1", b"e1=1"])
            outs.append((seen, _state(pool)))
        finally:
            client.stop()
    assert outs[1] == outs[0]


def test_flush_and_txs_available_as_the_reference():
    outs = []
    for pool, _, client in _pools():
        try:
            pool.enable_txs_available()
            before = pool.txs_available().is_set()
            pool.check_tx(b"f=1")
            after = pool.txs_available().is_set()
            pool.flush()
            outs.append((before, after, _state(pool)))
            pool.check_tx(b"f=1")  # the flushed cache admits it again
            outs.append(_state(pool))
        finally:
            client.stop()
    assert outs[2:] == outs[:2]


def test_mempool_defaults_to_cuda_and_raises_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    client = TLocalClient(TKVStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        TMempool(tconfig.MempoolConfig(), client)
