"""Import boundary and device discipline of the PyTorch/CUDA port.

* No file of cometbft_tpu_torch/, and not chip_smoke.py, imports jax or
  the JAX package cometbft_tpu (the exact package: cometbft_tpu_torch is
  the port itself), nor names a path into the JAX package: the native
  host engine is built from the port's own copy.
* Entry points default to the GPU and raise without one: they never run
  on the CPU unless asked.
* On CPU tensors the kernel wrappers (and the hash plane on the CPU) take
  the plain path and leave their launch counters at 0; on bad inputs they
  raise.
"""

import ast
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import coalesce, hashplane
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.ops import cuda_sha256, cuda_verify
from cometbft_tpu_torch.ops import sha256 as tsha
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import validation as tvalidation
from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "cometbft_tpu"}


def _port_files():
    files = sorted((ROOT / "cometbft_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    # the sr25519, secp256k1, mixed-set and RLC modules are scanned too
    for rel in ("crypto/sr25519.py", "crypto/secp256k1.py",
                "crypto/host_batch.py", "crypto/batch.py", "crypto/keys.py",
                "crypto/__init__.py", "ops/verify.py", "convert.py",
                "ops/rlc.py", "ops/cuda_rlc.py", "libs/sync.py",
                "libs/lockprof.py", "libs/devledger.py", "libs/health.py",
                "libs/pprof.py", "libs/service.py", "libs/devstats.py",
                "crypto/plane.py"):
        assert ROOT / "cometbft_tpu_torch" / rel in files, rel
    bad = {
        f"{f.relative_to(ROOT)}: {mod}"
        for f in files
        for mod in _imported_roots(f)
        if mod in FORBIDDEN
    }
    assert not bad, sorted(bad)


def test_lock_registries_are_read_from_the_ports_own_copy():
    """libs/lockprof and libs/sync read lockorder.json and
    fieldguards.json from cometbft_tpu_torch/devtools/lint/graph, copies
    of the JAX package's files byte for byte."""
    from cometbft_tpu_torch.libs import lockprof, sync

    graph = ROOT / "cometbft_tpu_torch" / "devtools" / "lint" / "graph"
    ref = ROOT / "cometbft_tpu" / "devtools" / "lint" / "graph"
    paths = {"lockorder.json": {lockprof._registry_path(),
                                sync._static_graph_path()},
             "fieldguards.json": {sync._fieldguards_path()}}
    for name, read in paths.items():
        assert {Path(p).resolve() for p in read} == {graph / name}, name
        assert (graph / name).read_bytes() == (ref / name).read_bytes()
    assert len(lockprof.NAMES) > 60 and sync._load_field_guards()


def _path_literals(path: Path):
    """String constants of a file that could name a path into the JAX
    package: the bare package name as a path segment, or a path through
    cometbft_tpu/."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            if v == "cometbft_tpu" or v.startswith(("cometbft_tpu/",
                                                    "cometbft_tpu\\")):
                yield v


def test_port_names_no_path_into_the_reference_package():
    """Docstrings may cite the reference's files; code may not open one.
    The host engine compiles from cometbft_tpu_torch/native/."""
    from cometbft_tpu_torch.crypto import host_batch

    bad = {
        f"{f.relative_to(ROOT)}: {v!r}"
        for f in _port_files()
        for v in _path_literals(f)
        if not v.startswith("cometbft_tpu/ops/")  # chip_smoke's "replaces"
        or f.name != "chip_smoke.py"
    }
    assert not bad, sorted(bad)
    assert host_batch.SRC == ROOT / "cometbft_tpu_torch" / "native" / (
        "edbatch.cpp")


def test_port_reads_no_sr25519_host_escape_and_needs_no_crypto_wheel():
    """The reference's COMETBFT_TPU_SR_HOST sends every sr25519 batch to
    the host, and without the cryptography wheel its secp256k1 keys
    verify every signature False. The port reads no such variable, and
    its secp256k1 module imports nothing outside the standard library and
    the package."""
    assert not [str(f.relative_to(ROOT)) for f in _port_files()
                if "COMETBFT_TPU_SR_HOST" in f.read_text()]
    secp = ROOT / "cometbft_tpu_torch" / "crypto" / "secp256k1.py"
    assert set(_imported_roots(secp)) <= {"__future__", "hashlib", "hmac",
                                          "dataclasses", ""}


def test_import_scan_catches_the_reference_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import cometbft_tpu_torch\nfrom cometbft_tpu.ops import curve\n"
        "import jax.numpy as jnp\n"
    )
    assert set(_imported_roots(probe)) == {
        "cometbft_tpu_torch", "cometbft_tpu", "jax"
    }
    probe.write_text('SRC = Path("cometbft_tpu/native/edbatch.cpp")\n'
                     'ROOT = Path(x) / "cometbft_tpu" / "native"\n')
    assert list(_path_literals(probe)) == [
        "cometbft_tpu/native/edbatch.cpp", "cometbft_tpu"]


def _one_signature():
    seed = bytes(range(32))
    msg = b"default-device probe"
    return [ref.pubkey_from_seed(seed)], [msg], [ref.sign(seed, msg)]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    pks, msgs, sigs = _one_signature()
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.verify_batch(pks, msgs, sigs)
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.PubkeyTableCache()
    buf, _ = tverify.pack_bytes(pks, msgs, sigs)
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.verify_bytes_async(buf, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.verify_batch(pks, msgs, sigs, flavor="8")
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.verify_bytes_async(buf, 1, flavor="8")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsha.sha256_many_async([b"default-device probe"])
    with pytest.raises(RuntimeError, match="CUDA"):
        hashplane.HashCoalescer()
    with pytest.raises(RuntimeError, match="CUDA"):
        coalesce.VerifyCoalescer()
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.LaneArena()


def test_sr25519_and_mixed_entry_points_default_to_cuda():
    """Sr25519BatchVerifier, MixedBatchVerifier and verify_prepacked
    default to the GPU and raise without one, below the cut as at it;
    with device="cpu" the same lanes verify."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from cometbft_tpu_torch.crypto import batch as tbatch
    from cometbft_tpu_torch.crypto import sr25519 as tsr

    mini = bytes(range(32))
    pk = tsr.Sr25519PubKey(tsr.public_from_mini(mini))
    sig = tsr.sign(mini, b"default-device probe")
    for cls in (tbatch.Sr25519BatchVerifier, tbatch.MixedBatchVerifier):
        bv = cls()
        assert bv.device == "cuda"
        bv.add(pk, b"default-device probe", sig)
        with pytest.raises(RuntimeError, match="CUDA"):
            bv.verify()
        on_cpu = cls(device="cpu")
        on_cpu.add(pk, b"default-device probe", sig)
        assert on_cpu.verify() == (True, [True])
    quad = tsr.verification_encs_batch([pk.data], [b"default-device probe"],
                                       [sig])
    buf, _ = tverify.pack_parts(quad)
    with pytest.raises(RuntimeError, match="CUDA"):
        tverify.verify_prepacked(buf, [quad[0][0]], 1)


def _light_block(n_vals=2):
    """A height-1 light block signed by ``n_vals`` seeded validators."""
    seeds = [bytes([7 + i]) * 32 for i in range(n_vals)]
    vals = ValidatorSet([
        Validator(Ed25519PubKey(ref.pubkey_from_seed(s)), 10) for s in seeds
    ])
    by_addr = {Ed25519PubKey(ref.pubkey_from_seed(s)).address(): s
               for s in seeds}
    header = tblock.Header(
        version=tblock.Version(11, 1), chain_id="probe-chain", height=1,
        time_ns=1_700_000_000_000_000_000,
        last_block_id=tblock.BlockID(), last_commit_hash=b"", data_hash=b"",
        validators_hash=vals.hash(), next_validators_hash=vals.hash(),
        consensus_hash=b"", app_hash=b"", last_results_hash=b"",
        evidence_hash=b"", proposer_address=vals.validators[0].address,
    )
    bid = tblock.BlockID(header.hash(), tblock.PartSetHeader(1, bytes(32)))
    commit = tblock.Commit(1, 0, bid, [
        tblock.CommitSig(tblock.BLOCK_ID_FLAG_COMMIT, v.address,
                         header.time_ns + i)
        for i, v in enumerate(vals.validators)
    ])
    commit.signatures = [
        tblock.CommitSig(cs.block_id_flag, cs.validator_address,
                         cs.timestamp_ns,
                         ref.sign(by_addr[cs.validator_address],
                                  commit.vote_sign_bytes("probe-chain", i)))
        for i, cs in enumerate(commit.signatures)
    ]
    return LightBlock(SignedHeader(header, commit), vals)


class _OneBlock(tlight.Provider):
    def __init__(self, lb):
        self.lb = lb

    def chain_id(self):
        return "probe-chain"

    def light_block(self, height):
        return self.lb


def test_light_entry_points_default_to_cuda():
    """light.Client and CommitVerifier default to the GPU: without one the
    first commit check raises; with device="cpu" the same block passes."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    lb = _light_block()
    commit, vals = lb.signed_header.commit, lb.validator_set
    cv = tlight.CommitVerifier()
    assert cv.device == "cuda" and cv.flavor is None
    with pytest.raises(RuntimeError, match="CUDA"):
        cv.verify_commit_light("probe-chain", vals, commit.block_id, 1,
                               commit)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvalidation.verify_commit_light_trusting("probe-chain", vals, commit)
    opts = tlight.TrustOptions(3600 * 10**9, 1, lb.hash())
    with pytest.raises(RuntimeError, match="CUDA"):
        tlight.Client("probe-chain", opts, _OneBlock(lb))
    client = tlight.Client("probe-chain", opts, _OneBlock(lb),
                           commit_verifier=tlight.CommitVerifier(
                               device="cpu", flavor="8"))
    assert client.last_trusted_height() == 1


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    cuda_verify.reset_launches()
    pks, msgs, sigs = _one_signature()
    buf, _ = tverify.pack_bytes(pks, msgs, sigs)
    arrays = tverify.unpack_on_device(torch.from_numpy(buf))
    assert cuda_verify.verify_kernel(**arrays).tolist() == [True]
    table, ok = cuda_verify.build_pubkey_tables(
        arrays["y_a"], arrays["sign_a"]
    )
    rsk = {k: arrays[k] for k in ("y_r", "sign_r", "s_nibs", "kneg_nibs")}
    slot = torch.zeros(1, dtype=torch.int16)
    assert cuda_verify.verify_kernel_cached(
        table, ok, **rsk, idxs=slot
    ).tolist() == [True]
    arrays8 = tverify.unpack_on_device(torch.from_numpy(buf), "8")
    assert cuda_verify.verify_kernel8(**arrays8).tolist() == [True]
    rsk8 = {k: arrays8[k] for k in ("y_r", "sign_r", "s_bytes", "kneg_nibs")}
    assert cuda_verify.verify_kernel8_cached(
        table, ok, **rsk8, idxs=slot
    ).tolist() == [True]
    assert cuda_verify.LAUNCHES == {
        "verify_kernel": 0, "verify_kernel_cached": 0,
        "build_pubkey_tables": 0, "verify_kernel8": 0,
        "verify_kernel8_cached": 0,
    }
    assert not any(cuda_verify.LAUNCH_LANES.values())


def test_cpu_hash_path_runs_plain_and_counts_nothing():
    """sha256_many_async and a HashCoalescer on the CPU run X4's plain
    version: right digests, no launch, no transfer counted."""
    cuda_sha256.reset_launches()
    msgs = [b"", b"a" * 55, b"b" * 56, b"c" * 1500]
    want = [hashlib.sha256(m).digest() for m in msgs]
    assert tsha.sha256_many_async(msgs, device="cpu")() == want
    co = hashplane.HashCoalescer(device="cpu", min_device_lanes=1)
    co.start()
    try:
        assert co.submit(msgs).result(timeout=30) == want
        assert co.device_windows == 1 and co.device_lanes == len(msgs)
    finally:
        co.stop()
    assert cuda_sha256.LAUNCHES == {"sha256": 0}
    assert not cuda_sha256.LAUNCH_SHAPES["sha256"]
    assert cuda_sha256.TRANSFERS == {"h2d_bytes": 0, "d2h_bytes": 0}


def test_sha256_wrapper_rejects_bad_inputs():
    blocks = torch.zeros((2, 16, 8), dtype=torch.uint32)
    counts = torch.zeros(8, dtype=torch.uint16)
    with pytest.raises(TypeError, match="blocks: dtype"):
        cuda_sha256.sha256(blocks.to(torch.int64), counts)
    with pytest.raises(ValueError, match="blocks: shape"):
        cuda_sha256.sha256(blocks[:, :8], counts)
    with pytest.raises(TypeError, match="nblocks: dtype"):
        cuda_sha256.sha256(blocks, counts.to(torch.int32))
    with pytest.raises(ValueError, match="nblocks: shape"):
        cuda_sha256.sha256(blocks, counts[:4])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sha256.sha256(blocks.transpose(0, 1).contiguous()
                           .transpose(0, 1), counts)
    assert cuda_sha256.LAUNCHES["sha256"] == 0


def test_wrappers_reject_bad_inputs():
    y = torch.zeros((20, 4), dtype=torch.int32)
    s = torch.zeros(4, dtype=torch.int32)
    nib = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        cuda_verify.verify_kernel(y.to(torch.int64), s, y, s, nib, nib)
    with pytest.raises(ValueError, match="shape"):
        cuda_verify.verify_kernel(y, s, y[:, :3], s, nib, nib)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_verify.build_pubkey_tables(
            torch.zeros((4, 20), dtype=torch.int32).T, s
        )
    table = torch.zeros((16, 4, 20, 9), dtype=torch.int32)
    with pytest.raises(TypeError, match="idxs"):
        cuda_verify.verify_kernel_cached(
            table, torch.zeros(9, dtype=torch.bool), y, s, nib, nib,
            idxs=torch.zeros(4, dtype=torch.int32),
        )
    assert cuda_verify.LAUNCHES["verify_kernel"] == 0
    # the 8-bit wrappers take S as (32, N) bytes, not (64, N) nibbles
    sb = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="s_bytes"):
        cuda_verify.verify_kernel8(y, s, y, s, nib, nib)
    with pytest.raises(TypeError, match="s_bytes"):
        cuda_verify.verify_kernel8(y, s, y, s, sb.to(torch.uint8), nib)
    with pytest.raises(ValueError, match="arena"):
        cuda_verify.verify_kernel8_cached(
            table[:, :3], torch.zeros(9, dtype=torch.bool), y, s, sb, nib,
            idxs=torch.zeros(4, dtype=torch.int16),
        )
    assert cuda_verify.LAUNCHES["verify_kernel8"] == 0


def test_cache_rejects_oversized_arena_and_mismatched_device():
    with pytest.raises(ValueError, match="uint16"):
        tverify.PubkeyTableCache(device="cpu", capacity=1 << 16)
    cache = tverify.PubkeyTableCache(device="cpu", capacity=4)
    with pytest.raises(ValueError, match="arena"):
        cache.load({}, torch.zeros((16, 4, 20, 3), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.bool))
    # five distinct keys cannot fit four slots: the caller runs uncached
    assert cache.lookup([bytes([i]) * 32 for i in range(5)]) is None
    assert np.array_equal(cache.arena()[1].numpy(), np.zeros(5, bool))


def test_rlc_entry_points_default_to_cuda_and_the_wrapper_checks():
    """verify_batch_rlc and check_equation default to the GPU and raise
    without one; X5's wrapper refuses bad launch inputs before any launch
    and on the CPU runs the plain version, counting nothing."""
    from cometbft_tpu_torch.ops import cuda_rlc, rlc

    pks, msgs, sigs = _one_signature()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rlc.verify_batch_rlc(pks, msgs, sigs)
        with pytest.raises(RuntimeError, match="CUDA"):
            rlc.check_equation([], [], [], [], 0)
    assert rlc.verify_batch_rlc(pks, msgs, sigs, device="cpu")[0]
    inp = rlc.to_device(rlc.launch_inputs([], [], [], [], 0), "cpu")
    bad_y = dict(inp, y_a=inp["y_a"].to(torch.int64))
    with pytest.raises(TypeError, match="y_a: dtype"):
        cuda_rlc.rlc_equation(**bad_y)
    with pytest.raises(ValueError, match="plan_r.starts: shape"):
        plan = list(inp["plan_r"])
        plan[2] = plan[2][:, :4].contiguous()
        cuda_rlc.rlc_equation(**dict(inp, plan_r=tuple(plan)))
    with pytest.raises(ValueError, match="c_a"):
        cuda_rlc.rlc_equation(**dict(inp, c_a=13))
    with pytest.raises(ValueError, match="power of two"):
        cuda_rlc.rlc_equation(**dict(inp, y_r=inp["y_r"][:, :6]))
    with pytest.raises(ValueError, match="b_bytes: shape"):
        cuda_rlc.rlc_equation(**dict(inp, b_bytes=inp["b_bytes"][:16]))
    assert bool(cuda_rlc.rlc_equation(**inp))
    assert cuda_rlc.LAUNCHES == {"rlc": 0}
    assert not cuda_rlc.LAUNCH_SHAPES["rlc"]


EXECUTION_LAYER = ("libs/jsoncodec.py", "libs/fail.py", "libs/db.py",
                   "libs/pubsub.py", "types/params.py", "types/genesis.py",
                   "types/priv_validator.py", "types/serialization.py",
                   "types/event_bus.py", "types/evidence.py",
                   "abci/__init__.py", "abci/types.py",
                   "abci/application.py", "abci/codec.py", "abci/kvstore.py",
                   "abci/client.py", "proxy.py", "store/__init__.py",
                   "store/block_store.py", "state/__init__.py",
                   "state/state.py", "state/store.py", "state/validation.py",
                   "state/execution.py")


@pytest.mark.parametrize("rel", EXECUTION_LAYER)
def test_execution_layer_module_is_scanned_and_clean(rel):
    """Each module of the block-execution and storage layer sits at its
    reference path, is in the scan, and imports no jax and nothing of the
    JAX package (not even its pure-Python jsoncodec, db or abci types)."""
    path = ROOT / "cometbft_tpu_torch" / rel
    assert (ROOT / "cometbft_tpu" / rel).exists(), rel
    assert path in _port_files()
    assert not set(_imported_roots(path)) & FORBIDDEN, rel
    assert not list(_path_literals(path)), rel


def _exec_chain():
    """A two-validator genesis state, its state store, the app's proxy
    connections and the first block a CPU executor proposes."""
    from cometbft_tpu_torch import proxy
    from cometbft_tpu_torch import state as tstate
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.types import GenesisDoc, GenesisValidator

    pubs = [Ed25519PubKey(ref.pubkey_from_seed(bytes([i]) * 32))
            for i in (1, 2)]
    state = tstate.make_genesis_state(GenesisDoc(
        chain_id="probe-chain", genesis_time_ns=1,
        validators=[GenesisValidator(p, 10) for p in pubs]))
    conns = proxy.AppConns(proxy.local_client_creator(KVStoreApplication()))
    conns.start()
    store = tstate.Store(MemDB())
    exe = tstate.BlockExecutor(store, conns.consensus, device="cpu")
    blk = exe.create_proposal_block(1, state, None,
                                    state.validators.get_proposer().address,
                                    time_ns=2)
    return state, store, conns, blk


def test_execution_entry_points_default_to_cuda():
    """validate_block and BlockExecutor default to the GPU and raise
    without one, whatever the commit's size (a first block has none);
    with device="cpu" the same block validates and applies."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from cometbft_tpu_torch import state as tstate
    from cometbft_tpu_torch.types import BlockID, PartSetHeader

    state, store, conns, blk = _exec_chain()
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.validate_block(state, blk)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.BlockExecutor(store, conns.consensus)
    tstate.validate_block(state, blk, device="cpu")
    exe = tstate.BlockExecutor(store, conns.consensus, device="cpu")
    assert exe.device == "cpu"
    new = exe.apply_block(state, BlockID(blk.hash(), PartSetHeader(
        1, bytes(32))), blk)
    assert new.last_block_height == 1


def test_remote_abci_creators_raise_until_ported():
    """The socket and gRPC ABCI clients come with the p2p/RPC slice:
    asking for them raises instead of connecting."""
    from cometbft_tpu_torch import proxy

    with pytest.raises(NotImplementedError, match="socket"):
        proxy.socket_client_creator("tcp://127.0.0.1:26658")
    with pytest.raises(NotImplementedError, match="gRPC"):
        proxy.grpc_client_creator("tcp://127.0.0.1:26658")


ENGINE_LAYER = ("config.py", "libs/clist.py", "libs/events.py",
                "libs/autofile.py", "mempool/__init__.py", "mempool/cache.py",
                "mempool/clist_mempool.py", "evidence/__init__.py",
                "evidence/verify.py", "evidence/pool.py", "state/rollback.py",
                "consensus/__init__.py", "consensus/round_state.py",
                "consensus/messages.py", "consensus/height_vote_set.py",
                "consensus/ticker.py", "consensus/wal.py",
                "consensus/replay.py", "consensus/state.py",
                "consensus/pipeline.py")


@pytest.mark.parametrize("rel", ENGINE_LAYER)
def test_engine_layer_module_is_scanned_and_clean(rel):
    """Each module of the consensus engine, its mempool and evidence pool
    sits at its reference path, is in the scan, imports no jax and nothing
    of the JAX package, and reaches for none of the sensors that come with
    a later slice (libs/txtrace, libs/netstats)."""
    path = ROOT / "cometbft_tpu_torch" / rel
    assert (ROOT / "cometbft_tpu" / rel).exists(), rel
    assert path in _port_files()
    assert not set(_imported_roots(path)) & FORBIDDEN, rel
    assert not list(_path_literals(path)), rel
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
    assert not names & {"txtrace", "netstats"}, rel


def test_env_knobs_list_exactly_the_knobs_the_port_reads():
    """config.ENV_KNOBS names each COMETBFT_TPU_* variable that the port's
    code names as a constant (each env read), and no other."""
    import re

    from cometbft_tpu_torch import config as tconfig

    read = set()
    for f in _port_files():
        if f == ROOT / "cometbft_tpu_torch" / "config.py" or \
                f.name == "chip_smoke.py":
            continue
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and re.fullmatch(
                        r"COMETBFT_TPU_[A-Z0-9_]+", node.value):
                read.add(node.value)
    assert read == set(tconfig.ENV_KNOBS)
    assert "COMETBFT_TPU_SR_HOST" not in tconfig.ENV_KNOBS


def test_engine_entry_points_default_to_cuda():
    """ConsensusState, CListMempool, EvidencePool and CommitPipeline
    default to the GPU and raise without one before doing anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from cometbft_tpu_torch.consensus import ConsensusState
    from cometbft_tpu_torch.consensus.pipeline import CommitPipeline
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.mempool import CListMempool

    for make in (lambda: ConsensusState(None, None, None, None),
                 lambda: CListMempool(None, None),
                 lambda: EvidencePool(None, None, None),
                 lambda: CommitPipeline(None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("name", ["_consts", "_base_table8_26"])
def test_kernel_constants_are_one_kept_copy_under_racing_first_calls(
        monkeypatch, name):
    """The wrappers hand K1-K4, X1 and X5 their constants by pointer, so
    each device's copy must be one tensor kept for the process, also when
    the first calls race: a racing call's own copy, dropped after the
    launch was queued, freed memory that another thread's next tensor on
    the same stream could take and overwrite before the kernel read it
    (on the H100, X1's tables then differed from its plain version's in
    4,721 words when four nodes' prestage threads first built their sets
    at once)."""
    import threading
    import time as _time

    from cometbft_tpu_torch.ops import cuda_verify, curve

    if name == "_consts":
        real = curve.kernel_consts

        def slow():
            _time.sleep(0.05)
            return real()
        monkeypatch.setattr(curve, "kernel_consts", slow)
    else:
        def slow(device):
            _time.sleep(0.05)
            return torch.zeros(4, dtype=torch.int32, device=device)
        monkeypatch.setattr(cuda_verify, "_make_base_table8_26", slow)
    monkeypatch.setattr(cuda_verify, "_CONSTS", {})
    dev = torch.device("cpu")
    fn = getattr(cuda_verify, name)
    barrier = threading.Barrier(8)
    got = []

    def first():
        barrier.wait()
        got.append(fn(dev))
    threads = [threading.Thread(target=first) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and len({id(t) for t in got}) == 1
    assert fn(dev) is got[0]


NETWORK_LAYER = ("libs/flowrate.py", "libs/netstats.py", "crypto/x25519.py",
                 "crypto/aead.py", "p2p/__init__.py", "p2p/key.py",
                 "p2p/node_info.py", "p2p/base_reactor.py", "p2p/peer.py",
                 "p2p/switch.py", "p2p/transport.py",
                 "p2p/conn/__init__.py", "p2p/conn/connection.py",
                 "p2p/conn/secret_connection.py", "mempool/reactor.py",
                 "evidence/reactor.py", "consensus/reactor.py",
                 "blocksync/__init__.py", "blocksync/messages.py",
                 "blocksync/pool.py", "blocksync/reactor.py")


@pytest.mark.parametrize("rel", NETWORK_LAYER)
def test_network_layer_module_is_scanned_and_clean(rel):
    """Each module of p2p/ and the reactors sits at its reference path,
    is in the scan, imports no jax and nothing of the JAX package, and
    reaches for no libs/txtrace (its hooks come with that module)."""
    path = ROOT / "cometbft_tpu_torch" / rel
    assert (ROOT / "cometbft_tpu" / rel).exists(), rel
    assert path in _port_files()
    assert not set(_imported_roots(path)) & FORBIDDEN, rel
    assert not list(_path_literals(path)), rel
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
    assert "txtrace" not in names, rel


def test_network_layer_knobs_are_registered_and_pex_waits():
    """libs/netstats' three knobs are in config.ENV_KNOBS; pex/, fuzz.py
    and suspicion.py come with the node; the native frame cipher builds
    from the port's own source."""
    from cometbft_tpu_torch import config as tconfig
    from cometbft_tpu_torch.crypto import aead

    assert {"COMETBFT_TPU_NET", "COMETBFT_TPU_NET_STAMP",
            "COMETBFT_TPU_NET_TOPK"} <= set(tconfig.ENV_KNOBS)
    p2p = ROOT / "cometbft_tpu_torch" / "p2p"
    assert not (p2p / "pex").exists()
    assert not (p2p / "fuzz.py").exists()
    assert not (p2p / "suspicion.py").exists()
    assert aead.NATIVE_SRC == ROOT / "cometbft_tpu_torch" / "native" / (
        "chacha20poly1305.cpp")


def test_blocksync_reactor_defaults_to_cuda():
    """BlocksyncReactor resolves its device at construction: without a GPU
    the default raises before anything is built."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    from cometbft_tpu_torch.blocksync import BlocksyncReactor

    store = type("S", (), {"height": lambda self: 0})()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlocksyncReactor(None, None, store, True)
    assert BlocksyncReactor(None, None, store, True,
                            device="cpu").device == "cpu"
