#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases,
each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch's view,
             and whether hashlib has RIPEMD-160 (secp256k1 addresses
             otherwise use the package's own).
2. build   — parallel nvcc builds of cometbft_tpu_torch/ops/csrc/*.cu,
             registers and spills per kernel (-Xptxas -v).
3. kernels — K1, K2, X1, K3 and K4 against their plain PyTorch versions on
             the card, on 4,096 seeded lanes, a ragged 1,000, and the main
             paths' 10,000, 6,667 and 3,334 (the lanes tiled), valid lanes
             mixed with ZIP-215 edge lanes on A and on R (non-canonical
             y = p + k, negative zero); K2 and K4 read a pubkey arena of the
             cache's 16,385 slots. Verdicts must be bit-identical (tables
             limb for limb), the 8-bit kernels' equal to the 4-bit ones',
             and a sample must agree with the ed25519 oracle. The ZIP-215
             conformance classes (zip215_corpus) go through K1-K4 against
             their expected verdicts: the A-side classes (y = p + k,
             negative zero, small-order and off-curve A) decode inside
             K1 and K3 only, the R-side ones in all four; X1's tables and
             ok bits on them equal its plain version's. X1 is also
             compared at every lane count the light path launches it at
             (X1_LIGHT_LANES), and K1 at every count the mesh path
             launches it at (K1_MESH_LANES: 8,192, 16,384 and 65,536,
             edge verdicts and an oracle sample too; 4,096 is above),
             then timed there. Then K1-K4 are timed at 3,334, 6,667 and
             10,000 lanes and X1 at each count its paths launch it at
             (CUDA events around 10 back-to-back launches, median of 5
             after a warm-up) beside the bound, X1 also beside its chain
             bound (its SASS's dependent depths, clock_probe's latency
             and clock), the plain versions at 10,000, and at each size
             K1/K3, K2/K4, K1/K2 and K3/K4 once more in turns
             (kernels.ab).
4. slice   — a seeded 10,000-validator ed25519 set with equal power signs a
             precommit Commit; verify_commit runs with the pubkey cache off
             (COMETBFT_TPU_PUBKEY_CACHE=0: K1), then prestage_validators
             warms the card's process-wide cache (X1) and a default-argument
             verify_commit must run K2 and neither X1 nor K1; then with a
             cache of its own cold and warm (X1, then K2), verify_commit_light
             runs warm, and a tampered signature must raise naming its index.
             Every kernel's launch counter must rise in this phase. Then one
             warm call's steps are timed on their own (slice.breakdown), and
             one warm call runs under torch.profiler for the card's idle
             share (slice.trace). This path runs the 4-bit flavor.
5. light   — a light-client replay over 10,000-validator sets in the 8-bit
             flavor: four seeded key groups A-D of 5,000 (power 100 each);
             the trusted block 1000 has A+B, the provider serves 1009 (B+C,
             whose next set is C+D) and 1010 (C+D). light.Client (trust
             level 1/3) runs verify_light_block_at_height(1010): 1000 ->
             1010 cannot be trusted (none of 1000's validators signed), the
             pivot 1009 passes verify_non_adjacent, 1009 -> 1010 passes
             verify_adjacent. The replay runs with the pubkey cache on (X1,
             K4), off (COMETBFT_TPU_PUBKEY_CACHE=0: K3), on the slice
             phase's cache (whose 10,000 other
             keys make the arena evict), and with a tampered signature in
             1010's commit, which must fail 1009 -> 1010. K3, K4 and X1 must
             each launch in this phase, K1 and K2 not at all.
6. vote    — the steady-state vote path on the slice phase's commit cell.
             First a warm default-argument verify_commit and both packers
             on its 10,000 lanes (native ops.verify.pack_bytes and the
             Python loop pack_bytes_plain, bytes equal, times printed);
             then the crossover sweep: host_batch.verify_many against one
             coalescer-shaped device window (native pack, arena lookup, K2
             through a LaneArena, readback) at 8-2,048 lanes of the
             prestaged set, in turns, RUNS each, medians and the first
             count where the card wins (crypto.batch's seed cut). Then the
             path, through pushed VerifyCoalescer(device="cuda")s: (3) the
             commit's 10,000 precommits, one tampered, each through
             Vote.verify from 64 threads, verdicts equal to
             host_batch.verify_many's and the tampered one rejected, once
             with the card's cut adapting (the default) and once held at
             its seed (which must put windows on the card), each with the
             crossover's fit before and after; (4)
             BASELINE config 3: a fresh prestaged 1,000-validator set's
             prevote and precommit rounds (one tampered vote each), each
             vote through add_vote from 50 peer threads, then the same
             votes through add_votes_batch in 50-vote chunks on a second
             set, decisions equal, 2/3 reached, and make_commit passing
             verify_commit; (5) BASELINE config 2: a 150-validator commit
             unrouted and routed, a tampered signature named alike. Each
             prints its windows on the card and on the host, windows by
             lane count and its host ms. Every K1/K2 launch of the path is
             recorded (WindowRecorder) and held against the plain version
             on its own window's lanes (the windows that share an arena
             through one plain call, each compared on its slice); K1/K2
             may launch on the path only at counts so compared. Last,
             part 3 at the seed once more under torch.profiler in a
             process of its own, for the card's idle share.
7. mixed   — BASELINE config 5: a seeded set of 2,048 ed25519 and 2,048
             sr25519 validators of equal power (the set's order of power,
             then address, interleaves them) signs precommits at four
             heights, every vote with its own sign bytes, like blocksync
             catching up four blocks. With the cut held at its seed (8):
             (1) verify_commit with the pubkey cache off, twice (K1 at
             4,096); (2) prestage_validators (X1 on the 2,048 ed25519 keys
             only), then a default-argument verify_commit (MixedBatchVerifier
             -> verify_prepacked: X1 on exactly the 2,048 converted sr25519
             keys, then K2 at 4,096), then the same call warm (K2 alone);
             (3) verify_commit_light at each height, twice (K2 at 2,731);
             (4) a tampered ed25519 signature, then an sr25519 one, each
             named as the reference names it; (5) the sr25519 half through
             Sr25519BatchVerifier, twice (K2 at 2,048); (6) a 6-lane mixed
             batch below the cut, on the host tier (no launch); (7) one
             height's 4,096 precommits through VoteSet.add_votes_batch in
             50-vote chunks. Every K1, K2 and X1 launch of the phase is
             recorded and held against its plain version on the card, and
             the device verdicts of runs 1-4 against
             host_batch.verify_quads on the same quads. Then a warm mixed
             batch's steps are timed on their own at 4,096 and 2,731
             lanes (mixed.breakdown), and one warm default-argument
             verify_commit runs under torch.profiler for the card's idle
             share (mixed.trace).
8. rlc     — the RLC batch equation (ops/rlc.py: X5, csrc/rlc.cu) on the
             slice phase's 10,000-validator set, which also signs
             precommits at heights 1001-1003: 40,000 lanes over 10,000
             keys, blocksync catch-up folded into one batch. First X5's
             check (rlc.kernels): X5 against its plain version on the
             card (the bool, every window sum and the pre-cofactor total
             as encodings), and against the native engine's MSM
             (host_batch._msm_identity) on the same points and scalars, on
             batches at buckets 8 and 16, one with an undecodable R, one
             with a tampered signature, one whose only fault is an extra
             undecodable R of scalar 0, the ZIP-215 classes as one-lane
             batches (each against its verdict; the plain version on all
             of them at once through torch.func.vmap), and both full
             widths, the z drawn from a seed. Then X5 timed at both full
             widths (rlc.time: CUDA events, its six stages, the
             throughput bound of the products the plans need and the
             chain bound, the plain version, K2 on the
             same lanes and a warm verify_batch). Then the path, through
             verify_batch_rlc (rlc.run): (1) the commit's 10,000 lanes
             and (2) the 40,000, twice each, True with X5 alone launched;
             (3) a tampered signature, (4) an undecodable R and a short
             signature, each named as ops.verify.verify_batch names it
             (its bitmaps taken before the path's counts are zeroed; K2
             attributes the first two, once each, and no other K2 launch
             is counted on the path). X5 may launch on the path
             only at (A bucket, R bucket) shapes the check compared. Last
             a warm 10,000- and 40,000-lane call step by step
             (rlc.breakdown) and one under torch.profiler (rlc.trace).
9. hash    — the SHA-256 hash plane on one seeded default block: 21 MiB
             (BlockParams.max_bytes, 22,020,096 B, 336 parts of 64 KiB) of
             10,752 txs of 2,048 B. First X4's kernels check (the lines
             kernels.x4*): X4 against hashlib on every lane and
             against its plain version on the card at the padding edges, a
             0-700 B fuzz and every (block bucket, lane bucket) the path can
             launch (buckets 1, 2 and 64 at every lane bucket 8-2,048; the
             336 part leaves at 2,048 x 512; gossip windows at 2,048 x 8);
             its SASS counted (cuobjdump), the SM clock and the dependent
             latency and issue rates of integer instructions read with
             clock64() (csrc/probes/clock_chain.cu), one warp of part
             leaves timed for the cycles a compression; then timed at the
             part leaves, a gossip window and a full tx-key window beside
             the throughput bound and the chain bound, and the leaf wire's
             pack and h2d. Then the path, each step unrouted (hashlib) and
             then with a fresh HashCoalescer(device="cuda") pushed (every
             plane shares the card's process-wide cuts, so a step's plane
             starts from what the earlier ones calibrated), results equal:
             make_block (Data.hash: tx keys and merkle levels; the slice
             commit's hash), PartSet.from_data, gossip ingress (a fresh
             PartSet takes the 336 parts through add_part from 8 threads;
             assemble() gives the bytes back; a part with a flipped byte
             raises PartSetError), and the slice phase's ValidatorSet.hash.
             Each step prints its windows on the card and on the host, its
             X4 launches by shape and the cuts at its start and end. X4
             must launch, only at shapes the check compared, and a routed
             from_data and a routed ingress on a warm plane each run under
             torch.profiler, in a process of its own, for the card's idle
             share.

10. mesh  — the multi-device verify path (parallel/mesh.py, the sharded
             branch of ops/verify.verify_batch) on the commit cell's
             10,000 lanes and the rlc phase's 40,000-lane catch-up batch,
             one lane tampered in each. A default-argument verify_batch on
             each first: on a one-card machine it must not shard (K2, no
             K1, no call to _verify_batch_sharded). Then
             _verify_batch_sharded through explicit meshes of card 0: (1,
             1), (1, 4) and (2, 2) on the commit (K1 at 16,384, 4 x 4,096,
             4 x 8,192), (1, 1) and (1, 4) on the catch-up batch (65,536, 4
             x 16,384); verdicts equal to verify_batch's, the tampered lane
             named; per run the host ms, pack_inputs' ms, K1's device ms
             by CUDA events, its launches by lanes and the h2d bytes
             (devstats). Then pack_inputs beside pack_bytes on the same
             lanes, and one warm (1, 4) run under torch.profiler in a
             process of its own for the card's idle share (mesh.trace).

11. ledger — the device-time ledger and the libs the two planes report to
             (libs/devledger, libs/health's flight recorder, libs/lockprof
             with COMETBFT_TPU_LOCKPROF=1, devstats), on from the start of
             the phase, read through a PrometheusServer and a PprofServer
             on 127.0.0.1:0. After the hash phase (whose X4 check it
             reuses). Both sets go into the card's arena first (X1 at
             1,000 and 150 lanes). (1) BASELINE config 3: a fresh
             1,000-validator set's prevote and precommit rounds, one
             tampered vote each, through add_vote from 50 threads and a
             pushed VerifyCoalescer(device="cuda") (add_vote verifies
             under the vote set's lock, so every window carries one lane:
             the coalescer's cut is held at LEDGER_CUT = 1 to put them on
             the card, K2); decisions equal host_batch.verify_many's, 2/3
             reached, make_commit passes verify_commit ("consensus-vote",
             then "commit-verify" for the direct batch); (2) BASELINE
             config 2: a 150-validator commit and a tampered one routed to
             a coalescer (the batch cut raised above the commit, the
             windows' kept at the seed: "commit-verify"); (3)
             PartSet.from_data of the hash phase's block and the 8-thread
             ingress through a pushed HashCoalescer(device="cuda")
             ("merkle"). Then, read before anything else runs: both planes
             reconcile (caller lanes = window lanes, |1 - ratio| <= 0.01);
             the ledger's device windows equal the coalescers' and the K2
             launches the coalescers made, and the hash plane's equal its
             X4 launches; the three caller rows carry every lane; the ring
             holds plane.budget rows for the verify plane and as many
             device hash.flush rows as device hash windows; /metrics
             carries the ledger's consensus-vote lanes, the coalescer's
             flushes, crypto.coalesce._mtx's hold time and the hottest
             lock's wait (lockprof's, the vote set's); every pprof
             route answers 200, an unknown one 404. Then run (1)'s
             prevote round timed with the accounting off and on in turns
             (LEDGER_TURNS each, the checked round the first "on"). Every
             K1/K2/X1 launch of the
             phase is held against its plain version (WindowRecorder) and
             may run only at counts so compared; X4 only at shapes the
             hash phase compared. Last, in a process of its own, the pprof
             server's /debug/torch/start_trace -> run (1)'s prevote round
             -> /debug/torch/stop_trace: the trace must name K2.

After the ledger phase one line "libs": the phase observations of the
NodeMetrics pushed for the whole run (crypto_verify_phase_seconds, after
the slice phase and at the end), the devstats transfer counters (on for
the whole run) and device-memory gauges, the fast25519 tier in force
(whether the cryptography wheel is installed) and 1,000
Ed25519PubKey.verify_signature calls, in us a verify.

12. chain — block execution and storage on a seeded 10,000-validator
             chain of fresh keys (the arena starts cold), equal power:
             proxy.AppConns(local_client_creator(KVStoreApplication)),
             state.Store, store.BlockStore, each on a FileDB under
             build/chain/, an EventBus, a BlockExecutor on the card and a
             HashCoalescer(device="cuda") pushed for the whole path.
             Heights 1-4 (cut to fit the script's time limit) each carry
             1,024 seeded kvstore txs of 1 KiB,
             put through a CListMempool's check_tx from 8 threads (their
             tx keys in X4 windows) and reaped from it; each height: the
             block
             from create_proposal_block, PartSet.from_data over the
             codec's bytes, apply_block (validate_block: the LastCommit
             through verify_commit on K2 via the process-wide arena, X1
             for the keys it lacks; FinalizeBlock, Commit, the state
             save), the height's 10,000 precommits signed by a spawn pool,
             BlockStore.save_block. Height 1 carries a val: tx adding a
             fresh key, so height 4's LastCommit has 10,001 signatures
             (K2 at 10,001 lanes, X1 at 1 key). Then a fifth block whose
             LastCommit has one spoiled signature must raise
             BlockValidationError naming its index, with the state, both
             stores and the app untouched; then the three FileDBs are
             reopened: Store.load() equals the last state,
             BlockStore.load_block(h) each block, the app's info its app
             hash. Per height it prints the host ms of validate_block
             (verify_commit, hashing, the rest), FinalizeBlock, Commit,
             the state save, the block save, and the launches; every
             K2/X1 launch of the path is held against its plain version
             (WindowRecorder) and every X4 launch against X4's plain
             version on its own wire (X4Recorder), and each may run only
             at counts or shapes so compared. Last, in a process of its
             own, one warm height (3) under torch.profiler for the card's
             idle share (chain.trace). The signing pool of phases 3-10
             is closed by then: the phase opens its own.

13. consensus — the consensus engine on the card (consensus/, mempool/,
             evidence/), each node wired as cometbft_tpu/node/node.py wires
             one without p2p (ConsensusNode: FileDBs under
             build/consensus/, the kvstore on the local client, the ABCI
             handshake, a CListMempool, an EvidencePool, a BlockExecutor,
             a WAL, ConsensusState and a CommitPipeline on the card), the
             card's arena emptied first as a node start leaves it. (1) The
             burst: four validators of power 10 in this process with
             perfect gossip, 64 kvstore txs in every mempool, until every
             node stores five blocks; block and app hashes agree, every tx
             is committed once, the mempools end empty. (2) Full width:
             the chain cell's 10,000 keys at power 100, one node holding
             validator 0's key, a VerifyCoalescer and a HashCoalescer
             pushed (device="cuda"), the verify cut at its seed, rounds
             timing out only after minutes. Heights 1-4: 1,024 kvstore txs
             of 1 KiB through check_tx from 8 threads (tx keys in X4
             windows); where another validator proposes, the phase builds
             the block with the node's create_proposal_block (reaping its
             mempool and evidence pool) and signs the proposal with the
             proposer's key; 9,999 prevotes, then 9,999 precommits, one of
             each spoiled, through add_vote_from_peer from 16 threads in a
             seeded order (the receive loop preverifies each drained batch:
             K2, or the coalescer's windows below the cut). At height 2
             validator 17 also precommits another block (its
             DuplicateVoteEvidence must be committed in block 3) and a
             header forged at height 2, signed by 3,334 of the 10,000,
             goes through EvidencePool.add_evidence (the trusting check:
             K2 at 3,334 lanes) and must be committed. Each height must
             commit in round 0; it prints the host ms from the proposal fed
             to the block stored and the node's steps (preverify,
             admission, validate_block, FinalizeBlock, Commit, the saves,
             the WAL), each preverify window's lanes and the K2, X1 and X4
             launches by shape. The spoiled votes must not count; the
             reopened FileDBs hold the node's state, blocks and app hash.
             Every K2/X1/X4 launch of the phase is held against its plain
             version and may run only at counts or shapes so compared.
             Last, in a process of its own, run (2)'s warm height 2 from
             its proposal to its block under torch.profiler
             (consensus.trace).
14. net   — p2p and the reactors (p2p/, blocksync/, the consensus,
             mempool and evidence reactors), every node a NetNode wired
             as cometbft_tpu/node/node.py wires one, each connection's
             frames sealed by the native ChaCha20-Poly1305 tier (the
             wheel's tier switched off: wheel_off). net.frame: µs to seal
             and open a 1,028 B frame, native, plain and the wheel's.
             Run (1), net.burst: four validators of power 10 over
             localhost TCP on a star around node 0 commit five heights
             with identical blocks; txs checked at node 3 must commit and
             be queried at node 1's kvstore; X1 at 4 keys, no K2. Run
             (2), net.catchup: a 4,096-validator chain (BASELINE config
             5's width; ed25519 keys, as no block can carry an sr25519
             validator's key) of five heights with 64 txs of 1 KiB each,
             applied by an honest server, proposed and signed here, on
             FileDBs; a byzantine server holds the same blocks but block
             3, whose LastCommit has one lane spoiled. A fresh follower with
             blocksync on dials the byzantine server (heights 2 and 3
             must be redone, the server stopped), then the honest one,
             and catches up heights 1-4 (verify_commit_light on K2 at
             2,731 lanes, validate_block at 4,096, its arena cold) and
             switches to consensus; its block IDs and app hashes must be
             the honest server's. Per height (net.catchup.height) the
             host ms from the block's last request to its arrival, of
             verify_commit_light and of apply_block; the MConnection
             bytes each way; launches by lane count, each K2/X1 launch
             held against its plain version; in a process of its own one
             warm catch-up height under torch.profiler (net.trace).

In the slice and light phases K1-K4 and X1 must run only at lane counts
the kernels phase compared (6,667 and 3,334 lanes are the +2/3 and 1/3
checks; X1 builds a commit's missing keys); in the vote phase K1 and K2,
and in the mixed phase K1, K2 and X1, only at the counts of the phase's
own compared launches; X5 only in the rlc phase, at compared shapes.

After the rlc phase one line "torch_ops" times X2 (the arena scatter)
and X3 (the wire unpack and the verdict bit-pack), which the port runs as
torch ops, at the commit cell's shapes beside their bytes bounds, with
their launches on each path (ops.cuda_verify.OP_LAUNCHES, read with
K1-K4's).

Then one line {"kernels": [...]} (K1-K4, X1, X5 and X4; launches by
path, the chain's, the consensus and the net phase's included), the card's
nvidia-smi line, and last {"ok": true, "device": {...}}. Any failed check
raises: the script exits nonzero and prints no last line. Without CUDA
it exits 2.
"""

import collections
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from multiprocessing import get_context
from pathlib import Path

CHAIN_ID = "chip-smoke-chain"
HEIGHT = 1000
N_VALIDATORS = 10_000
N_LANES = 4096
N_RAGGED = 1000
N_TIMED = 10_000
N_LIGHT = 2 * N_VALIDATORS // 3 + 1  # verify_commit_light's lanes
N_TRUST = N_VALIDATORS // 3 + 1  # verify_commit_light_trusting's, at 1/3
# the lane counts the kernels are held against their plain versions at;
# K1-K4 run at no other count on the main paths
COMPARED_LANES = (N_LANES, N_RAGGED, N_TIMED, N_LIGHT, N_TRUST)
PATH_LANES = (N_TRUST, N_LIGHT, N_TIMED)  # K1-K4 are timed at each
# X1 builds the keys a call misses: 10,000 on the slice path (prestaging,
# the cold commit); on the light path the misses of each check, which the
# seeded key groups fix. It is compared and timed at each.
X1_LIGHT_LANES = (N_LIGHT, 3_344, 3_323)
X1_PATH_LANES = (N_TIMED,) + X1_LIGHT_LANES
# K1's shards on the mesh path (no chunking there): the commit's 10,000
# lanes pad to 16,384 on a (1, 1) mesh, 4 x 4,096 on (1, 4) and 4 x 8,192
# on (2, 2) (the commit axis pads to 2); the 40,000-lane catch-up batch to
# 65,536 on (1, 1) and 4 x 16,384 on (1, 4). 4,096 is N_LANES.
K1_MESH_LANES = (8_192, 16_384, 65_536)
RUNS = 5
KERNEL_REPS = 10  # back-to-back launches between two CUDA events
TAMPERED = 4321
LIGHT_GROUP = 5_000  # validators in each of the four key groups
LIGHT_HEIGHTS = (1000, 1009, 1010)
LIGHT_T0_NS = 1_760_000_000 * 10**9
LIGHT_PERIOD_NS = 3 * 3600 * 10**9  # trusting period
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and the int32
# multiply-add rate. The data sheet gives 67 TFLOP/s float32 outside the
# tensor cores (128 FMA per clock per SM); on compute capability 9.0 an
# int32 multiply or multiply-add issues at 64 per clock per SM, half that
# (CUDA C++ Programming Guide, "Arithmetic Instructions" throughput
# table). A multiply-add counts as two operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12 / 2
# the kernels each main path must launch
SLICE_KERNELS = ("verify_kernel", "verify_kernel_cached", "build_pubkey_tables")
LIGHT_KERNELS = ("verify_kernel8", "verify_kernel8_cached",
                 "build_pubkey_tables")
VERIFY_KERNELS = ("verify_kernel", "verify_kernel_cached", "verify_kernel8",
                  "verify_kernel8_cached")
# the hash phase: one seeded default block, BlockParams.max_bytes (21 MiB,
# 336 parts of BLOCK_PART_SIZE_BYTES) of 2,048-byte txs, the tx size of
# the reference's bench_hash_plane
BLOCK_BYTES = 22_020_096
TX_BYTES = 2_048
INGRESS_THREADS = 8  # gossip peers handing parts to add_part at once
HASH_SEED = 21
PADDING_EDGES = (0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 127, 128, 129, 200)
# X4's (block bucket, lane bucket) shapes the kernels check compares beside
# the padding edges and the fuzz: every lane bucket of the merkle leaves
# (1 block), inner nodes (2) and tx keys (64, 2,048-byte txs), the 336
# part leaves (2,048: 1,025 blocks each, lane bucket 512) and the gossip
# windows of up to INGRESS_THREADS leaves (lane bucket 8)
X4_LANE_BUCKETS = tuple(8 << i for i in range(9))  # 8 .. 2,048
X4_PATH_SHAPES = tuple((bb, lb) for bb in (1, 2, 64)
                       for lb in X4_LANE_BUCKETS) + ((2048, 8), (2048, 512))
# signing workers: the cores this process may use, at most 8 (a one-card
# machine may share a host whose os.cpu_count() is far larger)
WORKERS = min(8, len(os.sched_getaffinity(0)))


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started (the
    phases' share of the time limit)."""
    print(json.dumps({**obj, "elapsed_s": round(time.perf_counter() - _T0,
                                                1)}), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _sign_chunk(items):
    """Worker: [(seed, msg)] -> [(pubkey, signature)]."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [(ref.pubkey_from_seed(s), ref.sign(s, m)) for s, m in items]


def _pubkey_chunk(seeds):
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [ref.pubkey_from_seed(s) for s in seeds]


def _expand_chunk(seeds):
    """Worker: seeds -> [(scalar a, nonce prefix, pubkey)]."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [ref.expand_seed(s) for s in seeds]


def _sign_expanded_chunk(items):
    """Worker: [((a, prefix, pubkey), msg)] -> [signature], each key
    expanded once beforehand (more keys than a worker's expansion cache)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [ref.sign_expanded(*key, msg) for key, msg in items]


def _pool_map(pool, fn, items):
    step = max(1, len(items) // (4 * WORKERS))
    chunks = [items[i : i + step] for i in range(0, len(items), step)]
    return [x for part in pool.map(fn, chunks) for x in part]


def _seed(tag: bytes, i: int) -> bytes:
    return hashlib.sha256(tag + i.to_bytes(8, "little")).digest()


# ------------------------------------------------------------------ lanes


def _order8_point(ref):
    y = 2
    while True:
        pt = ref.decompress(y.to_bytes(32, "little"))
        y += 1
        if pt is None:
            continue
        t = ref.scalar_mult(ref.L, pt)
        if not ref.is_identity(t) and not ref.is_identity(
            ref.point_double(ref.point_double(t))
        ):
            return t


def make_lanes(pool):
    """N_LANES seeded lanes; lanes 0-36 are edge lanes with known verdicts
    (0-11 on A, S and the message, 12-36 on R)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    items = [
        (_seed(b"lane-key", i % 256), b"lane message %d" % i)
        for i in range(N_LANES)
    ]
    signed = _pool_map(pool, _sign_chunk, items)
    pks = [p for p, _ in signed]
    sigs = [s for _, s in signed]
    msgs = [m for _, m in items]
    r = 123457
    r_enc = ref.compress(ref.scalar_mult(r, ref.BASE))
    rs = r_enc + r.to_bytes(32, "little")
    s0 = int.from_bytes(sigs[8][32:], "little")
    edge = {
        1: ("flipped signature bit", None, None,
            bytes([sigs[1][0] ^ 1]) + sigs[1][1:], False),
        2: ("wrong message", None, b"tampered", None, False),
        3: ("wrong key", pks[300], None, None, False),
        4: ("identity key y = 1 + p", (1 + ref.P).to_bytes(32, "little"),
            None, ref.compress(ref.scalar_mult(7, ref.BASE))
            + (7).to_bytes(32, "little"), True),
        5: ("A off the curve", (2).to_bytes(32, "little"), None, None, False),
        6: ("R off the curve", None, None,
            (2).to_bytes(32, "little") + sigs[6][32:], False),
        8: ("S >= L, host reject", None, None,
            sigs[8][:32] + (s0 + ref.L).to_bytes(32, "little"), False),
        9: ("S = L, host reject", None, None,
            sigs[9][:32] + ref.L.to_bytes(32, "little"), False),
        10: ("negative zero A", (1 | 1 << 255).to_bytes(32, "little"), None,
             rs, True),
        11: ("truncated signature", None, None, sigs[11][:40], False),
    }
    a8 = ref.compress(_order8_point(ref))
    m8 = next(
        b"small-order %d" % i for i in range(64)
        if ref.challenge_scalar(r_enc, a8, b"small-order %d" % i) % 8
    )
    edge[7] = ("small-order A, cofactored accept", a8, m8, rs, True)
    # R side: only R decompresses in K2/K4. A non-canonical R = (p + k)
    # for every k < 19 that decodes: the small-order ones (k = 0, 1; k = 1
    # is the identity) with a small-order A and S = 0 accept, since
    # [8](-[k]A - R) = O; the full-order ones reject on the equation.
    edge[12] = ("negative zero R, small-order A, S = 0", a8, None,
                (1 | 1 << 255).to_bytes(32, "little") + bytes(32), True)
    i = 13
    for k in range(19):
        for sign in (0, 1):
            enc = ((ref.P + k) | sign << 255).to_bytes(32, "little")
            pt = ref.decompress(enc)
            if pt is None:
                continue
            small = ref.is_identity(
                ref.point_double(ref.point_double(ref.point_double(pt))))
            edge[i] = ((f"R y = p + {k}, sign {sign}, "
                        + ("small-order A, S = 0" if small else "full order")),
                       a8 if small else None, None,
                       enc + (bytes(32) if small else sigs[i][32:]), small)
            i += 1
    expect = {0: True}
    for i, (_name, pk, msg, sig, verdict) in edge.items():
        pks[i] = pk if pk is not None else pks[i]
        msgs[i] = msg if msg is not None else msgs[i]
        sigs[i] = sig if sig is not None else sigs[i]
        expect[i] = verdict
    for i, verdict in expect.items():
        check(ref.verify(pks[i], msgs[i], sigs[i]) == verdict,
              f"edge lane {i} oracle verdict")
    return pks, msgs, sigs, expect


def zip215_corpus():
    """The ZIP-215 conformance classes as (name, pubkey, msg, sig, verdict),
    built with the port's ed25519_ref in the order and with the inputs of
    tests/test_zip215_conformance.py::build_corpus, whose comments derive
    each verdict (tests/test_torch_smoke.py holds the two lists equal)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    t8 = _order8_point(ref)
    torsion = [ref.scalar_mult(i, t8) for i in range(8)]
    v = []
    msg = b"zip215 conformance msg"
    seed = b"\x2a" * 32
    a, _prefix, a_enc = ref.expand_seed(seed)
    honest = ref.sign(seed, msg)
    v.append(("honest", a_enc, msg, honest, True))
    v.append(("wrong_msg", a_enc, b"other msg", honest, False))
    v.append(("wrong_key", ref.pubkey_from_seed(b"\x2b" * 32), msg, honest,
              False))
    r = 123457
    r_enc = ref.compress(ref.scalar_mult(r, ref.BASE))
    r_tail = (r % ref.L).to_bytes(32, "little")
    for i, t in enumerate(torsion):
        v.append((f"small_order_A_{i}", ref.compress(t), msg, r_enc + r_tail,
                  True))
    for i, t in enumerate(torsion[:4]):
        re_ = ref.compress(t)
        s = ref.challenge_scalar(re_, a_enc, msg) * a % ref.L
        v.append((f"small_order_R_{i}", a_enc, msg,
                  re_ + s.to_bytes(32, "little"), True))
    ident = ref.compress(ref.IDENTITY)
    v.append(("s0_identity_AR", ident, msg, ident + bytes(32), True))

    def first_msg(tag, r_e, a_e):
        return next(tag % i for i in range(64)
                    if ref.challenge_scalar(r_e, a_e, tag % i) % 8 != 0)

    am_enc = ref.compress(ref.point_add(ref.scalar_mult(a, ref.BASE),
                                        torsion[1]))
    m = first_msg(b"zip215-mixedA-%d", r_enc, am_enc)
    s = (r + ref.challenge_scalar(r_enc, am_enc, m) * a) % ref.L
    v.append(("mixed_order_A", am_enc, m, r_enc + s.to_bytes(32, "little"),
              True))
    rm_enc = ref.compress(ref.point_add(ref.scalar_mult(r, ref.BASE),
                                        torsion[1]))
    m = first_msg(b"zip215-mixedR-%d", rm_enc, a_enc)
    s = (r + ref.challenge_scalar(rm_enc, a_enc, m) * a) % ref.L
    v.append(("mixed_order_R", a_enc, m, rm_enc + s.to_bytes(32, "little"),
              True))
    small, full = [], []
    for y in range(19):
        for sign in (0, 1):
            e = ((y + ref.P) | (sign << 255)).to_bytes(32, "little")
            pt = ref.decompress(e)
            if pt is None:
                continue
            p8 = ref.point_double(ref.point_double(ref.point_double(pt)))
            (small if ref.is_identity(p8) else full).append((y, sign, e))
    for y, sign, e in small:
        v.append((f"noncanon_A_y{y}s{sign}", e, msg, r_enc + r_tail, True))
        s = ref.challenge_scalar(e, a_enc, msg) * a % ref.L
        v.append((f"noncanon_R_y{y}s{sign}", a_enc, msg,
                  e + s.to_bytes(32, "little"), True))
    negzero = (1 | (1 << 255)).to_bytes(32, "little")
    v.append(("negative_zero_A", negzero, msg, r_enc + r_tail, True))
    s_int = int.from_bytes(honest[32:], "little")
    v.append(("s_plus_L", a_enc, msg,
              honest[:32] + (s_int + ref.L).to_bytes(32, "little"), False))
    v.append(("s_eq_L", a_enc, msg, honest[:32] + ref.L.to_bytes(32, "little"),
              False))
    v.append(("s_max", a_enc, msg, honest[:32] + b"\xff" * 32, False))
    off = (2).to_bytes(32, "little")
    v.append(("A_off_curve", off, msg, honest, False))
    v.append(("R_off_curve", a_enc, msg, off + honest[32:], False))
    if full:
        v.append(("noncanon_full_order_A", full[0][2], msg, honest, False))
    return v


# ---------------------------------------------------------------- timing


def time_ms(torch, fn, reps=1):
    """(median ms a call over RUNS timings after one warm-up, CUDA events
    around ``reps`` calls each; the last call's output). A kernel is timed
    with reps=KERNEL_REPS: its wrapper's host time then overlaps the
    launch before it, where one call between two events would add it
    (~30 us) to the card's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), out


def bound(cuda_verify, name: str, lanes: int, extra_bytes: int = 0):
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the int32 rate and the bytes (per lane, plus ``extra_bytes`` read
    once per launch) over the memory rate."""
    ops_ms = 1e3 * 2 * cuda_verify.MULADDS_PER_LANE[name] * lanes / PEAK_OPS_PER_S
    bytes_ms = 1e3 * (cuda_verify.BYTES_PER_LANE[name] * lanes
                      + extra_bytes) / PEAK_BYTES_PER_S
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def table8_bytes(torch, cuda_verify, s_bytes, name) -> int:
    """Bytes of the 8-bit fixed-base table that these S bytes name, as
    kernel ``name`` holds it: each distinct (window, byte) entry read once
    (0 for the 4-bit kernels)."""
    if name not in cuda_verify.TABLE8_ENTRY_BYTES:
        return 0
    win = torch.arange(s_bytes.shape[0], device=s_bytes.device)[:, None]
    entries = torch.unique(win * 256 + (s_bytes & 255)).numel()
    return entries * cuda_verify.TABLE8_ENTRY_BYTES[name]


# ----------------------------------------------------------------- phases


def tally(torch, err, mismatches, name, got, plain) -> None:
    """Kernel ``name``'s output against its plain version's: the largest
    absolute difference into err, the elements that differ into
    mismatches."""
    diff = (got.to(torch.int64) - plain.to(torch.int64)).abs()
    err[name] = max(err[name], int(diff.max()))
    mismatches[name] += int((diff != 0).sum())


def phase_kernels(torch, pool):
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    pks, msgs, sigs, expect = make_lanes(pool)
    emit({"phase": "kernels.inputs", "lanes": N_LANES,
          "edge_lanes": len(expect), "seconds": time.perf_counter() - t0})
    buf, host_ok = ov.pack_bytes(pks, msgs, sigs)
    wire = torch.from_numpy(buf).to(dev)
    # K2 and K4 read an arena of PubkeyTableCache's CAPACITY + 1 slots. At
    # the main paths' sizes the slots are 0..n-1 in lane order, as a cold
    # fill of the cache assigns them (and as K2 and K4 are timed); at the
    # two smaller sizes they are scattered over the whole arena, as after
    # evictions.
    slots = ov.PubkeyTableCache.CAPACITY + 1
    oracle = {}  # lane -> ed25519_ref verdict; larger sizes tile the lanes
    timed_inputs, x1_inputs = {}, {}
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    for n in COMPARED_LANES:
        cols = torch.arange(n, device=dev) % N_LANES
        a = ov.unpack_on_device(wire[:, cols])
        a8 = ov.unpack_on_device(wire[:, cols], "8")
        rsk = {k: a[k] for k in ("y_r", "sign_r", "s_nibs", "kneg_nibs")}
        rsk8 = {k: a8[k] for k in ("y_r", "sign_r", "s_bytes", "kneg_nibs")}
        if n in (N_TIMED, N_LIGHT, N_TRUST):
            slot = torch.arange(n, device=dev)
        else:
            gen = torch.Generator().manual_seed(n)
            slot = torch.randperm(slots - 1, generator=gen)[:n].to(dev)
        k1 = cuda_verify.verify_kernel(**a)
        k3 = cuda_verify.verify_kernel8(**a8)
        table, tab_ok = cuda_verify.build_pubkey_tables(a["y_a"], a["sign_a"])
        arena = torch.zeros((16, 4, 20, slots), dtype=torch.int32, device=dev)
        arena[..., slot] = table
        arena_ok = torch.zeros(slots, dtype=torch.bool, device=dev)
        arena_ok[slot] = tab_ok
        idxs = slot.to(torch.int16)
        k2 = cuda_verify.verify_kernel_cached(arena, arena_ok, **rsk,
                                              idxs=idxs)
        k4 = cuda_verify.verify_kernel8_cached(arena, arena_ok, **rsk8,
                                               idxs=idxs)
        table_plain, tab_ok_plain = curve.build_pubkey_tables(
            a["y_a"], a["sign_a"]
        )
        torch.cuda.synchronize()
        for name, got, plain in (
            ("verify_kernel", k1, curve.verify_kernel(**a)),
            ("verify_kernel_cached", k2,
             curve.verify_kernel_slots(arena, arena_ok, idxs, **rsk)),
            ("build_pubkey_tables", table, table_plain),
            ("build_pubkey_tables", tab_ok, tab_ok_plain),
            ("verify_kernel8", k3, curve.verify_kernel8(**a8)),
            ("verify_kernel8_cached", k4,
             curve.verify_kernel8_slots(arena, arena_ok, idxs, **rsk8)),
        ):
            tally(torch, err, mismatches, name, got, plain)
        valid = k1.cpu().numpy() & host_ok[cols.cpu().numpy()]
        for i, verdict in expect.items():
            check(bool(valid[i]) == verdict, f"edge lane {i} verdict (n={n})")
        sample = list(range(len(expect), n, max(1, n // 48)))
        for i in sample:
            j = i % N_LANES
            if j not in oracle:
                oracle[j] = ref.verify(pks[j], msgs[j], sigs[j])
            check(bool(valid[i]) == oracle[j],
                  f"lane {i} disagrees with the oracle (n={n})")
        check(bool((k2 == k1).all()), f"K2 and K1 verdicts differ (n={n})")
        check(bool((k3 == k1).all()), f"K3 and K1 verdicts differ (n={n})")
        check(bool((k4 == k2).all()), f"K4 and K2 verdicts differ (n={n})")
        emit({"phase": "kernels.compare", "lanes": n, "arena_slots": slots,
              "slots_scattered": n not in (N_TIMED, N_LIGHT, N_TRUST),
              "mismatches": dict(mismatches), "oracle_lanes":
              len(expect) + len(sample), "valid_lanes": int(valid.sum())})
        if n in PATH_LANES:
            timed_inputs[n] = (a, rsk, a8, rsk8, arena, arena_ok, idxs,
                               k1, k2, k3, k4)
        if n in X1_PATH_LANES:
            x1_inputs[n] = (a["y_a"], a["sign_a"], table)
    # X1 at the counts only the light path launches it at, on the same
    # tiled lanes
    for n in sorted(set(X1_PATH_LANES) - set(COMPARED_LANES)):
        cols = torch.arange(n, device=dev) % N_LANES
        a = ov.unpack_on_device(wire[:, cols])
        table, tab_ok = cuda_verify.build_pubkey_tables(a["y_a"], a["sign_a"])
        for got, plain in zip((table, tab_ok), curve.build_pubkey_tables(
                a["y_a"], a["sign_a"])):
            tally(torch, err, mismatches, "build_pubkey_tables", got, plain)
        emit({"phase": "kernels.compare", "kernel": "build_pubkey_tables",
              "lanes": n, "mismatches": mismatches["build_pubkey_tables"]})
        x1_inputs[n] = (a["y_a"], a["sign_a"], table)
    # K1 at the counts only the mesh path launches it at, on the same
    # tiled lanes: edge verdicts, a sample against the oracle
    k1_mesh = {}
    for n in K1_MESH_LANES:
        cols = torch.arange(n, device=dev) % N_LANES
        a = ov.unpack_on_device(wire[:, cols])
        k1 = cuda_verify.verify_kernel(**a)
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = curve.verify_kernel(**a)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t)  # one call, host clock
        tally(torch, err, mismatches, "verify_kernel", k1, plain)
        valid = k1.cpu().numpy() & host_ok[cols.cpu().numpy()]
        for i, verdict in expect.items():
            check(bool(valid[i]) == verdict, f"edge lane {i} verdict (n={n})")
        for i in range(len(expect), n, max(1, n // 48)):
            j = i % N_LANES
            if j not in oracle:
                oracle[j] = ref.verify(pks[j], msgs[j], sigs[j])
            check(bool(valid[i]) == oracle[j],
                  f"lane {i} disagrees with the oracle (n={n})")
        emit({"phase": "kernels.compare", "kernel": "verify_kernel",
              "lanes": n, "mismatches": mismatches["verify_kernel"],
              "plain_ms": plain_ms})
        k1_mesh[n] = (a, k1, plain_ms)
    check_zip215(torch, dev, err, mismatches)
    check(not any(mismatches.values()), f"kernel != plain: {mismatches}")

    # K1-K4 timed at each lane count the main paths launch them at, the
    # plain versions at 10,000, on the inputs compared above; each timed
    # kernel's last output must equal the one compared
    timed, by_lanes = {}, {}
    for n in PATH_LANES:
        a, rsk, a8, rsk8, arena, arena_ok, idxs, k1, k2, k3, k4 = (
            timed_inputs[n])
        runs = {
            "verify_kernel": (
                lambda: cuda_verify.verify_kernel(**a),
                lambda: curve.verify_kernel(**a),
                k1,
            ),
            "verify_kernel_cached": (
                lambda: cuda_verify.verify_kernel_cached(
                    arena, arena_ok, **rsk, idxs=idxs),
                lambda: curve.verify_kernel_slots(arena, arena_ok, idxs,
                                                  **rsk),
                k2,
            ),
            "verify_kernel8": (
                lambda: cuda_verify.verify_kernel8(**a8),
                lambda: curve.verify_kernel8(**a8),
                k3,
            ),
            "verify_kernel8_cached": (
                lambda: cuda_verify.verify_kernel8_cached(
                    arena, arena_ok, **rsk8, idxs=idxs),
                lambda: curve.verify_kernel8_slots(arena, arena_ok, idxs,
                                                   **rsk8),
                k4,
            ),
        }
        for name, (kernel, plain, compared) in runs.items():
            ms, out = time_ms(torch, kernel, KERNEL_REPS)
            check(torch.equal(out, compared), f"{name}: timed output changed")
            bound_ms, bound_by = bound(
                cuda_verify, name, n,
                table8_bytes(torch, cuda_verify, a8["s_bytes"], name))
            row = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / ms}
            if n == N_TIMED:
                row.update(plain_ms=time_ms(torch, plain)[0],
                           max_abs_err=err[name],
                           mismatches=mismatches[name])
                timed[name] = dict(row)
            by_lanes.setdefault(name, {})[n] = ms
            emit({"phase": "kernels.time", "kernel": name, "lanes": n, **row})
        # pairs once more in turns (a, b, b, a), on the same card and
        # inputs: each 8-bit kernel beside its 4-bit sibling, and each
        # cached kernel beside the uncached one of its flavor
        for one, two in (("verify_kernel", "verify_kernel8"),
                         ("verify_kernel_cached", "verify_kernel8_cached"),
                         ("verify_kernel", "verify_kernel_cached"),
                         ("verify_kernel8", "verify_kernel8_cached")):
            order = (one, two, two, one)
            ms = [time_ms(torch, runs[name][0], KERNEL_REPS)[0]
                  for name in order]
            emit({"phase": "kernels.ab", "lanes": n, "order": order,
                  "ms": ms, one: (ms[0] + ms[3]) / 2, two: (ms[1] + ms[2]) / 2,
                  "ratio": (ms[1] + ms[2]) / (ms[0] + ms[3])})
    for name in VERIFY_KERNELS:
        timed[name]["ms_by_lanes"] = by_lanes[name]
    # K1 at the mesh path's shard counts beside its bound
    mesh_rows = {}
    for n, (a, k1, plain_ms) in k1_mesh.items():
        ms, out = time_ms(torch, lambda: cuda_verify.verify_kernel(**a),
                          KERNEL_REPS)
        check(torch.equal(out, k1), "verify_kernel: timed output changed")
        bound_ms, bound_by = bound(cuda_verify, "verify_kernel", n)
        mesh_rows[n] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "bound_share": bound_ms / ms, "plain_ms": plain_ms}
        emit({"phase": "kernels.time", "kernel": "verify_kernel", "lanes": n,
              **mesh_rows[n]})
    timed["verify_kernel"]["mesh_lanes"] = mesh_rows
    timed["build_pubkey_tables"] = time_x1(torch, x1_inputs, err, mismatches)
    return timed


def time_x1(torch, x1_inputs, err, mismatches):
    """X1 timed at each lane count its paths launch it at, on the inputs
    compared, beside its throughput bound and its chain bound (its SASS
    and clock_probe, read here); its plain version at 10,000."""
    from cometbft_tpu_torch.ops import build, cuda_verify, curve

    name = "build_pubkey_tables"
    probe = clock_probe(torch)
    sass = x1_sass(build.BUILD_INFO["build_tables.cu"]["path"], probe)
    chain_ms = x1_lane_ms(sass, probe)
    emit({"phase": "kernels.x1.sass", **sass, "chain_bound_ms": chain_ms,
          "warp_issue_ms": x1_lane_ms(sass, probe, "issue_cycles"),
          "clock_probe": {k: v for k, v in probe.items() if k != "sass"}})
    row, by_lanes = {}, {}
    for n in sorted(set(X1_PATH_LANES)):
        y_a, sign_a, table = x1_inputs[n]
        ms, out = time_ms(
            torch, lambda: cuda_verify.build_pubkey_tables(y_a, sign_a)[0],
            KERNEL_REPS)
        check(torch.equal(out, table), f"{name}: timed output changed")
        bound_ms, bound_by = bound(cuda_verify, name, n)
        line = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_share": bound_ms / ms, "chain_bound_ms": chain_ms,
                "larger_bound_share": max(bound_ms, chain_ms) / ms}
        if n == N_TIMED:
            row = dict(line, plain_ms=time_ms(
                torch, lambda: curve.build_pubkey_tables(y_a, sign_a))[0],
                max_abs_err=err[name], mismatches=mismatches[name])
        by_lanes[n] = ms
        emit({"phase": "kernels.time", "kernel": name, "lanes": n, **line})
    row["ms_by_lanes"] = by_lanes
    row["sass"] = {k: sass[k] for k in ("instructions", "squaring",
                                        "table_loop")}
    return row


def check_zip215(torch, dev, err, mismatches):
    """The ZIP-215 classes through K1-K4 (K2's and K4's slots scattered
    over the cache's arena) against the plain versions, their expected
    verdicts and the oracle. K1 and K3 decompress A themselves, so the
    A-side classes reach a decompression only there."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

    corpus = zip215_corpus()
    names, pks, msgs, sigs, expected = zip(*corpus)
    buf, host_ok = ov.pack_bytes(pks, msgs, sigs)
    wire = torch.from_numpy(buf).to(dev)
    a = ov.unpack_on_device(wire)
    a8 = ov.unpack_on_device(wire, "8")
    n = len(corpus)
    slots = ov.PubkeyTableCache.CAPACITY + 1
    gen = torch.Generator().manual_seed(215)
    slot = torch.randperm(slots - 1, generator=gen)[:n].to(dev)
    table, tab_ok = cuda_verify.build_pubkey_tables(a["y_a"], a["sign_a"])
    arena = torch.zeros((16, 4, 20, slots), dtype=torch.int32, device=dev)
    arena[..., slot] = table
    arena_ok = torch.zeros(slots, dtype=torch.bool, device=dev)
    arena_ok[slot] = tab_ok
    idxs = slot.to(torch.int16)
    rsk = {k: a[k] for k in ("y_r", "sign_r", "s_nibs", "kneg_nibs")}
    rsk8 = {k: a8[k] for k in ("y_r", "sign_r", "s_bytes", "kneg_nibs")}
    k1 = cuda_verify.verify_kernel(**a)
    k2 = cuda_verify.verify_kernel_cached(arena, arena_ok, **rsk, idxs=idxs)
    k3 = cuda_verify.verify_kernel8(**a8)
    k4 = cuda_verify.verify_kernel8_cached(arena, arena_ok, **rsk8, idxs=idxs)
    torch.cuda.synchronize()
    for got, plain in zip((table, tab_ok),
                          curve.build_pubkey_tables(a["y_a"], a["sign_a"])):
        tally(torch, err, mismatches, "build_pubkey_tables", got, plain)
    for name, got, plain in (
        ("verify_kernel", k1, curve.verify_kernel(**a)),
        ("verify_kernel8", k3, curve.verify_kernel8(**a8)),
        ("verify_kernel_cached", k2,
         curve.verify_kernel_slots(arena, arena_ok, idxs, **rsk)),
        ("verify_kernel8_cached", k4,
         curve.verify_kernel8_slots(arena, arena_ok, idxs, **rsk8)),
    ):
        tally(torch, err, mismatches, name, got, plain)
        valid = got.cpu().numpy() & host_ok
        for i, vec in enumerate(names):
            check(bool(valid[i]) == expected[i], f"{name}: ZIP-215 {vec}")
            check(expected[i] == ref.verify(pks[i], msgs[i], sigs[i]),
                  f"oracle: ZIP-215 {vec}")
    emit({"phase": "kernels.zip215", "vectors": n,
          "accepted": int(sum(expected)), "mismatches": dict(mismatches)})


def make_commit(pool):
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    seeds = [_seed(b"validator", i) for i in range(N_VALIDATORS)]
    pubs = _pool_map(pool, _pubkey_chunk, seeds)
    vals = ValidatorSet([Validator(Ed25519PubKey(p), 100) for p in pubs])
    seed_of = {Ed25519PubKey(p).address(): s for p, s in zip(pubs, seeds)}
    block_id = block.BlockID(
        hashlib.sha256(b"block").digest(),
        block.PartSetHeader(2, hashlib.sha256(b"parts").digest()),
    )
    unsigned = [
        block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                        1_760_000_000_000_000_000 + 7919 * i)
        for i, v in enumerate(vals.validators)
    ]
    commit = block.Commit(HEIGHT, 0, block_id, unsigned)
    items = [
        (seed_of[cs.validator_address], commit.vote_sign_bytes(CHAIN_ID, i))
        for i, cs in enumerate(unsigned)
    ]
    signed = _pool_map(pool, _sign_chunk, items)
    commit.signatures = [
        block.CommitSig(cs.block_id_flag, cs.validator_address,
                        cs.timestamp_ns, sig)
        for cs, (_, sig) in zip(unsigned, signed)
    ]
    return vals, block_id, commit


@contextlib.contextmanager
def env(name: str, value: str):
    """``name`` set to ``value`` inside the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def phase_slice(torch, pool, card):
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.types import block, validation

    t0 = time.perf_counter()
    vals, block_id, commit = make_commit(pool)
    emit({"phase": "slice.commit", "validators": len(vals),
          "signatures": len(commit.signatures),
          "seconds": time.perf_counter() - t0})
    cache = ov.PubkeyTableCache(device="cuda")
    bad = block.Commit(commit.height, commit.round, commit.block_id,
                       list(commit.signatures))
    cs = bad.signatures[TAMPERED]
    sig = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    bad.signatures[TAMPERED] = block.CommitSig(
        cs.block_id_flag, cs.validator_address, cs.timestamp_ns, sig)

    # (name, mode, fn, pubkey_cache, commit, COMETBFT_TPU_PUBKEY_CACHE):
    # the cache-off call turns the process-wide cache off; the default one
    # calls verify_commit with default arguments (the card, its
    # process-wide cache, the flavor COMETBFT_TPU_KERNEL names) right after
    # prestage_validators warmed that cache; the rest pass a cache
    calls = [
        ("verify_commit", "cache off", validation.verify_commit, None, commit,
         "0"),
        ("prestage_validators", "process-wide cache", None, None, None, "1"),
        ("verify_commit", "default arguments, prestaged", None, None, commit,
         "1"),
        ("verify_commit", "cache cold", validation.verify_commit, cache,
         commit, "1"),
        ("verify_commit", "cache warm", validation.verify_commit, cache,
         commit, "1"),
        ("verify_commit", "cache warm", validation.verify_commit, cache,
         commit, "1"),
        ("verify_commit_light", "cache warm", validation.verify_commit_light,
         cache, commit, "1"),
        ("verify_commit", "tampered, cache warm", validation.verify_commit,
         cache, bad, "1"),
    ]
    torch.cuda.synchronize()
    cuda_verify.reset_launches()  # the main path starts here
    per_call = []
    for fn_name, mode, fn, pubkey_cache, c, cache_env in calls:
        before = dict(cuda_verify.LAUNCHES)
        t = time.perf_counter()
        error = None
        with env("COMETBFT_TPU_PUBKEY_CACHE", cache_env):
            try:
                if fn_name == "prestage_validators":
                    with env("COMETBFT_TPU_PRESTAGE", "auto"):
                        built = crypto_batch.prestage_validators(vals)
                    check(built >= 1, f"prestage_validators built {built}")
                elif fn is None:
                    with env("COMETBFT_TPU_KERNEL", "auto"):  # its default
                        validation.verify_commit(CHAIN_ID, vals, block_id,
                                                 HEIGHT, c)
                else:
                    fn(CHAIN_ID, vals, block_id, HEIGHT, c, device="cuda",
                       pubkey_cache=pubkey_cache, flavor="4")
            except validation.VerificationError as e:
                error = str(e)
        seconds = time.perf_counter() - t
        if c is bad:
            check(error is not None and f"(#{TAMPERED})" in error,
                  f"tampered commit: {error!r}")
        else:
            check(error is None, f"{fn_name} ({mode}) rejected: {error}")
        launches = {k: v - before[k] for k, v in cuda_verify.LAUNCHES.items()}
        per_call.append(launches)
        line = {"phase": "slice.call", "call": fn_name, "mode": mode,
                "ms": 1e3 * seconds, "launches": launches, "error": error,
                "pubkey_cache_env": cache_env, "card": card}
        if c is not None:
            sigs = len(c.signatures) if fn_name == "verify_commit" else (
                2 * len(c.signatures) // 3 + 1)
            line.update(sigs_per_s=sigs / seconds, signatures=sigs)
        emit(line)
    launches = dict(cuda_verify.LAUNCHES)  # read just after the main path
    lanes = check_lanes(cuda_verify, "slice")
    check(per_call[0]["verify_kernel"] >= 1
          and per_call[0]["verify_kernel_cached"] == 0,
          "cache-off call did not run K1")
    check(per_call[1]["build_pubkey_tables"] >= 1, "prestaging built nothing")
    check(per_call[2]["verify_kernel_cached"] >= 1
          and per_call[2]["build_pubkey_tables"] == 0
          and per_call[2]["verify_kernel"] == 0,
          f"the default route did not run K2 alone: {per_call[2]}")
    check(per_call[3]["build_pubkey_tables"] >= 1, "cold call built nothing")
    check(per_call[4]["verify_kernel_cached"] >= 1
          and per_call[4]["build_pubkey_tables"] == 0,
          "warm call did not run K2 alone")
    for name in SLICE_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the main path")
    for name in set(launches) - set(SLICE_KERNELS):
        check(launches[name] == 0, f"{name} launched on the 4-bit path")
    emit({"phase": "slice", "launches": launches, "lanes": lanes,
          "cache": cache_stats(cache)})

    # where a warm verify_commit's time goes, each step on its own (host
    # clock; "device" is h2d + unpack + K2 + bit-pack + readback)
    steps = {}
    t = time.perf_counter()
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i)
            for i in range(len(commit.signatures))]
    steps["sign_bytes_ms"] = 1e3 * (time.perf_counter() - t)
    pubs = [v.pub_key.data for v in vals.validators]
    sigs = [cs.signature for cs in commit.signatures]
    t = time.perf_counter()
    buf, _ = ov.pack_bytes(pubs, msgs, sigs)
    steps["pack_bytes_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    idxs, arena, arena_ok = cache.lookup(pubs)
    steps["cache_lookup_ms"] = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok = ov.verify_rsk_async(buf[32:], idxs, arena, arena_ok, len(pubs),
                             flavor="4")()
    steps["device_ms"] = 1e3 * (time.perf_counter() - t)
    check(bool(ok.all()), "breakdown verify rejected the commit")
    emit({"phase": "slice.breakdown", "signatures": len(pubs), **steps,
          "card": card})

    # the card's busy and idle share of one warm verify_commit, read from
    # a torch.profiler trace (host clock for the call, trace for the card)
    host_ms, busy_ms, events = device_busy_ms(
        torch, lambda: validation.verify_commit(
            CHAIN_ID, vals, block_id, HEIGHT, commit, device="cuda",
            pubkey_cache=cache, flavor="4"))
    emit({"phase": "slice.trace", "call": "verify_commit", "mode":
          "cache warm, profiled", "host_ms": host_ms,
          "device_busy_ms": busy_ms, "device_events": events,
          "idle_share": 1 - busy_ms / host_ms if events else None,
          "card": card})
    return launches, lanes, cache, vals, commit


def make_light_chain(pool):
    """Light blocks 1000 (A+B), 1009 (B+C, next C+D) and 1010 (C+D), each
    commit signed by all 10,000 validators of its set."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    def sha(tag: bytes) -> bytes:
        return hashlib.sha256(tag).digest()

    seeds = [_seed(b"light-validator", i) for i in range(4 * LIGHT_GROUP)]
    keys = _pool_map(pool, _expand_chunk, seeds)
    pubs = [Ed25519PubKey(k[2]) for k in keys]
    key_of = {p.address(): k for p, k in zip(pubs, keys)}

    def valset(*groups):
        return ValidatorSet([
            Validator(p, 100) for g in groups
            for p in pubs[g * LIGHT_GROUP : (g + 1) * LIGHT_GROUP]
        ])

    sets = {1000: valset(0, 1), 1009: valset(1, 2), 1010: valset(2, 3)}
    next_sets = {1000: sets[1000], 1009: sets[1010], 1010: sets[1010]}
    headers, commits = {}, {}
    last_id = block.BlockID(sha(b"block 999"),
                            block.PartSetHeader(1, sha(b"parts 999")))
    for h in LIGHT_HEIGHTS:
        vals = sets[h]
        t = LIGHT_T0_NS + h * 10**9
        headers[h] = block.Header(
            version=block.Version(11, 1), chain_id=CHAIN_ID, height=h,
            time_ns=t, last_block_id=last_id,
            last_commit_hash=sha(b"last commit %d" % h),
            data_hash=sha(b"data %d" % h), validators_hash=vals.hash(),
            next_validators_hash=next_sets[h].hash(),
            consensus_hash=sha(b"consensus"), app_hash=sha(b"app %d" % h),
            last_results_hash=sha(b"results %d" % h),
            evidence_hash=sha(b"evidence"),
            proposer_address=vals.get_proposer().address,
        )
        last_id = block.BlockID(headers[h].hash(),
                                block.PartSetHeader(1, sha(b"parts %d" % h)))
        commits[h] = block.Commit(h, 0, last_id, [
            block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                            t + 1_000_000 + 7919 * i)
            for i, v in enumerate(vals.validators)
        ])
    items = [
        (key_of[cs.validator_address], commits[h].vote_sign_bytes(CHAIN_ID, i))
        for h in LIGHT_HEIGHTS
        for i, cs in enumerate(commits[h].signatures)
    ]
    signed = iter(_pool_map(pool, _sign_expanded_chunk, items))
    for h in LIGHT_HEIGHTS:
        commits[h].signatures = [
            dataclasses.replace(cs, signature=next(signed))
            for cs in commits[h].signatures
        ]
    return {h: LightBlock(SignedHeader(headers[h], commits[h]), sets[h])
            for h in LIGHT_HEIGHTS}, items


def _with_tampered_signature(lb, idx):
    """``lb`` with one byte of commit signature ``idx`` flipped."""
    commit = lb.signed_header.commit
    sigs = list(commit.signatures)
    cs = sigs[idx]
    sigs[idx] = dataclasses.replace(
        cs, signature=cs.signature[:40] + bytes([cs.signature[40] ^ 1])
        + cs.signature[41:])
    return dataclasses.replace(lb, signed_header=dataclasses.replace(
        lb.signed_header, commit=dataclasses.replace(commit, signatures=sigs)))


def phase_light(torch, pool, card, slice_cache):
    from cometbft_tpu_torch import light
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov

    t0 = time.perf_counter()
    blocks, items = make_light_chain(pool)
    per_commit = 2 * LIGHT_GROUP
    for j in range(0, len(items), max(1, len(items) // 12)):
        h, i = LIGHT_HEIGHTS[j // per_commit], j % per_commit
        cs = blocks[h].signed_header.commit.signatures[i]
        pub = blocks[h].validator_set.validators[i].pub_key.data
        check(ref.verify(pub, items[j][1], cs.signature),
              f"signer: {h}/{i}")
    emit({"phase": "light.chain", "heights": list(LIGHT_HEIGHTS),
          "validators": [len(blocks[h].validator_set) for h in LIGHT_HEIGHTS],
          "signatures": len(items), "keys": 4 * LIGHT_GROUP,
          "seconds": time.perf_counter() - t0})

    class ChainProvider(light.Provider):
        def __init__(self, chain):
            self.chain = chain
            self.fetched = []

        def chain_id(self):
            return CHAIN_ID

        def light_block(self, height):
            self.fetched.append(height)
            if height not in self.chain:
                raise light.LightBlockNotFoundError(height)
            return self.chain[height]

    class TimedVerifier(light.CommitVerifier):
        """The commit checks, each timed on the host clock (the verdicts
        are read back inside the call) with its launches and arena use."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.calls = []

        def _timed(self, check_name, height, fn, *args):
            before = dict(cuda_verify.LAUNCHES)
            c = self.pubkey_cache
            stats0 = cache_stats(c) if c is not None else {}
            t = time.perf_counter()
            error = None
            try:
                fn(*args)
            except Exception as e:
                error = f"{type(e).__name__}: {e}"
                raise
            finally:
                self.calls.append({
                    "check": check_name, "height": height,
                    "ms": 1e3 * (time.perf_counter() - t),
                    "launches": {k: v - before[k] for k, v
                                 in cuda_verify.LAUNCHES.items()
                                 if v != before[k]},
                    "arena": {k: v - stats0[k] for k, v
                              in cache_stats(c).items()} if c else None,
                    "error": error and error[:160],
                })

        def verify_commit_light(self, chain_id, vals, block_id, height,
                                commit):
            self._timed("light", height, super().verify_commit_light,
                        chain_id, vals, block_id, height, commit)

        def verify_commit_light_trusting(self, chain_id, vals, commit,
                                         trust_level):
            self._timed("trusting", commit.height,
                        super().verify_commit_light_trusting, chain_id, vals,
                        commit, trust_level)

    now_ns = LIGHT_T0_NS + LIGHT_HEIGHTS[-1] * 10**9 + 10**9
    trust = light.TrustOptions(LIGHT_PERIOD_NS, 1000, blocks[1000].hash())

    def replay(mode, chain, cache):
        provider = ChainProvider(chain)
        cv = TimedVerifier(device="cuda", flavor="8", pubkey_cache=cache)
        before = dict(cuda_verify.LAUNCHES)
        t = time.perf_counter()
        client = light.Client(CHAIN_ID, trust, provider, commit_verifier=cv)
        error = None
        try:
            lb = client.verify_light_block_at_height(1010, now_ns)
            check(lb.height == 1010, f"{mode}: got height {lb.height}")
        except light.VerificationFailedError as e:
            error = e
        seconds = time.perf_counter() - t
        trace = [b.height for b in client.latest_trace] if error is None \
            else None
        for call in cv.calls:
            emit({"phase": "light.call", "mode": mode, **call, "card": card})
        emit({"phase": "light.replay", "mode": mode, "ms": 1e3 * seconds,
              "trace": trace, "fetched": provider.fetched,
              "launches": {k: v - before[k] for k, v
                           in cuda_verify.LAUNCHES.items()},
              "arena": cache_stats(cache) if cache is not None else None,
              "error": None if error is None else {
                  "type": type(error).__name__,
                  "from_height": error.from_height,
                  "to_height": error.to_height,
                  "reason": f"{type(error.reason).__name__}: "
                            f"{error.reason}"[:200]},
              "card": card})
        return trace, provider.fetched, cv.calls, error

    expected_calls = [("light", 1000), ("trusting", 1010), ("trusting", 1009),
                      ("light", 1009), ("light", 1010)]
    fresh = ov.PubkeyTableCache(device="cuda")
    torch.cuda.synchronize()
    cuda_verify.reset_launches()  # the light path starts here
    for mode, cache in (("cache on", fresh), ("cache off", None),
                        ("cache shared with the slice phase", slice_cache)):
        evictions0 = cache.evictions if cache is not None else 0
        # off: no cache given and the process-wide one turned off
        with env("COMETBFT_TPU_PUBKEY_CACHE", "1" if cache else "0"):
            trace, fetched, calls, error = replay(mode, blocks, cache)
        check(error is None, f"{mode}: replay failed: {error}")
        check(trace == [1000, 1009, 1010], f"{mode}: trace {trace}")
        check(fetched == [1000, 1010, 1009], f"{mode}: fetched {fetched}")
        check([(c["check"], c["height"]) for c in calls] == expected_calls,
              f"{mode}: checks {calls}")
        check("got 0," in (calls[1]["error"] or ""),
              f"{mode}: 1000 -> 1010 found trusted power: {calls[1]}")
        for c in calls[:1] + calls[2:]:
            check(c["error"] is None, f"{mode}: {c}")
        if cache is slice_cache:
            check(cache.evictions > evictions0,
                  "the shared arena did not evict")
    tampered = dict(blocks)
    tampered[1010] = _with_tampered_signature(blocks[1010], TAMPERED)
    _, _, _, error = replay("tampered, cache on", tampered, fresh)
    check(error is not None and (error.from_height, error.to_height)
          == (1009, 1010) and f"(#{TAMPERED})" in str(error.reason),
          f"tampered replay: {error!r}")
    launches = dict(cuda_verify.LAUNCHES)  # read just after the light path
    lanes = check_lanes(cuda_verify, "light")
    for name in LIGHT_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the light path")
    for name in set(launches) - set(LIGHT_KERNELS):
        check(launches[name] == 0, f"{name} launched on the 8-bit path")
    emit({"phase": "light", "launches": launches, "lanes": lanes,
          "fresh_cache": cache_stats(fresh),
          "shared_cache": cache_stats(slice_cache)})

    # where a replay's host time goes outside its commit checks: the block
    # checks hash 10,000-validator sets and walk 10,000-signature commits
    # (host clock, one call each)
    lb = blocks[1010]
    steps = {}
    for step, fn in (
        ("validator_set_hash_ms", lb.validator_set.hash),
        ("header_hash_ms", lb.signed_header.header.hash),
        ("commit_validate_basic_ms", lb.signed_header.commit.validate_basic),
        ("light_block_validate_basic_ms",
         lambda: lb.validate_basic(CHAIN_ID)),
    ):
        t = time.perf_counter()
        fn()
        steps[step] = 1e3 * (time.perf_counter() - t)
    emit({"phase": "light.breakdown", "validators": len(lb.validator_set),
          **steps, "card": card})
    # the card's busy and idle share of one warm replay (cache on)
    host_ms, busy_ms, events = device_busy_ms(
        torch, lambda: replay("cache on, warm, profiled", blocks, fresh))
    emit({"phase": "light.trace", "mode": "cache on, warm, profiled",
          "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": events,
          "idle_share": 1 - busy_ms / host_ms if events else None,
          "card": card})
    return launches, lanes


# ------------------------------------------------------------------- vote
# The steady-state vote path: Vote.verify, VoteSet.add_vote and
# add_votes_batch through a pushed VerifyCoalescer(device="cuda").
SWEEP_LANES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
VOTE_THREADS = 64  # single-vote callers of part 3
VOTE_TAMPERED = 2718
ROUND_VALIDATORS = 1_000  # BASELINE config 3
PEER_THREADS = 50
GOSSIP_CHUNK = 50
ROUND_TAMPERED = 777
SMALL_VALIDATORS = 150  # BASELINE config 2
SMALL_TAMPERED = 77


class WindowRecorder:
    """Records every launch of ops.verify's two launchers while it is
    entered: the kernel, its wire inputs and the verdicts read back, so
    that each device window of the vote path is held against the plain
    version on its own lanes afterwards (compare_windows). Given
    ``cuda_verify``, it records X1's launches too (the arena builds): their
    limbs in, their tables and ok bits out."""

    KERNELS = {"verify_rsk_async": "verify_kernel_cached",
               "verify_bytes_async": "verify_kernel"}

    def __init__(self, ov, cuda_verify=None):
        self.ov = ov
        self.cuda_verify = cuda_verify
        self.records = []
        self._saved = {}

    def __enter__(self):
        for name in self.KERNELS:
            self._saved[name] = getattr(self.ov, name)
            setattr(self.ov, name, self._wrap(name, self._saved[name]))
        if self.cuda_verify is not None:
            real = self._x1 = self.cuda_verify.build_pubkey_tables

            def recording_x1(y_a, sign_a):
                out = real(y_a, sign_a)
                self.records.append({
                    "kernel": "build_pubkey_tables", "lanes": y_a.shape[-1],
                    "y_a": y_a, "sign_a": sign_a, "got": out, "flavor": "4",
                    "device": y_a.device})
                return out
            self.cuda_verify.build_pubkey_tables = recording_x1
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ov, name, fn)
        if self.cuda_verify is not None:
            self.cuda_verify.build_pubkey_tables = self._x1

    def _wrap(self, name, real):
        def launcher(*args, **kwargs):
            flavor = kwargs.get("flavor")
            if name == "verify_rsk_async":
                buf, idxs, arena, arena_ok, n = args[:5]
                flavor = args[5] if len(args) > 5 else flavor
                rec = {"kernel": self.KERNELS[name], "lanes": n, "buf": buf,
                       "idxs": idxs, "arena": arena, "arena_ok": arena_ok,
                       "device": arena.device}
            else:
                buf, n = args[:2]
                flavor = args[3] if len(args) > 3 else flavor
                rec = {"kernel": self.KERNELS[name], "lanes": n, "buf": buf,
                       "device": args[2] if len(args) > 2
                       else kwargs.get("device", "cuda")}
            rec["flavor"] = self.ov.kernel_flavor(flavor)
            finish = real(*args, **kwargs)
            self.records.append(rec)

            def materialize():
                rec["got"] = out = finish()
                return out
            return materialize
        return launcher


def window_record(rec) -> dict:
    """What the vote phase prints of one recorded window."""
    return {"kernel": rec["kernel"], "lanes": rec["lanes"],
            "flavor": rec["flavor"], "read_back": "got" in rec,
            "mismatches": rec.get("mismatches")}


# Lanes a plain call takes in compare_windows: the plain versions' time
# goes to their launches more than to their lanes.
PLAIN_CHUNK = 1 << 16


def compare_windows(torch, records, err, mismatches):
    """Each recorded window against its kernel's plain version on the
    card, on the window's own wire rows (and arena): the elements that
    differ into rec["mismatches"] and ``mismatches``, the largest
    difference into ``err``. The plain versions' cost is their launches,
    not their lanes, so the windows that share an arena (or, uncached, a
    device) run through one plain call, each compared on its own slice.
    Returns {kernel: set of lane counts compared}."""
    import numpy as np

    from cometbft_tpu_torch.ops import curve
    from cometbft_tpu_torch.ops import verify as ov

    groups = collections.defaultdict(list)
    compared = collections.defaultdict(set)
    for rec in records:
        check("got" in rec, f"a {rec['kernel']} window was never read back")
        check(rec["flavor"] == "4", "the vote path runs the 4-bit flavor")
        if rec["kernel"] == "build_pubkey_tables":  # X1: tables, ok bits
            before = mismatches["build_pubkey_tables"]
            for got, plain in zip(rec["got"], curve.build_pubkey_tables(
                    rec["y_a"], rec["sign_a"])):
                tally(torch, err, mismatches, "build_pubkey_tables", got,
                      plain)
            rec["mismatches"] = mismatches["build_pubkey_tables"] - before
            compared["build_pubkey_tables"].add(rec["lanes"])
            continue
        key = id(rec["arena"]) if "arena" in rec else str(rec["device"])
        groups[(rec["kernel"], key)].append(rec)
    for (name, _), recs in groups.items():
        dev = recs[0]["device"]
        rows = torch.from_numpy(np.ascontiguousarray(np.concatenate(
            [r["buf"] for r in recs], axis=1))).to(dev)
        if name == "verify_kernel_cached":
            idxs = torch.from_numpy(np.concatenate(
                [np.asarray(r["idxs"], np.uint16) for r in recs])
                .view(np.int16)).to(dev)
        parts = []  # the plain version a chunk of lanes at a time
        for lo in range(0, rows.shape[1], PLAIN_CHUNK):
            hi = min(lo + PLAIN_CHUNK, rows.shape[1])
            if name == "verify_kernel_cached":
                parts.append(curve.verify_kernel_slots(
                    recs[0]["arena"], recs[0]["arena_ok"], idxs[lo:hi],
                    **ov._unpack_rsk_on_device(rows[:, lo:hi])).cpu())
            else:
                parts.append(curve.verify_kernel(
                    **ov.unpack_on_device(rows[:, lo:hi])).cpu())
        plain = torch.cat(parts)
        lo = 0
        for rec in recs:
            got = torch.from_numpy(np.asarray(rec["got"], bool))
            before = mismatches[name]
            tally(torch, err, mismatches, name, got,
                  plain[lo : lo + rec["lanes"]])
            rec["mismatches"] = mismatches[name] - before
            compared[name].add(rec["lanes"])
            lo += rec["lanes"]
    return compared


def run_vote_callers(votes, keys, threads):
    """Vote.verify(CHAIN_ID, key) of every vote from a pool of ``threads``:
    (per vote True, or False where it raised VoteError; host seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from cometbft_tpu_torch.types.vote import VoteError

    def one(i):
        try:
            votes[i].verify(CHAIN_ID, keys[i])
        except VoteError:
            return False
        return True

    t = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        verdicts = list(ex.map(one, range(len(votes))))
    return verdicts, time.perf_counter() - t


def commit_votes(commit, tampered=None):
    """The precommits a commit was made from, one Vote a signature; the
    one at ``tampered`` with a flipped signature byte."""
    from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.vote import Vote

    votes = []
    for i, cs in enumerate(commit.signatures):
        sig = cs.signature
        if i == tampered:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        votes.append(Vote(PRECOMMIT_TYPE, commit.height, commit.round,
                          commit.block_id, cs.timestamp_ns,
                          cs.validator_address, i, sig))
    return votes


def make_validators(pool, tag: bytes, n: int):
    """(ValidatorSet of n seeded keys, power 100; seed by address)."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    seeds = [_seed(tag, i) for i in range(n)]
    pubs = _pool_map(pool, _pubkey_chunk, seeds)
    vals = ValidatorSet([Validator(Ed25519PubKey(p), 100) for p in pubs])
    return vals, {Ed25519PubKey(p).address(): s for p, s in zip(pubs, seeds)}


def make_round_votes(pool, vals, seed_of, msg_type, block_id, tampered):
    """Every validator's signed vote of ``msg_type`` for ``block_id`` at
    HEIGHT, round 0; the one at ``tampered`` with a flipped byte."""
    from cometbft_tpu_torch.types.vote import Vote

    votes = [Vote(msg_type, HEIGHT, 0, block_id,
                  1_760_000_000_000_000_000 + 131 * i + msg_type,
                  v.address, i) for i, v in enumerate(vals.validators)]
    signed = _pool_map(pool, _sign_chunk, [
        (seed_of[v.validator_address], v.sign_bytes(CHAIN_ID))
        for v in votes])
    for i, (v, (_, sig)) in enumerate(zip(votes, signed)):
        v.signature = (sig if i != tampered else
                       sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
    return votes


def make_small_commit(pool, vals, seed_of, block_id):
    from cometbft_tpu_torch.types import block

    unsigned = [block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                                1_760_000_000_000_000_000 + 17 * i)
                for i, v in enumerate(vals.validators)]
    commit = block.Commit(HEIGHT, 0, block_id, unsigned)
    signed = _pool_map(pool, _sign_chunk, [
        (seed_of[cs.validator_address], commit.vote_sign_bytes(CHAIN_ID, i))
        for i, cs in enumerate(unsigned)])
    commit.signatures = [
        block.CommitSig(cs.block_id_flag, cs.validator_address,
                        cs.timestamp_ns, sig)
        for cs, (_, sig) in zip(unsigned, signed)]
    return commit


def crossing(sweep):
    """The first swept lane count at which the device window's median is
    below the host batch's, or None when the host wins at every count."""
    for n, host_ms, device_ms in sweep:
        if device_ms < host_ms:
            return n
    return None


def vote_sweep(torch, vals, commit):
    """host_batch.verify_many against one coalescer-shaped device window
    (native pack, arena lookup, K2 through a lane arena, readback) on the
    first n lanes of the prestaged commit, in turns, RUNS each: [(n, host
    median ms, device median ms)]."""
    from cometbft_tpu_torch.crypto import host_batch
    from cometbft_tpu_torch.ops import verify as ov

    pubs = [v.pub_key.data for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pubs))]
    sigs = [cs.signature for cs in commit.signatures]
    cache = ov.pubkey_cache("cuda")
    lanes = ov.LaneArena("cuda")

    def host(n):
        return host_batch.verify_many(pubs[:n], msgs[:n], sigs[:n])

    def device(n):
        buf, ok = ov.pack_bytes(pubs[:n], msgs[:n], sigs[:n])
        idxs, arena, arena_ok = cache.lookup(pubs[:n])
        return ov.verify_rsk_async(buf[32:], idxs, arena, arena_ok, n,
                                   lanes=lanes)() & ok

    sweep = []
    for n in SWEEP_LANES:
        check(all(host(n)) and bool(device(n).all()),
              f"sweep: a valid lane rejected at {n}")
        times = {"host": [], "device": []}
        for turn in range(RUNS):
            order = ("host", "device") if turn % 2 == 0 else ("device", "host")
            for side in order:
                t = time.perf_counter()
                (host if side == "host" else device)(n)
                times[side].append(1e3 * (time.perf_counter() - t))
        sweep.append((n, statistics.median(times["host"]),
                      statistics.median(times["device"])))
    return sweep


def _traced_votes(pubs, votes):
    """Worker: the 10,000 single-vote callers once more, through a warm
    pushed VerifyCoalescer(device="cuda") with the cut held at its seed,
    under torch.profiler: (host ms, card-busy ms, device events, windows
    on the card, windows, the cut)."""
    import torch

    os.environ["COMETBFT_TPU_ADAPTIVE_THRESHOLD"] = "0"

    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import coalesce
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.ops import verify as ov

    keys = [Ed25519PubKey(p) for p in pubs]
    ov.prestage_pubkeys(pubs, device="cuda")
    co = coalesce.VerifyCoalescer(device="cuda")
    co.start()
    coalesce.push_active(co)
    try:
        run_vote_callers(votes[:2000], keys[:2000], VOTE_THREADS)  # warm
        windows0, device0 = co.windows, co.device_windows
        traced = device_busy_ms(
            torch, lambda: run_vote_callers(votes, keys, VOTE_THREADS))
        return (*traced, co.device_windows - device0, co.windows - windows0,
                crypto_batch.host_batch_threshold("cuda"))
    finally:
        coalesce.pop_active(co)
        co.stop()


def phase_vote(torch, pool, card, vals, commit):
    """The steady-state vote path (see the module docstring, phase 6).
    Returns ({kernel: launches}, {kernel: {lanes: launches}}, the window
    comparisons' (err, mismatches))."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import coalesce, host_batch
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.types import block, canonical, validation
    from cometbft_tpu_torch.types.vote_set import VoteSet

    # 1. the native packer on the commit path: a warm default-argument
    # verify_commit, then both packers on its 10,000 lanes
    pubs = [v.pub_key.data for v in vals.validators]
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(len(pubs))]
    sigs = [cs.signature for cs in commit.signatures]
    t = time.perf_counter()
    validation.verify_commit(CHAIN_ID, vals, commit.block_id, HEIGHT, commit)
    commit_ms = 1e3 * (time.perf_counter() - t)
    packs = {}
    for name, fn in (("pack_bytes", ov.pack_bytes),
                     ("pack_bytes_plain", ov.pack_bytes_plain)):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            packs[name] = fn(pubs, msgs, sigs)
            times.append(1e3 * (time.perf_counter() - t))
        packs[name + "_ms"] = statistics.median(times)
    check(packs["pack_bytes"][0].tobytes() == packs["pack_bytes_plain"][0]
          .tobytes() and (packs["pack_bytes"][1]
                          == packs["pack_bytes_plain"][1]).all(),
          "native pack_bytes != the Python loop")
    emit({"phase": "vote.pack", "lanes": len(pubs),
          "verify_commit_ms": commit_ms,
          "pack_bytes_ms": packs["pack_bytes_ms"],
          "pack_bytes_plain_ms": packs["pack_bytes_plain_ms"],
          "bytes_equal": True, "card": card})

    # 2. the crossover sweep on the prestaged set
    sweep = vote_sweep(torch, vals, commit)
    cut = crossing(sweep)
    emit({"phase": "vote.sweep", "rows": [
        {"lanes": n, "host_ms": h, "device_ms": d} for n, h, d in sweep],
        "crossing_lanes": cut,
        "seed_host_batch_threshold": crypto_batch.HOST_BATCH_THRESHOLD,
        "card": card})

    # the sets of parts 4 and 5, made and prestaged before the path
    t0 = time.perf_counter()
    round_vals, round_seeds = make_validators(pool, b"round-validator",
                                              ROUND_VALIDATORS)
    round_bid = block.BlockID(hashlib.sha256(b"round-block").digest(),
                              block.PartSetHeader(1, hashlib.sha256(
                                  b"round-parts").digest()))
    rounds = {t: make_round_votes(pool, round_vals, round_seeds, t,
                                  round_bid, ROUND_TAMPERED)
              for t in (canonical.PREVOTE_TYPE, canonical.PRECOMMIT_TYPE)}
    small_vals, small_seeds = make_validators(pool, b"small-validator",
                                              SMALL_VALIDATORS)
    small_commit = make_small_commit(pool, small_vals, small_seeds, round_bid)
    small_bad = block.Commit(HEIGHT, 0, round_bid,
                             list(small_commit.signatures))
    cs = small_bad.signatures[SMALL_TAMPERED]
    small_bad.signatures[SMALL_TAMPERED] = block.CommitSig(
        cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
        cs.signature[:40] + bytes([cs.signature[40] ^ 1])
        + cs.signature[41:])
    with env("COMETBFT_TPU_PRESTAGE", "auto"):
        built = (crypto_batch.prestage_validators(round_vals),
                 crypto_batch.prestage_validators(small_vals))
    votes = commit_votes(commit, VOTE_TAMPERED)
    keys = [v.pub_key for v in vals.validators]
    want = host_batch.verify_many(
        pubs, [v.sign_bytes(CHAIN_ID) for v in votes],
        [v.signature for v in votes])
    check([i for i, ok in enumerate(want) if not ok] == [VOTE_TAMPERED],
          "host batch: the tampered vote is not the only invalid one")
    emit({"phase": "vote.sets", "round_validators": len(round_vals),
          "small_validators": len(small_vals), "prestage_builds": built,
          "seconds": time.perf_counter() - t0})

    def windows_of(co):
        return {"device_windows": co.device_windows,
                "host_windows": co.windows - co.device_windows,
                "lanes_by_window": {
                    tier: dict(sorted(c.items()))
                    for tier, c in co.window_lanes.items()},
                "flushes": co.flushes}

    torch.cuda.synchronize()
    cuda_verify.reset_launches()  # the vote path starts here
    with WindowRecorder(ov) as recorder:
        # 3. 10,000 single-vote callers under a pushed coalescer: with the
        # card's cut adapting (the default), then with it held at the seed
        for mode, adaptive in (("adaptive", "auto"), ("seed", "0")):
            co = coalesce.VerifyCoalescer(device="cuda")
            co.start()
            coalesce.push_active(co)
            fit0 = crypto_batch.crossover("cuda").fit_summary()
            try:
                with env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", adaptive):
                    got, seconds = run_vote_callers(votes, keys,
                                                    VOTE_THREADS)
                    cut = crypto_batch.host_batch_threshold("cuda")
            finally:
                coalesce.pop_active(co)
                co.stop()
            check(got == want,
                  "Vote.verify verdicts != host_batch.verify_many")
            check([i for i, ok in enumerate(got) if not ok]
                  == [VOTE_TAMPERED],
                  f"the tampered vote #{VOTE_TAMPERED} was not the one "
                  "rejected")
            if mode == "seed":
                check(co.device_windows > 0, "no vote window ran on the card")
            emit({"phase": "vote.callers", "mode": mode, "votes": len(votes),
                  "threads": VOTE_THREADS, "host_ms": 1e3 * seconds,
                  "rejected": [VOTE_TAMPERED], "cut_after": cut,
                  **windows_of(co), "fit_before": fit0,
                  "fit_after": crypto_batch.crossover("cuda").fit_summary(),
                  "launches": dict(cuda_verify.LAUNCHES),
                  "card": card})

        # 4. BASELINE config 3: a prevote and a precommit round of a
        # 1,000-validator set, add_vote from 50 peers, then add_votes_batch
        # in 50-vote gossip chunks on a second pair of sets
        from concurrent.futures import ThreadPoolExecutor

        def decision(fn):
            try:
                return (fn(), None)
            except Exception as e:  # the decision is the error's type
                return (False, type(e).__name__)

        for msg_type, rvotes in rounds.items():
            runs = {}
            for mode in ("add_vote", "add_votes_batch"):
                vs = VoteSet(CHAIN_ID, HEIGHT, 0, msg_type, round_vals)
                co = coalesce.VerifyCoalescer(device="cuda")
                co.start()
                coalesce.push_active(co)
                try:
                    t = time.perf_counter()
                    with ThreadPoolExecutor(PEER_THREADS) as ex:
                        if mode == "add_vote":
                            out = list(ex.map(
                                lambda v, vs=vs: decision(
                                    lambda: vs.add_vote(v)), rvotes))
                        else:
                            chunks = [rvotes[i : i + GOSSIP_CHUNK] for i in
                                      range(0, len(rvotes), GOSSIP_CHUNK)]
                            out = []
                            for added, errs in ex.map(vs.add_votes_batch,
                                                      chunks):
                                out += [(a, type(e).__name__ if e else None)
                                        for a, e in zip(added, errs)]
                    ms = 1e3 * (time.perf_counter() - t)
                finally:
                    coalesce.pop_active(co)
                    co.stop()
                check(vs.has_two_thirds_majority(),
                      f"{mode}: no 2/3 majority")
                runs[mode] = (out, vs)
                emit({"phase": "vote.round", "msg_type": msg_type,
                      "mode": mode, "votes": len(rvotes),
                      "threads": PEER_THREADS, "host_ms": ms,
                      "rejected": [i for i, (a, e) in enumerate(out) if e],
                      **windows_of(co),
                      "cut_after": crypto_batch.host_batch_threshold("cuda"),
                      "card": card})
            (single, vs1), (batched, vs2) = runs.values()
            check(single == batched, "add_vote and add_votes_batch decided "
                  "differently")
            check([i for i, (a, e) in enumerate(single) if e]
                  == [ROUND_TAMPERED] and single[ROUND_TAMPERED][1]
                  == "VoteError", f"round decisions: {single[:3]}")
            if msg_type == canonical.PRECOMMIT_TYPE:
                made = vs1.make_commit()
                check(made == vs2.make_commit(), "make_commit differs")
                t = time.perf_counter()
                validation.verify_commit(CHAIN_ID, round_vals, round_bid,
                                         HEIGHT, made)
                emit({"phase": "vote.round.commit", "signatures": sum(
                    1 for s in made.signatures if s.signature),
                      "verify_commit_ms": 1e3 * (time.perf_counter() - t),
                      "card": card})

        # 5. BASELINE config 2: a 150-validator commit unrouted, then
        # routed through a coalescer
        outcomes = {}
        for mode in ("unrouted", "routed"):
            co = None
            if mode == "routed":
                co = coalesce.VerifyCoalescer(device="cuda")
                co.start()
                coalesce.push_active(co)
            try:
                for tag, c in (("good", small_commit), ("tampered",
                                                        small_bad)):
                    before = sum(cuda_verify.LAUNCHES.values())
                    windows0 = co.windows if co is not None else 0
                    t = time.perf_counter()
                    try:
                        validation.verify_commit(CHAIN_ID, small_vals,
                                                 round_bid, HEIGHT, c)
                        error = None
                    except validation.VerificationError as e:
                        error = str(e)
                    ms = 1e3 * (time.perf_counter() - t)
                    on_card = sum(cuda_verify.LAUNCHES.values()) > before
                    tier = "device" if on_card else "host"
                    if co is not None and co.windows > windows0:
                        tier = f"coalescer ({tier} window)"
                    outcomes[(mode, tag)] = error
                    emit({"phase": "vote.small_commit", "mode": mode,
                          "commit": tag, "validators": SMALL_VALIDATORS,
                          "ms": ms, "tier": tier, "error": error,
                          "card": card})
            finally:
                if co is not None:
                    coalesce.pop_active(co)
                    co.stop()
        check(outcomes[("unrouted", "good")] is None
              and outcomes[("routed", "good")] is None,
              "the 150-validator commit was rejected")
        check(outcomes[("unrouted", "tampered")]
              == outcomes[("routed", "tampered")]
              and f"(#{SMALL_TAMPERED})" in outcomes[("routed", "tampered")],
              f"tampered 150-validator commit: {outcomes}")
    launches = dict(cuda_verify.LAUNCHES)  # read just after the vote path
    torch.cuda.synchronize()
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    compared = compare_windows(torch, recorder.records, err, mismatches)
    emit({"phase": "vote.windows", "windows": len(recorder.records),
          "compared": {k: sorted(v) for k, v in compared.items()},
          "mismatches": dict(mismatches), "max_abs_err": dict(err),
          "first_records": [window_record(r) for r in recorder.records[:8]]})
    check(not any(mismatches.values()),
          f"vote windows != plain: {mismatches}")
    lanes = check_lanes(cuda_verify, "vote", compared)
    check(launches["verify_kernel_cached"] > 0,
          "K2 was not launched on the vote path")
    for name in ("build_pubkey_tables", "verify_kernel8",
                 "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the vote path")
    emit({"phase": "vote", "launches": launches, "lanes": lanes,
          "windows_compared": len(recorder.records)})

    # the card's busy and idle share of part 3, warm, in a process of its
    # own (as the hash phase traces its routed steps)
    with get_context("spawn").Pool(1) as tracer:
        host_ms, busy_ms, events, dev_windows, windows, traced_cut = (
            tracer.apply(_traced_votes, (pubs, votes)))
        tracer.close()
        tracer.join()
    check(events > 0, "the traced vote callers ran nothing on the card")
    emit({"phase": "vote.trace", "step": "10,000 single-vote callers, "
          "cut held at the seed, warm, profiled", "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": events, "idle_share": 1 - busy_ms / host_ms,
          "device_windows": dev_windows, "windows": windows,
          "cut": traced_cut, "card": card})
    return launches, lanes, (err, mismatches)


MIXED_ED = 2_048  # BASELINE config 5: ed25519 validators ...
MIXED_SR = 2_048  # ... and sr25519 ones, equal power
MIXED_VALIDATORS = MIXED_ED + MIXED_SR
MIXED_HEIGHTS = tuple(HEIGHT + 1 + i for i in range(4))  # catch-up blocks
MIXED_LIGHT = 2 * MIXED_VALIDATORS // 3 + 1  # verify_commit_light's lanes
MIXED_SMALL = 6  # a batch below the seed cut: the host tier
MIXED_CHUNK = 50  # add_votes_batch's gossip chunk


def _sr_pubkey_chunk(minis):
    from cometbft_tpu_torch.crypto import sr25519

    return [sr25519.public_from_mini(m) for m in minis]


def _sr_sign_chunk(items):
    """Worker: [(mini secret, msg)] -> [sr25519 signature]."""
    from cometbft_tpu_torch.crypto import sr25519

    return [sr25519.sign(m, msg) for m, msg in items]


def make_mixed_commits(pool):
    """The seeded mixed set (MIXED_ED ed25519 and MIXED_SR sr25519 keys,
    power 100, in the set's order of power then address) and its
    precommits at each of MIXED_HEIGHTS, every validator signing: (vals,
    {height: commit}, seconds to sign)."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    ed_seeds = [_seed(b"mixed-ed", i) for i in range(MIXED_ED)]
    sr_minis = [_seed(b"mixed-sr", i) for i in range(MIXED_SR)]
    expanded = _pool_map(pool, _expand_chunk, ed_seeds)
    sr_pubs = _pool_map(pool, _sr_pubkey_chunk, sr_minis)
    secret = {}  # address -> ("ed", expanded key) or ("sr", mini)
    validators = []
    for key in expanded:
        pk = Ed25519PubKey(key[2])
        secret[pk.address()] = ("ed", key)
        validators.append(Validator(pk, 100))
    for mini, pub in zip(sr_minis, sr_pubs):
        pk = Sr25519PubKey(pub)
        secret[pk.address()] = ("sr", mini)
        validators.append(Validator(pk, 100))
    vals = ValidatorSet(validators)
    commits, ed_items, sr_items, where = {}, [], [], []
    for h in MIXED_HEIGHTS:
        bid = block.BlockID(
            hashlib.sha256(b"mixed-block %d" % h).digest(),
            block.PartSetHeader(1, hashlib.sha256(b"mixed-parts %d" % h)
                                .digest()))
        commit = block.Commit(h, 0, bid, [
            block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                            1_760_000_000_000_000_000 + 1_000_003 * h + 13 * i)
            for i, v in enumerate(vals.validators)])
        commits[h] = commit
        for i, v in enumerate(vals.validators):
            kind, key = secret[v.address]
            msg = commit.vote_sign_bytes(CHAIN_ID, i)
            (ed_items if kind == "ed" else sr_items).append((key, msg))
            where.append((h, i, kind))
    t = time.perf_counter()
    ed_sigs = iter(_pool_map(pool, _sign_expanded_chunk, ed_items))
    sr_sigs = iter(_pool_map(pool, _sr_sign_chunk, sr_items))
    seconds = time.perf_counter() - t
    sigs = {}
    for h, i, kind in where:
        sigs[(h, i)] = next(ed_sigs if kind == "ed" else sr_sigs)
    for h, commit in commits.items():
        commit.signatures = [
            block.CommitSig(cs.block_id_flag, cs.validator_address,
                            cs.timestamp_ns, sigs[(h, i)])
            for i, cs in enumerate(commit.signatures)]
    return vals, commits, seconds


def _tampered_commit(commit, idx):
    from cometbft_tpu_torch.types import block

    bad = block.Commit(commit.height, commit.round, commit.block_id,
                       list(commit.signatures))
    cs = bad.signatures[idx]
    sig = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    bad.signatures[idx] = block.CommitSig(cs.block_id_flag,
                                          cs.validator_address,
                                          cs.timestamp_ns, sig)
    return bad


def _mixed_verifier(vals, commit, lanes, device="cuda"):
    """A MixedBatchVerifier holding the first ``lanes`` of ``commit``."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    bv = crypto_batch.MixedBatchVerifier(device=device)
    for i in range(lanes):
        bv.add(vals.validators[i].pub_key,
               commit.vote_sign_bytes(CHAIN_ID, i),
               commit.signatures[i].signature)
    return bv


def mixed_breakdown(torch, vals, commit, lanes):
    """A warm mixed batch of the first ``lanes`` of ``commit``, each step
    on its own (host clock): sign bytes, the sr25519 lanes' Edwards
    encodings and challenges, the whole row pack (which includes the
    sr25519 step again, and pack_bytes on the ed25519 lanes), the arena
    lookup, and the device part (K2 and its readback)."""
    from cometbft_tpu_torch.crypto import sr25519
    from cometbft_tpu_torch.ops import verify as ov

    steps = {"lanes": lanes}
    t = time.perf_counter()
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i) for i in range(lanes)]
    steps["sign_bytes_ms"] = 1e3 * (time.perf_counter() - t)
    bv = _mixed_verifier(vals, commit, lanes)
    sr_idx = [i for i in range(lanes)
              if vals.validators[i].pub_key.type == "sr25519"]
    t = time.perf_counter()
    quads = sr25519.verification_encs_batch(
        [vals.validators[i].pub_key.data for i in sr_idx],
        [msgs[i] for i in sr_idx],
        [commit.signatures[i].signature for i in sr_idx])
    steps["sr_encs_and_challenges_ms"] = 1e3 * (time.perf_counter() - t)
    check(all(q is not None for q in quads), "an sr25519 lane was rejected")
    t = time.perf_counter()
    buf, host_ok, a_keys = bv._pack_rows()
    steps["row_pack_ms"] = 1e3 * (time.perf_counter() - t)
    cache = ov.pubkey_cache("cuda")
    t = time.perf_counter()
    idxs, arena, arena_ok = cache.lookup(a_keys)
    steps["arena_lookup_ms"] = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok = ov.verify_rsk_async(buf[32:], idxs, arena, arena_ok, lanes)()
    steps["device_ms"] = 1e3 * (time.perf_counter() - t)
    check(bool((ok & host_ok).all()), "breakdown: a valid lane rejected")
    steps["sr_lanes"] = len(sr_idx)
    return steps


def phase_mixed(torch, pool, card):
    """BASELINE config 5: a mixed ed25519 + sr25519 set through the batch
    verifier (see the module docstring, phase 7). Returns ({kernel:
    launches}, {kernel: {lanes: launches}}, the comparisons' (err,
    mismatches))."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import host_batch
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.types import canonical, validation
    from cometbft_tpu_torch.types.vote_set import VoteSet

    t0 = time.perf_counter()
    vals, commits, sign_s = make_mixed_commits(pool)
    types = [v.pub_key.type for v in vals.validators]
    check(types.count("sr25519") == MIXED_SR
          and types.count("ed25519") == MIXED_ED, "mixed set's key types")
    ed_bad = next(i for i in range(MIXED_VALIDATORS // 4, MIXED_VALIDATORS)
                  if types[i] == "ed25519")
    sr_bad = next(i for i in range(3 * MIXED_VALIDATORS // 4,
                                   MIXED_VALIDATORS)
                  if types[i] == "sr25519")
    h1 = MIXED_HEIGHTS[0]
    bad = {"ed25519": (ed_bad, _tampered_commit(commits[h1], ed_bad)),
           "sr25519": (sr_bad, _tampered_commit(commits[h1], sr_bad))}
    # the host tier's verdicts on the same quads, for runs 1-4
    host = {}
    for key, c in [(h, commits[h]) for h in MIXED_HEIGHTS] + [
            (kind, b) for kind, (_, b) in bad.items()]:
        host[key] = host_batch.verify_quads(
            _mixed_verifier(vals, c, MIXED_VALIDATORS, "cpu")._quads())
    check(all(all(host[h]) for h in MIXED_HEIGHTS),
          "host tier rejected a valid mixed commit")
    for kind, (idx, _) in bad.items():
        check([i for i, ok in enumerate(host[kind]) if not ok] == [idx],
              f"host tier: the tampered {kind} lane is not the one rejected")
    emit({"phase": "mixed.set", "validators": len(vals), "ed25519": MIXED_ED,
          "sr25519": MIXED_SR, "heights": list(MIXED_HEIGHTS),
          "interleaved_first_16": "".join(t[0] for t in types[:16]),
          "tampered": {k: v[0] for k, v in bad.items()},
          "sign_seconds": sign_s, "seconds": time.perf_counter() - t0,
          "card": card})

    runs = []  # (run, ms, launches, records of the run)
    recorder = WindowRecorder(ov, cuda_verify)

    def run(name, fn, cache_env="1", host_key=None):
        before = dict(cuda_verify.LAUNCHES)
        lanes_before = {k: collections.Counter(v)
                        for k, v in cuda_verify.LAUNCH_LANES.items()}
        first = len(recorder.records)
        error = None
        with env("COMETBFT_TPU_PUBKEY_CACHE", cache_env):
            t = time.perf_counter()
            try:
                fn()
            except validation.VerificationError as e:
                error = str(e)
            ms = 1e3 * (time.perf_counter() - t)
        launches = {k: v - before[k] for k, v in cuda_verify.LAUNCHES.items()
                    if v - before[k]}
        lanes = {k: dict(v - lanes_before[k])
                 for k, v in cuda_verify.LAUNCH_LANES.items()
                 if v - lanes_before[k]}
        runs.append((name, host_key, recorder.records[first:]))
        emit({"phase": "mixed.run", "run": name, "ms": ms,
              "launches": launches, "lanes": lanes, "error": error,
              "card": card})
        return error, launches, lanes

    def commit_call(h, fn=validation.verify_commit, c=None):
        return lambda: fn(CHAIN_ID, vals, commits[h].block_id, h,
                          c if c is not None else commits[h])

    torch.cuda.synchronize()
    cuda_verify.reset_launches()  # the mixed path starts here
    with env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"), \
            env("COMETBFT_TPU_KERNEL", "auto"), \
            env("COMETBFT_TPU_PRESTAGE", "auto"), recorder:
        # 1. verify_commit with the cache off: K1 at 4,096, cold and warm
        for mode in ("cold", "warm"):
            error, got, lanes = run(f"1 verify_commit cache off, {mode}",
                                    commit_call(h1), "0", h1)
            check(error is None and got.get("verify_kernel") == 1
                  and set(got) == {"verify_kernel"},
                  f"cache-off mixed commit: {error} {got}")
        # 2. prestaging (ed25519 keys only), then default-argument
        # verify_commit: X1 builds the sr25519 keys, K2 runs; then warm
        error, got, lanes = run(
            "2 prestage_validators",
            lambda: check(crypto_batch.prestage_validators(vals) == 1,
                          "prestaging built other than once"))
        check(lanes == {"build_pubkey_tables": {MIXED_ED: 1}},
              f"prestaging did not build the {MIXED_ED} ed25519 keys: "
              f"{lanes}")
        error, got, lanes = run("2 verify_commit default arguments, cold",
                                commit_call(h1), host_key=h1)
        check(error is None and lanes == {
            "build_pubkey_tables": {MIXED_SR: 1},
            "verify_kernel_cached": {MIXED_VALIDATORS: 1}},
            f"default mixed commit did not build the {MIXED_SR} sr25519 "
            f"keys and run K2: {error} {lanes}")
        error, got, lanes = run("2 verify_commit default arguments, warm",
                                commit_call(h1), host_key=h1)
        check(error is None and lanes == {
            "verify_kernel_cached": {MIXED_VALIDATORS: 1}},
            f"warm mixed commit did not run K2 alone: {error} {lanes}")
        # 3. verify_commit_light at the four heights, warm: K2 at 2,731
        for mode in ("first", "second"):
            for h in MIXED_HEIGHTS:
                error, got, lanes = run(
                    f"3 verify_commit_light height {h}, {mode}",
                    commit_call(h, validation.verify_commit_light),
                    host_key=h)
                check(error is None and lanes == {
                    "verify_kernel_cached": {MIXED_LIGHT: 1}},
                    f"light mixed commit at {h}: {error} {lanes}")
        # 4. one tampered ed25519 signature, then one sr25519: each named
        for kind, (idx, c) in bad.items():
            error, got, lanes = run(f"4 verify_commit tampered {kind}",
                                    commit_call(h1, c=c), host_key=kind)
            want = (f"wrong signature (#{idx}): "
                    f"{c.signatures[idx].signature.hex()}")
            check(error == want, f"tampered {kind} lane: {error!r}")
        # 5. the sr25519 half alone through Sr25519BatchVerifier
        sr_idx = [i for i, t in enumerate(types) if t == "sr25519"]

        def sr_half():
            bv = crypto_batch.Sr25519BatchVerifier()
            for i in sr_idx:
                bv.add(vals.validators[i].pub_key,
                       commits[h1].vote_sign_bytes(CHAIN_ID, i),
                       commits[h1].signatures[i].signature)
            ok, bits = bv.verify()
            check(ok and len(bits) == MIXED_SR, "the sr25519 half failed")
        for mode in ("cold", "warm"):
            error, got, lanes = run(f"5 Sr25519BatchVerifier, {mode}",
                                    sr_half)
            check(lanes == {"verify_kernel_cached": {MIXED_SR: 1}},
                  f"the sr25519 half did not run K2 alone: {lanes}")

        # 6. a 6-lane mixed batch, below the seed cut: the host tier
        def small():
            bv = _mixed_verifier(vals, commits[h1], MIXED_SMALL)
            ok, bits = bv.verify()
            check(ok and len(bits) == MIXED_SMALL, "the small batch failed")
        check(crypto_batch.host_batch_threshold("cuda") > MIXED_SMALL,
              "the cut is not above the small batch")
        error, got, lanes = run("6 MixedBatchVerifier, 6 lanes", small)
        check(not got, f"the 6-lane batch launched {got}")
        # 7. one height's precommits through add_votes_batch, 50 a chunk
        votes = commit_votes(commits[MIXED_HEIGHTS[-1]])
        vs = VoteSet(CHAIN_ID, MIXED_HEIGHTS[-1], 0, canonical.PRECOMMIT_TYPE,
                     vals)

        def gossip():
            for i in range(0, len(votes), MIXED_CHUNK):
                added, errs = vs.add_votes_batch(votes[i : i + MIXED_CHUNK])
                check(all(added) and not any(errs),
                      f"add_votes_batch chunk {i}: {errs}")
            check(vs.has_two_thirds_majority(), "no 2/3 majority")
        error, got, lanes = run("7 add_votes_batch, 50-vote chunks", gossip)
        cut = crypto_batch.host_batch_threshold("cuda")
        chunks = collections.Counter(  # the chunks at or above the cut
            n for n in (min(MIXED_CHUNK, len(votes) - i)
                        for i in range(0, len(votes), MIXED_CHUNK))
            if n >= cut)
        check(lanes == {"verify_kernel_cached": dict(chunks)},
              f"add_votes_batch launches {lanes}, chunks {dict(chunks)}")
        launches = dict(cuda_verify.LAUNCHES)  # read just after the path
        path_lanes = {k: dict(sorted(v.items()))
                      for k, v in cuda_verify.LAUNCH_LANES.items()}
        path_records = len(recorder.records)
        steps = [mixed_breakdown(torch, vals, commits[h1], n)
                 for n in (MIXED_VALIDATORS, MIXED_LIGHT)]
        for row in steps:
            emit({"phase": "mixed.breakdown", **row, "card": card})
        # the card's busy and idle share of one warm default-argument
        # verify_commit of the mixed set (host clock for the call, the
        # torch.profiler trace for the card)
        host_ms, busy_ms, events = device_busy_ms(torch, commit_call(h1))
        emit({"phase": "mixed.trace", "call": "verify_commit", "mode":
              "default arguments, warm, profiled", "host_ms": host_ms,
              "device_busy_ms": busy_ms, "device_events": events,
              "idle_share": 1 - busy_ms / host_ms if events else None,
              "card": card})
    torch.cuda.synchronize()

    # every recorded launch against its plain version; runs 1-4's device
    # verdicts against the host tier's on the same quads
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    compared = compare_windows(torch, recorder.records, err, mismatches)
    host_lanes = 0
    for name, key, recs in runs:
        for rec in recs:
            if key is None or rec["kernel"] == "build_pubkey_tables":
                continue
            want = host[key][: rec["lanes"]]
            check(list(map(bool, rec["got"])) == want,
                  f"{name}: device verdicts != host_batch.verify_quads")
            host_lanes += rec["lanes"]
    emit({"phase": "mixed.windows", "launches_recorded": path_records,
          "with_breakdown": len(recorder.records),
          "compared": {k: sorted(v) for k, v in compared.items()},
          "mismatches": dict(mismatches), "max_abs_err": dict(err),
          "lanes_held_against_host_tier": host_lanes})
    check(not any(mismatches.values()),
          f"mixed launches != plain: {mismatches}")
    check_lanes(cuda_verify, "mixed", compared)  # the breakdown's too
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        check(launches[name] > 0, f"{name} was not launched on the mixed "
              "path")
    for name in ("verify_kernel8", "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the mixed path")
    emit({"phase": "mixed", "launches": launches, "lanes": path_lanes,
          "seconds": time.perf_counter() - t0})
    return launches, path_lanes, (err, mismatches)


# ------------------------------------------------------------------ rlc

RLC_HEIGHTS = tuple(HEIGHT + i for i in range(4))  # blocksync catch-up
RLC_SMALL = (5, 13)  # lanes of the bucket-8 and bucket-16 batches
RLC_BAD_LANE = 3  # the lane spoiled in the small check batches
RLC_TAMPERED = 2024  # on the path: a tampered signature's lane ...
RLC_UNDECODABLE = 3141  # ... an R that does not decode ...
RLC_SHORT = 5926  # ... and a signature cut short (host-malformed)
RLC_SEED = 10


_CATCHUP: dict = {}


def make_catchup_commits(pool, vals, commit):
    """The slice phase's set signing precommits at RLC_HEIGHTS: ``commit``
    at HEIGHT, seeded blocks at the next three ({height: commit}, seconds
    to sign). Signed once per (set, commit): the mesh phase reuses the
    rlc phase's."""
    key = (id(vals), id(commit))
    if key not in _CATCHUP:
        _CATCHUP[key] = (vals, commit, _make_catchup_commits(pool, vals,
                                                             commit))
    return _CATCHUP[key][2]


def _make_catchup_commits(pool, vals, commit):
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types import block

    seeds = [_seed(b"validator", i) for i in range(N_VALIDATORS)]
    expanded = _pool_map(pool, _expand_chunk, seeds)
    key_of = {Ed25519PubKey(key[2]).address(): key for key in expanded}
    commits, items = {HEIGHT: commit}, []
    for h in RLC_HEIGHTS[1:]:
        bid = block.BlockID(
            hashlib.sha256(b"catch-up block %d" % h).digest(),
            block.PartSetHeader(2, hashlib.sha256(b"catch-up parts %d" % h)
                                .digest()))
        commits[h] = block.Commit(h, 0, bid, [
            block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                            1_760_000_000_000_000_000 + 1_000_003 * h + 13 * i)
            for i, v in enumerate(vals.validators)])
        items += [(key_of[v.address], commits[h].vote_sign_bytes(CHAIN_ID, i))
                  for i, v in enumerate(vals.validators)]
    t = time.perf_counter()
    sigs = iter(_pool_map(pool, _sign_expanded_chunk, items))
    seconds = time.perf_counter() - t
    for h in RLC_HEIGHTS[1:]:
        commits[h].signatures = [
            block.CommitSig(cs.block_id_flag, cs.validator_address,
                            cs.timestamp_ns, next(sigs))
            for cs in commits[h].signatures]
    return commits, seconds


def commit_lanes(vals, commits):
    """(pubkeys, sign bytes, signatures) of every precommit of
    ``commits``, height after height."""
    pubs, msgs, sigs = [], [], []
    for c in commits:
        for i, cs in enumerate(c.signatures):
            pubs.append(vals.validators[i].pub_key.data)
            msgs.append(c.vote_sign_bytes(CHAIN_ID, i))
            sigs.append(cs.signature)
    return pubs, msgs, sigs


def msm_oracle(host_batch, folded) -> int:
    """The native engine's verdict on one folded batch equation
    (host_batch._msm_identity: 1 holds, 0 fails, below 0 a point does not
    decode), on the points and scalars X5 is given."""
    a_encs, a_sc, r_encs, r_sc, b = folded
    return host_batch._msm_identity(
        b"".join(list(a_encs) + list(r_encs) + [host_batch._B_ENC]),
        b"".join(s.to_bytes(32, "little")
                 for s in list(a_sc) + list(r_sc) + [b]),
        len(a_encs) + len(r_encs) + 1)


def _undecodable_r() -> bytes:
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    y = next(y for y in range(2, 300)
             if ref.decompress(y.to_bytes(32, "little")) is None)
    return y.to_bytes(32, "little")


def _spoil(lanes, idx, how):
    """``lanes`` with lane ``idx``'s signature tampered (a byte of S
    flipped), its R undecodable, or cut short."""
    pubs, msgs, sigs = (list(x) for x in lanes)
    sig = sigs[idx]
    sigs[idx] = {"tampered": sig[:40] + bytes([sig[40] ^ 1]) + sig[41:],
                 "undecodable": _undecodable_r() + sig[32:],
                 "short": sig[:63]}[how]
    return pubs, msgs, sigs


def x5_compare(rlc, inp, got, plain) -> dict:
    """X5's parts (window sums, pre-cofactor total, bool) against the
    plain version's, points as encodings: the differing ones, and the
    bools' difference."""
    diff = 0
    for i in range(3):
        g = got[i] if i < 2 else got[i][:, :, None]
        p = plain[i] if i < 2 else plain[i][:, :, None]
        diff += sum(a != b for a, b in zip(rlc.encode(g), rlc.encode(p)))
    err = abs(int(bool(got[3])) - int(bool(plain[3])))
    return {"mismatches": diff + err, "max_abs_err": err,
            "x5": bool(got[3]), "plain": bool(plain[3])}


def check_x5(torch, lanes10, lanes40):
    """X5 against its plain version on the card (the rlc kernels check),
    the native MSM and the ZIP-215 verdicts. Returns (the comparisons'
    totals, the (A bucket, R bucket) shapes compared, which are the ones
    X5 may run at on the path, and the two full-width batches as (launch
    inputs, lanes))."""
    import numpy as np

    from cometbft_tpu_torch.crypto import host_batch
    from cometbft_tpu_torch.ops import cuda_rlc, rlc
    from cometbft_tpu_torch.ops import verify as ov

    dev = ov.resolve_device("cuda")
    rng = np.random.default_rng(RLC_SEED)
    totals = {"mismatches": 0, "max_abs_err": 0, "launches": 0}
    shapes, full = set(), []

    def case(name, lanes, expect, undecodable_zero=False):
        buf, host_ok = ov.pack_bytes(*lanes)
        folded = rlc.fold(buf, host_ok, rng.bytes(16 * int(host_ok.sum())))
        if undecodable_zero:  # one more R, undecodable, of scalar 0: the
            # sums still hold, so only the ok bit can fail the equation
            a_encs, a_sc, r_encs, r_sc, b = folded
            folded = (a_encs, a_sc, r_encs + [_undecodable_r()], r_sc + [0],
                      b)
        inp = rlc.to_device(rlc.launch_inputs(*folded), dev)
        got = cuda_rlc.rlc_equation(**inp, parts=True)
        plain = rlc._rlc_parts(**inp)
        line = x5_compare(rlc, inp, got, plain)
        oracle = msm_oracle(host_batch, folded)
        shape = (inp["y_a"].shape[1], inp["y_r"].shape[1])
        emit({"phase": "rlc.kernels", "case": name, "lanes": len(lanes[0]),
              "shape": list(shape), **line, "oracle": oracle,
              "expect": expect})
        check(line["mismatches"] == 0, f"X5 != plain on {name}")
        check(line["x5"] == (oracle == 1) == expect,
              f"X5 {line['x5']}, oracle {oracle}, expected {expect}: {name}")
        totals["mismatches"] += line["mismatches"]
        totals["max_abs_err"] = max(totals["max_abs_err"],
                                    line["max_abs_err"])
        totals["launches"] += 1
        shapes.add(shape)
        return inp

    with torch.no_grad():
        for n in RLC_SMALL:
            small = tuple(x[:n] for x in lanes10)
            case(f"{n} lanes", small, True)
        small = tuple(x[:RLC_SMALL[1]] for x in lanes10)
        case("undecodable R", _spoil(small, RLC_BAD_LANE, "undecodable"),
             False)
        case("tampered signature", _spoil(small, RLC_BAD_LANE, "tampered"),
             False)
        case("undecodable R of scalar 0", small, False, undecodable_zero=True)
        # the ZIP-215 classes as one-lane batches: X5 one at a time, the
        # plain version on all of them at once (torch.func.vmap)
        eqs, names, expects, folded_all = [], [], [], []
        for name, pk, msg, sig, expect in zip215_corpus():
            buf, host_ok = ov.pack_bytes([pk], [msg], [sig])
            if not host_ok[0]:
                check(not expect, f"host rejected {name}")
                continue
            folded = rlc.fold(buf, host_ok, rng.bytes(16))
            eqs.append(rlc.to_device(rlc.launch_inputs(*folded), dev))
            names.append(name)
            expects.append(expect)
            folded_all.append(folded)
        keys = ("y_a", "sign_a", "plan_a", "y_r", "sign_r", "plan_r",
                "b_bytes")
        stacked = [tuple(torch.stack([e[k][i] for e in eqs])
                         for i in range(4)) if k.startswith("plan")
                   else torch.stack([e[k] for e in eqs]) for k in keys]
        c_a, c_r = eqs[0]["c_a"], eqs[0]["c_r"]
        check(all((e["c_a"], e["c_r"]) == (c_a, c_r) for e in eqs),
              "corpus equations differ in shape")
        plains = torch.func.vmap(
            lambda *a: rlc._rlc_parts(*a, c_a=c_a, c_r=c_r))(*stacked)
        corpus = {"classes": len(eqs), "mismatches": 0, "verdicts_wrong": []}
        for k, (inp, name, expect, folded) in enumerate(
                zip(eqs, names, expects, folded_all)):
            got = cuda_rlc.rlc_equation(**inp, parts=True)
            line = x5_compare(rlc, inp, got, tuple(p[k] for p in plains))
            oracle = msm_oracle(host_batch, folded)
            corpus["mismatches"] += line["mismatches"]
            totals["max_abs_err"] = max(totals["max_abs_err"],
                                        line["max_abs_err"])
            totals["launches"] += 1
            if not line["x5"] == (oracle == 1) == expect:
                corpus["verdicts_wrong"].append(name)
        shapes.add((eqs[0]["y_a"].shape[1], eqs[0]["y_r"].shape[1]))
        totals["mismatches"] += corpus["mismatches"]
        emit({"phase": "rlc.kernels", "case": "ZIP-215 corpus", **corpus})
        check(not corpus["mismatches"] and not corpus["verdicts_wrong"],
              f"X5 on the ZIP-215 corpus: {corpus}")
        for lanes, name in ((lanes10, f"{N_VALIDATORS} lanes"),
                            (lanes40, f"{len(lanes40[0])} lanes over "
                                      f"{N_VALIDATORS} keys")):
            full.append((case(name, lanes, True), lanes))

    return {"mismatches": totals["mismatches"],
            "max_abs_err": totals["max_abs_err"],
            "compared_launches": totals["launches"],
            "compared_shapes": sorted("%dx%d" % s for s in shapes)}, \
        shapes, full


# X5's chain models, in dependent field products (time_x5 prices them
# at the cycles of one). The yardstick is kept as it was first defined,
# so that the kernel's shares before and after its redesign stand on one
# bound: a four-launch MSM with runs of 32 buckets (decompress, bucket
# walks, runs, one finish that joins the runs and walks Horner).
# design_chain is the chain of X5 as csrc/rlc.cu builds it; bucket_walks
# repeats the kernel's split rule (x5_buckets) and must change with it.
YARDSTICK_RUN_BUCKETS = 32


def chain_products(plan_a, plan_r, c_a: int, c_r: int) -> int:
    """The dependent field products on the longest chain of an MSM of
    these plans as the yardstick walks it: a quad's add is two rounds of
    products, a doubling two, a conversion to Niels form one, and a
    thread's decompression 273 (the sqrt chain: 255 squarings, 18
    multiplications). The bucket walks run a warp to its longest segment;
    the runs and their join are fixed by the shapes, and the two Horner
    walks and [b]B run side by side."""
    from cometbft_tpu_torch.ops import rlc

    s = min(YARDSTICK_RUN_BUCKETS, 1 << (c_a - 1), 1 << (c_r - 1))
    add, dbl, niels = 2, 2, 1
    longest = 0
    horner = []
    stage_d = 0
    for plan, c, nbits in ((plan_a, c_a, rlc.A_BITS),
                           (plan_r, c_r, rlc.R_BITS)):
        starts, ends = plan[2], plan[3]
        seg = (ends - starts).reshape(-1, 8).max(axis=1)  # a warp's most
        longest = max(longest, int(seg.max()))
        w = rlc.windows(c, nbits)
        k = (1 << (c - 1)) // s
        # the runs' chain: run, niels, acc each turn; then [S] and one add
        stage_d = max(stage_d, (k - 1) * (add + niels + add) + niels
                      + int(math.log2(s)) * dbl + niels + add)
        horner.append((w - 1) * (c * dbl + niels + add))
    decompress = 273 + 2
    stage_b = longest * add + niels
    stage_c = s * (add + niels) + add + niels
    finish = max(max(horner), 32 * add) + 2 * (niels + add) + 3 * dbl + 1
    return decompress + stage_b + stage_c + stage_d + finish


def bucket_walks(plan) -> tuple[int, int]:
    """(the most points a warp's quads walk in X5's bucket stage, the tree
    levels that join a split bucket's parts there) for one side's numpy
    plan: a window whose digits fill only buckets 1..m / P (P = 8, 4, 2,
    the largest that fits) walks each of those buckets on P quads, each
    an even part of its segment."""
    import numpy as np

    starts, ends = plan[2], plan[3]
    w, m = starts.shape
    most, levels = 0, 0
    for j in range(w):
        split = next((f for f in (8, 4, 2)
                      if ends[j, m // f - 1] == ends[j, m - 1]), 1)
        idx = np.arange(m)
        v, part = idx // split, idx % split
        seg = (ends[j] - starts[j])[v].astype(np.int64)
        parts = seg * (part + 1) // split - seg * part // split
        warp_most = parts.reshape(-1, 8).max(axis=1)
        most = max(most, int(warp_most.max()))
        levels = max(levels, int(math.log2(split)))
    return most, levels


def design_chain(plan_a, plan_r, c_a: int, c_r: int) -> dict:
    """The dependent field products on each of X5's six stages for these
    plans, in chain_products' units, and their sum: the chain of X5 as it
    is built. The bucket stage walks a warp's longest part (bucket_walks)
    and joins split parts in a tree; a combine of n segments of L buckets
    walks n - 1 turns of run, Niels form and acc (the T sum beside it on
    its own warp), log2 L doublings and an add, and for a group the C
    total's add and both Niels forms; the join runs [b]B beside the
    windows (16 adds a warp and one to join them), the finish the two
    Horner walks side by side."""
    from cometbft_tpu_torch.ops import cuda_rlc, rlc

    s, f = cuda_rlc.run_buckets(c_a, c_r), cuda_rlc.group_runs(c_a, c_r)
    add, dbl, niels = 2, 2, 1
    buckets, groups, join, horner = 0, 0, 16 * add + niels + add, 0
    for plan, c, nbits in ((plan_a, c_a, rlc.A_BITS),
                           (plan_r, c_r, rlc.R_BITS)):
        most, levels = bucket_walks(plan)
        buckets = max(buckets, most * add + levels * (niels + add) + niels)
        g = (1 << (c - 1)) // (s * f)
        groups = max(groups, (f - 1) * (add + niels + add) + add
                     + int(math.log2(s)) * dbl + niels + add + niels)
        join = max(join, (g - 1) * (add + niels + add)
                   + int(math.log2(s * f)) * dbl + niels + add)
        horner = max(horner, (rlc.windows(c, nbits) - 1)
                     * (c * dbl + niels + add))
    out = {"decompress": 273 + 2, "buckets": buckets,
           "runs": s * (add + niels) + add + niels, "groups": groups,
           "join": join,
           "finish": horner + 2 * (niels + add) + 3 * dbl + 1}
    out["total"] = sum(out.values())
    return out


def time_x5(torch, card, full, lanes40):
    """X5 timed at both full widths (CUDA events around KERNEL_REPS
    launches, median of RUNS; its stages, cuda_rlc.STAGES, between
    events), beside the throughput bound (cuda_rlc.work), the chain bound
    (chain_products at the cycles of one dependent product: a
    turn of X1's squaring loop on fe26.cuh, at clock_probe's latencies and
    clock; and at one warp's issue of that turn), X5's own chain by stage
    (design_chain) at the same cycles and the share of the larger of it,
    the operations and the bytes, the plain version, and
    K2 on the same lanes: the kernel, one launch a height, and the host ms
    of a warm verify_batch. Returns the kernels line's row (the
    10,000-lane numbers of ``full``'s first batch, the 40,000-lane ones of
    its second under "at_40000")."""
    import numpy as np

    from cometbft_tpu_torch.ops import build, cuda_rlc, cuda_verify, rlc
    from cometbft_tpu_torch.ops import verify as ov

    dev = ov.resolve_device("cuda")
    probe = clock_probe(torch)
    sass = x1_sass(build.BUILD_INFO["build_tables.cu"]["path"], probe)
    product_cycles = sass["squaring"]["chain_cycles"]
    issue_cycles = sass["squaring"]["issue_cycles"]
    cache = ov.pubkey_cache("cuda")
    k2_lanes = []
    for h in range(len(lanes40[0]) // N_VALIDATORS):
        part = tuple(x[h * N_VALIDATORS:(h + 1) * N_VALIDATORS]
                     for x in lanes40)
        buf, _ = ov.pack_bytes(*part)
        idxs, arena, arena_ok = cache.lookup(part[0])
        k2_lanes.append((arena, arena_ok, ov._unpack_rsk_on_device(
            torch.from_numpy(buf[32:]).to(dev)), torch.from_numpy(
            np.asarray(idxs, np.uint16).view(np.int16)).to(dev)))

    def k2(count):
        return lambda: [cuda_verify.verify_kernel_cached(a, ok, **rsk, idxs=i)
                        for a, ok, rsk, i in k2_lanes[:count]]

    row, by_shape = {}, {}
    for inp, lanes in full:
        shape = (inp["y_a"].shape[1], inp["y_r"].shape[1])
        n = len(lanes[0])
        ms, _ = time_ms(torch, lambda: cuda_rlc.rlc_equation(**inp),
                        KERNEL_REPS)
        stages = []
        for _ in range(RUNS):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(cuda_rlc.STAGES) + 1)]
            cuda_rlc.rlc_equation(**inp, stage_events=ev)
            ev[-1].synchronize()
            stages.append([ev[i].elapsed_time(ev[i + 1])
                           for i in range(len(cuda_rlc.STAGES))])
        stage_ms = dict(zip(cuda_rlc.STAGES,
                            (statistics.median(s) for s in zip(*stages))))
        plain_ms = time_ms(torch, lambda: rlc._rlc_parts(**inp)[3])[0]
        plans = ([a.cpu().numpy() for a in inp["plan_a"]],
                 [a.cpu().numpy() for a in inp["plan_r"]],
                 inp["c_a"], inp["c_r"])
        ops, nbytes = cuda_rlc.work(*plans)
        ops_ms, bytes_ms = (1e3 * ops / PEAK_OPS_PER_S,
                            1e3 * nbytes / PEAK_BYTES_PER_S)
        products = chain_products(*plans)
        chain_ms = products * product_cycles / (probe["clock_ghz"] * 1e6)
        design = design_chain(*plans)
        design_ms = design["total"] * product_cycles / (
            probe["clock_ghz"] * 1e6)
        # the bound that holds for X5 as built: its own chain beside the
        # operations and the bytes (the yardstick's chain is longer)
        design_bound = max((ops_ms, "operations"), (bytes_ms, "bytes"),
                           (design_ms, "chain"))
        # the same chain at one warp's issue of each product: the floor
        # of X5's serial stages while one warp runs each
        issue_ms = products * issue_cycles / (probe["clock_ghz"] * 1e6)
        k2_ms = time_ms(torch, k2(n // N_VALIDATORS), KERNEL_REPS)[0]
        ov.verify_batch(*lanes)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok, _ = ov.verify_batch(*lanes)
        batch_ms = 1e3 * (time.perf_counter() - t)
        check(ok, "verify_batch rejected the full-width lanes")
        line = {"ms": ms, "stage_ms": stage_ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                "needed_products": ops // (2 * cuda_rlc.MULADDS_PER_PRODUCT),
                "op_ledger_products": rlc.op_ledger(shape[1], shape[0])[
                    "field_muls_total"],
                "chain_products": products, "chain_bound_ms": chain_ms,
                "warp_issue_ms": issue_ms,
                "design_chain_products": design,
                "design_chain_ms": design_ms,
                "bound_share": max(ops_ms, bytes_ms) / ms,
                "larger_bound_share": max(ops_ms, bytes_ms, chain_ms) / ms,
                "design_bound_ms": design_bound[0],
                "design_bound_by": design_bound[1],
                "design_bound_share": design_bound[0] / ms,
                "k2_ms": k2_ms, "k2_launches": n // N_VALIDATORS,
                "verify_batch_host_ms": batch_ms}
        emit({"phase": "rlc.time", "lanes": n, "shape": list(shape), **line,
              "product_cycles": product_cycles,
              "product_issue_cycles": issue_cycles,
              "clock_ghz": probe["clock_ghz"], "card": card})
        by_shape["%dx%d" % shape] = ms
        if n == N_VALIDATORS:
            row = dict(line)
        else:
            row["at_40000"] = line
    row["by_shape_ms"] = by_shape
    return row


def rlc_breakdown(torch, lanes):
    """A warm verify_batch_rlc on ``lanes``, each step on its own (host
    clock): pack, the fold loop, the encodings, the scalar rows, the
    plans, h2d, and the device part (X5 and its one-byte readback), with
    X5's stages (cuda_rlc.STAGES) between CUDA events."""
    import secrets

    import numpy as np

    from cometbft_tpu_torch.ops import cuda_rlc, rlc
    from cometbft_tpu_torch.ops import verify as ov

    dev = ov.resolve_device("cuda")
    steps = {"lanes": len(lanes[0])}
    t = time.perf_counter()
    buf, host_ok = ov.pack_bytes(*lanes)
    steps["pack_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    folded = rlc.fold(buf, host_ok,
                      secrets.token_bytes(16 * int(host_ok.sum())))
    steps["fold_ms"] = 1e3 * (time.perf_counter() - t)
    a_encs, a_sc, r_encs, r_sc, b = folded
    na, nr = rlc._bucket(len(a_encs)), rlc._bucket(len(r_encs))
    c_a, c_r = rlc.window_bits(na, rlc.A_BITS), rlc.window_bits(nr, rlc.R_BITS)
    t = time.perf_counter()
    y_a, sign_a = rlc._enc_arrays(a_encs, na)
    y_r, sign_r = rlc._enc_arrays(r_encs, nr)
    steps["encodings_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    rows_a, rows_r = rlc._scalar_rows(a_sc, na), rlc._scalar_rows(r_sc, nr)
    steps["scalar_rows_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    plan_a = rlc.plan_msm(rows_a, c_a, rlc.A_BITS)
    plan_r = rlc.plan_msm(rows_r, c_r, rlc.R_BITS)
    steps["plan_msm_ms"] = 1e3 * (time.perf_counter() - t)
    host = {"y_a": y_a, "sign_a": sign_a,
            "plan_a": tuple(plan_a[k] for k in rlc.PLAN_KEYS),
            "y_r": y_r, "sign_r": sign_r,
            "plan_r": tuple(plan_r[k] for k in rlc.PLAN_KEYS),
            "b_bytes": np.frombuffer(b.to_bytes(32, "little"),
                                     np.uint8).astype(np.int32)[:, None],
            "c_a": c_a, "c_r": c_r}
    torch.cuda.synchronize()
    t = time.perf_counter()
    inp = rlc.to_device(host, dev)
    torch.cuda.synchronize()
    steps["h2d_ms"] = 1e3 * (time.perf_counter() - t)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(len(cuda_rlc.STAGES) + 1)]
    t = time.perf_counter()
    ok = bool(cuda_rlc.rlc_equation(**inp, stage_events=ev))
    steps["device_ms"] = 1e3 * (time.perf_counter() - t)
    check(ok, "breakdown: the equation failed")
    steps["x5_stage_ms"] = dict(zip(
        cuda_rlc.STAGES, (ev[i].elapsed_time(ev[i + 1])
                          for i in range(len(cuda_rlc.STAGES)))))
    return steps


def phase_rlc(torch, pool, card, vals, commit):
    """The RLC batch equation (X5, see the module docstring, phase 8) on
    the slice phase's set and commit. Returns ({kernel: launches on the
    path, "rlc": X5's}, check_lanes' {kernel: {lanes: launches}} with
    X5's by shape under "rlc", X5's row of the kernels line)."""
    import numpy as np

    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import cuda_rlc, cuda_verify, rlc
    from cometbft_tpu_torch.ops import verify as ov

    t0 = time.perf_counter()
    commits, sign_s = make_catchup_commits(pool, vals, commit)
    lanes10 = commit_lanes(vals, [commit])
    lanes40 = commit_lanes(vals, [commits[h] for h in RLC_HEIGHTS])
    emit({"phase": "rlc.set", "validators": len(vals),
          "heights": list(RLC_HEIGHTS), "lanes": len(lanes40[0]),
          "sign_seconds": sign_s, "seconds": time.perf_counter() - t0,
          "card": card})
    row, compared, full = check_x5(torch, lanes10, lanes40)
    row.update(time_x5(torch, card, full, lanes40))
    # the attribution runs K2 on the process-wide arena: the set's keys
    # must be there (later phases may have evicted some)
    crypto_batch.prestage_validators(vals)
    torch.cuda.synchronize()

    def run(name, lanes, want_ok, named=()):
        before = dict(cuda_verify.LAUNCHES)
        x5_before = dict(cuda_rlc.LAUNCH_SHAPES["rlc"])
        t = time.perf_counter()
        ok, bitmap = rlc.verify_batch_rlc(*lanes)
        ms = 1e3 * (time.perf_counter() - t)
        launches = {k: v - before[k] for k, v in cuda_verify.LAUNCHES.items()
                    if v - before[k]}
        x5 = {"%dx%d" % s: n - x5_before.get(s, 0)
              for s, n in cuda_rlc.LAUNCH_SHAPES["rlc"].items()
              if n - x5_before.get(s, 0)}
        emit({"phase": "rlc.run", "run": name, "lanes": len(lanes[0]),
              "ms": ms, "ok": ok, "rejected": [int(i) for i in
                                                np.nonzero(~bitmap)[0]],
              "x5": x5, "launches": launches, "card": card})
        check(ok == want_ok and sorted(np.nonzero(~bitmap)[0].tolist())
              == sorted(named), f"{name}: {ok}, rejected "
              f"{np.nonzero(~bitmap)[0].tolist()[:8]}, expected {named}")
        check(sum(x5.values()) == 1, f"{name}: X5 ran {x5}")
        return bitmap, launches

    # runs 3 and 4 and verify_batch's own bitmaps for them, taken before
    # the counts are zeroed: only verify_batch_rlc's launches count
    spoiled = []
    with torch.no_grad():
        for label, how, idx in (("3", "tampered", RLC_TAMPERED),
                                ("4", "undecodable", RLC_UNDECODABLE),
                                ("4", "short", RLC_SHORT)):
            lanes = _spoil(lanes10, idx, how)
            spoiled.append((label, how, idx, lanes,
                            ov.verify_batch(*lanes)[1]))
    torch.cuda.synchronize()
    attributed = 0  # K2 launches of the runs' attributions
    cuda_verify.reset_launches()
    cuda_rlc.reset_launches()  # the rlc path starts here
    with torch.no_grad():
        for label, lanes in (("1", lanes10), ("2", lanes40)):
            for mode in ("first", "second"):
                _, launches = run(f"{label} verify_batch_rlc, "
                                  f"{len(lanes[0])} lanes, {mode}", lanes,
                                  True)
                check(not launches, f"K1/K2/X1 ran beside X5: {launches}")
        for label, how, idx, lanes, want in spoiled:
            bitmap, launches = run(f"{label} verify_batch_rlc, {how} lane",
                                   lanes, False, (idx,))
            check(np.array_equal(bitmap, want),
                  f"{how}: the bitmap is not verify_batch's")
            if how != "short":  # the equation fails: verify_batch names it
                check(launches == {"verify_kernel_cached": 1},
                      f"{how}: the attribution ran {launches}")
                attributed += launches["verify_kernel_cached"]
            else:  # the host rejects it; X5 holds on the rest
                check(not launches, f"short: {launches}")
    launches = dict(cuda_verify.LAUNCHES)  # read just after the path
    launches["rlc"] = cuda_rlc.LAUNCHES["rlc"]
    lanes = check_lanes(cuda_verify, "rlc", rlc_compared=compared)
    check(launches["verify_kernel_cached"] == attributed,
          f"K2 ran {launches['verify_kernel_cached']} times on the rlc "
          f"path, the runs' attributions {attributed}")
    check(launches["rlc"] > 0, "X5 was not launched on the rlc path")
    for name in ("verify_kernel", "build_pubkey_tables", "verify_kernel8",
                 "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the rlc path")
    emit({"phase": "rlc", "launches": launches, "lanes": lanes,
          "seconds": time.perf_counter() - t0})
    for lanes_ in (lanes10, lanes40):
        emit({"phase": "rlc.breakdown", **rlc_breakdown(torch, lanes_),
              "card": card})
    # the card's busy and idle share of one warm 10,000-lane call, in a
    # process of its own: this one's profiler saw no device work here
    with get_context("spawn").Pool(1) as tracer:
        host_ms, busy_ms, events = tracer.apply(_traced_rlc, (lanes10,))
        tracer.close()
        tracer.join()
    check(events > 0, "the traced verify_batch_rlc ran nothing on the card")
    emit({"phase": "rlc.trace", "call": "verify_batch_rlc", "lanes":
          N_VALIDATORS, "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": events, "idle_share": 1 - busy_ms / host_ms,
          "card": card})
    return launches, lanes, row


def _traced_rlc(lanes):
    """Worker: verify_batch_rlc on ``lanes``, once to warm, then under
    torch.profiler: (host ms, card-busy ms, device events)."""
    import torch

    from cometbft_tpu_torch.ops import rlc

    check(rlc.verify_batch_rlc(*lanes)[0], "the traced batch failed")
    return device_busy_ms(torch, lambda: rlc.verify_batch_rlc(*lanes))


MESH_TAMPERED = 6_789  # the mesh phase's tampered lane, in both batches
# the mesh path's runs: (name, batch, mesh entries, commit axis); each
# entry is card 0, as XLA's virtual devices let one host play eight, and
# n_dev is the number of entries
MESH_RUNS = (("1x1", "commit", 1, 1), ("1x4", "commit", 4, 1),
             ("2x2", "commit", 4, 2), ("1x1", "catch-up", 1, 1),
             ("1x4", "catch-up", 4, 1))


class K1Timer:
    """Wraps cuda_verify.verify_kernel while entered: CUDA events around
    each launch on its device's stream, read by :meth:`device_ms` after a
    sync. Launches still count in the wrapper's own counters."""

    def __init__(self, torch, cuda_verify):
        self.torch, self.cv = torch, cuda_verify
        self.real = cuda_verify.verify_kernel
        self.events = []

    def __enter__(self):
        torch = self.torch

        def timed(*a, **k):
            dev = a[0].device
            stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                      else None)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = self.real(*a, **k)
            end.record(stream)
            self.events.append((start, end))
            return out

        self.cv.verify_kernel = timed
        return self

    def __exit__(self, *exc):
        self.cv.verify_kernel = self.real
        return False

    def device_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase_mesh(torch, pool, card, vals, commit):
    """The multi-device verify path (parallel/mesh.py, the sharded branch
    of ops/verify.verify_batch) on the slice phase's commit (10,000 lanes)
    and the rlc phase's catch-up batch (40,000 over the same keys), each
    with lane MESH_TAMPERED tampered. Returns ({kernel: launches on the
    path}, check_lanes' {kernel: {lanes: launches}})."""
    import numpy as np

    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.libs import accel, devstats
    from cometbft_tpu_torch.ops import cuda_rlc, cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    commits, _ = make_catchup_commits(pool, vals, commit)
    batches = {
        "commit": _spoil(commit_lanes(vals, [commit]), MESH_TAMPERED,
                         "tampered"),
        "catch-up": _spoil(commit_lanes(vals, [commits[h]
                                               for h in RLC_HEIGHTS]),
                           MESH_TAMPERED, "tampered"),
    }
    # the single-device route first, default arguments: on a one-card
    # machine it must not shard (K2 on the prestaged arena, no K1)
    crypto_batch.prestage_validators(vals)
    sharded_calls = []
    real_sharded = ov._verify_batch_sharded

    def spy(*a, **k):
        sharded_calls.append(len(a[0]))
        return real_sharded(*a, **k)

    want = {}
    ov._verify_batch_sharded = spy
    try:
        for key, lanes in batches.items():
            before = dict(cuda_verify.LAUNCHES)
            t = time.perf_counter()
            ok_all, bitmap = ov.verify_batch(*lanes)
            ms = 1e3 * (time.perf_counter() - t)
            launches = {k: v - before[k] for k, v in cuda_verify.LAUNCHES.items()
                        if v - before[k]}
            named = np.flatnonzero(~bitmap).tolist()
            emit({"phase": "mesh.single", "batch": key, "lanes": len(lanes[0]),
                  "ms": ms, "launches": launches, "rejected": named,
                  "sharded_calls": len(sharded_calls),
                  "cuda_devices": accel.cuda_device_count(), "card": card})
            check(not ok_all and named == [MESH_TAMPERED],
                  f"single-device {key}: rejected {named[:8]}")
            check(not sharded_calls and launches.get("verify_kernel_cached")
                  and not launches.get("verify_kernel"),
                  f"default-argument verify_batch ({key}) took {launches}, "
                  f"sharded calls {sharded_calls}")
            want[key] = bitmap
    finally:
        ov._verify_batch_sharded = real_sharded
    check(ov._shard_devices(torch.device("cuda")) is None,
          "a one-card machine must not shard")

    dev = torch.device("cuda", 0)
    pack_ms = []
    real_pack = ov.pack_inputs

    def timed_pack(*a):
        t = time.perf_counter()
        out = real_pack(*a)
        pack_ms.append(1e3 * (time.perf_counter() - t))
        return out

    torch.cuda.synchronize()
    cuda_verify.reset_launches()
    cuda_rlc.reset_launches()  # the mesh path starts here
    ov.pack_inputs = timed_pack
    try:
        for name, key, entries, commit_axis in MESH_RUNS:
            lanes = batches[key]
            mesh = pmesh.make_mesh([dev] * entries, commit_axis)
            k1_before = collections.Counter(
                cuda_verify.LAUNCH_LANES["verify_kernel"])
            io_before = devstats.counters()
            with K1Timer(torch, cuda_verify) as timer:
                t = time.perf_counter()
                ok_all, bitmap = ov._verify_batch_sharded(*lanes, entries,
                                                          mesh=mesh)
                ms = 1e3 * (time.perf_counter() - t)
            device_ms = timer.device_ms()
            io = {k: v - io_before[k] for k, v in devstats.counters().items()}
            k1 = dict(collections.Counter(
                cuda_verify.LAUNCH_LANES["verify_kernel"]) - k1_before)
            named = np.flatnonzero(~bitmap).tolist()
            n = len(lanes[0])
            # the least time the shards' K1 launches could take
            k1_bound = sum(c * bound(cuda_verify, "verify_kernel", w)[0]
                           for w, c in k1.items())
            emit({"phase": "mesh.run", "mesh": name, "batch": key,
                  "lanes": n, "entries": entries, "ms": ms,
                  "pack_inputs_ms": pack_ms[-1], "k1_device_ms": device_ms,
                  "k1_by_lanes": k1, "k1_bound_ms": k1_bound,
                  "k1_bound_share": k1_bound / device_ms if device_ms
                  else None, **io,
                  "h2d_bytes_a_lane": io["h2d_bytes"] / n,
                  "rejected": named, "card": card})
            check(np.array_equal(bitmap, want[key]) and not ok_all,
                  f"mesh {name} {key}: verdicts differ from verify_batch's")
            check(sum(k1.values()) == entries,
                  f"mesh {name} {key}: K1 ran {k1}, {entries} shards")
    finally:
        ov.pack_inputs = real_pack
    launches = dict(cuda_verify.LAUNCHES)  # read just after the path
    lanes = check_lanes(cuda_verify, "mesh")
    check(launches["verify_kernel"] == sum(r[2] for r in MESH_RUNS),
          f"K1 ran {launches['verify_kernel']} times on the mesh path")
    for name in set(launches) - {"verify_kernel"}:
        check(launches[name] == 0, f"{name} launched on the mesh path")
    emit({"phase": "mesh", "launches": launches, "lanes": lanes,
          "seconds": time.perf_counter() - t0})
    # the host packers on the same lanes: K1's limb arrays (680 B a lane
    # to the card) against the single-device wire (96 B and a 2 B slot)
    for key, lanes_ in batches.items():
        row = {}
        for packer in ("pack_inputs", "pack_bytes"):
            t = time.perf_counter()
            getattr(ov, packer)(*lanes_)
            row[packer + "_ms"] = 1e3 * (time.perf_counter() - t)
        emit({"phase": "mesh.pack", "batch": key, "lanes": len(lanes_[0]),
              **row, "h2d_bytes_a_lane": {"sharded": 680, "single": 98},
              "card": card})
    # the card's busy and idle share of one warm (1, 4) commit, in a
    # process of its own (as the rlc phase's)
    with get_context("spawn").Pool(1) as tracer:
        host_ms, busy_ms, events = tracer.apply(_traced_mesh,
                                                (batches["commit"],))
        tracer.close()
        tracer.join()
    check(events > 0, "the traced mesh run ran nothing on the card")
    emit({"phase": "mesh.trace", "mesh": "1x4", "lanes": N_VALIDATORS,
          "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": events, "idle_share": 1 - busy_ms / host_ms,
          "card": card})
    return launches, lanes


def _traced_mesh(lanes):
    """Worker: _verify_batch_sharded on ``lanes`` over a (1, 4) mesh of
    card 0, once to warm, then under torch.profiler: (host ms, card-busy
    ms, device events)."""
    import torch

    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh([torch.device("cuda", 0)] * 4)
    run = lambda: ov._verify_batch_sharded(*lanes, 4, mesh=mesh)  # noqa: E731
    check(not run()[0], "the traced mesh run accepted a tampered batch")
    return device_busy_ms(torch, run)


def make_hash_block():
    """The seeded block: its txs (BLOCK_BYTES / TX_BYTES of TX_BYTES) and
    their bytes, which the part set splits (the port has no block codec
    yet)."""
    import numpy as np

    data = np.random.default_rng(HASH_SEED).bytes(BLOCK_BYTES)
    return [data[i : i + TX_BYTES] for i in range(0, BLOCK_BYTES, TX_BYTES)], data


def x4_bound(ops: int, shift_logic: int, nbytes: int):
    """(least ms, "operations" or "bytes") of an X4 launch. Operations: its
    fewest 32-bit integer instructions (cuda_sha256.work), of which the
    shifts and LOP3s issue only on the integer pipe, at 64 a clock per SM
    (PEAK_OPS_PER_S / 2: that constant counts a multiply-add as two), and
    all of them at most one a clock per SM sub-partition, 128 a clock per
    SM, with the additions as IMADs on the FMA pipe. Against its bytes over
    the memory rate."""
    ops_ms = 1e3 * max(shift_logic / (PEAK_OPS_PER_S / 2),
                       ops / PEAK_OPS_PER_S)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# ------------------------------------------------------------------ SASS

# SHA-256's rotation and shift amounts: the message schedule's (sigma0,
# sigma1) and the rounds' (Sigma0, Sigma1) are disjoint, so a funnel shift
# in the SASS names its side by its amount
_SCHEDULE_ROT, _SCHEDULE_SHR = {7, 18, 17, 19}, {3, 10}
_ROUND_ROT = {2, 13, 22, 6, 11, 25}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def _shift_side(opcode: str, operands: str) -> str:
    """"schedule", "round" or "other" for one SHF: a funnel shift of a
    register with itself is a rotation (right by its amount, or left,
    i.e. right by 32 less it; with a constant amount below 32 the wrap and
    clamp forms agree), one with RZ a plain shift. An operand's ".reuse"
    (a register-reuse cache flag) is not part of the register."""
    ops = [o.strip().removesuffix(".reuse") for o in operands.split(",")]
    if len(ops) != 4 or not ops[2].startswith("0x"):
        return "other"
    n = int(ops[2], 16)
    if ops[1] == ops[3]:
        rot = n if ".R" in opcode else 32 - n
        return ("schedule" if rot in _SCHEDULE_ROT
                else "round" if rot in _ROUND_ROT else "other")
    if ops[1] == "RZ" and ".R" in opcode and n in _SCHEDULE_SHR:
        return "schedule"
    return "other"


_REG = re.compile(r"\b(UR|R|UP|P)(\d+)(\.64)?")
_NO_DEST = ("ST", "RED", "BRA", "EXIT", "BAR", "BSYNC", "BSSY", "WARPSYNC",
            "NOP", "CALL", "RET", "YIELD", "MEMBAR", "DEPBAR", "ERRBAR")


def _regs(operands, width=1):
    """The registers an operand list names, a 64-bit one (R4.64) or one of
    ``width`` as its first register and the next ones."""
    out = []
    for m in _REG.finditer(" ".join(operands)):
        wide = 2 if m.group(3) else (width if m.group(1) in "RUR" else 1)
        out += [f"{m.group(1)}{int(m.group(2)) + j}" for j in range(wide)]
    return out


def _dests_sources(opcode: str, operands: str):
    """(registers written, registers read) of one SASS instruction: the
    leading predicates and first register an instruction writes (with the
    carry-out predicates after it), both predicates of a *SETP or PLOP3;
    a .WIDE product writes and adds a register pair, a .64 or .128 load
    or store moves 2 or 4."""
    ops = [o.strip() for o in operands.split(",")] if operands.strip() else []
    base = opcode.split(".")[0]
    is_pred = lambda o: re.fullmatch(r"U?P(\d|T)", o) is not None
    width = 4 if ".128" in opcode else (2 if ".64" in opcode else 1)
    if base.startswith(_NO_DEST):
        if base.startswith("ST") and ops:
            return [], _regs(ops[:-1]) + _regs(ops[-1:], width)
        return [], _regs(ops)
    if "SETP" in base or base == "PLOP3":
        k = 2
    else:
        k = 0
        while k < len(ops) and is_pred(ops[k]):
            k += 1
        if k < len(ops) and re.fullmatch(r"U?R(\d+|Z)", ops[k]):
            k += 1
        while k < len(ops) and is_pred(ops[k]):
            k += 1
    if ".WIDE" in opcode:
        return (_regs(ops[:k], 2),
                _regs(ops[k:k + 2]) + _regs(ops[k + 2:k + 3], 2)
                + _regs(ops[k + 3:]))
    return _regs(ops[:k], width if base.startswith("LD") else 1), _regs(ops[k:])


def sass_depth(instrs, cost=lambda opcode: 1):
    """The longest chain of dependent instructions in [(addr, opcode,
    operands)], read through registers and predicates (a loop body: one
    turn, what enters it taken as ready): its instructions, or the sum of
    ``cost(opcode)`` along the costliest chain."""
    depth, best = {}, 0
    for _, op, operands in instrs:
        if op == "NOP":
            continue
        dests, srcs = _dests_sources(op, operands)
        d = cost(op) + max((depth.get(r, 0) for r in srcs), default=0)
        for r in dests:
            depth[r] = d
        best = max(best, d)
    return best


def _sass_summary(instrs, cost=None):
    """Counts over [(addr, opcode, operands)]: instructions (NOPs left
    out), by opcode, 64-bit-result multiply-adds, SHFs by side,
    constant-bank-3 operands (the __constant__ round constants), loads and
    stores, barriers, and the longest dependent chain (sass_depth), also
    in cycles where ``cost`` prices an opcode."""
    real = [(a, op, o) for a, op, o in instrs if op != "NOP"]
    by_op = collections.Counter(op.split(".")[0] for _, op, _ in real)
    shifts = collections.Counter(_shift_side(op, o) for _, op, o in real
                                 if op.startswith("SHF"))
    return {"instructions": len(real),
            "opcodes": dict(by_op.most_common()),
            "imad_wide": sum(op.startswith("IMAD.WIDE") for _, op, _ in real),
            "depth": sass_depth(real),
            **({"chain_cycles": sass_depth(real, cost)} if cost else {}),
            "shf_by_side": dict(shifts),
            "shf_other_sample": [
                f"{op} {o.strip()}" for _, op, o in real
                if op.startswith("SHF") and _shift_side(op, o) == "other"][:4],
            "const_bank3_operands": sum("c[0x3]" in o for _, _, o in real),
            "ldg": by_op["LDG"], "lds": by_op["LDS"], "sts": by_op["STS"],
            "bar": by_op["BAR"]}


def sass_report(lib_path, name_part: str, cost=None) -> dict:
    """``cuobjdump -sass`` of a built library: for each function whose
    name holds ``name_part``, _sass_summary of the whole function and of
    each loop (a backward branch: from its target to the branch)."""
    from cometbft_tpu_torch.ops import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name, instrs, labels, pending = {}, None, [], {}, []
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None and name_part in name:
                funcs[name] = (instrs, labels)
            name, instrs, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_LINE.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            instrs.append((addr, m.group(2), m.group(3)))
    report = {}
    for fname, (instrs, labels) in funcs.items():
        loops = []
        for addr, op, operands in instrs:
            if not op.startswith("BRA"):
                continue
            m = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", operands)
            target = (labels.get(m.group(1)) if m and m.group(1)
                      else int(m.group(2), 16) if m else None)
            if target is not None and target < addr:
                body = [i for i in instrs if target <= i[0] <= addr]
                loops.append({"from": target, "to": addr,
                              **_sass_summary(body, cost)})
        report[fname] = {**_sass_summary(instrs, cost), "loops": loops}
    return report


# clock_chain.cu's modes: the latency chain (adds, IMAD adds), the rate of
# one instruction in eight independent chains, the IMAD.WIDE chain
CLOCK_MODES = ("latency", "latency_imad_adds", "rate_shf", "rate_lop3",
               "rate_iadd3", "rate_imad", "rate_imad_wide",
               "latency_imad_wide")


def clock_probe(torch):
    """The SM clock and what one warp's integer instructions cost, from
    csrc/probes/clock_chain.cu, its cycles read with clock64() and each
    launch timed with CUDA events (the median of RUNS after a warm-up):
    "latency_cycles", the dependent-issue latency of a chain of funnel
    shifts, LOP3s and adds (and with IMAD adds; and of IMAD.WIDE.U32s),
    and "issue_cycles", the cycles one warp takes a SHF, LOP3, IADD3, IMAD
    or IMAD.WIDE.U32 when eight chains of it run side by side. Also the
    probe's SASS, so each mode's instructions can be checked."""
    from cometbft_tpu_torch.ops import build

    lib = build.load_all(["probes/clock_chain.cu"])["clock_chain"]
    run = lib.clock_chain_run
    run.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 3
    run.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    out = torch.empty(32, dtype=torch.int32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    turns = 20_000
    per, ghz = {}, []
    for mode, name in enumerate(CLOCK_MODES):
        samples = []
        for _ in range(RUNS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(dev).cuda_stream
            start.record()
            check(run(0x6A09E667, 0x3C6EF372, 0x510E527F, turns, mode,
                      out.data_ptr(), cycles.data_ptr(), stream) == 0,
                  "clock_chain launch")
            end.record()
            end.synchronize()
            samples.append((int(cycles.item()), start.elapsed_time(end)))
        samples = samples[1:]  # the first warms up
        instrs = turns * lib.clock_chain_steps(mode)
        per[name] = statistics.median(c for c, _ in samples) / instrs
        ghz.append(statistics.median(c / t / 1e6 for c, t in samples))
    so = build.BUILD_INFO["clock_chain.cu"]["path"]
    return {"latency_cycles": per["latency"],
            "latency_cycles_imad_adds": per["latency_imad_adds"],
            "latency_cycles_imad_wide": per["latency_imad_wide"],
            "issue_cycles": {k[5:]: v for k, v in per.items()
                             if k.startswith("rate_")},
            "clock_ghz": statistics.median(ghz),
            "sass": sass_report(so, "clock_")}


def x4_sass_counts(lib_path) -> dict:
    """X4's SASS, its uint16-count instantiation: the kernel's
    instructions and each loop that holds SHA-256's funnel shifts, with
    its role by the side of those shifts (the schedule's, the rounds' or
    both), its instructions and, for a loop of rounds, those over 64 (a
    round's share of one compression)."""
    report = sass_report(lib_path, "x4_sha256")
    name = next(n for n in report if "x4_sha256It" in n)
    loops = []
    for loop in report[name]["loops"]:
        sides = loop["shf_by_side"]
        rounds, sched = sides.get("round", 0), sides.get("schedule", 0)
        if not (rounds or sched):
            continue
        role = ("rounds and schedule" if rounds and sched
                else "rounds" if rounds else "schedule")
        row = {"role": role, **{k: loop[k] for k in (
            "instructions", "shf_by_side", "shf_other_sample",
            "const_bank3_operands", "ldg", "lds", "sts", "bar",
            "opcodes")}}
        if rounds:
            row["per_round"] = loop["instructions"] / 64
        loops.append(row)
    return {"function": name,
            "instructions": report[name]["instructions"], "loops": loops}


# X1's chain (csrc/build_tables.cu): A's decompression is 273 dependent
# field operations (the sqrt chain: 255 squarings and 18 multiplications
# from y^2 to the sqrt(-1) fix-up), then the table's 30 rounds of products,
# 13 turns of its loop (two rounds each) and 4 rounds outside it
X1_CHAIN_PRODUCTS = 273
X1_TABLE_TURNS = 15


def x1_sass(lib_path, probe) -> dict:
    """X1's SASS: the kernel's instructions, its squaring loop (the sqrt
    chain's fe_sq_n on fe26.cuh: a loop of 64-bit multiply-adds with no
    shuffle, the deepest of them) and its table loop (the one with the
    quad's shuffles), each with its instructions and its dependent chain,
    in instructions and in cycles at clock_probe's latencies (an
    IMAD.WIDE at its own, every other instruction at an integer add's or
    IMAD's: a shuffle's longer latency is not counted)."""
    wide = probe["latency_cycles_imad_wide"]
    other = max(probe["latency_cycles"], probe["latency_cycles_imad_adds"])
    report = sass_report(lib_path, "x1_build_tables",
                         lambda op: wide if op.startswith("IMAD.WIDE")
                         else other)
    name = next(iter(report))
    rate = probe["issue_cycles"]
    for lp in report[name]["loops"]:
        # one warp's issue of a turn: the FMA pipe's multiply-adds against
        # every other instruction at its rate (an IADD3's where unprobed)
        ops = lp["opcodes"]
        fma = (lp["imad_wide"] * rate["imad_wide"]
               + (ops.get("IMAD", 0) - lp["imad_wide"]) * rate["imad"])
        rest = sum(n * rate.get(op.lower(), rate["iadd3"])
                   for op, n in ops.items() if op != "IMAD")
        lp["issue_cycles"] = max(fma, rest)
    keys = ("instructions", "depth", "chain_cycles", "issue_cycles",
            "imad_wide", "opcodes")
    sq = [lp for lp in report[name]["loops"]
          if not lp["opcodes"].get("SHFL") and lp["imad_wide"] >= 40]
    table = [lp for lp in report[name]["loops"] if lp["opcodes"].get("SHFL")]
    pick = lambda loops: ({k: max(loops, key=lambda lp: lp["depth"])[k]
                           for k in keys} if loops else None)
    return {"function": name, "instructions": report[name]["instructions"],
            "squaring_loops": len(sq), "squaring": pick(sq),
            "table_loop": pick(table)}


def x1_lane_ms(sass, probe, key="chain_cycles") -> float:
    """One lane's 273 sqrt-chain operations at a turn of the squaring loop
    (fe26.cuh; a multiplication is no shorter) and its table's 30 rounds
    at 15 turns of the table loop, each turn priced by ``key`` of x1_sass,
    over the SM clock (clock_probe). With "chain_cycles" it is X1's chain
    bound, the least time one lane's dependent chain allows a launch;
    with "issue_cycles" what one warp takes to issue that stream."""
    cycles = (X1_CHAIN_PRODUCTS * sass["squaring"][key]
              + X1_TABLE_TURNS * sass["table_loop"][key])
    return cycles / (probe["clock_ghz"] * 1e6)


def x4_one_warp(torch, fn, leaves, clock_ghz, check_digests=True):
    """One warp's worth of part leaves (32 lanes of 1,025 blocks, so one
    warp of a one-thread-a-lane kernel, one warp pair of a specialised
    one) through ``fn(blocks, nblocks)``, timed with CUDA events: its ms
    and, at the SM clock clock_probe read in the same run, the cycles a
    compression takes on one lane's chain."""
    from cometbft_tpu_torch.ops import sha256 as osha

    dev = torch.device("cuda", 0)
    blocks, nblocks = osha.pack_messages(leaves[:32])
    b, nb = (torch.from_numpy(x).to(dev) for x in (blocks, nblocks))
    ms, state = time_ms(torch, lambda: fn(b, nb), KERNEL_REPS)
    got = osha._digests_from_state(state.cpu().numpy(), 32)
    check(not check_digests
          or got == [hashlib.sha256(m).digest() for m in leaves[:32]],
          "X4 one-warp launch != hashlib")
    compressions = int(nblocks.max())
    return {"lanes": 32, "compressions": compressions, "ms": ms,
            "cycles_per_compression":
                ms * clock_ghz * 1e6 / compressions}


def x4_chain_bound_ms(nblocks, bucket: int, probe) -> float:
    """The least time SHA-256's serial chain allows a launch: its largest
    count (clamped to the bucket) x 64 rounds x 3 dependent integer
    instructions (a funnel shift, a LOP3, an add) x their dependent-issue
    latency, over the SM clock (clock_probe)."""
    from cometbft_tpu_torch.ops import cuda_sha256

    longest = int(cuda_sha256.as_int64(nblocks).clamp(max=bucket).max())
    cycles = longest * 64 * 3 * probe["latency_cycles"]
    return cycles / (probe["clock_ghz"] * 1e6)


def _x4_inputs(leaves, txs):
    """[messages] for X4's kernels check: the padding edges, a fuzz of
    0-700 bytes, and one ragged batch at each of X4_PATH_SHAPES (the
    largest lane bucket full: a full window)."""
    import random

    rnd = random.Random(HASH_SEED)
    batches = [[rnd.randbytes(n) for n in PADDING_EDGES],
               [rnd.randbytes(rnd.randrange(0, 700)) for _ in range(64)]]
    for bb, lb in X4_PATH_SHAPES:
        n = lb if lb == X4_LANE_BUCKETS[-1] else lb // 2 + 1
        if bb == 2048:
            batches.append(leaves if lb == 512 else leaves[:n])
        elif bb == 64:
            batches.append(txs[:n])
        else:
            top = 64 * bb - 9  # the longest message of bb blocks
            low = 0 if bb == 1 else 56
            batches.append([rnd.randbytes(top)] + [
                rnd.randbytes(rnd.randrange(low, top + 1))
                for _ in range(n - 1)])
    return batches


def check_x4(torch, leaves, txs, card):
    """X4 against hashlib on every lane, and against its plain version on
    the card (one plain call per block bucket over that bucket's wires
    side by side: the plain version is launch-bound, so lanes come free),
    at every shape the hash path launches it; then timed at the part-leaf
    shape and at a full tx-key window beside its bound."""
    import numpy as np

    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import sha256 as osha

    dev = torch.device("cuda", 0)
    wires = {}
    for msgs in _x4_inputs(leaves, txs):
        t = time.perf_counter()
        blocks, nblocks = osha.pack_messages(msgs)
        pack_ms = 1e3 * (time.perf_counter() - t)
        shape = (blocks.shape[0], blocks.shape[2])
        check(shape not in wires, f"X4 inputs: shape {shape} twice")
        b = torch.from_numpy(blocks).to(dev)
        nb = torch.from_numpy(nblocks).to(dev)
        state = cuda_sha256.sha256(b, nb)
        got = osha._digests_from_state(state.cpu().numpy(), len(msgs))
        check(got == [hashlib.sha256(m).digest() for m in msgs],
              f"X4 != hashlib at {shape}")
        wires[shape] = dict(np=(blocks, nblocks), dev=(b, nb), state=state,
                            lanes=len(msgs), pack_ms=pack_ms)
    err = mismatches = 0
    plain_ms = {}
    for bb in sorted({s[0] for s in wires}):
        group = sorted(s for s in wires if s[0] == bb)
        cat_b = torch.from_numpy(np.concatenate(
            [wires[s]["np"][0] for s in group], axis=2)).to(dev)
        cat_nb = torch.from_numpy(np.concatenate(
            [wires[s]["np"][1].astype(np.int64) for s in group])).to(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = osha.sha256_plain(cat_b, cat_nb)
        end.record()
        end.synchronize()
        plain_ms[bb] = start.elapsed_time(end)
        # the helper every phase compares X4 with, itself held against
        # sha256_plain on these wires
        plain = check_plain_x4(torch, cat_b, cat_nb, f"block bucket {bb}",
                               ref)
        x4 = torch.cat([cuda_sha256.as_int64(wires[s]["state"])
                        for s in group], dim=1)
        diff = (x4 - cuda_sha256.as_int64(plain)).abs()
        err = max(err, int(diff.max()))
        mismatches += int((diff != 0).sum())
        emit({"phase": "kernels.x4", "block_bucket": bb,
              "lane_buckets": [s[1] for s in group],
              "lanes": [wires[s]["lanes"] for s in group],
              "real_blocks": int(cat_nb.sum()), "plain_ms": plain_ms[bb],
              "plain_lanes": int(cat_b.shape[2]), "mismatches": mismatches,
              "max_abs_err": err})
    check(mismatches == 0, f"X4 != plain: {mismatches} words differ")
    # block counts above the bucket B read as B: a wire of the padding
    # edges in front of random words, so a block read past B shows
    rng = np.random.default_rng(HASH_SEED)
    blocks, nblocks = osha.pack_messages(
        [rng.bytes(n) for n in PADDING_EDGES])
    bb, lanes = blocks.shape[0], blocks.shape[2]
    room = rng.integers(0, 2**32, (bb + 8, 16, lanes), dtype=np.uint32)
    room[:bb] = blocks
    wire = torch.from_numpy(room).to(dev)[:bb]
    over = nblocks.copy()
    over[::3] = bb + 1 + np.arange(len(over[::3])) % 8
    over_nb = torch.from_numpy(over).to(dev)
    diff = (cuda_sha256.as_int64(cuda_sha256.sha256(wire, over_nb))
            - cuda_sha256.as_int64(check_plain_x4(torch, wire, over_nb,
                                                  "the over-bucket wire")))
    emit({"phase": "kernels.x4.over_bucket", "block_bucket": bb,
          "lanes": lanes, "mismatches": int((diff != 0).sum())})
    check(not bool(diff.any()), "X4 read a block past its bucket")

    # what one warp issues (SASS) and how fast the chain goes: the SM
    # clock and an integer instruction's dependent-issue latency
    # (clock_probe), X4's cycles a compression on one warp of part leaves
    from cometbft_tpu_torch.ops import build

    sass = x4_sass_counts(build.BUILD_INFO["sha256.cu"]["path"])
    probe = clock_probe(torch)
    one_warp = x4_one_warp(torch, cuda_sha256.sha256, leaves,
                           probe["clock_ghz"])
    emit({"phase": "kernels.x4.sass", **sass})
    emit({"phase": "kernels.x4.clock", "latency_cycles":
          probe["latency_cycles"], "clock_ghz": probe["clock_ghz"],
          "chain_sass": probe["sass"], "one_warp": one_warp, "card": card})
    timed = {}
    for name, shape in (("part_leaves", (2048, 512)),
                        ("gossip_window", (2048, 8)),
                        ("tx_key_window", (64, 2048))):
        w = wires[shape]
        b, nb = w["dev"]
        ms, out = time_ms(torch, lambda: cuda_sha256.sha256(b, nb),
                          KERNEL_REPS)
        check(torch.equal(out.view(torch.int32), w["state"].view(torch.int32)),
              f"X4 {name}: timed output changed")
        bound_ms, bound_by = x4_bound(*cuda_sha256.work(nb, shape[0]))
        chain_ms = x4_chain_bound_ms(nb, shape[0], probe)
        timed[name] = {"block_bucket": shape[0], "lane_bucket": shape[1],
                       "lanes": w["lanes"], "real_blocks":
                       int(cuda_sha256.as_int64(nb).sum()), "ms": ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_share": bound_ms / ms,
                       "chain_bound_ms": chain_ms,
                       "chain_bound_share": chain_ms / ms}
        emit({"phase": "kernels.x4.time", "shape": name, **timed[name],
              "card": card})
    # the part leaves' wire, as from_data ships it: packed on the host,
    # then copied from pinned memory
    blocks, _ = wires[(2048, 512)]["np"]
    pinned = torch.from_numpy(blocks).pin_memory()
    h2d_ms = time_ms(torch, lambda: pinned.to(dev, non_blocking=True))[0]
    emit({"phase": "kernels.x4.wire", "shape": "part_leaves",
          "wire_bytes": blocks.nbytes,
          "real_bytes": 64 * timed["part_leaves"]["real_blocks"],
          "pack_ms": wires[(2048, 512)]["pack_ms"], "h2d_ms": h2d_ms,
          "h2d_gb_per_s": blocks.nbytes / h2d_ms / 1e6, "card": card})
    leaf = timed["part_leaves"]
    return set(wires), {
        "ms": leaf["ms"], "plain_ms": plain_ms[2048],
        "bound_ms": leaf["bound_ms"], "bound_by": leaf["bound_by"],
        "bound_share": leaf["bound_share"],
        "chain_bound_ms": leaf["chain_bound_ms"], "max_abs_err": err,
        "mismatches": mismatches, "ms_by_shape": {
            k: {"ms": v["ms"], "bound_ms": v["bound_ms"],
                "chain_bound_ms": v["chain_bound_ms"]}
            for k, v in timed.items()},
        "cycles_per_compression": one_warp["cycles_per_compression"],
        "round_loop_per_round": next(
            (lp["per_round"] for lp in sass["loops"] if "per_round" in lp),
            None),
    }


def _ingress(src):
    """(assembled bytes, the tampered part's rejection) of a fresh part set
    fed src's parts through add_part from INGRESS_THREADS threads at
    once, as gossip peers hand them over."""
    from concurrent.futures import ThreadPoolExecutor

    from cometbft_tpu_torch.types import part_set

    fresh = part_set.PartSet(src.header)

    def feed(k):
        for i in range(k, src.header.total, INGRESS_THREADS):
            check(fresh.add_part(src.get_part(i)), f"part {i} twice")

    with ThreadPoolExecutor(INGRESS_THREADS) as pool:
        list(pool.map(feed, range(INGRESS_THREADS)))
    good = src.get_part(17)
    bad = dataclasses.replace(good, bytes_=good.bytes_[:100] + bytes(
        [good.bytes_[100] ^ 1]) + good.bytes_[101:])
    try:
        part_set.PartSet(src.header).add_part(bad)
        rejected = None
    except part_set.PartSetError as e:
        rejected = str(e)
    return fresh.assemble(), rejected


def _traced_routed(step):
    """Worker: one routed step of the seeded block ("part_set_from_data"
    or "gossip_ingress") through a warm, pushed HashCoalescer(device=
    "cuda") under torch.profiler: (host ms, card-busy ms, device events,
    the plane's windows on the card and in all). The plane is warmed by
    one routed from_data first, which also makes the ingress's parts."""
    import torch

    from cometbft_tpu_torch.crypto import hashplane
    from cometbft_tpu_torch.types import part_set

    _, data = make_hash_block()
    co = hashplane.HashCoalescer(device="cuda")
    co.start()
    hashplane.push_active(co)
    try:
        ps = part_set.PartSet.from_data(data)
        fn = ((lambda: part_set.PartSet.from_data(data))
              if step == "part_set_from_data" else (lambda: _ingress(ps)))
        windows0, device0 = co.windows, co.device_windows
        traced = device_busy_ms(torch, fn)
        return (*traced, co.device_windows - device0, co.windows - windows0)
    finally:
        hashplane.pop_active(co)
        co.stop()


def phase_hash(torch, card, vals, commit):
    """The hash plane on a default block: make_block (Data.hash and the
    last commit's hash), PartSet.from_data, gossip ingress through
    add_part from INGRESS_THREADS threads, and ValidatorSet.hash, each
    unrouted (hashlib) and then with a fresh HashCoalescer(device="cuda")
    pushed at its default knobs; routed results must equal unrouted. The
    planes share the card's process-wide cuts (hashplane.crossover): each
    step's plane starts from what the earlier steps' planes calibrated."""
    from cometbft_tpu_torch.crypto import hashplane
    from cometbft_tpu_torch.ops import cuda_sha256, cuda_verify
    from cometbft_tpu_torch.types import block, part_set

    t0 = time.perf_counter()
    txs, data = make_hash_block()
    size = block.BLOCK_PART_SIZE_BYTES
    leaves = [b"\x00" + data[i : i + size] for i in range(0, len(data), size)]
    emit({"phase": "hash.block", "txs": len(txs), "tx_bytes": TX_BYTES,
          "bytes": len(data), "parts": len(leaves),
          "seconds": time.perf_counter() - t0})
    compared, x4_row = check_x4(torch, leaves, txs, card)

    def sha(tag: bytes) -> bytes:
        return hashlib.sha256(tag).digest()

    fields = dict(
        version=block.Version(11, 1), chain_id=CHAIN_ID,
        time_ns=LIGHT_T0_NS, last_block_id=commit.block_id,
        validators_hash=vals.hash(), next_validators_hash=vals.hash(),
        consensus_hash=sha(b"consensus"), app_hash=sha(b"app"),
        last_results_hash=sha(b"results"),
        proposer_address=vals.get_proposer().address,
    )
    device_windows = 0
    xo = hashplane.crossover("cuda")

    def cuts():
        return {bb: xo.threshold(bb) for bb in (1, 2, 64, 2048)}

    def step(name, fn, same):
        nonlocal device_windows
        t = time.perf_counter()
        unrouted = fn()
        unrouted_ms = 1e3 * (time.perf_counter() - t)
        co = hashplane.HashCoalescer(device="cuda")
        co.start()
        hashplane.push_active(co)
        launches0 = cuda_sha256.LAUNCHES["sha256"]
        shapes0 = dict(cuda_sha256.LAUNCH_SHAPES["sha256"])
        h2d0 = cuda_sha256.TRANSFERS["h2d_bytes"]
        cuts0 = cuts()
        try:
            t = time.perf_counter()
            routed = fn()
            routed_ms = 1e3 * (time.perf_counter() - t)
        finally:
            hashplane.pop_active(co)
            co.stop()
        check(same(unrouted, routed), f"hash {name}: routed != unrouted")
        device_windows += co.device_windows
        by_shape = {f"{bb}x{lb}": n - shapes0.get((bb, lb), 0) for (bb, lb), n
                    in sorted(cuda_sha256.LAUNCH_SHAPES["sha256"].items())
                    if n != shapes0.get((bb, lb), 0)}
        emit({"phase": "hash.step", "step": name, "unrouted_ms": unrouted_ms,
              "routed_ms": routed_ms, "routed_equal": True,
              "windows": co.windows, "device_windows": co.device_windows,
              "host_windows": co.windows - co.device_windows,
              "flushes": co.flushes, "tickets": co.tickets,
              "device_lanes": co.device_lanes, "host_lanes": co.host_lanes,
              "inline_lanes": co.inline_lanes,
              "launches": cuda_sha256.LAUNCHES["sha256"] - launches0,
              "launches_by_shape": by_shape,
              "h2d_bytes": cuda_sha256.TRANSFERS["h2d_bytes"] - h2d0,
              "crossover": "process-wide: this step's plane starts from the "
                           "cuts the earlier steps' planes calibrated",
              "cuts_by_block_bucket": {"start": cuts0, "end": cuts()},
              "card": card})
        return unrouted, routed

    torch.cuda.synchronize()
    verify0 = dict(cuda_verify.LAUNCHES)
    cuda_sha256.reset_launches()  # the hash path starts here
    blk, _ = step(
        "make_block",
        lambda: block.make_block(HEIGHT + 1, txs, commit, [], fields),
        lambda a, b: a.header == b.header and a.hash() == b.hash())
    blk.validate_basic()
    ps, routed_ps = step(
        "part_set_from_data", lambda: part_set.PartSet.from_data(data),
        lambda a, b: (a.header == b.header and a.count == b.count
                      == len(leaves) and [p.proof for p in a.parts]
                      == [p.proof for p in b.parts]))
    step("gossip_ingress", lambda: _ingress(routed_ps),
         lambda a, b: a[0] == b[0] == data and a[1] == b[1]
         and "leaf hash mismatch" in b[1])
    step("validator_set_hash", vals.hash, lambda a, b: a == b)
    launches = cuda_sha256.LAUNCHES["sha256"]  # read just after the path
    shapes = dict(sorted(cuda_sha256.LAUNCH_SHAPES["sha256"].items()))
    check(launches > 0, "X4 was not launched on the hash path")
    check(device_windows > 0, "no hash window ran on the card")
    check(set(shapes) <= compared,
          f"hash: X4 ran at {sorted(shapes)}, compared at "
          f"{sorted(compared)} only")
    check(cuda_verify.LAUNCHES == verify0, "the hash path ran verify kernels")
    emit({"phase": "hash", "launches": launches, "launches_by_shape": {
              f"{bb}x{lb}": n for (bb, lb), n in shapes.items()},
          "device_windows": device_windows, "header": {
              "total": ps.header.total, "hash": ps.header.hash.hex()},
          "block_hash": blk.hash().hex()})

    # the card's busy and idle share of a routed from_data and a routed
    # ingress, each traced in a process of its own: after the X4 check,
    # this process's profiler no longer sees the plane's threads' device
    # work (it still sees the main thread's)
    for name in ("part_set_from_data", "gossip_ingress"):
        with get_context("spawn").Pool(1) as pool:
            host_ms, busy_ms, events, dev_windows, windows = pool.apply(
                _traced_routed, (name,))
            pool.close()
            pool.join()
        check(events > 0, f"the traced routed {name} ran nothing on the card")
        emit({"phase": "hash.trace", "step": f"{name}, routed, warm, "
              "profiled", "host_ms": host_ms, "device_busy_ms": busy_ms,
              "device_events": events, "idle_share": 1 - busy_ms / host_ms,
              "device_windows": dev_windows, "windows": windows,
              "card": card})
    x4_row["launches_by_shape"] = {f"{bb}x{lb}": n
                                   for (bb, lb), n in shapes.items()}
    return launches, x4_row, compared


# The ledger phase: the device-time ledger and the libs the two planes
# report to, driven through the planes on the card.
LEDGER_VALIDATORS = 1_000  # BASELINE config 3, a fresh set
LEDGER_TAMPERED = 555
LEDGER_SMALL = 150  # BASELINE config 2
LEDGER_SMALL_TAMPERED = 99
LEDGER_TURNS = 3  # run (1)'s prevote round, accounting off and on in turns
# run (1)'s coalescer cut: add_vote verifies under the vote set's lock, so
# its windows carry one lane each, and only a cut of 1 puts them on the card
LEDGER_CUT = 1
LEDGER_RING = 1 << 14
LEDGER_CALLERS = ("consensus-vote", "commit-verify", "merkle")
K2_SYMBOL = "k2_verify_cached"  # K2's kernel in a torch.profiler trace
PPROF_ROUTES = ("/debug/pprof/", "/debug/pprof", "/debug/pprof/goroutine",
                "/debug/pprof/heap", "/debug/heap/start", "/debug/heap/stop",
                "/debug/locks", "/debug/devstats", "/debug/budget",
                "/debug/flight", "/debug/contention", "/debug/trace",
                "/debug/trace/start", "/debug/trace/stop")


def make_ledger_sets(pool):
    """The ledger phase's inputs: a fresh LEDGER_VALIDATORS set with its
    prevote and precommit rounds (one tampered vote each), and a fresh
    LEDGER_SMALL set's commit, signed in the pool."""
    from cometbft_tpu_torch.types import block, canonical

    vals, seeds = make_validators(pool, b"ledger-validator",
                                  LEDGER_VALIDATORS)
    bid = block.BlockID(hashlib.sha256(b"ledger-block").digest(),
                        block.PartSetHeader(1, hashlib.sha256(
                            b"ledger-parts").digest()))
    rounds = {t: make_round_votes(pool, vals, seeds, t, bid, LEDGER_TAMPERED)
              for t in (canonical.PREVOTE_TYPE, canonical.PRECOMMIT_TYPE)}
    small_vals, small_seeds = make_validators(pool, b"ledger-small",
                                              LEDGER_SMALL)
    small = make_small_commit(pool, small_vals, small_seeds, bid)
    cs = small.signatures[LEDGER_SMALL_TAMPERED]
    bad = block.Commit(HEIGHT, 0, bid, list(small.signatures))
    bad.signatures[LEDGER_SMALL_TAMPERED] = block.CommitSig(
        cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
        cs.signature[:40] + bytes([cs.signature[40] ^ 1])
        + cs.signature[41:])
    return {"vals": vals, "bid": bid, "rounds": rounds,
            "small_vals": small_vals, "small": small, "small_bad": bad}


def ledger_round(vals, msg_type, votes):
    """One round's votes through VoteSet.add_vote from PEER_THREADS
    threads, each verified through a fresh pushed
    VerifyCoalescer(device="cuda") of cut LEDGER_CUT: (decisions, the vote
    set, host ms, the coalescer)."""
    from concurrent.futures import ThreadPoolExecutor

    from cometbft_tpu_torch.crypto import coalesce
    from cometbft_tpu_torch.types.vote_set import VoteSet

    def decision(v):
        try:
            return (vs.add_vote(v), None)
        except Exception as e:  # the decision is the error's type
            return (False, type(e).__name__)

    vs = VoteSet(CHAIN_ID, HEIGHT, 0, msg_type, vals)
    co = coalesce.VerifyCoalescer(device="cuda", min_device_lanes=LEDGER_CUT)
    co.start()
    coalesce.push_active(co)
    try:
        t = time.perf_counter()
        with ThreadPoolExecutor(PEER_THREADS) as ex:
            out = list(ex.map(decision, votes))
        ms = 1e3 * (time.perf_counter() - t)
    finally:
        coalesce.pop_active(co)
        co.stop()
    return out, vs, ms, co


def _ledger_accounting(on: bool) -> None:
    """The record paths the ledger phase measures: the device-time ledger,
    the flight recorder, the lock profiler and devstats, on or off."""
    from cometbft_tpu_torch.libs import devledger, devstats, health, lockprof

    for lib in (devledger, health, lockprof, devstats):
        lib.enable() if on else lib.disable()


def _http_get(port: int, path: str):
    """(status, body) of a GET to 127.0.0.1:port."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def _metric(body: str, series: str):
    """The value of one exposition series line, or None."""
    for line in body.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def _traced_ledger(vals, votes):
    """Worker: the pprof server's torch.profiler round trip around run (1)'s
    prevote round on a prestaged set: /debug/torch/start_trace, the round,
    /debug/torch/stop_trace; what the written trace holds."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.libs import pprof
    from cometbft_tpu_torch.types import canonical

    trace_dir = Path(__file__).resolve().parent / "build" / "ledger_trace"
    with env("COMETBFT_TPU_PRESTAGE", "auto"):
        crypto_batch.prestage_validators(vals)
    srv = pprof.PprofServer("tcp://127.0.0.1:0")
    srv.start()
    try:
        started = _http_get(srv.bound_port,
                            f"/debug/torch/start_trace?dir={trace_dir}")
        with env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"):
            out, _, ms, co = ledger_round(vals, canonical.PREVOTE_TYPE, votes)
        stopped = _http_get(srv.bound_port, "/debug/torch/stop_trace")
    finally:
        srv.stop()
    check(started[0] == 200 and stopped[0] == 200
          and stopped[1].startswith("trace written to "),
          f"torch trace round trip: {started} {stopped}")
    path = Path(stopped[1][len("trace written to "):])
    text = path.read_text()
    path.unlink()
    return {"trace_bytes": len(text), "names_k2": K2_SYMBOL in text,
            "k2_rows": text.count(K2_SYMBOL), "host_ms": ms,
            "device_windows": co.device_windows, "windows": co.windows,
            "rejected": [i for i, (a, e) in enumerate(out) if e]}


def phase_ledger(torch, card, sets, x4_compared):
    """The device-time ledger phase (see the module docstring, phase 11).
    Returns ({kernel: launches}, {kernel: {lanes: launches}}, the window
    comparisons' (err, mismatches), X4's launches, X4's launches by
    shape)."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import hashplane, host_batch
    from cometbft_tpu_torch.libs import devledger, devstats, health
    from cometbft_tpu_torch.libs import lockprof, metrics, pprof
    from cometbft_tpu_torch.ops import cuda_sha256, cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.types import canonical, part_set, validation

    t_phase = time.perf_counter()
    vals, rounds = sets["vals"], sets["rounds"]
    V, H = devledger.PLANE_VERIFY, devledger.PLANE_HASH
    m = metrics.NodeMetrics()
    metrics.push_node_metrics(m)
    saved_lockprof = os.environ.get("COMETBFT_TPU_LOCKPROF")
    os.environ["COMETBFT_TPU_LOCKPROF"] = "1"
    devstats.acquire()
    devledger.reset()
    lockprof.reset()
    health.enable(ring=LEDGER_RING)
    health.reset()
    _ledger_accounting(True)

    def refresh():
        devstats.sample(m)
        devledger.sample(m)
        lockprof.sample(m)

    prom = devstats.PrometheusServer("127.0.0.1:0", m.registry, refresh)
    dbg = pprof.PprofServer("tcp://127.0.0.1:0")
    prom.start()
    dbg.start()
    try:
        want = {}
        for t, votes in rounds.items():
            want[t] = host_batch.verify_many(
                [vals.validators[v.validator_index].pub_key.data
                 for v in votes],
                [v.sign_bytes(CHAIN_ID) for v in votes],
                [v.signature for v in votes])
            check([i for i, ok in enumerate(want[t]) if not ok]
                  == [LEDGER_TAMPERED], "host batch: the tampered vote is "
                  "not the only invalid one")
        torch.cuda.synchronize()
        cuda_verify.reset_launches()  # the ledger path starts here
        cuda_sha256.reset_launches()
        coalescers = []
        with WindowRecorder(ov, cuda_verify) as recorder, \
                env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"):
            # both sets into the card's arena (X1, X2), then (1) BASELINE
            # config 3 through add_vote, accounting on
            with env("COMETBFT_TPU_PRESTAGE", "auto"):
                built = (crypto_batch.prestage_validators(vals),
                         crypto_batch.prestage_validators(
                             sets["small_vals"]))
            runs = []
            for t, votes in rounds.items():
                out, vs, ms, co = ledger_round(vals, t, votes)
                coalescers.append(co)
                check([ok for ok, _ in out] == [
                    bool(w) for w in want[t]], f"round {t}: add_vote "
                    "decisions != host_batch.verify_many")
                check([i for i, (a, e) in enumerate(out) if e]
                      == [LEDGER_TAMPERED]
                      and out[LEDGER_TAMPERED][1] == "VoteError",
                      f"round {t}: the tampered vote was not the one "
                      "rejected")
                check(vs.has_two_thirds_majority(), f"round {t}: no 2/3")
                runs.append({"msg_type": t, "host_ms": ms,
                             "device_windows": co.device_windows,
                             "windows": co.windows})
                if t == canonical.PRECOMMIT_TYPE:
                    k2_before = cuda_verify.LAUNCHES["verify_kernel_cached"]
                    validation.verify_commit(CHAIN_ID, vals, sets["bid"],
                                             HEIGHT, vs.make_commit())
                    k2_direct = (cuda_verify.LAUNCHES["verify_kernel_cached"]
                                 - k2_before)
            emit({"phase": "ledger.run", "run": "(1) BASELINE config 3, "
                  "add_vote from 50 threads", "rounds": runs,
                  "commit_verify_k2_launches": k2_direct,
                  "prestage_builds": built, "card": card})

            # (2) BASELINE config 2: the 150-validator commit routed to the
            # coalescer (the batch cut above the commit, the windows'
            # held at the seed)
            from cometbft_tpu_torch.crypto import coalesce

            co = coalesce.VerifyCoalescer(
                device="cuda", min_device_lanes=crypto_batch.HOST_BATCH_THRESHOLD)
            co.start()
            coalesce.push_active(co)
            seed_cut = crypto_batch.HOST_BATCH_THRESHOLD
            crypto_batch.HOST_BATCH_THRESHOLD = LEDGER_SMALL + 1
            errors = {}
            try:
                t = time.perf_counter()
                for tag, c in (("good", sets["small"]),
                               ("tampered", sets["small_bad"])):
                    try:
                        validation.verify_commit(
                            CHAIN_ID, sets["small_vals"], sets["bid"],
                            HEIGHT, c)
                        errors[tag] = None
                    except validation.VerificationError as e:
                        errors[tag] = str(e)
                ms = 1e3 * (time.perf_counter() - t)
            finally:
                crypto_batch.HOST_BATCH_THRESHOLD = seed_cut
                coalesce.pop_active(co)
                co.stop()
            coalescers.append(co)
            check(errors["good"] is None
                  and f"(#{LEDGER_SMALL_TAMPERED})" in errors["tampered"],
                  f"150-validator commit through the coalescer: {errors}")
            emit({"phase": "ledger.run", "run": "(2) BASELINE config 2, "
                  "routed", "host_ms": ms, "windows": co.windows,
                  "device_windows": co.device_windows, "card": card})

            # (3) the hash plane: from_data of the default block, then the
            # 8-thread ingress, through a pushed plane
            _, data = make_hash_block()
            plane = hashplane.HashCoalescer(device="cuda")
            plane.start()
            hashplane.push_active(plane)
            try:
                t = time.perf_counter()
                ps = part_set.PartSet.from_data(data)
                assembled, rejected = _ingress(ps)
                ms = 1e3 * (time.perf_counter() - t)
            finally:
                hashplane.pop_active(plane)
                plane.stop()
            check(assembled == data and "leaf hash mismatch" in rejected,
                  "hash plane: ingress did not give the block back")
            emit({"phase": "ledger.run", "run": "(3) PartSet.from_data and "
                  "8-thread ingress, routed", "host_ms": ms,
                  "windows": plane.windows,
                  "device_windows": plane.device_windows, "card": card})

            # what the reports say, read before anything else runs
            torch.cuda.synchronize()
            k2 = cuda_verify.LAUNCHES["verify_kernel_cached"]
            x4 = cuda_sha256.LAUNCHES["sha256"]
            snap = devledger.snapshot()
            rec = devledger.reconcile()
            occ = devledger.occupancy()
            ring = health.recorder().dump()
            lanes_cv = devledger.cell(V, devledger.CALLER_CODES[
                "consensus-vote"])["lanes"]
            hottest = lockprof.snapshot()["hottest"]
            status, body = _http_get(prom.bound_port, "/metrics")
            routes = {r: _http_get(dbg.bound_port, r)[0]
                      for r in PPROF_ROUTES + ("/debug/nope",)}
            budget = json.loads(_http_get(dbg.bound_port,
                                          "/debug/budget")[1])

            # the accounting's cost on run (1)'s prevote round: off and on
            # in turns, the checked round above the first "on"
            turns = {"off": [], "on": [runs[0]["host_ms"]]}
            for i in range(2 * LEDGER_TURNS - 1):
                mode = "off" if i % 2 == 0 else "on"
                _ledger_accounting(mode == "on")
                out, _, ms, _ = ledger_round(
                    vals, canonical.PREVOTE_TYPE,
                    rounds[canonical.PREVOTE_TYPE])
                check([i for i, (a, e) in enumerate(out) if e]
                      == [LEDGER_TAMPERED], "a timed round decided "
                      "differently")
                turns[mode].append(ms)
            _ledger_accounting(True)
        launches = dict(cuda_verify.LAUNCHES)  # read just after the path
        x4_shapes = dict(sorted(cuda_sha256.LAUNCH_SHAPES["sha256"].items()))
        x4_all = cuda_sha256.LAUNCHES["sha256"]
    finally:
        prom.stop()
        dbg.stop()
        for lib in (devledger, health, lockprof):
            lib.disable()
        devstats.release()  # devstats stays on for the caller's holders
        metrics.pop_node_metrics(m)
        if saved_lockprof is None:
            del os.environ["COMETBFT_TPU_LOCKPROF"]
        else:
            os.environ["COMETBFT_TPU_LOCKPROF"] = saved_lockprof

    # the checks on what the reports said
    for plane_name, r in rec.items():
        check(r["caller_lanes"] == r["window_lanes"] > 0
              and abs(1 - r["ratio"]) <= 0.01,
              f"{plane_name} plane does not reconcile: {r}")
    co_dev = sum(c.device_windows for c in coalescers)
    check(occ["verify"]["device_windows"] == co_dev == k2 - k2_direct > 0,
          f"verify device windows: ledger {occ['verify']['device_windows']}"
          f", coalescers {co_dev}, K2 on the coalescers {k2 - k2_direct}")
    check(occ["hash"]["device_windows"] == plane.device_windows == x4 > 0,
          f"hash device windows: ledger {occ['hash']['device_windows']}, "
          f"plane {plane.device_windows}, X4 {x4}")
    callers = snap["callers"]
    for plane_name, rows in callers.items():
        check(set(rows) <= set(LEDGER_CALLERS),
              f"{plane_name} plane: lanes outside {LEDGER_CALLERS}: "
              f"{sorted(rows)}")
    check(all(callers["verify"].get(c, {}).get("lanes") for c in
              ("consensus-vote", "commit-verify"))
          and callers["hash"].get("merkle", {}).get("lanes"),
          f"a caller row carries no lanes: {callers}")
    budget_rows = [e for e in ring if e["event"] == "plane.budget"]
    hash_rows = [e for e in ring if e["event"] == "hash.flush"]
    check(any(e["plane"] == "verify" for e in budget_rows),
          "no plane.budget row for the verify plane")
    check(sum(1 for e in hash_rows if e["device"]) == plane.device_windows,
          "hash.flush rows on the device != the plane's device windows")
    check(len(ring) < LEDGER_RING, "the ring wrapped")
    scraped = _metric(body, 'cometbft_tpu_device_lanes_total{plane="verify"'
                      ',caller="consensus-vote"}')
    check(status == 200 and scraped == lanes_cv,
          f"/metrics: consensus-vote lanes {scraped} != the ledger's "
          f"{lanes_cv}")
    flushes = {r: _metric(body, "cometbft_tpu_crypto_coalesce_flush_total"
                          f'{{reason="{r}"}}')
               for r in ("size", "deadline", "drain")}
    # the lock families: crypto.coalesce._mtx is held on every submit and
    # flush, but waited on only when a submit meets the executor inside it
    # (add_vote's callers reach it one at a time, behind the vote set's
    # lock), so its wait series may be absent; the hottest lock's is not
    locks = {name: {kind: _metric(body, f"cometbft_tpu_lock_{kind}_seconds"
                                  f'_total{{lock="{name}"}}')
                    for kind in ("wait", "hold")}
             for name in ("crypto.coalesce._mtx", hottest)}
    check(any(flushes.values())
          and locks["crypto.coalesce._mtx"]["hold"]
          and hottest is not None and locks[hottest]["wait"],
          f"/metrics lacks the flush or lock series: {flushes}, {locks}")
    check(routes.pop("/debug/nope") == 404
          and set(routes.values()) == {200}, f"pprof routes: {routes}")
    check(budget["ledger"]["reconciliation"] == json.loads(json.dumps(rec)),
          "/debug/budget disagrees with reconcile()")

    # every K1/K2/X1 launch of the path against its plain version, X4's
    # shapes against those its check compared
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    compared = compare_windows(torch, recorder.records, err, mismatches)
    check(not any(mismatches.values()),
          f"ledger windows != plain: {mismatches}")
    lanes = check_lanes(cuda_verify, "ledger", compared)
    check(launches["verify_kernel_cached"] > 0, "K2 did not run")
    for name in ("verify_kernel", "verify_kernel8", "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the ledger path")
    check(set(x4_shapes) <= x4_compared,
          f"ledger: X4 ran at {sorted(x4_shapes)}, compared at "
          f"{sorted(x4_compared)} only")

    # the pprof server's torch.profiler round trip, in a process of its own
    with get_context("spawn").Pool(1) as tracer:
        traced = tracer.apply(_traced_ledger, (vals,
                                               rounds[canonical.PREVOTE_TYPE]))
        tracer.close()
        tracer.join()
    check(traced["names_k2"] and traced["rejected"] == [LEDGER_TAMPERED],
          f"the torch trace does not name K2: {traced}")

    emit({"phase": "ledger", "launches": launches, "lanes": lanes,
          "x4_launches": x4_all, "x4_by_shape": {
              f"{bb}x{lb}": n for (bb, lb), n in x4_shapes.items()},
          "windows_compared": len(recorder.records),
          "mismatches": dict(mismatches), "max_abs_err": dict(err),
          "reconcile": rec, "occupancy": occ, "callers": callers,
          "plane_budget_rows": len(budget_rows),
          "hash_flush_rows": len(hash_rows), "ring_rows": len(ring),
          "metrics": {"device_lanes_consensus_vote": scraped,
                      "coalesce_flushes": flushes, "lock_seconds": locks},
          "pprof": routes, "torch_trace": traced,
          "prevote_round_host_ms": {"accounting_on": turns["on"],
                                    "accounting_off": turns["off"]},
          "lockprof_hottest": hottest,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return launches, lanes, (err, mismatches), x4_all, x4_shapes


# The chain phase: block execution and storage (state/, store/, abci/
# kvstore, proxy, libs/db) on a 10,000-validator chain, the LastCommits
# on K2 (X1 for the keys the arena lacks), the block's hashes on X4.
CHAIN_VALIDATORS = N_VALIDATORS  # fresh keys: the arena starts cold
CHAIN_POWER = 100  # every validator's, the added one's too
CHAIN_HEIGHTS = 4  # cut to fit the script's time limit (PERF.md §4)
CHAIN_TXS = 1_024  # a height's kvstore txs, ...
CHAIN_TX_BYTES = 1_024  # ... of 1 KiB each: ~1 MiB of txs a block
CHAIN_UPDATE_HEIGHT = 1  # carries the val: tx that adds a fresh key
CHAIN_TAMPERED = 6_173  # the last block's spoiled LastCommit signature
CHAIN_TRACE_HEIGHT = 3  # the warm height profiled in a process of its own
CHAIN_EXEC_ID = "chip-smoke-exec"
CHAIN_T0_NS = 1_770_000_000_000_000_000
CHAIN_SEED = b"chain"


def _fast_pubkey_chunk(seeds):
    """Worker: seeds -> public keys (crypto/fast25519: OpenSSL when the
    cryptography wheel is installed)."""
    from cometbft_tpu_torch.crypto import fast25519

    return [fast25519.pubkey_from_seed(s) for s in seeds]


def _fast_sign_chunk(items):
    """Worker: [(seed, msg)] -> [signature] through crypto/fast25519."""
    from cometbft_tpu_torch.crypto import fast25519

    return [fast25519.sign_one(s, m) for s, m in items]


def chain_seeds() -> list[bytes]:
    """The chain's validator seeds, the added validator's last."""
    return [_seed(CHAIN_SEED, i) for i in range(CHAIN_VALIDATORS + 1)]


def chain_txs(height: int) -> list[bytes]:
    """Height ``height``'s CHAIN_TXS seeded kvstore txs, ``key=value`` of
    CHAIN_TX_BYTES each, and at CHAIN_UPDATE_HEIGHT nothing else: the
    validator update comes on its own (chain_update_tx)."""
    txs = []
    for i in range(CHAIN_TXS):
        key = b"h%02d-k%05d" % (height, i)
        fill = CHAIN_TX_BYTES - len(key) - 1
        value = hashlib.sha256(CHAIN_SEED + key).hexdigest().encode()
        txs.append(key + b"=" + (value * (fill // len(value) + 1))[:fill])
    return txs


def chain_update_tx(pub: bytes) -> bytes:
    """The kvstore's validator-update tx adding ``pub`` at CHAIN_POWER
    (``val:<pubkey hex>!<power>``)."""
    return b"val:" + pub.hex().encode() + b"!%d" % CHAIN_POWER


def check_txs(mempool, txs, threads=INGRESS_THREADS) -> float:
    """``txs`` through ``mempool.check_tx`` from ``threads`` threads at
    once (their tx keys share the pushed hash plane's windows); host ms.
    Every tx must be admitted."""
    from concurrent.futures import ThreadPoolExecutor

    n0 = mempool.size()
    t = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(mempool.check_tx, txs))
    ms = 1e3 * (time.perf_counter() - t)
    check(mempool.size() == n0 + len(txs),
          f"the mempool admitted {mempool.size() - n0} of {len(txs)} txs")
    return ms


class ChainRig:
    """The chain's node-side objects on the port: a KVStoreApplication
    behind proxy.AppConns(local_client_creator(...)), state.Store,
    store.BlockStore and an EventBus subscribed to every event, each store
    a FileDB under ``root`` (a MemDB without one), and a BlockExecutor on
    ``device``, its mempool a CListMempool on the app's mempool
    connection. The genesis set is CHAIN_VALIDATORS validators of equal
    power; InitChain hands them to the app and its app hash to the
    state."""

    def __init__(self, pubs, device="cuda", root=None):
        from cometbft_tpu_torch import proxy, state as st, store
        from cometbft_tpu_torch.abci import kvstore, types as abci
        from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
        from cometbft_tpu_torch import config as tconfig
        from cometbft_tpu_torch.libs import db as dbm, pubsub
        from cometbft_tpu_torch.mempool import CListMempool
        from cometbft_tpu_torch.types import event_bus, genesis

        def db(name):
            if root is None:
                return dbm.MemDB()
            return dbm.FileDB(str(Path(root) / f"{name}.db"))

        self.dbs = {n: db(n) for n in ("app", "state", "blocks")}
        self.app = kvstore.KVStoreApplication(self.dbs["app"])
        self.conns = proxy.AppConns(proxy.local_client_creator(self.app))
        self.conns.start()
        gen = genesis.GenesisDoc(
            chain_id=CHAIN_EXEC_ID, genesis_time_ns=CHAIN_T0_NS,
            validators=[genesis.GenesisValidator(Ed25519PubKey(p),
                                                 CHAIN_POWER)
                        for p in pubs[:CHAIN_VALIDATORS]])
        self.state = st.make_genesis_state(gen)
        init = self.conns.consensus.init_chain(abci.RequestInitChain(
            time_ns=CHAIN_T0_NS, chain_id=CHAIN_EXEC_ID,
            validators=[abci.ValidatorUpdate("ed25519", p, CHAIN_POWER)
                        for p in pubs[:CHAIN_VALIDATORS]]))
        self.state.app_hash = init.app_hash
        self.state_store = st.Store(self.dbs["state"])
        self.state_store.save(self.state)
        self.block_store = store.BlockStore(self.dbs["blocks"])
        self.bus = event_bus.EventBus()
        self.bus.start()
        self.events = self.bus.subscribe("chip-smoke", pubsub.Empty(),
                                         capacity=None)
        self.mempool = CListMempool(tconfig.default_config().mempool,
                                    self.conns.mempool, device=device)
        self.exe = st.BlockExecutor(
            self.state_store, self.conns.consensus, mempool=self.mempool,
            block_store=self.block_store, event_bus=self.bus, device=device)
        self.blocks = {}
        self.last_ext = None

    def propose(self, height: int):
        """Block ``height`` from create_proposal_block, its part set over
        the codec's bytes and its BlockID; (block, part set, block id,
        {step: host ms})."""
        from cometbft_tpu_torch.types import block, part_set
        from cometbft_tpu_torch.types import serialization as ser

        ms = {}
        t = time.perf_counter()
        blk = self.exe.create_proposal_block(
            height, self.state, self.last_ext,
            self.state.validators.get_proposer().address,
            time_ns=CHAIN_T0_NS + height * 10**9)
        ms["create_proposal_block"] = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        data = ser.dumps(blk)
        ms["codec"] = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        ps = part_set.PartSet.from_data(data)
        bid = block.BlockID(blk.hash(), ps.header)
        ms["part_set"] = 1e3 * (time.perf_counter() - t)
        return blk, ps, bid, ms

    def close(self) -> None:
        self.bus.stop()
        self.conns.stop()
        for db in self.dbs.values():
            db.close()


def chain_commit(sign, seed_of, vals, height: int, bid,
                 chain_id=CHAIN_EXEC_ID, t0_ns=CHAIN_T0_NS):
    """The precommits of ``vals`` for ``bid`` at ``height`` as a Commit,
    every validator's sign bytes on ``chain_id`` signed by ``sign``
    ([(seed, msg)] -> [signature]), as make_commit does."""
    from cometbft_tpu_torch.types import block

    t_ns = t0_ns + height * 10**9 + 500_000_000
    unsigned = [block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                                t_ns + 7919 * i)
                for i, v in enumerate(vals.validators)]
    commit = block.Commit(height, 0, bid, unsigned)
    sigs = sign([(seed_of[cs.validator_address],
                  commit.vote_sign_bytes(chain_id, i))
                 for i, cs in enumerate(unsigned)])
    commit.signatures = [block.CommitSig(cs.block_id_flag,
                                         cs.validator_address,
                                         cs.timestamp_ns, sig)
                         for cs, sig in zip(unsigned, sigs)]
    return commit


def chain_extended(commit):
    """``commit`` as the ExtendedCommit the next proposal carries (no vote
    extensions: they are off in the genesis params)."""
    from cometbft_tpu_torch.types import block

    return block.ExtendedCommit(
        commit.height, commit.round, commit.block_id,
        [block.ExtendedCommitSig(cs) for cs in commit.signatures])


def chain_height(rig, height, sign, seed_of):
    """One height on ``rig``: the height's txs through the mempool's
    check_tx (the update tx at CHAIN_UPDATE_HEIGHT), propose, apply_block
    (whose Commit drops the block's txs from the mempool), the commit
    signed by the height's validators, BlockStore.save_block. {step:
    host ms}."""
    txs = chain_txs(height)
    if height == CHAIN_UPDATE_HEIGHT:
        txs.append(chain_update_tx(rig.added_pub))
    check_ms = check_txs(rig.mempool, txs)
    blk, ps, bid, ms = rig.propose(height)
    ms["check_tx"] = check_ms
    t = time.perf_counter()
    rig.state = rig.exe.apply_block(rig.state, bid, blk)
    ms["apply_block"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    commit = chain_commit(sign, seed_of, rig.state.last_validators, height,
                          bid)
    ms["sign"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    rig.block_store.save_block(blk, ps, commit)
    ms["save_block"] = 1e3 * (time.perf_counter() - t)
    rig.blocks[height] = blk
    rig.last_ext = chain_extended(commit)
    check(rig.mempool.size() == 0, f"height {height}: the mempool kept "
          f"{rig.mempool.size()} txs after the commit")
    return ms, blk, ps


class StepTimer:
    """Host ms of the executor's steps while entered: validate_block, and
    inside it verify_commit and the hashing (the outermost merkle roots
    and tx-key batches); FinalizeBlock; Commit; the state save. Wraps the
    module functions and the rig's instances, restores them on exit."""

    def __init__(self, rig):
        self.rig = rig
        self.ms = collections.Counter()
        self._depth = 0
        self._saved = []

    def _patch(self, owner, name, key, nested=False):
        real = getattr(owner, name)

        def timed(*args, **kwargs):
            if nested and self._depth:
                return real(*args, **kwargs)
            self._depth += nested
            t = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.ms[key] += 1e3 * (time.perf_counter() - t)
                self._depth -= nested
        self._saved.append((owner, name, real))
        setattr(owner, name, timed)

    def __enter__(self):
        from cometbft_tpu_torch.crypto import hashplane, merkle
        from cometbft_tpu_torch.state import execution
        from cometbft_tpu_torch.types import validation

        self._patch(merkle, "hash_from_byte_slices", "hashing", nested=True)
        self._patch(hashplane, "hash_many", "hashing", nested=True)
        self._patch(validation, "verify_commit", "verify_commit")
        self._patch(self.rig.conns.consensus, "finalize_block",
                    "finalize_block")
        self._patch(self.rig.conns.consensus, "commit", "commit")
        self._patch(self.rig.state_store, "save", "state_save")
        real_validate = execution.validate_block

        def validate(*args, **kwargs):
            h0 = self.ms["hashing"]
            t = time.perf_counter()
            try:
                return real_validate(*args, **kwargs)
            finally:
                self.ms["validate_block"] += 1e3 * (time.perf_counter() - t)
                self.ms["validate_hashing"] += self.ms["hashing"] - h0
        self._saved.append((execution, "validate_block", real_validate))
        execution.validate_block = validate
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            if owner in (self.rig.conns.consensus, self.rig.state_store):
                delattr(owner, name)  # back to the class's method
            else:
                setattr(owner, name, real)

    def take(self) -> dict:
        """This height's steps, and zero for the next."""
        ms, self.ms = dict(self.ms), collections.Counter()
        verify = ms.get("verify_commit", 0.0)
        hashing = ms.pop("validate_hashing", 0.0)
        total = ms.get("validate_block", 0.0)
        ms.pop("hashing", None)
        return {"validate_block": {"total": total, "verify_commit": verify,
                                   "hashing": hashing,
                                   "rest": total - verify - hashing},
                "finalize_block": ms.get("finalize_block", 0.0),
                "commit": ms.get("commit", 0.0),
                "state_save": ms.get("state_save", 0.0)}


class X4Recorder:
    """Records every X4 launch (cuda_sha256.sha256) while entered: its
    wire, block counts and output state (each dispatch's buffers are its
    own, so the references stay valid), for compare_x4."""

    def __init__(self, cuda_sha256):
        self.mod = cuda_sha256
        self.records = []

    def __enter__(self):
        real = self._real = self.mod.sha256

        def recording(blocks, nblocks):
            out = real(blocks, nblocks)
            self.records.append((blocks, nblocks, out))
            return out
        self.mod.sha256 = recording
        return self

    def __exit__(self, *exc):
        self.mod.sha256 = self._real


def plain_x4(torch, blocks, nblocks):
    """ops.sha256.sha256_plain's state through its per-block step (the
    plain compression, then the lanes whose message goes on keep it). On
    the card the step is captured once in a CUDA graph and replayed block
    by block: the same operations on the same tensors, without one host
    launch each (~1,300 a block, ~40 s for a part set's 1,025 blocks). On
    the CPU the step runs as it is. check_x4 holds it against sha256_plain
    on every wire it compares."""
    import numpy as np

    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import sha256 as osha

    dev = blocks.device
    lanes = blocks.shape[2]
    nb = cuda_sha256.as_int64(nblocks).clamp(max=blocks.shape[0])
    h0 = torch.from_numpy(osha._H0.astype(np.int64)).to(dev)[:, None]
    state = h0.repeat(1, lanes)
    k = torch.from_numpy(osha._K.astype(np.int64)).to(dev)[:, None]
    rots = osha._rot_consts(dev)
    words = torch.zeros((16, lanes), dtype=torch.int64, device=dev)
    live = torch.zeros(lanes, dtype=torch.bool, device=dev)

    def step():
        state.copy_(torch.where(live[None, :], osha._compress_plain(
            state, words, k, rots), state))
    run = step
    if dev.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()  # the warm-up capture needs: its result is dropped below
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        run = graph.replay
    state.copy_(h0.expand(8, lanes))
    for b in range(int(nb.max()) if lanes else 0):
        words.copy_(cuda_sha256.as_int64(blocks[b]))
        live.copy_(nb > b)
        run()
    return state.to(torch.int32).view(torch.uint32)


def check_plain_x4(torch, blocks, nblocks, what, ref=None):
    """plain_x4 on one wire, held word for word against sha256_plain's
    state on the same wire (``ref``, when the caller has it already;
    ``what`` names the wire in a failure)."""
    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import sha256 as osha

    ours = plain_x4(torch, blocks, nblocks)
    if ref is None:
        ref = osha.sha256_plain(blocks, nblocks)
    diff = (cuda_sha256.as_int64(ours) - cuda_sha256.as_int64(ref)).abs()
    check(not bool(diff.any()),
          f"plain_x4 != sha256_plain at {what}: "
          f"{int((diff != 0).sum())} words differ")
    return ours


def compare_x4(torch, records):
    """Each recorded X4 launch against the plain version on its own wire,
    one plain call per block bucket over that bucket's wires side by
    side: (largest difference, words that differ, {(block bucket, lane
    bucket)} compared)."""
    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import sha256 as osha

    torch.cuda.synchronize()
    err = mismatches = 0
    compared = set()
    for bb in sorted({b.shape[0] for b, _, _ in records}):
        group = [r for r in records if r[0].shape[0] == bb]
        plain = plain_x4(
            torch, torch.cat([b for b, _, _ in group], dim=2),
            torch.cat([cuda_sha256.as_int64(nb) for _, nb, _ in group]))
        got = torch.cat([cuda_sha256.as_int64(s) for _, _, s in group],
                        dim=1)
        diff = (got - cuda_sha256.as_int64(plain)).abs()
        err = max(err, int(diff.max()))
        mismatches += int((diff != 0).sum())
        compared |= {(bb, b.shape[2]) for b, _, _ in group}
    return err, mismatches, compared


def _traced_chain(pubs):
    """Worker: a MemDB chain on the card through heights 1 to
    CHAIN_TRACE_HEIGHT - 1 (height 2's LastCommit builds the arena), then
    the warm height CHAIN_TRACE_HEIGHT (propose: create_proposal_block,
    the codec and from_data; then apply_block) under torch.profiler, through a pushed HashCoalescer
    (device="cuda"): (host ms, card-busy ms, device events)."""
    import torch

    from cometbft_tpu_torch.crypto import hashplane

    seed_of, sign = _chain_signer(pubs, None)
    rig = ChainRig(pubs, device="cuda")
    rig.added_pub = pubs[CHAIN_VALIDATORS]
    co = hashplane.HashCoalescer(device="cuda")
    co.start()
    hashplane.push_active(co)
    try:
        for h in range(1, CHAIN_TRACE_HEIGHT):
            chain_height(rig, h, sign, seed_of)
        h = CHAIN_TRACE_HEIGHT
        txs = chain_txs(h)
        if h == CHAIN_UPDATE_HEIGHT:
            txs.append(chain_update_tx(rig.added_pub))
        check_txs(rig.mempool, txs)

        out = {}

        def warm_height():
            blk, ps, bid, _ = rig.propose(h)
            out["state"] = rig.exe.apply_block(rig.state, bid, blk)
        host_ms, busy_ms, events = device_busy_ms(torch, warm_height)
        check(out["state"].last_block_height == h, "the traced height "
              "was not applied")
        return host_ms, busy_ms, events
    finally:
        hashplane.pop_active(co)
        co.stop()
        rig.close()


def _chain_signer(pubs, pool):
    """({address: seed}, sign): ``sign`` signs [(seed, msg)] through the
    pool's workers, or in this process without a pool."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey

    seeds = chain_seeds()
    seed_of = {Ed25519PubKey(p).address(): s for p, s in zip(pubs, seeds)}
    if pool is None:
        return seed_of, _fast_sign_chunk
    return seed_of, lambda items: _pool_map(pool, _fast_sign_chunk, items)


def phase_chain(torch, card):
    """The chain phase (see the module docstring, phase 12). Returns
    ({kernel: launches}, {kernel: {lanes: launches}}, the window
    comparisons' (err, mismatches), X4's launches, X4's launches by shape,
    X4's (err, mismatches))."""
    import shutil

    from cometbft_tpu_torch.crypto import hashplane
    from cometbft_tpu_torch.ops import cuda_sha256, cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.state import validation as sv
    from cometbft_tpu_torch.state import State, Store
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.abci import kvstore, types as abci
    from cometbft_tpu_torch.libs import db as dbm

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chain"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    with get_context("spawn").Pool(WORKERS) as pool:
        t = time.perf_counter()
        pubs = _pool_map(pool, _fast_pubkey_chunk, chain_seeds())
        seed_of, sign = _chain_signer(pubs, pool)
        keys_s = time.perf_counter() - t
        rig = ChainRig(pubs, device="cuda", root=root)
        rig.added_pub = pubs[CHAIN_VALIDATORS]
        plane = hashplane.HashCoalescer(device="cuda")
        plane.start()
        hashplane.push_active(plane)
        heights = []
        try:
            torch.cuda.synchronize()
            cuda_verify.reset_launches()  # the chain path starts here
            cuda_sha256.reset_launches()
            with WindowRecorder(ov, cuda_verify) as recorder, \
                    X4Recorder(cuda_sha256) as x4_recorder, \
                    StepTimer(rig) as timer, \
                    env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"):
                for h in range(1, CHAIN_HEIGHTS + 1):
                    k2_0 = dict(cuda_verify.LAUNCH_LANES[
                        "verify_kernel_cached"])
                    x1_0 = dict(cuda_verify.LAUNCH_LANES[
                        "build_pubkey_tables"])
                    x4_0 = cuda_sha256.LAUNCHES["sha256"]
                    proposer = rig.state.validators.get_proposer().address
                    ms, blk, ps = chain_height(rig, h, sign, seed_of)
                    torch.cuda.synchronize()
                    row = {"height": h, "validators": len(
                        rig.state.last_validators), "txs": len(
                        blk.data.txs), "parts": ps.header.total,
                        "block_bytes": sum(len(p.bytes_) for p in ps.parts),
                        "proposer_index": rig.state.last_validators.
                        get_by_address(proposer)[0],
                        "host_ms": {**ms, **timer.take()},
                        "k2_by_lanes": _lanes_since(cuda_verify, 
                                                    "verify_kernel_cached", k2_0),
                        "x1_by_lanes": _lanes_since(cuda_verify,
                                                    "build_pubkey_tables", x1_0),
                        "x4_launches": cuda_sha256.LAUNCHES["sha256"] - x4_0,
                        "card": card}
                    heights.append(row)
                    emit({"phase": "chain.height", **row})
                # one more block, its LastCommit spoiled at one lane:
                # refused, nothing changed
                before = {n: list(db.iterator())
                          for n, db in rig.dbs.items()}
                state_bytes = Store._encode_state(rig.state)
                info0 = rig.conns.query.info(abci.RequestInfo())
                sigs = list(rig.last_ext.extended_signatures)
                cs = sigs[CHAIN_TAMPERED].commit_sig
                bad = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
                sigs[CHAIN_TAMPERED] = dataclasses.replace(
                    sigs[CHAIN_TAMPERED], commit_sig=dataclasses.replace(
                        cs, signature=bad))
                rig.last_ext = dataclasses.replace(
                    rig.last_ext, extended_signatures=sigs)
                check_txs(rig.mempool, chain_txs(CHAIN_HEIGHTS + 1))
                bad_blk, _, bad_bid, _ = rig.propose(CHAIN_HEIGHTS + 1)
                try:
                    rig.exe.apply_block(rig.state, bad_bid, bad_blk)
                    refused = None
                except sv.BlockValidationError as e:
                    refused = str(e)
                timer.take()
            torch.cuda.synchronize()
            launches = dict(cuda_verify.LAUNCHES)  # read just after the path
            x4_shapes = dict(sorted(
                cuda_sha256.LAUNCH_SHAPES["sha256"].items()))
            x4_all = cuda_sha256.LAUNCHES["sha256"]
        finally:
            hashplane.pop_active(plane)
            plane.stop()
        check(refused is not None
              and f"wrong signature (#{CHAIN_TAMPERED})" in refused,
              f"the tampered last block was not refused as expected: "
              f"{refused}")
        check(Store._encode_state(rig.state) == state_bytes
              and {n: list(db.iterator())
                   for n, db in rig.dbs.items()} == before
              and rig.conns.query.info(abci.RequestInfo()) == info0,
              "the refused block changed the state, a store or the app")
        events = collections.Counter()
        while not rig.events.out.empty():
            events[rig.events.out.get_nowait().events["tm.event"][0]] += 1
        last = rig.state
        blocks = dict(rig.blocks)
        rig.close()

        # the three FileDBs reopened: the state, every block and the app
        # as they were left
        t = time.perf_counter()
        reopened = {n: dbm.FileDB(str(root / f"{n}.db"))
                    for n in ("app", "state", "blocks")}
        try:
            loaded = Store(reopened["state"]).load()
            check(isinstance(loaded, State) and Store._encode_state(loaded)
                  == Store._encode_state(last),
                  "the reopened state store does not hold the last state")
            bs = BlockStore(reopened["blocks"])
            check(bs.height() == CHAIN_HEIGHTS and all(
                bs.load_block(h).hash() == blocks[h].hash()
                for h in blocks), "the reopened block store lost a block")
            info = kvstore.KVStoreApplication(reopened["app"]).info(
                abci.RequestInfo())
            check(info.last_block_app_hash == last.app_hash
                  and info.last_block_height == CHAIN_HEIGHTS,
                  f"the reopened app: {info} against {last.app_hash.hex()}")
        finally:
            for db in reopened.values():
                db.close()
        reopen_ms = 1e3 * (time.perf_counter() - t)
        pool.close()
        pool.join()
    shutil.rmtree(root, ignore_errors=True)

    # every K2/X1 launch of the path against its plain version, and every
    # X4 launch: the chain's lane counts and shapes are its own
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    compared = compare_windows(torch, recorder.records, err, mismatches)
    check(not any(mismatches.values()),
          f"chain windows != plain: {mismatches}")
    lanes = check_lanes(cuda_verify, "chain", compared)
    k2_lanes = lanes["verify_kernel_cached"]
    check(k2_lanes.get(CHAIN_VALIDATORS, 0) >= 1
          and k2_lanes.get(CHAIN_VALIDATORS + 1, 0) >= 1,
          f"K2 did not run at {CHAIN_VALIDATORS} and "
          f"{CHAIN_VALIDATORS + 1} lanes: {k2_lanes}")
    check(lanes["build_pubkey_tables"].get(1, 0) >= 1,
          f"X1 did not build the added key alone: "
          f"{lanes['build_pubkey_tables']}")
    for name in ("verify_kernel", "verify_kernel8", "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the chain path")
    x4_err, x4_mismatches, x4_compared = compare_x4(
        torch, x4_recorder.records)
    check(x4_mismatches == 0, f"chain X4 != plain: {x4_mismatches} words")
    check(x4_all > 0 and len(x4_recorder.records) == x4_all
          and set(x4_shapes) <= x4_compared,
          f"chain: X4 ran at {sorted(x4_shapes)}, compared at "
          f"{sorted(x4_compared)} only")

    # the card's busy and idle share of one warm height, in a process of
    # its own (this process's profiler no longer sees the hash plane's
    # threads after the X4 check)
    with get_context("spawn").Pool(1) as tracer:
        host_ms, busy_ms, ev = tracer.apply(_traced_chain, (pubs,))
        tracer.close()
        tracer.join()
    check(ev > 0, "the traced warm height ran nothing on the card")
    emit({"phase": "chain.trace", "step": f"height {CHAIN_TRACE_HEIGHT}, "
          "warm, profiled (propose, from_data, apply_block)",
          "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": ev, "idle_share": 1 - busy_ms / host_ms,
          "card": card})
    emit({"phase": "chain", "validators": CHAIN_VALIDATORS,
          "heights": CHAIN_HEIGHTS, "launches": launches, "lanes": lanes,
          "x4_launches": x4_all, "x4_by_shape": {
              f"{bb}x{lb}": n for (bb, lb), n in x4_shapes.items()},
          "x4_mismatches": x4_mismatches, "x4_max_abs_err": x4_err,
          "windows_compared": len(recorder.records),
          "mismatches": dict(mismatches), "max_abs_err": dict(err),
          "refused": refused, "events": dict(events),
          "app_hash": last.app_hash.hex(), "reopen_ms": reopen_ms,
          "keys_seconds": keys_s,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return launches, lanes, (err, mismatches), x4_all, x4_shapes, (
        x4_err, x4_mismatches)


CONS_CHAIN_ID = "chip-smoke-consensus"
CONS_BURST_NODES = 4  # run (1): in-process validators, perfect gossip
CONS_BURST_POWER = 10
CONS_BURST_HEIGHTS = 5
CONS_BURST_TXS = 64  # into every node's mempool before the start
CONS_VALIDATORS = CHAIN_VALIDATORS  # run (2): the chain cell's keys
CONS_HEIGHTS = 4
CONS_TX_THREADS = INGRESS_THREADS  # check_tx callers of a height's txs
CONS_PEER_THREADS = 16  # add_vote_from_peer callers of a round's votes
CONS_TAMPERED = (4_242, 5_151)  # the spoiled prevote's and precommit's
CONS_DUP_HEIGHT = 2  # validator CONS_DUP_VALIDATOR precommits twice
CONS_DUP_VALIDATOR = 17
CONS_ATTACK_HEIGHT = 2  # the light-client attack goes to add_evidence
CONS_ATTACK_SIGNERS = N_TRUST  # 3,334 of 10,000: over the 1/3 trust level
# The attack's codec bytes (3,334 signatures, its 3,334-validator set and
# the byzantine list as tagged JSON: ~2.5 MB) are over the default 1 MiB
# of evidence a block: the cell's genesis raises it.
CONS_EVIDENCE_BYTES = 4 << 20
CONS_TRACE_HEIGHT = 2  # the warm height profiled in a process of its own
CONS_WAIT_S = 180.0  # the most the others wait for one step of the node
CONS_SEED = b"consensus"


def consensus_config(burst: bool):
    """The port's Config for a consensus node: run (1)'s test_config
    timeouts with the propose window widened to 30 s and the prevote and
    precommit waits to 5 s (the nodes share one process and a host, and
    perfect gossip sends a block's parts once: a node that moves to a
    later round than its peers on a loaded host cannot fetch the block
    they commit); run (2)'s timeouts long enough that no round times out
    while the others sign and feed 10,000 votes, and CometBFT's default
    1 s commit timeout (the late precommits join the LastCommit)."""
    from cometbft_tpu_torch import config as tconfig

    cfg = tconfig.test_config()
    ms = 1_000_000
    if burst:
        cfg.consensus = dataclasses.replace(
            cfg.consensus, timeout_propose_ns=30_000 * ms,
            timeout_prevote_ns=5_000 * ms, timeout_precommit_ns=5_000 * ms)
    else:
        cfg.consensus = dataclasses.replace(
            cfg.consensus, timeout_propose_ns=600_000 * ms,
            timeout_prevote_ns=600_000 * ms,
            timeout_precommit_ns=600_000 * ms, timeout_commit_ns=1_000 * ms,
            skip_timeout_commit=False)
    return cfg


class ConsensusNode:
    """One port node in this process, wired as cometbft_tpu/node/node.py
    wires one (without p2p): the kvstore behind proxy.AppConns(local
    client), state.Store, store.BlockStore and the evidence pool's DB, each
    a FileDB under ``root`` (MemDB without one), an EventBus, the ABCI
    handshake (InitChain at genesis), a CListMempool, an EvidencePool, the
    BlockExecutor, the WAL (none without a root), the ConsensusState with
    ``pv`` and a CommitPipeline (COMETBFT_TPU_PIPELINE, _SPEC_EXEC), all
    on ``device``. A fatal error lands in ``fatal``."""

    def __init__(self, genesis, pv, cfg, root=None, device="cuda"):
        from cometbft_tpu_torch import proxy
        from cometbft_tpu_torch.abci import kvstore
        from cometbft_tpu_torch.consensus import ConsensusState
        from cometbft_tpu_torch.consensus.pipeline import (
            CommitPipeline, pipeline_mode, spec_mode)
        from cometbft_tpu_torch.consensus.replay import Handshaker
        from cometbft_tpu_torch.consensus.wal import WAL
        from cometbft_tpu_torch.evidence import EvidencePool
        from cometbft_tpu_torch.libs import db as dbm
        from cometbft_tpu_torch.mempool import CListMempool
        from cometbft_tpu_torch.state import (
            BlockExecutor, Store, make_genesis_state)
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types.event_bus import EventBus

        def db(name):
            if root is None:
                return dbm.MemDB()
            return dbm.FileDB(str(Path(root) / f"{name}.db"))

        self.dbs = {n: db(n) for n in ("app", "state", "blocks", "evidence")}
        self.fatal = []
        self.app = kvstore.KVStoreApplication(self.dbs["app"])
        self.conns = proxy.AppConns(proxy.local_client_creator(self.app))
        self.conns.start()
        self.state_store = Store(self.dbs["state"])
        self.block_store = BlockStore(self.dbs["blocks"])
        state = self.state_store.load()
        if state is None:
            state = make_genesis_state(genesis)
            self.state_store.save(state)
        self.bus = EventBus()
        self.bus.start()
        hs = Handshaker(self.state_store, state, self.block_store, genesis,
                        block_exec=BlockExecutor(
                            self.state_store, self.conns.consensus,
                            block_store=self.block_store, device=device))
        hs.handshake(self.conns)
        state = hs.state
        self.mempool = CListMempool(cfg.mempool, self.conns.mempool,
                                    height=state.last_block_height,
                                    device=device)
        self.evidence = EvidencePool(self.dbs["evidence"], self.state_store,
                                     self.block_store, device=device)
        self.exe = BlockExecutor(
            self.state_store, self.conns.consensus, mempool=self.mempool,
            evidence_pool=self.evidence, block_store=self.block_store,
            event_bus=self.bus, device=device)
        self.wal = (WAL(str(Path(root) / "cs.wal" / "wal"))
                    if root is not None else None)
        self.cs = ConsensusState(
            cfg.consensus, state, self.exe, self.block_store,
            tx_notifier=self.mempool, evidence_pool=self.evidence,
            event_bus=self.bus, wal=self.wal, device=device)
        self.cs.set_priv_validator(pv)
        self.cs.on_fatal = self.fatal.append
        pipe = CommitPipeline(self.exe, self.cs.wal,
                              on_fatal=self.fatal.append, device=device)
        pmode = pipeline_mode()
        pipe.enabled = pmode in ("auto", "on", "inline")
        pipe.inline = pmode == "inline"
        smode = spec_mode()
        pipe.spec_enabled = smode == "on" or (
            smode == "auto" and self.conns.consensus.supports_speculation())
        pipe.note_base(state.last_block_height)
        self.exe.prune_gate = pipe.durable_height
        self.cs.pipeline = pipe
        self.address = (bytes(pv.get_pub_key().address()) if pv is not None
                        else None)

    def stop(self) -> None:
        """Stop consensus (draining the pipeline; a kept prestage error
        raises here), then the bus, the app connections, the WAL and the
        DBs."""
        try:
            if self.cs.is_running():
                self.cs.stop()
        finally:
            self.bus.stop()
            self.conns.stop()
            if self.wal is not None:
                self.wal.close()
            for d in self.dbs.values():
                d.close()


def wire_gossip(nodes) -> None:
    """Perfect gossip (tests/helpers.py wire_perfect_gossip): every
    message a node sends itself also goes to every other node."""
    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, ProposalMessage, VoteMessage)

    css = [n.cs for n in nodes]
    for me, cs in enumerate(css):
        def send(msg, orig=cs._send_internal, me=me):
            orig(msg)
            for j, other in enumerate(css):
                if j == me:
                    continue
                if isinstance(msg, VoteMessage):
                    other.add_vote_from_peer(msg.vote, f"node{me}")
                elif isinstance(msg, ProposalMessage):
                    other.set_proposal_from_peer(msg.proposal, f"node{me}")
                elif isinstance(msg, BlockPartMessage):
                    other.add_block_part_from_peer(
                        msg.height, msg.round, msg.part, f"node{me}")
        cs._send_internal = send


def wait_for(cond, what: str, timeout: float = CONS_WAIT_S, nodes=(),
             state=None):
    """Poll ``cond()`` until it holds; fail naming ``what`` (and any
    node's fatal error, and ``state()`` when given) past ``timeout``
    seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        for n in nodes:
            check(not n.fatal, f"{what}: the node fail-stopped: {n.fatal}")
        check(time.monotonic() < deadline, f"timed out waiting for {what}"
              + (f": {state()}" if state is not None else ""))
        time.sleep(0.005)


def burst_txs() -> list[bytes]:
    return [b"burst-%03d=%s" % (i, hashlib.sha256(b"%d" % i).hexdigest()
                                .encode()) for i in range(CONS_BURST_TXS)]


def consensus_burst(root, device="cuda") -> dict:
    """Run (1): CONS_BURST_NODES port validators of power
    CONS_BURST_POWER in this process with perfect gossip, each a
    ConsensusNode under ``root``, CONS_BURST_TXS kvstore txs in every
    mempool; until every node stores CONS_BURST_HEIGHTS blocks. All must
    agree on each block and app hash, commit every tx once and end with
    empty mempools."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.types import GenesisDoc, GenesisValidator, MockPV

    pvs = [MockPV(Ed25519PrivKey.from_seed(_seed(CONS_SEED + b"-burst", i)))
           for i in range(CONS_BURST_NODES)]
    genesis = GenesisDoc(
        chain_id=CONS_CHAIN_ID + "-burst", genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.get_pub_key(), CONS_BURST_POWER)
                    for pv in pvs])
    cfg = consensus_config(burst=True)
    nodes = [ConsensusNode(genesis, pv, cfg, Path(root) / f"node{i}",
                           device) for i, pv in enumerate(pvs)]
    wire_gossip(nodes)
    txs = burst_txs()
    t = time.perf_counter()
    try:
        for n in nodes:
            for tx in txs:
                n.mempool.check_tx(tx)
        for n in nodes:
            n.cs.start()
        wait_for(lambda: min(n.block_store.height() for n in nodes)
                 >= CONS_BURST_HEIGHTS and all(
                     n.mempool.size() == 0 for n in nodes),
                 f"{CONS_BURST_NODES} nodes to commit {CONS_BURST_HEIGHTS} "
                 f"heights", nodes=nodes,
                 state=lambda: [(n.block_store.height(), n.mempool.size(),
                                 n.cs.get_round_state().round,
                                 n.cs.get_round_state().step.name)
                                for n in nodes])
        seconds = time.perf_counter() - t
    finally:
        for n in nodes:
            n.stop()
    for n in nodes:
        check(not n.fatal, f"a burst node fail-stopped: {n.fatal}")
    reopened = [ConsensusNode(genesis, pv, cfg, Path(root) / f"node{i}",
                              device) for i, pv in enumerate(pvs)]
    try:
        stores = [n.block_store for n in reopened]
        rounds, committed = [], collections.Counter()
        for h in range(1, CONS_BURST_HEIGHTS + 1):
            hashes = {bs.load_block(h).hash() for bs in stores}
            check(len(hashes) == 1, f"burst: the nodes disagree on block "
                  f"{h}")
            apps = {n.state_store.load_finalize_block_response(h).app_hash
                    for n in reopened}
            check(len(apps) == 1, f"burst: the nodes disagree on the app "
                  f"hash after block {h}")
            committed.update(stores[0].load_block(h).data.txs)
            rounds.append(stores[0].load_block_commit(h).round
                          if stores[0].height() > h else None)
        check(committed == collections.Counter(txs),
              f"burst: txs committed {sum(committed.values())} times, "
              f"{len(committed)} distinct, against {len(txs)} once each")
        apps = [n.state_store.load().app_hash for n in reopened]
        heights = [n.block_store.height() for n in reopened]
    finally:
        for n in reopened:
            n.stop()
    return {"nodes": CONS_BURST_NODES, "heights": heights,
            "commit_rounds": rounds, "txs": len(txs),
            "app_hashes": sorted({a.hex() for a in apps}),
            "seconds": seconds}


class NodeTimer:
    """Host ms of a consensus node's steps while entered, each summed over
    the threads that run it (the FSM, the commit writer, the speculation
    worker) and exclusive of the other steps nested in it: preverify (the
    receive loop's batch), admission (_try_add_vote, which also runs the
    transitions a vote triggers), validate_block, FinalizeBlock (or its
    speculation), Commit, the mempool's update, the state and block saves
    and the WAL. Also each preverify window's lanes."""

    STEPS = (("cs", "_preverify_queued_votes", "preverify"),
             ("cs", "_try_add_vote", "admission"),
             ("exe", "validate_block", "validate_block"),
             ("client", "finalize_block", "finalize_block"),
             ("client", "speculate_finalize", "finalize_block"),
             ("client", "commit", "commit"),
             ("mempool", "update", "mempool_update"),
             ("state_store", "save", "state_save"),
             ("block_store", "save_block", "block_save"),
             ("wal", "write", "wal"),
             ("wal", "write_sync", "wal"),
             ("wal", "flush_and_sync", "wal"))

    def __init__(self, node):
        import threading

        self.node = node
        self.owners = {"cs": node.cs, "exe": node.exe,
                       "client": node.conns.consensus,
                       "mempool": node.mempool,
                       "state_store": node.state_store,
                       "block_store": node.block_store, "wal": node.cs.wal}
        self.ms = collections.Counter()
        self.windows = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._patched = []

    def _wrap(self, real, key):
        def timed(*args, **kwargs):
            stack = self._local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t = time.perf_counter()
            try:
                out = real(*args, **kwargs)
                if key == "preverify":
                    with self._lock:
                        self.windows.append(len(out) if out else 0)
                return out
            finally:
                spent = time.perf_counter() - t
                nested = stack.pop()
                if stack:
                    stack[-1] += spent
                with self._lock:
                    self.ms[key] += 1e3 * (spent - nested)
        return timed

    def __enter__(self):
        for owner, name, key in self.STEPS:
            obj = self.owners[owner]
            if obj is None or not hasattr(obj, name):
                continue
            setattr(obj, name, self._wrap(getattr(obj, name), key))
            self._patched.append((obj, name))
        return self

    def __exit__(self, *exc):
        for obj, name in self._patched:
            delattr(obj, name)  # back to the class's method

    def take(self) -> tuple[dict, list]:
        """The steps' ms and the preverify windows' lanes so far, and zero
        for the next height."""
        with self._lock:
            ms, self.ms = dict(self.ms), collections.Counter()
            windows, self.windows = self.windows, []
        return ms, windows


class OtherValidators:
    """Plays every validator of a chain but the node's: builds a proposal
    when another validator is the proposer (through the node's own
    create_proposal_block, which reaps its mempool and evidence pool),
    signs it with the proposer's key, feeds it and its parts; then each
    round's votes of the other validators, one of them spoiled, through
    add_vote_from_peer from CONS_PEER_THREADS threads in a seeded shuffled
    order. ``sign`` signs [(seed, msg)]."""

    def __init__(self, node, genesis, seed_of, sign):
        self.node = node
        self.chain_id = genesis.chain_id
        self.seed_of = seed_of
        self.sign = sign
        self.hvs = {}  # height -> the node's HeightVoteSet

    def prepare(self, h: int, extra=None) -> dict:
        """Height ``h`` up to its votes: wait for the node to reach it,
        take or build the proposal, sign both rounds' votes for it. With
        ``extra`` (h -> callable), run it before a block is built."""
        from cometbft_tpu_torch.types import BlockID, PartSet, Proposal
        from cometbft_tpu_torch.types import canonical
        from cometbft_tpu_torch.types import serialization as ser

        cs, node = self.node.cs, self.node
        wait_for(lambda: cs.height() == h, f"the node to reach height {h}",
                 nodes=(node,))
        rs = cs.get_round_state()
        self.hvs[h] = rs.votes
        proposer = rs.validators.get_proposer()
        out = {"height": h, "own_proposal": proposer.address ==
               node.address}
        if extra is not None:
            extra(h)
        if out["own_proposal"]:
            # the node proposes round 0 itself once it enters PROPOSE
            def proposed():
                r = cs.get_round_state()
                return (r.height == h and r.proposal is not None
                        and r.proposal_block is not None)
            wait_for(proposed, f"the node's own proposal at {h}",
                     nodes=(node,))
            r = cs.get_round_state()
            out.update(block=r.proposal_block, parts=r.proposal_block_parts,
                       block_id=r.proposal.block_id, proposal=None)
        else:
            # the proposer builds on a durable H-1, as the node's own
            # _decide_proposal does (its evidence and mempool updated)
            wait_for(lambda: cs.pipeline.durable_height() >= h - 1,
                     f"height {h - 1} to be durable", nodes=(node,))
            with cs._mtx:
                state = cs.state
                last = cs.rs.last_commit
            t = time.perf_counter()
            blk = node.exe.create_proposal_block(
                h, state, last.make_extended_commit() if last is not None
                else None, proposer.address, time_ns=time.time_ns())
            ps = PartSet.from_data(ser.dumps(blk))
            bid = BlockID(blk.hash(), ps.header)
            prop = Proposal(height=h, round=0, pol_round=-1, block_id=bid,
                            timestamp_ns=time.time_ns())
            prop.signature = self.sign([(self.seed_of[proposer.address],
                                         prop.sign_bytes(self.chain_id))])[0]
            out.update(block=blk, parts=ps, block_id=bid, proposal=prop,
                       propose_ms=1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        vals = rs.validators
        out["prevotes"] = self.votes(vals, h, canonical.PREVOTE_TYPE,
                                     out["block_id"], CONS_TAMPERED[0])
        out["precommits"] = self.votes(vals, h, canonical.PRECOMMIT_TYPE,
                                       out["block_id"], CONS_TAMPERED[1])
        out["sign_ms"] = 1e3 * (time.perf_counter() - t)
        return out

    def votes(self, vals, h, msg_type, bid, tampered):
        """Every validator's vote but the node's, signed; the one at index
        ``tampered`` with a flipped signature byte."""
        from cometbft_tpu_torch.types import Vote

        t_ns = time.time_ns()
        unsigned = [Vote(msg_type=msg_type, height=h, round=0, block_id=bid,
                         timestamp_ns=t_ns + 7919 * i,
                         validator_address=v.address, validator_index=i)
                    for i, v in enumerate(vals.validators)
                    if v.address != self.node.address]
        sigs = self.sign([(self.seed_of[v.validator_address],
                           v.sign_bytes(self.chain_id)) for v in unsigned])
        votes = [dataclasses.replace(v, signature=s)
                 for v, s in zip(unsigned, sigs)]
        for i, v in enumerate(votes):
            if v.validator_index == tampered:
                votes[i] = dataclasses.replace(
                    v, signature=bytes([v.signature[0] ^ 1])
                    + v.signature[1:])
        return votes

    def feed(self, votes, first=()):
        """``first`` from this thread in order, then ``votes`` shuffled
        (seeded) from CONS_PEER_THREADS threads."""
        import random
        from concurrent.futures import ThreadPoolExecutor

        cs = self.node.cs
        for v in first:
            cs.add_vote_from_peer(v, "peer")
        order = list(votes)
        random.Random(int.from_bytes(CONS_SEED, "big") + votes[0].height
                      * 10 + votes[0].msg_type).shuffle(order)
        chunks = [order[i::CONS_PEER_THREADS]
                  for i in range(CONS_PEER_THREADS)]

        def put(chunk, peer):
            for v in chunk:
                cs.add_vote_from_peer(v, peer)
        with ThreadPoolExecutor(CONS_PEER_THREADS) as ex:
            list(ex.map(put, chunks, [f"peer{i}" for i in
                                      range(CONS_PEER_THREADS)]))

    def play(self, prep, conflicting=None) -> dict:
        """Feed height prep["height"]'s proposal (unless the node's own),
        its parts, the prevotes, then (once the node precommits) the
        precommits, ``conflicting`` right after its validator's genuine
        one; wait until the node has committed the block. Host ms from
        the proposal fed to the node's precommit, to the block stored, and
        to the height durable (the app's Commit and the state saved)."""
        from cometbft_tpu_torch.consensus.round_state import RoundStep

        cs, node, h = self.node.cs, self.node, prep["height"]
        t = time.perf_counter()
        if prep["proposal"] is not None:
            cs.set_proposal_from_peer(prep["proposal"], "peer")
            for part in prep["parts"].parts:
                cs.add_block_part_from_peer(h, 0, part, "peer")
        self.feed(prep["prevotes"])
        wait_for(lambda: cs.height() > h or cs.get_round_state().step
                 >= RoundStep.PRECOMMIT, f"the node to precommit at {h}",
                 nodes=(node,))
        out = {"proposal_to_precommit": 1e3 * (time.perf_counter() - t)}
        first = []
        precommits = prep["precommits"]
        if conflicting is not None:
            i = next(i for i, v in enumerate(precommits)
                     if v.validator_index == conflicting.validator_index)
            first = [precommits[i], conflicting]
            precommits = precommits[:i] + precommits[i + 1:]
        self.feed(precommits, first)
        wait_for(lambda: node.block_store.height() >= h,
                 f"the node to commit height {h}", nodes=(node,))
        out["proposal_to_stored"] = 1e3 * (time.perf_counter() - t)
        wait_for(lambda: cs.pipeline.durable_height() >= h,
                 f"height {h} to be durable", nodes=(node,))
        out["proposal_to_durable"] = 1e3 * (time.perf_counter() - t)
        return out

    def settle(self, h: int) -> None:
        """Wait until every valid precommit of height ``h`` is counted
        (the node's own with them), or until the node has left the
        commit timeout of height ``h + 1``, after which it drops late
        precommits (as the reference does)."""
        from cometbft_tpu_torch.consensus.round_state import RoundStep

        cs = self.node.cs
        pc = self.hvs[h].precommits(0)
        vals = pc.val_set
        want = (vals.total_voting_power()
                - vals.validators[CONS_TAMPERED[1]].voting_power)

        def settled():
            if pc.sum >= want:
                return True
            rs = cs.get_round_state()
            return rs.height > h + 1 or rs.step != RoundStep.NEW_HEIGHT
        wait_for(settled, f"height {h}'s precommits to be counted",
                 nodes=(self.node,))


def conflicting_precommit(others, prep, index):
    """Validator ``index``'s precommit at prep's height for another block,
    signed."""
    from cometbft_tpu_torch.types import (PRECOMMIT_TYPE, BlockID,
                                          PartSetHeader, Vote)

    vals = others.hvs[prep["height"]].val_set
    v = vals.validators[index]
    other = BlockID(hashlib.sha256(b"conflict").digest(),
                    PartSetHeader(1, hashlib.sha256(b"parts").digest()))
    vote = Vote(msg_type=PRECOMMIT_TYPE, height=prep["height"], round=0, block_id=other,
                timestamp_ns=time.time_ns(), validator_address=v.address,
                validator_index=index)
    vote.signature = others.sign([(others.seed_of[v.address],
                                   vote.sign_bytes(others.chain_id))])[0]
    return vote


def light_attack(others, common_height: int):
    """A LightClientAttackEvidence against the node's chain: block
    ``common_height + 1``'s header with another app hash, signed by the
    first CONS_ATTACK_SIGNERS validators of the common height's set (its
    commit carries their signatures alone)."""
    from cometbft_tpu_torch.types import (BlockID, PartSetHeader,
                                          ValidatorSet)
    from cometbft_tpu_torch.types import block as tblock
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.types.light_block import LightBlock, SignedHeader

    node = others.node
    vals = node.state_store.load_validators(common_height)
    trusted = node.block_store.load_block(common_height).header
    header = dataclasses.replace(
        trusted, height=common_height + 1, time_ns=trusted.time_ns + 10**9,
        app_hash=hashlib.sha256(b"forged").digest())
    bid = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(
        b"forged-parts").digest()))
    signers = vals.validators[:CONS_ATTACK_SIGNERS]
    unsigned = [tblock.CommitSig(tblock.BLOCK_ID_FLAG_COMMIT, v.address,
                                 header.time_ns + 7919 * i)
                for i, v in enumerate(signers)]
    commit = tblock.Commit(common_height + 1, 0, bid, unsigned)
    sigs = others.sign([(others.seed_of[cs.validator_address],
                         commit.vote_sign_bytes(others.chain_id, i))
                        for i, cs in enumerate(unsigned)])
    commit.signatures = [dataclasses.replace(cs, signature=s)
                         for cs, s in zip(unsigned, sigs)]
    return LightClientAttackEvidence(
        conflicting_block=LightBlock(SignedHeader(header, commit),
                                     ValidatorSet([dataclasses.replace(v)
                                                   for v in signers])),
        common_height=common_height, byzantine_validators=list(signers),
        total_voting_power=vals.total_voting_power(),
        timestamp_ns=trusted.time_ns)


def consensus_genesis(pubs):
    """Run (2)'s genesis: the chain cell's CONS_VALIDATORS keys at
    CHAIN_POWER, evidence up to CONS_EVIDENCE_BYTES a block."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types import (ConsensusParams, GenesisDoc,
                                          GenesisValidator)
    from cometbft_tpu_torch.types.params import EvidenceParams

    return GenesisDoc(
        chain_id=CONS_CHAIN_ID, genesis_time_ns=time.time_ns(),
        consensus_params=ConsensusParams(evidence=EvidenceParams(
            max_bytes=CONS_EVIDENCE_BYTES)),
        validators=[GenesisValidator(Ed25519PubKey(p), CHAIN_POWER)
                    for p in pubs[:CONS_VALIDATORS]])


def consensus_node(pubs, root, device="cuda"):
    """(genesis, {address: seed}, run (2)'s node holding validator 0's
    key, in the set's order)."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
    from cometbft_tpu_torch.types import MockPV

    genesis = consensus_genesis(pubs)
    seeds = chain_seeds()
    seed_of = {Ed25519PubKey(p).address(): s for p, s in zip(pubs, seeds)}
    first = genesis.validator_set().validators[0].address
    pv = MockPV(Ed25519PrivKey.from_seed(seed_of[first]))
    node = ConsensusNode(genesis, pv, consensus_config(burst=False), root,
                         device)
    return genesis, seed_of, node


def _traced_consensus(pubs):
    """Worker: run (2)'s node on MemDBs with the planes pushed, through
    heights 1 to CONS_TRACE_HEIGHT - 1 (the arena builds at the first),
    then the warm height CONS_TRACE_HEIGHT from its proposal fed to its
    block stored under torch.profiler (its votes signed before): (host
    ms, card-busy ms, device events)."""
    import torch

    from cometbft_tpu_torch.crypto import coalesce, hashplane

    vco = coalesce.VerifyCoalescer(device="cuda")
    hco = hashplane.HashCoalescer(device="cuda")
    for co, mod in ((vco, coalesce), (hco, hashplane)):
        co.start()
        mod.push_active(co)
    genesis, seed_of, node = consensus_node(pubs, None)
    others = OtherValidators(node, genesis, seed_of, _fast_sign_chunk)
    try:
        with env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"):
            check_txs(node.mempool, consensus_txs(1), CONS_TX_THREADS)
            node.cs.start()
            for h in range(1, CONS_TRACE_HEIGHT + 1):
                prep = others.prepare(h)
                if h < CONS_HEIGHTS:
                    check_txs(node.mempool, consensus_txs(h + 1),
                              CONS_TX_THREADS)
                if h < CONS_TRACE_HEIGHT:
                    others.play(prep)
                    continue
                host_ms, busy_ms, events = device_busy_ms(
                    torch, lambda: others.play(prep))
        check(not node.fatal, f"the traced node fail-stopped: {node.fatal}")
        return host_ms, busy_ms, events
    finally:
        node.stop()
        for co, mod in ((hco, hashplane), (vco, coalesce)):
            mod.pop_active(co)
            co.stop()


def consensus_txs(height: int) -> list[bytes]:
    """Run (2)'s height ``height``: CHAIN_TXS kvstore txs of
    CHAIN_TX_BYTES, distinct from the chain phase's."""
    return chain_txs(100 + height)


def phase_consensus(torch, card):
    """The consensus phase (see the module docstring, phase 13). Returns
    ({kernel: launches}, {kernel: {lanes: launches}}, the window
    comparisons' (err, mismatches), X4's launches, X4's launches by shape,
    X4's (err, mismatches))."""
    import shutil

    from cometbft_tpu_torch.crypto import coalesce, hashplane
    from cometbft_tpu_torch.libs import db as dbm
    from cometbft_tpu_torch.ops import cuda_sha256, cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.state import Store
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.abci import kvstore, types as abci
    from cometbft_tpu_torch.types import BLOCK_ID_FLAG_COMMIT
    from cometbft_tpu_torch.types.evidence import (DuplicateVoteEvidence,
                                                   LightClientAttackEvidence)

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "consensus"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # a node starts with the card's arena cold: the prestage of each new
    # validator set builds its tables (X1)
    ov._PUBKEY_CACHE = {}
    with get_context("spawn").Pool(WORKERS) as pool:
        t = time.perf_counter()
        pubs = _pool_map(pool, _fast_pubkey_chunk, chain_seeds())
        _, sign = _chain_signer(pubs, pool)
        keys_s = time.perf_counter() - t
        torch.cuda.synchronize()
        cuda_verify.reset_launches()  # the consensus path starts here
        cuda_sha256.reset_launches()
        with WindowRecorder(ov, cuda_verify) as recorder, \
                X4Recorder(cuda_sha256) as x4_recorder, \
                env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"):
            burst = consensus_burst(root / "burst")
            emit({"phase": "consensus.burst", **burst, "card": card})
            vco = coalesce.VerifyCoalescer(device="cuda")
            hco = hashplane.HashCoalescer(device="cuda")
            for co, mod in ((vco, coalesce), (hco, hashplane)):
                co.start()
                mod.push_active(co)
            genesis, seed_of, node = consensus_node(pubs, root / "node")
            others = OtherValidators(node, genesis, seed_of, sign)
            evidence, heights, seen = {}, [], {}

            def attack(h):
                if h == CONS_ATTACK_HEIGHT:
                    ev = light_attack(others, h - 1)
                    t = time.perf_counter()
                    node.evidence.add_evidence(ev)
                    evidence["light"] = ev
                    evidence["light_ms"] = 1e3 * (time.perf_counter() - t)
                    check(node.evidence.is_pending(ev), "the light-client "
                          "attack did not reach the pool")
            try:
                tx_ms = check_txs(node.mempool, consensus_txs(1),
                                  CONS_TX_THREADS)
                node.cs.start()
                with NodeTimer(node) as timer:
                    for h in range(1, CONS_HEIGHTS + 1):
                        k2_0 = dict(cuda_verify.LAUNCH_LANES[
                            "verify_kernel_cached"])
                        x1_0 = dict(cuda_verify.LAUNCH_LANES[
                            "build_pubkey_tables"])
                        x4_0 = dict(cuda_sha256.LAUNCH_SHAPES["sha256"])
                        prep = others.prepare(h, attack)
                        next_tx_ms = (check_txs(
                            node.mempool, consensus_txs(h + 1),
                            CONS_TX_THREADS) if h < CONS_HEIGHTS else None)
                        timer.take()  # the node's steps before the feed
                        conflicting = (conflicting_precommit(
                            others, prep, CONS_DUP_VALIDATOR)
                            if h == CONS_DUP_HEIGHT else None)
                        ms = others.play(prep, conflicting)
                        others.settle(h)
                        torch.cuda.synchronize()
                        steps, windows = timer.take()
                        commit = seen[h] = node.block_store.load_seen_commit()
                        x4_now = cuda_sha256.LAUNCH_SHAPES["sha256"]
                        row = {
                            "height": h, "round": commit.round,
                            "own_proposal": prep["own_proposal"],
                            "txs": len(prep["block"].data.txs),
                            "evidence": [type(e).__name__ for e in
                                         prep["block"].evidence],
                            "parts": prep["parts"].header.total,
                            "host_ms": {**ms, **{k: round(v, 3) for k, v in
                                                 sorted(steps.items())}},
                            "propose_ms": prep.get("propose_ms"),
                            "sign_ms": prep["sign_ms"],
                            "check_tx_ms": tx_ms,
                            "preverify_lanes": windows,
                            "k2_by_lanes": _lanes_since(
                                cuda_verify, "verify_kernel_cached", k2_0),
                            "x1_by_lanes": _lanes_since(
                                cuda_verify, "build_pubkey_tables", x1_0),
                            "x4_by_shape": {
                                f"{bb}x{lb}": n - x4_0.get((bb, lb), 0)
                                for (bb, lb), n in sorted(x4_now.items())
                                if n != x4_0.get((bb, lb), 0)},
                            "card": card}
                        tx_ms = next_tx_ms
                        heights.append(row)
                        emit({"phase": "consensus.height", **row})
                        check(commit.round == 0, f"height {h} committed in "
                              f"round {commit.round}: a timeout moved the "
                              f"round ({row['host_ms']})")
                wait_for(lambda: node.cs.pipeline.durable_height()
                         >= CONS_HEIGHTS, "the last height to be durable",
                         nodes=(node,))
                blocks = {h: node.block_store.load_block(h)
                          for h in range(1, CONS_HEIGHTS + 1)}
                stored = {h: node.block_store.load_block_commit(h)
                          for h in range(1, CONS_HEIGHTS)}
                dup_address = others.hvs[CONS_DUP_HEIGHT].val_set.validators[
                    CONS_DUP_VALIDATOR].address
                last = node.cs.state
                dup = [e for b in blocks.values() for e in b.evidence
                       if isinstance(e, DuplicateVoteEvidence)]
                light = [e for b in blocks.values() for e in b.evidence
                         if isinstance(e, LightClientAttackEvidence)]
                committed_ev = [node.evidence.is_committed(e)
                                for e in dup + light]
                mempool_left = node.mempool.size()
            finally:
                node.stop()
                for co, mod in ((hco, hashplane), (vco, coalesce)):
                    mod.pop_active(co)
                    co.stop()
            # read once the node and both planes have stopped: a warm-up
            # thread may launch after the last height
            torch.cuda.synchronize()
            launches = dict(cuda_verify.LAUNCHES)
            x4_shapes = dict(sorted(
                cuda_sha256.LAUNCH_SHAPES["sha256"].items()))
            x4_all = cuda_sha256.LAUNCHES["sha256"]
        check(not node.fatal, f"the node fail-stopped: {node.fatal}")
        # the spoiled votes did not count: not in the node's vote sets,
        # not in any commit it stored
        for h, hvs in others.hvs.items():
            counted = (hvs.prevotes(0).get_by_index(CONS_TAMPERED[0]),
                       hvs.precommits(0).get_by_index(CONS_TAMPERED[1]))
            check(counted == (None, None),
                  f"height {h}: a tampered vote was counted: {counted}")
            for c in (seen[h], stored.get(h)):
                check(c is None or c.signatures[CONS_TAMPERED[1]]
                      .block_id_flag != BLOCK_ID_FLAG_COMMIT,
                      f"height {h}: the tampered precommit is in a commit")
        check(len(dup) == 1 and dup[0].vote_a.validator_address
              == dup_address, f"{len(dup)} duplicate-vote evidence "
              f"committed, want 1 of validator {CONS_DUP_VALIDATOR}")
        check(any(isinstance(e, DuplicateVoteEvidence)
                  for e in blocks[CONS_DUP_HEIGHT + 1].evidence),
              f"the duplicate vote is not in block {CONS_DUP_HEIGHT + 1}")
        check(len(light) == 1 and light[0].hash()
              == evidence["light"].hash(),
              f"{len(light)} light-client attacks committed, want 1")
        check(all(committed_ev), "the pool did not mark the committed "
              "evidence")
        check(mempool_left == 0, f"the mempool kept {mempool_left} txs")

        # the four FileDBs reopened: the state, every block and the app
        t = time.perf_counter()
        reopened = {n: dbm.FileDB(str(root / "node" / f"{n}.db"))
                    for n in ("app", "state", "blocks")}
        try:
            loaded = Store(reopened["state"]).load()
            check(Store._encode_state(loaded) == Store._encode_state(last),
                  "the reopened state store does not hold the last state")
            bs = BlockStore(reopened["blocks"])
            check(bs.height() >= CONS_HEIGHTS and all(
                bs.load_block(h).hash() == b.hash()
                for h, b in blocks.items()),
                "the reopened block store lost a block")
            info = kvstore.KVStoreApplication(reopened["app"]).info(
                abci.RequestInfo())
            check(info.last_block_app_hash == last.app_hash
                  and info.last_block_height == last.last_block_height,
                  f"the reopened app: {info} against {last.app_hash.hex()}")
        finally:
            for d in reopened.values():
                d.close()
        reopen_ms = 1e3 * (time.perf_counter() - t)
        pool.close()
        pool.join()
    shutil.rmtree(root, ignore_errors=True)

    # every K2/X1 launch of the path against its plain version, and every
    # X4 launch: the phase's lane counts and shapes are its own
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    compared = compare_windows(torch, recorder.records, err, mismatches)
    check(not any(mismatches.values()),
          f"consensus windows != plain: {mismatches}")
    lanes = check_lanes(cuda_verify, "consensus", compared)
    check(launches["verify_kernel_cached"] > 0
          and launches["build_pubkey_tables"] > 0,
          f"consensus: K2 and X1 must both launch: {launches}")
    check(lanes["verify_kernel_cached"].get(CONS_ATTACK_SIGNERS, 0) >= 1,
          f"the light attack's trusting check did not run K2 at "
          f"{CONS_ATTACK_SIGNERS} lanes: {lanes['verify_kernel_cached']}")
    for name in ("verify_kernel", "verify_kernel8", "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the consensus path")
    x4_err, x4_mismatches, x4_compared = compare_x4(
        torch, x4_recorder.records)
    check(x4_mismatches == 0,
          f"consensus X4 != plain: {x4_mismatches} words")
    check(x4_all > 0 and len(x4_recorder.records) == x4_all
          and set(x4_shapes) <= x4_compared,
          f"consensus: X4 ran at {sorted(x4_shapes)}, compared at "
          f"{sorted(x4_compared)} only")

    # the card's busy and idle share of one warm height, in a process of
    # its own
    with get_context("spawn").Pool(1) as tracer:
        host_ms, busy_ms, ev = tracer.apply(_traced_consensus, (pubs,))
        tracer.close()
        tracer.join()
    check(ev > 0, "the traced warm height ran nothing on the card")
    emit({"phase": "consensus.trace", "step": f"height {CONS_TRACE_HEIGHT}, "
          "warm, profiled (proposal fed to block stored)",
          "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": ev, "idle_share": 1 - busy_ms / host_ms,
          "card": card})
    emit({"phase": "consensus", "validators": CONS_VALIDATORS,
          "heights": CONS_HEIGHTS, "launches": launches, "lanes": lanes,
          "x4_launches": x4_all, "x4_by_shape": {
              f"{bb}x{lb}": n for (bb, lb), n in x4_shapes.items()},
          "x4_mismatches": x4_mismatches, "x4_max_abs_err": x4_err,
          "windows_compared": len(recorder.records),
          "mismatches": dict(mismatches), "max_abs_err": dict(err),
          "evidence": {"duplicate_vote": len(dup),
                       "light_client_attack": len(light),
                       "light_add_ms": evidence["light_ms"]},
          "app_hash": last.app_hash.hex(), "reopen_ms": reopen_ms,
          "keys_seconds": keys_s,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return launches, lanes, (err, mismatches), x4_all, x4_shapes, (
        x4_err, x4_mismatches)


NET_CHAIN_ID = "chip-smoke-net"
NET_BURST_NODES = CONS_BURST_NODES  # run (1): four validators over TCP
NET_BURST_HEIGHTS = 5
NET_BURST_TXS = 8  # checked at node 3, queried at node 1
NET_HEIGHTS = 5  # the servers' chain: the follower applies 1 to 4
NET_TXS = 64  # a height's kvstore txs, ...
NET_TX_BYTES = 1_024  # ... of 1 KiB each
# BASELINE config 5's width: 4,096 signatures a commit, 2,731 lanes in the
# light check. Its keys are ed25519: a validator set holding an sr25519
# key has no hash (types/validator_set.pubkey_proto_encode raises, as the
# reference's does: CometBFT's PublicKey proto has no sr25519 field), so no
# block can carry one; the mixed phase runs config 5's mixed batches.
NET_VALIDATORS = MIXED_VALIDATORS
NET_LIGHT = 2 * NET_VALIDATORS // 3 + 1
NET_POWER = 100  # every validator's
NET_BAD_HEIGHT = 3  # the byzantine server's block with a spoiled LastCommit
NET_TAMPERED = 1_234  # its spoiled lane: under NET_LIGHT, so the light
# check reaches it
NET_TRACE_HEIGHT = 3  # the catch-up height profiled in a process of its own
NET_T0_NS = 1_780_000_000_000_000_000
NET_WAIT_S = 120.0  # the most one step of the phase may take
NET_FRAME_BYTES = 1_028  # a sealed frame's plaintext: length + 1,024 B
NET_FRAME_REPS = 2_000  # native frames timed ...
NET_PLAIN_REPS = 10  # ... and plain ones
NET_SEED = b"net"


class NetNode(ConsensusNode):
    """A ConsensusNode with the p2p wiring of cometbft_tpu/node/node.py,
    which the port has no Node to do (:270-353, :689, :722-726,
    :797-804): a NodeKey from ``key_seed``, a NodeInfo on the genesis chain
    id advertising the netstamp capability (libs/netstats), a
    MultiplexTransport and a Switch with MConnConfig from the config's p2p
    section, and the four reactors in add_reactor order MEMPOOL,
    BLOCKSYNC, EVIDENCE, CONSENSUS. Blocksync runs when ``block_sync`` and
    the node is not the only validator, and consensus then waits for it;
    ``consensus=False`` keeps the engine from starting at all (a server
    that only serves its store). start() listens on 127.0.0.1 at a free
    port, starts the switch (and with it consensus, unless it waits) and
    dials ``persistent`` peers. A device fault, a failed block or a fatal
    consensus error lands in ``fatal``."""

    def __init__(self, genesis, pv, cfg, key_seed, root=None, device="cuda",
                 block_sync=False, consensus=True):
        from cometbft_tpu_torch.blocksync import BlocksyncReactor
        from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
        from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
        from cometbft_tpu_torch.evidence import EvidenceReactor
        from cometbft_tpu_torch.libs import netstats
        from cometbft_tpu_torch.mempool.reactor import MempoolReactor
        from cometbft_tpu_torch.p2p import (MultiplexTransport, NodeInfo,
                                            NodeKey, Switch)
        from cometbft_tpu_torch.p2p.conn.connection import MConnConfig

        super().__init__(genesis, pv, cfg, root, device)
        state = self.cs.state
        only_us = (pv is not None and len(state.validators) == 1
                   and state.validators.has_address(self.address))
        run_blocksync = block_sync and not only_us
        self.consensus_reactor = ConsensusReactor(
            self.cs, wait_sync=run_blocksync or not consensus)
        self.blocksync_reactor = BlocksyncReactor(
            state, self.exe, self.block_store, run_blocksync,
            consensus_reactor=self.consensus_reactor,
            min_recv_rate=cfg.blocksync.min_recv_rate, device=device)
        self.mempool_reactor = MempoolReactor(cfg.mempool, self.mempool)
        self.node_key = NodeKey(Ed25519PrivKey.from_seed(key_seed))
        self.node_info = NodeInfo(
            node_id=self.node_key.node_id, listen_addr="",
            network=genesis.chain_id, moniker=cfg.base.moniker,
            other=({netstats.NODEINFO_STAMP_KEY: 1}
                   if netstats.stamping_wanted() else {}))
        self.transport = MultiplexTransport(
            self.node_key, self.node_info,
            handshake_timeout=cfg.p2p.handshake_timeout_ns / 1e9,
            dial_timeout=cfg.p2p.dial_timeout_ns / 1e9)
        self.switch = Switch(
            self.transport, mconn_config=MConnConfig(
                send_rate=cfg.p2p.send_rate, recv_rate=cfg.p2p.recv_rate,
                flush_throttle=cfg.p2p.flush_throttle_timeout_ns / 1e9),
            max_inbound=cfg.p2p.max_num_inbound_peers,
            max_outbound=cfg.p2p.max_num_outbound_peers)
        self.evidence_reactor = EvidenceReactor(self.evidence)
        for name, reactor in (("MEMPOOL", self.mempool_reactor),
                              ("BLOCKSYNC", self.blocksync_reactor),
                              ("EVIDENCE", self.evidence_reactor),
                              ("CONSENSUS", self.consensus_reactor)):
            self.switch.add_reactor(name, reactor)
        self.switch.on_fatal = self.fatal.append
        self.blocksync_reactor.on_fatal = self.fatal.append
        self._acquired = False

    def start(self, persistent=()) -> None:
        from cometbft_tpu_torch.libs import netstats

        netstats.acquire()
        self._acquired = True
        self.transport.listen("tcp://127.0.0.1:0")
        self.node_info.listen_addr = self.transport.listen_addr
        self.switch.start()
        if persistent:
            self.switch.set_persistent_peers(list(persistent))
            self.switch.dial_peers_async(list(persistent))

    @property
    def addr(self) -> str:
        """``id@host:port`` of the node's listener."""
        return (f"{self.node_key.node_id}@"
                f"{self.transport.listen_addr[len('tcp://'):]}")

    def stop(self) -> None:
        """Stop the switch (its reactors, consensus with them, and every
        peer connection), then what ConsensusNode.stop stops."""
        from cometbft_tpu_torch.libs import netstats

        try:
            if self.switch.is_running():
                self.switch.stop()
        finally:
            if self._acquired:
                netstats.release()
                self._acquired = False
            super().stop()


def net_burst(root, device="cuda") -> dict:
    """Run (1) of the net phase: NET_BURST_NODES port validators of power
    CONS_BURST_POWER, each a NetNode under ``root`` on a star around node 0
    (the others dial it as a persistent peer), NET_BURST_TXS kvstore txs
    checked at node 3 only; until every node stores NET_BURST_HEIGHTS
    blocks and node 1's kvstore answers every tx. All must agree on each
    block and app hash, and commit every tx once."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.types import GenesisDoc, GenesisValidator, MockPV

    pvs = [MockPV(Ed25519PrivKey.from_seed(_seed(NET_SEED + b"-burst", i)))
           for i in range(NET_BURST_NODES)]
    genesis = GenesisDoc(
        chain_id=NET_CHAIN_ID + "-burst", genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pv.get_pub_key(), CONS_BURST_POWER)
                    for pv in pvs])
    cfg = consensus_config(burst=True)
    nodes = [NetNode(genesis, pv, cfg, _seed(NET_SEED + b"-key", i),
                     Path(root) / f"node{i}", device)
             for i, pv in enumerate(pvs)]
    txs = {b"net-%02d" % i: hashlib.sha256(b"net %d" % i).hexdigest().encode()
           for i in range(NET_BURST_TXS)}

    def queried():
        return all(nodes[1].conns.query.query(abci.RequestQuery(data=k))
                   .value == v for k, v in txs.items())
    try:
        for k, v in txs.items():
            nodes[3].mempool.check_tx(k + b"=" + v)
        t = time.perf_counter()
        nodes[0].start()
        for n in nodes[1:]:
            n.start(persistent=[nodes[0].addr])
        wait_for(lambda: min(n.block_store.height() for n in nodes)
                 >= NET_BURST_HEIGHTS and queried(),
                 f"{NET_BURST_NODES} nodes over TCP to commit "
                 f"{NET_BURST_HEIGHTS} heights and node 1 to hold node 3's "
                 "txs", timeout=NET_WAIT_S, nodes=nodes,
                 state=lambda: [(n.block_store.height(), n.mempool.size(),
                                 len(n.switch.peers())) for n in nodes])
        seconds = time.perf_counter() - t
        heights = [n.block_store.height() for n in nodes]
        committed = collections.Counter()
        for h in range(1, min(heights) + 1):
            hashes = {n.block_store.load_block(h).hash() for n in nodes}
            check(len(hashes) == 1, f"net burst: the nodes disagree on "
                  f"block {h}")
            apps = {n.state_store.load_finalize_block_response(h).app_hash
                    for n in nodes}
            check(len(apps) == 1, f"net burst: the nodes disagree on the "
                  f"app hash after block {h}")
            committed.update(nodes[0].block_store.load_block(h).data.txs)
        check(committed == collections.Counter(k + b"=" + v
                                               for k, v in txs.items()),
              f"net burst: {sum(committed.values())} txs committed, "
              f"{len(committed)} distinct, against {len(txs)} once each")
        peers = [len(n.switch.peers()) for n in nodes]
        wire = [sum(p.mconn.send_monitor.total() for p in n.switch.peers())
                for n in nodes]
    finally:
        for n in nodes:
            n.stop()
    for n in nodes:
        check(not n.fatal, f"a net burst node fail-stopped: {n.fatal}")
    check(peers == [NET_BURST_NODES - 1] + [1] * (NET_BURST_NODES - 1),
          f"net burst: peers {peers}, want a star around node 0")
    return {"nodes": NET_BURST_NODES, "heights": heights, "peers": peers,
            "txs": len(txs), "tx_checked_at": 3, "tx_queried_at": 1,
            "mconn_bytes_sent": wire, "seconds": seconds}


def net_key_set(pool):
    """The catch-up chain's NET_VALIDATORS ed25519 keys, the first
    MIXED_ED of them the mixed phase's: ([public keys], {address: seed},
    sign), ``sign`` signing [(seed, msg)] through the pool's workers (in
    this process without a pool)."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey

    seeds = [_seed(b"mixed-ed", i) for i in range(NET_VALIDATORS)]
    if pool is None:
        pubs = _fast_pubkey_chunk(seeds)
    else:
        pubs = _pool_map(pool, _fast_pubkey_chunk, seeds)
    keys = [Ed25519PubKey(p) for p in pubs]
    secret = {k.address(): s for k, s in zip(keys, seeds)}

    def sign(items):
        if pool is None:
            return _fast_sign_chunk(items)
        return _pool_map(pool, _fast_sign_chunk, items)
    return keys, secret, sign


def net_genesis(keys):
    from cometbft_tpu_torch.types import GenesisDoc, GenesisValidator

    return GenesisDoc(chain_id=NET_CHAIN_ID, genesis_time_ns=NET_T0_NS,
                      validators=[GenesisValidator(k, NET_POWER)
                                  for k in keys])


def net_txs(height: int) -> list[bytes]:
    """Height ``height``'s NET_TXS kvstore txs of NET_TX_BYTES."""
    txs = []
    for i in range(NET_TXS):
        key = b"n%02d-k%04d" % (height, i)
        fill = NET_TX_BYTES - len(key) - 1
        value = hashlib.sha256(NET_SEED + key).hexdigest().encode()
        txs.append(key + b"=" + (value * (fill // len(value) + 1))[:fill])
    return txs


def net_chain(node, sign, secret):
    """Heights 1 to NET_HEIGHTS on ``node``'s executor, proposed and
    signed here as chain_height builds the chain cell's: NET_TXS txs
    through check_tx, create_proposal_block, apply_block, the commit
    signed by every validator, save_block. ({height: (block, part set,
    commit)}, {height: the state after it})."""
    from cometbft_tpu_torch.types import block, part_set
    from cometbft_tpu_torch.types import serialization as ser

    state = node.state_store.load()
    last_ext = None
    chain, states = {}, {}
    for h in range(1, NET_HEIGHTS + 1):
        check_txs(node.mempool, net_txs(h))
        blk = node.exe.create_proposal_block(
            h, state, last_ext, state.validators.get_proposer().address,
            time_ns=NET_T0_NS + h * 10**9)
        ps = part_set.PartSet.from_data(ser.dumps(blk))
        bid = block.BlockID(blk.hash(), ps.header)
        state = node.exe.apply_block(state, bid, blk)
        commit = chain_commit(sign, secret, state.last_validators, h, bid,
                              chain_id=NET_CHAIN_ID, t0_ns=NET_T0_NS)
        node.block_store.save_block(blk, ps, commit)
        last_ext = chain_extended(commit)
        chain[h], states[h] = (blk, ps, commit), state
    return chain, states


def byzantine_store(node, chain):
    """``chain`` saved into ``node``'s block store as it is, but for block
    NET_BAD_HEIGHT, whose LastCommit has lane NET_TAMPERED spoiled (its
    header, and so its hash, unchanged)."""
    from cometbft_tpu_torch.types import part_set
    from cometbft_tpu_torch.types import serialization as ser

    for h, (blk, ps, commit) in sorted(chain.items()):
        if h == NET_BAD_HEIGHT:
            blk = dataclasses.replace(blk, last_commit=_tampered_commit(
                blk.last_commit, NET_TAMPERED))
            ps = part_set.PartSet.from_data(ser.dumps(blk))
        node.block_store.save_block(blk, ps, commit)


class CatchupProbe:
    """What the net phase reads of the follower while it syncs: the pool's
    redone heights, the peers the switch stopped (with the reason and
    the wire bytes each way), the last request and the arrival of each
    height (host clock), and the host ms of each height's
    verify_commit_light and apply_block. Wraps the follower's objects and
    the blocksync reactor module's verify_commit_light; restore() puts
    them back."""

    def __init__(self, node):
        from cometbft_tpu_torch.blocksync import reactor as bs_reactor

        self.redone, self.stopped = [], []
        self.requested, self.arrived = {}, {}
        self.verify_ms, self.apply_ms = {}, {}
        self._saved = []
        bsr = node.blocksync_reactor
        pool = bsr.pool

        def wrap(owner, name, make):
            real = getattr(owner, name)
            self._saved.append((owner, name, real, name in vars(owner)))
            setattr(owner, name, make(real))

        def redo(real):
            def redo_request(height):
                self.redone.append(height)
                return real(height)
            return redo_request

        def stop(real):
            def stop_and_remove_peer(peer, reason):
                if node.switch.get_peer(peer.id) is not None:
                    self.stopped.append({
                        "peer": peer.id[:10], "reason": str(reason),
                        "mconn_bytes_sent": peer.mconn.send_monitor.total(),
                        "mconn_bytes_received":
                            peer.mconn.recv_monitor.total()})
                return real(peer, reason)
            return stop_and_remove_peer

        def request(real):
            def send_block_request(height, peer_id):
                self.requested[height] = time.perf_counter()
                return real(height, peer_id)
            return send_block_request

        def add(real):
            def add_block(peer_id, blk, ext_commit=None, size=0):
                ok = real(peer_id, blk, ext_commit, size)
                h = blk.header.height
                if ok and h in self.requested:
                    self.arrived[h] = 1e3 * (time.perf_counter()
                                             - self.requested[h])
                return ok
            return add_block

        def verify(real):
            def verify_commit_light(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    self.verify_ms.setdefault(args[3], []).append(
                        1e3 * (time.perf_counter() - t))
            return verify_commit_light

        def apply(real):
            def apply_block(state, bid, blk, *args, **kwargs):
                t = time.perf_counter()
                try:
                    return real(state, bid, blk, *args, **kwargs)
                finally:
                    self.apply_ms[blk.header.height] = 1e3 * (
                        time.perf_counter() - t)
            return apply_block

        wrap(pool, "redo_request", redo)
        wrap(pool, "add_block", add)
        wrap(pool, "send_request", request)
        wrap(node.switch, "stop_and_remove_peer", stop)
        wrap(bs_reactor, "verify_commit_light", verify)
        wrap(node.exe, "apply_block", apply)

    def restore(self) -> None:
        for owner, name, real, own in reversed(self._saved):
            if own:
                setattr(owner, name, real)
            else:
                delattr(owner, name)  # back to the class's method


@contextlib.contextmanager
def wheel_off():
    """The secret connection as a node without the ``cryptography`` wheel
    runs it, whether or not the wheel is installed here: X25519 and HKDF
    in Python, every frame sealed and opened by the native tier
    (crypto/aead.ChaCha20Poly1305Native)."""
    from cometbft_tpu_torch.crypto import aead
    from cometbft_tpu_torch.p2p.conn import secret_connection as sc

    saved = aead._HAVE_CRYPTOGRAPHY, sc._HAVE_CRYPTOGRAPHY
    aead._HAVE_CRYPTOGRAPHY = sc._HAVE_CRYPTOGRAPHY = False
    try:
        yield
    finally:
        aead._HAVE_CRYPTOGRAPHY, sc._HAVE_CRYPTOGRAPHY = saved


def frame_us() -> dict:
    """µs to seal and to open one NET_FRAME_BYTES frame (the secret
    connection's 1,024 B payload and its length) on the host through the
    native tier, the plain pure-Python construction and, where it is
    installed, the wheel's OpenSSL; all must give the same bytes."""
    from cometbft_tpu_torch.crypto import aead

    key, nonce = _seed(NET_SEED, 0), bytes(12)
    frame = _seed(NET_SEED, 1) * (NET_FRAME_BYTES // 32) + bytes(
        NET_FRAME_BYTES % 32)
    tiers = [("native", aead.ChaCha20Poly1305Native(key), NET_FRAME_REPS),
             ("plain", aead.ChaCha20Poly1305Fallback(key), NET_PLAIN_REPS)]
    if aead._HAVE_CRYPTOGRAPHY:
        tiers.append(("wheel", aead.new_chacha20poly1305(key),
                      NET_FRAME_REPS))
    out = {"frame_bytes": NET_FRAME_BYTES,
           "wheel_installed": aead._HAVE_CRYPTOGRAPHY}
    sealed = {}
    for name, cipher, reps in tiers:
        t = time.perf_counter()
        for _ in range(reps):
            sealed[name] = cipher.encrypt(nonce, frame, None)
        out[f"{name}_seal_us"] = 1e6 * (time.perf_counter() - t) / reps
        t = time.perf_counter()
        for _ in range(reps):
            opened = cipher.decrypt(nonce, sealed[name], None)
        out[f"{name}_open_us"] = 1e6 * (time.perf_counter() - t) / reps
        check(opened == frame, f"the {name} tier did not open its frame")
    check(len(set(sealed.values())) == 1,
          f"the frame ciphers differ: {sorted(sealed)}")
    return out


def _traced_net(key_specs, blocks):
    """Worker: a follower on MemDBs with blocksync on and no network: the
    net chain's blocks (codec bytes) handed to its pool as one peer's,
    heights 1 to NET_TRACE_HEIGHT - 1 applied (the arena builds at the
    first), then catch-up height NET_TRACE_HEIGHT (verify_commit_light,
    then apply_block) under torch.profiler: (host ms, card-busy ms,
    device events)."""
    import torch

    from cometbft_tpu_torch.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.crypto import keys as tkeys
    from cometbft_tpu_torch.types import serialization as ser

    tkeys.register_extra_key_types()
    keys = [tkeys.pubkey_from_type_and_bytes(t, b) for t, b in key_specs]
    node = ConsensusNode(net_genesis(keys), None, consensus_config(True))
    try:
        bsr = BlocksyncReactor(node.cs.state, node.exe, node.block_store,
                               True, device="cuda")
        pool = bsr.pool
        pool.set_peer_range("server", 1, len(blocks))
        pool.make_requests()
        for raw in blocks:
            check(pool.add_block("server", ser.loads(raw)),
                  "the traced pool refused a block")
        while pool.height < NET_TRACE_HEIGHT:
            check(bsr._pool_step(0.0) == bsr.STEP_APPLIED,
                  "a traced height did not apply")
        out = {}

        def height():
            out["step"] = bsr._pool_step(0.0)
        host_ms, busy_ms, events = device_busy_ms(torch, height)
        check(out["step"] == bsr.STEP_APPLIED
              and bsr._n_synced == NET_TRACE_HEIGHT,
              "the traced catch-up height did not apply")
        return host_ms, busy_ms, events
    finally:
        node.stop()


def phase_net(torch, card):
    """The net phase (see the module docstring, phase 14). Returns
    ({kernel: launches}, {kernel: {lanes: launches}}, the window
    comparisons' (err, mismatches))."""
    import shutil

    from cometbft_tpu_torch.blocksync import pool as bs_pool
    from cometbft_tpu_torch.crypto import aead
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.p2p.conn import secret_connection
    from cometbft_tpu_torch.types import serialization as ser

    t_phase = time.perf_counter()
    check((bs_pool.REQUEST_WINDOW, bs_pool.REQUEST_TIMEOUT,
           bs_pool.MIN_RECV_RATE, secret_connection.DATA_MAX_SIZE)
          == (20, 15.0, 7680, 1024),
          "the pool's constants or the frame size are not the reference's")
    emit({"phase": "net.frame", **frame_us()})
    root = Path(__file__).resolve().parent / "build" / "net"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ov._PUBKEY_CACHE = {}
    with get_context("spawn").Pool(WORKERS) as pool, wheel_off():
        tier = type(aead.new_chacha20poly1305(bytes(32))).__name__
        check(tier == "ChaCha20Poly1305Native",
              f"the secret connection's frames would use {tier}")
        t = time.perf_counter()
        keys, secret, sign = net_key_set(pool)
        keys_s = time.perf_counter() - t
        torch.cuda.synchronize()
        cuda_verify.reset_launches()  # the net path starts here
        with WindowRecorder(ov, cuda_verify) as recorder, \
                env("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0"):
            burst = net_burst(root / "burst")
            emit({"phase": "net.burst", **burst, "card": card})
            burst_lanes = {k: dict(v) for k, v in
                           cuda_verify.LAUNCH_LANES.items() if v}

            genesis = net_genesis(keys)
            cfg = consensus_config(burst=True)
            honest = NetNode(genesis, None, cfg, _seed(NET_SEED, 10),
                             root / "honest", consensus=False)
            byz = NetNode(genesis, None, cfg, _seed(NET_SEED, 11),
                          root / "byzantine", consensus=False)
            fol = NetNode(genesis, None, cfg, _seed(NET_SEED, 12),
                          root / "follower", block_sync=True)
            probe = None
            try:
                t = time.perf_counter()
                chain, states = net_chain(honest, sign, secret)
                chain_s = time.perf_counter() - t
                byzantine_store(byz, chain)
                block_bytes = {h: sum(len(p.bytes_) for p in ps.parts)
                               for h, (_, ps, _) in chain.items()}
                honest.start()
                byz.start()
                torch.cuda.synchronize()
                ov._PUBKEY_CACHE = {}  # the follower's arena starts cold
                probe = CatchupProbe(fol)
                t = time.perf_counter()
                fol.start()
                fol.switch.dial_peers_async([byz.addr])
                bsr = fol.blocksync_reactor
                wait_for(lambda: probe.stopped, "the follower to stop the "
                         "byzantine server", timeout=NET_WAIT_S,
                         nodes=(fol,), state=lambda: (
                             bsr.pool.height, probe.redone))
                reject_s = time.perf_counter() - t
                fol.switch.dial_peers_async([honest.addr])
                wait_for(bsr.synced.is_set, "the follower to catch up and "
                         "switch to consensus", timeout=NET_WAIT_S,
                         nodes=(fol,), state=lambda: (
                             bsr.pool.height, bsr._n_synced, probe.redone,
                             len(fol.switch.peers())))
                wait_for(fol.cs.is_running, "the follower's consensus to "
                         "start", timeout=NET_WAIT_S, nodes=(fol,))
                catchup_s = time.perf_counter() - t
                torch.cuda.synchronize()
                honest_peer = fol.switch.get_peer(honest.node_key.node_id)
                wire_honest = {
                    "mconn_bytes_sent": honest_peer.mconn.send_monitor.total(),
                    "mconn_bytes_received":
                        honest_peer.mconn.recv_monitor.total()}
                synced = bsr._n_synced
                skip_wal = not fol.cs.do_wal_catchup
                top = fol.block_store.height()
                ids = {h: (fol.block_store.load_block_meta(h).block_id,
                           honest.block_store.load_block_meta(h).block_id)
                       for h in range(1, NET_HEIGHTS)}
                apps = {h: (fol.state_store.load_finalize_block_response(h)
                            .app_hash, states[h].app_hash)
                        for h in range(1, NET_HEIGHTS)}
                fol_app = bsr.state.app_hash
            finally:
                if probe is not None:
                    probe.restore()
                for n in (fol, byz, honest):
                    n.stop()
            torch.cuda.synchronize()
            launches = dict(cuda_verify.LAUNCHES)  # read just after the path
        for n in (fol, byz, honest):
            check(not n.fatal, f"a net node fail-stopped: {n.fatal}")
        check(probe.redone[:2] == [2, 3],
              f"the byzantine block was not redone at heights 2 and 3: "
              f"{probe.redone}")
        check(len(probe.stopped) >= 1 and probe.stopped[0]["peer"]
              == byz.node_key.node_id[:10]
              and "bad block" in probe.stopped[0]["reason"],
              f"the byzantine server was not stopped: {probe.stopped}")
        check(synced >= NET_HEIGHTS - 1 and top >= NET_HEIGHTS - 1,
              f"the follower applied {synced} heights (store {top})")
        check(skip_wal, "the follower switched to consensus with its WAL "
              "catch-up on")
        for h in range(1, NET_HEIGHTS):
            check(ids[h][0] == ids[h][1], f"the follower's block ID at "
                  f"height {h} is not the honest server's")
            check(apps[h][0] == apps[h][1], f"the follower's app hash after "
                  f"height {h} is not the honest server's")
        check(fol_app == states[NET_HEIGHTS - 1].app_hash,
              "the follower's state is not the honest server's")
        for h in range(1, NET_HEIGHTS):
            emit({"phase": "net.catchup.height", "height": h,
                  "validators": len(keys), "block_bytes": block_bytes[h],
                  "host_ms": {"arrival_after_request": probe.arrived.get(h),
                              "verify_commit_light": probe.verify_ms.get(h),
                              "apply_block": probe.apply_ms.get(h)},
                  "card": card})
        pool.close()
        pool.join()
    shutil.rmtree(root, ignore_errors=True)

    # every K2/X1 launch of the phase against its plain version
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    compared = compare_windows(torch, recorder.records, err, mismatches)
    check(not any(mismatches.values()), f"net windows != plain: {mismatches}")
    lanes = check_lanes(cuda_verify, "net", compared)
    k2 = lanes["verify_kernel_cached"]
    check(k2.get(NET_LIGHT, 0) >= NET_HEIGHTS
          and k2.get(NET_VALIDATORS, 0) >= 1,
          f"K2 did not run the light checks at {NET_LIGHT} lanes and the "
          f"commits at {NET_VALIDATORS}: {k2}")
    check(burst_lanes.get("build_pubkey_tables", {}).get(NET_BURST_NODES, 0)
          >= 1 and "verify_kernel_cached" not in burst_lanes,
          f"the burst's launches: {burst_lanes}, want X1 at "
          f"{NET_BURST_NODES} keys and no K2")
    for name in ("verify_kernel", "verify_kernel8", "verify_kernel8_cached"):
        check(launches[name] == 0, f"{name} launched on the net path")

    # the card's busy and idle share of one catch-up height, in a process
    # of its own
    specs = [(k.type, k.bytes()) for k in keys]
    raw = [ser.dumps(chain[h][0]) for h in range(1, NET_TRACE_HEIGHT + 2)]
    with get_context("spawn").Pool(1) as tracer:
        host_ms, busy_ms, ev = tracer.apply(_traced_net, (specs, raw))
        tracer.close()
        tracer.join()
    check(ev > 0, "the traced catch-up height ran nothing on the card")
    emit({"phase": "net.trace", "step": f"catch-up height "
          f"{NET_TRACE_HEIGHT}, warm, profiled (verify_commit_light, "
          "apply_block)", "host_ms": host_ms, "device_busy_ms": busy_ms,
          "device_events": ev, "idle_share": 1 - busy_ms / host_ms,
          "card": card})
    emit({"phase": "net.catchup", "validators": len(keys),
          "key_type": "ed25519", "heights": NET_HEIGHTS,
          "secret_connection_tier": tier,
          "synced": synced, "redone": probe.redone,
          "stopped": probe.stopped, "honest_peer": wire_honest,
          "light_lanes": NET_LIGHT, "launches": launches, "lanes": lanes,
          "burst_lanes": burst_lanes,
          "windows_compared": len(recorder.records),
          "mismatches": dict(mismatches), "max_abs_err": dict(err),
          "pool": {"request_window": bs_pool.REQUEST_WINDOW,
                   "request_timeout_s": bs_pool.REQUEST_TIMEOUT,
                   "min_recv_rate": bs_pool.MIN_RECV_RATE,
                   "frame_bytes": secret_connection.DATA_MAX_SIZE},
          "app_hash": fol_app.hex(), "keys_seconds": keys_s,
          "chain_seconds": chain_s, "reject_seconds": reject_s,
          "catchup_seconds": catchup_s,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return launches, lanes, (err, mismatches)


def _lanes_since(cuda_verify, name, before) -> dict:
    """{lanes: launches} of ``name`` since the snapshot ``before``."""
    return {n: c - before.get(n, 0) for n, c in sorted(
        cuda_verify.LAUNCH_LANES[name].items()) if c != before.get(n, 0)}


# X2's and X3's launches on each path (ops.cuda_verify.OP_LAUNCHES), read
# by check_lanes with K1-K4's just after the path
OP_BY_PATH: dict[str, dict] = {}


def time_torch_ops(torch, card, vals, commit) -> dict:
    """X2 and X3, the device programs that the reference left to XLA and
    the port runs as torch ops (ops/verify.py), timed by CUDA events at
    the commit cell's shapes (time_ms: KERNEL_REPS calls between two
    events, median of RUNS): X2 as a cache on the card runs it
    (PubkeyTableCache._scatter: the slots' copy to the card and its two
    index_copy calls) scattering 10,000 keys' tables into its 16,385-slot
    arena, X3 unpacking the commit's 10,000 wire rows for K1 (128 B a
    lane) and for K2 (96 B a lane) and bit-packing the verdicts of the
    16,384-lane wire bucket; each beside its bytes bound (what the
    function needs read once and written once, over the memory rate: the
    scatter reads the tables, oks and slots and writes the same rows),
    with their launches on each path (OP_BY_PATH). X2's "port_bytes" is
    what its out-of-place index_copy moves: the whole arena read and a
    new one written, beside the tables, oks and slots."""
    from cometbft_tpu_torch.ops import curve, field
    from cometbft_tpu_torch.ops import verify as ov

    dev = ov.resolve_device("cuda")
    n = N_VALIDATORS
    buf, _ = ov.pack_bytes(*commit_lanes(vals, [commit]))
    wire = torch.from_numpy(buf).to(dev)
    rsk = wire[32:].contiguous()
    cache = ov.PubkeyTableCache(device="cuda")
    keys = [i.to_bytes(32, "little") for i in range(n)]
    slots = cache._assign(keys, set(keys))
    gen = torch.Generator().manual_seed(n)
    tables = torch.randint(0, 8192, (curve.TSIZE, 4, field.NLIMB, n),
                           generator=gen, dtype=torch.int32).to(dev)
    oks = torch.ones(n, dtype=torch.bool, device=dev)
    idx = torch.from_numpy(slots).to(dev)
    size = ov.bucket_size(n)
    verdicts = torch.zeros(size, dtype=torch.bool, device=dev)
    verdicts[:n] = True

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def scatter():
        cache._scatter(slots, tables, oks)
        return cache._arena, cache._arena_ok

    # X2 needs the tables, oks and slots read and the same rows written
    ops = {"x2_scatter": (scatter, 2 * nbytes(tables, oks) + nbytes(idx)),
           "x3_unpack_k1": (lambda: ov.unpack_on_device(wire), None),
           "x3_unpack_k2": (lambda: ov._unpack_rsk_on_device(rsk), None),
           "x3_bitpack": (lambda: ov._pack_ok_bits(verdicts), None)}
    inputs = {"x3_unpack_k1": (wire,), "x3_unpack_k2": (rsk,),
              "x3_bitpack": (verdicts,)}
    line = {}
    with torch.no_grad():
        for name, (fn, needed) in ops.items():
            ms, out = time_ms(torch, fn, KERNEL_REPS)
            if needed is None:
                outs = out.values() if isinstance(out, dict) else (out,)
                needed = nbytes(*inputs[name]) + nbytes(*outs)
            bound_ms = 1e3 * needed / PEAK_BYTES_PER_S
            line[name] = {"ms": ms, "bytes": needed, "bound_ms": bound_ms,
                          "bound_by": "bytes", "bound_share": bound_ms / ms}
    arena, arena_ok = scatter()
    line["x2_scatter"]["port_bytes"] = 2 * nbytes(arena, arena_ok) + nbytes(
        tables, oks, idx)
    check(torch.equal(arena[..., idx], tables)
          and bool(arena_ok[idx].all()) and int(arena_ok.sum()) == n,
          "X2 scattered wrong")
    return {"phase": "torch_ops", "lanes": n, "ops": line,
            "launches_by_path": OP_BY_PATH, "card": card}


def check_lanes(cuda_verify, path, compared_on_path=None, rlc_compared=(),
                cuda_rlc=None):
    """{kernel: {lane count: launches}} of K1-K4's and X1's launches on
    ``path`` since the last reset, and under "rlc" X5's by (A bucket, R
    bucket); each count must be one the kernels phase compared the kernel
    at, or for a kernel in ``compared_on_path`` ({kernel: lane counts}),
    exactly one that the path's own windows were compared at, and each X5
    shape one of ``rlc_compared`` (none outside the rlc path)."""
    from cometbft_tpu_torch.ops import cuda_verify as ops_counts

    if cuda_rlc is None:
        from cometbft_tpu_torch.ops import cuda_rlc
    OP_BY_PATH[path] = dict(ops_counts.OP_LAUNCHES)
    lanes = {k: dict(sorted(cuda_verify.LAUNCH_LANES[k].items()))
             for k in cuda_verify.LAUNCH_LANES}
    for name, counts in lanes.items():
        compared = set(COMPARED_LANES)
        if name == "build_pubkey_tables":
            compared |= set(X1_PATH_LANES)
        if name == "verify_kernel":
            compared |= set(K1_MESH_LANES)
        if compared_on_path is not None and name in compared_on_path:
            compared = set(compared_on_path[name])
        check(set(counts) <= compared,
              f"{path}: {name} ran at {sorted(counts)} lanes, compared at "
              f"{sorted(compared)} only")
    shapes = dict(sorted(cuda_rlc.LAUNCH_SHAPES["rlc"].items()))
    check(set(shapes) <= set(rlc_compared),
          f"{path}: X5 ran at (A bucket, R bucket) {sorted(shapes)}, "
          f"compared at {sorted(rlc_compared)} only")
    lanes["rlc"] = {"%dx%d" % s: n for s, n in shapes.items()}
    return lanes


def cache_stats(cache):
    return {"hits": cache.hits, "misses": cache.misses,
            "builds": cache.builds, "evictions": cache.evictions}


def device_busy_ms(torch, fn):
    """(host ms, card-busy ms, device events) of one fn() call under
    torch.profiler: busy is the union of the card's kernel, copy and set
    intervals in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    return host_ms, busy_us / 1e3, len(spans)


LIBS_VERIFIES = 1_000  # Ed25519PubKey.verify_signature calls timed


def phase_observations(node) -> dict:
    """crypto_verify_phase_seconds' observation counts by "phase/backend"
    in ``node``."""
    return {"/".join(key): child._n for key, child in sorted(
        node.verify_phase_seconds._children.items())}


def libs_line(torch, node, after_slice, vals, commit, card) -> dict:
    """The verify path's reports (the pushed NodeMetrics' phase
    observations after the slice phase and at the end, devstats' transfer
    counters and device-memory gauges), the fast25519 tier in force, and
    LIBS_VERIFIES single verifies of one commit signature."""
    from cometbft_tpu_torch.crypto import fast25519
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.libs import devstats

    sample = devstats.sample(node)
    pub = Ed25519PubKey(vals.validators[0].pub_key.data)
    msg = commit.vote_sign_bytes(CHAIN_ID, 0)
    sig = commit.signatures[0].signature
    check(pub.verify_signature(msg, sig), "verify_signature rejected")
    check(not pub.verify_signature(msg + b"!", sig),
          "verify_signature accepted a wrong message")
    t = time.perf_counter()
    for _ in range(LIBS_VERIFIES):
        pub.verify_signature(msg, sig)
    us = 1e6 * (time.perf_counter() - t) / LIBS_VERIFIES
    check(after_slice.get("pack/ed25519-tpu", 0) > 0,
          f"no verify phase observed in the slice phase: {after_slice}")
    return {"phase": "libs",
            "verify_phase_observations_after_slice": after_slice,
            "verify_phase_observations": phase_observations(node),
            "verify_batch_observations": {
                "/".join(k): c._n for k, c in sorted(
                    node.verify_batch_seconds._children.items())},
            "devstats": devstats.counters(),
            "device_memory": sample["device_memory"],
            "pubkey_arena": sample["pubkey_arena"],
            "fast25519_tier": fast25519.tier(),
            "cryptography_wheel": fast25519.HAVE_OPENSSL,
            "verify_signature_us": us, "verify_signature_calls":
            LIBS_VERIFIES, "card": card}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # the port itself: outside a checkout this fails before any output
    from cometbft_tpu_torch.crypto import secp256k1
    from cometbft_tpu_torch.ops import build, cuda_verify

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "hashlib_ripemd160": secp256k1.HASHLIB_RIPEMD160})

    t0 = time.perf_counter()
    cuda_verify._entries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {src: info["seconds"]
                           for src, info in build.BUILD_INFO.items()},
          "kernels": {k: v for info in build.BUILD_INFO.values()
                      for k, v in build.ptxas_usage(info["ptxas"]).items()}})

    # the verify path reports to a pushed NodeMetrics and, with devstats
    # on, counts its transfers (the libs line)
    from cometbft_tpu_torch.libs import devstats, metrics

    node = metrics.NodeMetrics()
    metrics.push_node_metrics(node)
    devstats.acquire()
    with get_context("spawn").Pool(WORKERS) as pool:
        timed = phase_kernels(torch, pool)
        slice_launches, slice_lanes, slice_cache, vals, commit = phase_slice(
            torch, pool, smi)
        after_slice = phase_observations(node)
        light_launches, light_lanes = phase_light(torch, pool, smi,
                                                  slice_cache)
        vote_launches, vote_lanes, (vote_err, vote_mismatches) = phase_vote(
            torch, pool, smi, vals, commit)
        mixed_launches, mixed_lanes, (mixed_err, mixed_mismatches) = (
            phase_mixed(torch, pool, smi))
        rlc_launches, rlc_lanes, rlc_row = phase_rlc(torch, pool, smi,
                                                     vals, commit)
        emit(time_torch_ops(torch, smi, vals, commit))
        rlc_shapes = rlc_lanes["rlc"]
        mesh_launches, mesh_lanes = phase_mesh(torch, pool, smi, vals, commit)
        ledger_sets = make_ledger_sets(pool)
        pool.close()
        pool.join()
    hash_launches, x4_row, x4_compared = phase_hash(torch, smi, vals, commit)
    (ledger_launches, ledger_lanes, (ledger_err, ledger_mismatches),
     ledger_x4, ledger_x4_shapes) = phase_ledger(torch, smi, ledger_sets,
                                                 x4_compared)
    emit(libs_line(torch, node, after_slice, vals, commit, smi))
    metrics.pop_node_metrics(node)
    devstats.release()
    (chain_launches, chain_lanes, (chain_err, chain_mismatches), chain_x4,
     chain_x4_shapes, chain_x4_diff) = phase_chain(torch, smi)
    (cons_launches, cons_lanes, (cons_err, cons_mismatches), cons_x4,
     cons_x4_shapes, cons_x4_diff) = phase_consensus(torch, smi)
    net_launches, net_lanes, (net_err, net_mismatches) = phase_net(torch,
                                                                   smi)

    replaces = {
        "verify_kernel": "cometbft_tpu/ops/pallas_verify.py:922",
        "verify_kernel_cached": "cometbft_tpu/ops/pallas_verify.py:858",
        "build_pubkey_tables": "cometbft_tpu/ops/verify.py:442",
        "verify_kernel8": "cometbft_tpu/ops/pallas_verify.py:745",
        "verify_kernel8_cached": "cometbft_tpu/ops/pallas_verify.py:801",
    }
    # launches: on the path that runs the kernel (the slice phase for the
    # 4-bit kernels, the light phase for the 8-bit ones; X1 runs on both)
    usage = {k: v for info in build.BUILD_INFO.values()
             for k, v in build.ptxas_usage(info["ptxas"]).items()}
    timed["build_pubkey_tables"].update(usage.get("x1_build_tables", {}))
    by_lanes = {name: dict(collections.Counter(slice_lanes[name])
                           + collections.Counter(light_lanes[name])
                           + collections.Counter(vote_lanes[name])
                           + collections.Counter(mixed_lanes[name])
                           + collections.Counter(rlc_lanes[name])
                           + collections.Counter(mesh_lanes[name])
                           + collections.Counter(ledger_lanes[name])
                           + collections.Counter(chain_lanes[name])
                           + collections.Counter(cons_lanes[name])
                           + collections.Counter(net_lanes[name]))
                for name in cuda_verify.LAUNCHES}
    # the vote, mixed, ledger, chain, consensus and net paths' launches
    # were compared too: their differences join the kernels phase's
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        for path_err, path_mismatches in ((vote_err, vote_mismatches),
                                          (mixed_err, mixed_mismatches),
                                          (ledger_err, ledger_mismatches),
                                          (chain_err, chain_mismatches),
                                          (cons_err, cons_mismatches),
                                          (net_err, net_mismatches)):
            timed[name]["max_abs_err"] = max(timed[name]["max_abs_err"],
                                             path_err[name])
            timed[name]["mismatches"] += path_mismatches[name]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "cometbft_tpu_torch/ops/csrc/" + cuda_verify.SOURCES[name],
         "replaces": replaces[name],
         "launches": (slice_launches[name] + light_launches[name]
                      + vote_launches[name] + mixed_launches[name]
                      + rlc_launches[name] + mesh_launches[name]
                      + ledger_launches[name] + chain_launches[name]
                      + cons_launches[name] + net_launches[name]),
         "launches_by_path": {"slice": slice_launches[name],
                              "light": light_launches[name],
                              "vote": vote_launches[name],
                              "mixed": mixed_launches[name],
                              "rlc": rlc_launches[name],
                              "mesh": mesh_launches[name],
                              "ledger": ledger_launches[name],
                              "chain": chain_launches[name],
                              "consensus": cons_launches[name],
                              "net": net_launches[name]},
         "launches_by_lanes": by_lanes[name],
         **timed[name], "library_ms": None}
        for name in ("verify_kernel_cached", "verify_kernel",
                     "build_pubkey_tables", "verify_kernel8_cached",
                     "verify_kernel8")
    ] + [
        {"name": "rlc", "route": "cuda",
         "source": "cometbft_tpu_torch/ops/csrc/rlc.cu",
         "replaces": "cometbft_tpu/ops/rlc.py:210",
         "launches": rlc_launches["rlc"],
         "launches_by_path": {"rlc": rlc_launches["rlc"]},
         "launches_by_shape": rlc_shapes, **rlc_row, "library_ms": None},
    ] + [
        {"name": "sha256", "route": "cuda",
         "source": "cometbft_tpu_torch/ops/csrc/sha256.cu",
         "replaces": "cometbft_tpu/ops/sha256.py:178",
         "launches": hash_launches + ledger_x4 + chain_x4 + cons_x4,
         "launches_by_path": {"hash": hash_launches, "ledger": ledger_x4,
                              "chain": chain_x4, "consensus": cons_x4},
         **x4_row, "launches_by_shape": {
             f"{bb}x{lb}": n for (bb, lb), n in sorted((collections.Counter(
                 {tuple(map(int, k.split("x"))): v for k, v in
                  x4_row["launches_by_shape"].items()})
                 + collections.Counter(ledger_x4_shapes)
                 + collections.Counter(chain_x4_shapes)
                 + collections.Counter(cons_x4_shapes)).items())},
         "max_abs_err": max(x4_row["max_abs_err"], chain_x4_diff[0],
                            cons_x4_diff[0]),
         "mismatches": (x4_row["mismatches"] + chain_x4_diff[1]
                        + cons_x4_diff[1]),
         "library_ms": None},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
