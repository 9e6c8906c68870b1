"""Commit verification, the engine-wide hot path (types/validation.go).

All three façades tally voting power while streaming (pubkey, sign-bytes,
signature) triples into one device batch:

* verify_commit          — full check, every signature (consensus apply path)
* verify_commit_light    — stop at +2/3, commit-flag sigs only (light/blocksync)
* verify_commit_light_trusting — trust-level fraction over a *different*
  validator set, lookup by address (light-client bisection)

Semantics follow types/validation.go:26-257, including the batch-vs-single
threshold and the find-first-invalid error. ``device`` (default the GPU),
``pubkey_cache`` (an ops.verify.PubkeyTableCache, or None for the
process-wide cache of the device; COMETBFT_TPU_PUBKEY_CACHE=0 turns that
off and runs the uncached kernel) and ``flavor`` (the kernels' flavor,
"4", "8" or None for COMETBFT_TPU_KERNEL; ops.verify.kernel_flavor) pass
through to the batch verifier.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import batch as crypto_batch
from .block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    Commit,
)
from .validator_set import ValidatorSet

BATCH_VERIFY_THRESHOLD = 2  # types/validation.go:13-17


class VerificationError(Exception):
    pass


@dataclass
class NotEnoughVotingPowerError(VerificationError):
    got: int
    needed: int

    def __str__(self) -> str:
        return (
            f"invalid commit -- insufficient voting power: got {self.got}, "
            f"needed more than {self.needed}"
        )


@dataclass(frozen=True)
class Fraction:
    numerator: int
    denominator: int


DEFAULT_TRUST_LEVEL = Fraction(1, 3)


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    # Unlike Go (which keys off one type and verifies a mixed set singly,
    # types/validation.go:170-176), a set of ed25519 and sr25519 keys
    # batches too, in one crypto_batch.MixedBatchVerifier; a secp256k1 key
    # has no batch backend, so its set verifies singly.
    return (
        len(commit.signatures) >= BATCH_VERIFY_THRESHOLD
        and crypto_batch.supports_commit_batch(vals)
    )


def _verify_basic(vals, commit, height, block_id) -> None:
    if vals is None:
        raise VerificationError("nil validator set")
    if commit is None:
        raise VerificationError("nil commit")
    if len(vals) != len(commit.signatures):
        raise VerificationError(
            f"validator set size {len(vals)} != commit size "
            f"{len(commit.signatures)}"
        )
    if height != commit.height:
        raise VerificationError(
            f"invalid commit height {commit.height}, expected {height}"
        )
    if block_id != commit.block_id:
        raise VerificationError(
            f"invalid commit block id {commit.block_id}, expected {block_id}"
        )


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    *,
    device="cuda",
    pubkey_cache=None,
    flavor=None,
) -> None:
    """+2/3 check over ALL signatures (incl. nil votes) — consensus path."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    ignore = lambda cs: cs.block_id_flag == BLOCK_ID_FLAG_ABSENT  # noqa: E731
    count = lambda cs: cs.block_id_flag == BLOCK_ID_FLAG_COMMIT  # noqa: E731
    _verify(
        chain_id, vals, commit, needed, ignore, count,
        count_all=True, by_index=True, device=device,
        pubkey_cache=pubkey_cache, flavor=flavor,
    )


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    *,
    device="cuda",
    pubkey_cache=None,
    flavor=None,
) -> None:
    """+2/3 check, commit-flag signatures only, stops when reached."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    ignore = lambda cs: cs.block_id_flag != BLOCK_ID_FLAG_COMMIT  # noqa: E731
    count = lambda cs: True  # noqa: E731
    _verify(
        chain_id, vals, commit, needed, ignore, count,
        count_all=False, by_index=True, device=device,
        pubkey_cache=pubkey_cache, flavor=flavor,
    )


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    *,
    device="cuda",
    pubkey_cache=None,
    flavor=None,
) -> None:
    """trust-level fraction of a (possibly different) validator set."""
    if vals is None:
        raise VerificationError("nil validator set")
    if commit is None:
        raise VerificationError("nil commit")
    if trust_level.denominator == 0:
        raise VerificationError("trust level has zero denominator")
    needed = (
        vals.total_voting_power() * trust_level.numerator
    ) // trust_level.denominator
    ignore = lambda cs: cs.block_id_flag != BLOCK_ID_FLAG_COMMIT  # noqa: E731
    count = lambda cs: True  # noqa: E731
    _verify(
        chain_id, vals, commit, needed, ignore, count,
        count_all=False, by_index=False, device=device,
        pubkey_cache=pubkey_cache, flavor=flavor,
    )


def _verify(
    chain_id, vals, commit, needed, ignore, count, count_all, by_index,
    device, pubkey_cache, flavor,
) -> None:
    from ..libs import devledger

    # the ledger's default tenant of a commit check; an outer declaration
    # (the light client's) wins
    with devledger.caller_class("commit-verify"):
        if _should_batch_verify(vals, commit):
            bv = crypto_batch.create_commit_batch_verifier(
                vals, device=device, pubkey_cache=pubkey_cache, flavor=flavor
            )
            _verify_batch(
                bv, chain_id, vals, commit, needed, ignore, count, count_all,
                by_index,
            )
        else:
            _verify_single(
                chain_id, vals, commit, needed, ignore, count, count_all,
                by_index,
            )


def _walk(vals, commit, ignore, by_index):
    """(idx, validator) for each signature the check reads, in order;
    a validator seen twice (lookup by address) raises."""
    seen: dict[int, int] = {}
    for idx, cs in enumerate(commit.signatures):
        if ignore(cs):
            continue
        if by_index:
            yield idx, vals.validators[idx]
            continue
        val_idx, val = vals.get_by_address(cs.validator_address)
        if val is None:
            continue
        if val_idx in seen:
            raise VerificationError(
                f"double vote from validator {val_idx} "
                f"({seen[val_idx]} and {idx})"
            )
        seen[val_idx] = idx
        yield idx, val


def _verify_batch(
    bv, chain_id, vals, commit, needed, ignore, count, count_all, by_index
) -> None:
    """Mirror of verifyCommitBatch (types/validation.go:153-257)."""
    batch_sig_idxs: list[int] = []
    tallied = 0
    for idx, val in _walk(vals, commit, ignore, by_index):
        cs = commit.signatures[idx]
        bv.add(val.pub_key, commit.vote_sign_bytes(chain_id, idx),
               cs.signature)
        batch_sig_idxs.append(idx)
        if count(cs):
            tallied += val.voting_power
        if not count_all and tallied > needed:
            break
    if tallied <= needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=needed)
    ok, valid_sigs = bv.verify()
    if ok:
        return
    for i, sig_ok in enumerate(valid_sigs):
        if not sig_ok:
            idx = batch_sig_idxs[i]
            raise VerificationError(
                f"wrong signature (#{idx}): "
                f"{commit.signatures[idx].signature.hex()}"
            )
    raise VerificationError(
        "BUG: batch verification failed with no invalid signatures"
    )


def _verify_single(
    chain_id, vals, commit, needed, ignore, count, count_all, by_index
) -> None:
    """Mirror of verifyCommitSingle (types/validation.go:266-330).

    With a verify coalescer routed (crypto/coalesce), the eligible
    signatures of the walk are deferred and submitted as one group, so
    concurrent single-verify commit checks share windows; the tally, the
    early stop and the error for the first invalid index are the unrouted
    walk's. A raise inside the walk is held until the deferred lanes, all
    of which precede it, are verified: an invalid deferred signature is
    named before a later double vote or inline failure. A routed window
    that fails raises; nothing is verified again on the host."""
    from ..crypto import coalesce

    co = coalesce.active()
    tallied = 0
    deferred: list[tuple] = []  # (idx, pubkey, sign bytes, signature)
    stopped_early = False
    walk_exc: BaseException | None = None
    walk = _walk(vals, commit, ignore, by_index)
    while True:
        try:
            item = next(walk, None)
            if item is None:
                break
            idx, val = item
            cs = commit.signatures[idx]
            sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        except Exception as e:  # held until the deferred lanes are read
            walk_exc = e
            break
        if co is not None and coalesce.eligible(val.pub_key):
            deferred.append((idx, val.pub_key, sign_bytes, cs.signature))
        elif not val.pub_key.verify_signature(sign_bytes, cs.signature):
            walk_exc = VerificationError(f"wrong signature (#{idx})")
            break
        if count(cs):
            tallied += val.voting_power
        if not count_all and tallied > needed:
            stopped_early = True
            break
    if deferred:
        bits = co.try_verify(
            [pk.data for _, pk, _, _ in deferred],
            [sb for _, _, sb, _ in deferred],
            [sig for _, _, _, sig in deferred],
        )
        for (idx, _, _, _), ok in zip(deferred, bits):
            if not ok:
                raise VerificationError(f"wrong signature (#{idx})")
    if walk_exc is not None:
        raise walk_exc
    if stopped_early:
        return
    if tallied <= needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=needed)
