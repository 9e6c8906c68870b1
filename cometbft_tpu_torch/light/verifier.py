"""Core light-client verification (reference: light/verifier.go).

Both checks bottom out in the batched commit verifiers of
types/validation.py, so a 10,000-validator light replay is a handful of
kernel launches on the card. :class:`CommitVerifier` carries where and how
they run: ``device`` (default the GPU), ``flavor`` (the kernels' flavor:
"4", "8", or None for COMETBFT_TPU_KERNEL) and ``pubkey_cache``.
"""

from __future__ import annotations

from ..types import validation
from ..types.light_block import SignedHeader
from ..types.validation import (
    DEFAULT_TRUST_LEVEL,
    Fraction,
    NotEnoughVotingPowerError,
)
from ..types.validator_set import ValidatorSet
from .errors import (
    InvalidHeaderError,
    LightClientError,
    NewValSetCantBeTrustedError,
    OldHeaderExpiredError,
)

SECOND_NS = 1_000_000_000
DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * SECOND_NS


class CommitVerifier:
    """The commit checks the light verification steps run.

    ``device`` (default ``"cuda"``: without a GPU a check raises),
    ``flavor`` and ``pubkey_cache`` (an ops.verify.PubkeyTableCache on that
    device, or None for the process-wide cache of the device, which
    COMETBFT_TPU_PUBKEY_CACHE=0 turns off) pass through to
    types/validation. Nothing is checked until a commit is.
    """

    def __init__(self, device="cuda", flavor=None, pubkey_cache=None):
        self.device = device
        self.flavor = flavor
        self.pubkey_cache = pubkey_cache

    def verify_commit_light(
        self, chain_id, vals, block_id, height, commit
    ) -> None:
        validation.verify_commit_light(
            chain_id, vals, block_id, height, commit, device=self.device,
            pubkey_cache=self.pubkey_cache, flavor=self.flavor,
        )

    def verify_commit_light_trusting(
        self, chain_id, vals, commit, trust_level
    ) -> None:
        validation.verify_commit_light_trusting(
            chain_id, vals, commit, trust_level, device=self.device,
            pubkey_cache=self.pubkey_cache, flavor=self.flavor,
        )


DEFAULT_COMMIT_VERIFIER = CommitVerifier()


def validate_trust_level(lvl: Fraction) -> None:
    """Trust level must lie in [1/3, 1] (verifier.go:197-205)."""
    if (
        lvl.numerator * 3 < lvl.denominator
        or lvl.numerator > lvl.denominator
        or lvl.denominator == 0
    ):
        raise LightClientError(
            f"trustLevel must be within [1/3, 1], given {lvl}"
        )


def header_expired(h: SignedHeader, trusting_period_ns: int,
                   now_ns: int) -> bool:
    """verifier.go:208-211."""
    return h.time_ns + trusting_period_ns <= now_ns


def _verify_new_header_and_vals(
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted_header: SignedHeader,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    """verifier.go:153-195."""
    untrusted_header.validate_basic(trusted_header.chain_id)
    if untrusted_header.height <= trusted_header.height:
        raise ValueError(
            f"expected new header height {untrusted_header.height} to be "
            f"greater than old header height {trusted_header.height}"
        )
    if untrusted_header.time_ns <= trusted_header.time_ns:
        raise ValueError(
            "expected new header time to be after old header time"
        )
    if untrusted_header.time_ns >= now_ns + max_clock_drift_ns:
        raise ValueError(
            f"new header has a time from the future "
            f"({untrusted_header.time_ns} > now {now_ns} + drift "
            f"{max_clock_drift_ns})"
        )
    if untrusted_header.header.validators_hash != untrusted_vals.hash():
        raise ValueError(
            "header validators_hash does not match supplied validator set"
        )


def verify_adjacent(
    trusted_header: SignedHeader,  # height X
    untrusted_header: SignedHeader,  # height X+1
    untrusted_vals: ValidatorSet,  # height X+1
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    commit_verifier: CommitVerifier | None = None,
) -> None:
    """Hash-chain + 2/3 check for adjacent headers (verifier.go:93-132)."""
    cv = commit_verifier if commit_verifier is not None \
        else DEFAULT_COMMIT_VERIFIER
    if untrusted_header.height != trusted_header.height + 1:
        raise LightClientError("headers must be adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now_ns):
        raise OldHeaderExpiredError(
            trusted_header.time_ns + trusting_period_ns, now_ns
        )
    try:
        _verify_new_header_and_vals(
            untrusted_header, untrusted_vals, trusted_header,
            now_ns, max_clock_drift_ns,
        )
    except Exception as e:
        raise InvalidHeaderError(e) from e
    if (
        untrusted_header.header.validators_hash
        != trusted_header.header.next_validators_hash
    ):
        raise LightClientError(
            "expected old header next validators to match those from new "
            "header"
        )
    try:
        cv.verify_commit_light(
            trusted_header.chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.height,
            untrusted_header.commit,
        )
    except Exception as e:
        raise InvalidHeaderError(e) from e


def verify_non_adjacent(
    trusted_header: SignedHeader,  # height X
    trusted_vals: ValidatorSet,  # height X or X+1
    untrusted_header: SignedHeader,  # height Y
    untrusted_vals: ValidatorSet,  # height Y
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    commit_verifier: CommitVerifier | None = None,
) -> None:
    """Skipping verification (verifier.go:32-80): trust-level fraction of
    the TRUSTED set plus 2/3 of the NEW set must have signed.

    The trusted-set check runs first because untrusted_vals can be made
    arbitrarily large to DoS the client (verifier.go:69-72)."""
    cv = commit_verifier if commit_verifier is not None \
        else DEFAULT_COMMIT_VERIFIER
    if untrusted_header.height == trusted_header.height + 1:
        raise LightClientError("headers must be non adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now_ns):
        raise OldHeaderExpiredError(
            trusted_header.time_ns + trusting_period_ns, now_ns
        )
    try:
        _verify_new_header_and_vals(
            untrusted_header, untrusted_vals, trusted_header,
            now_ns, max_clock_drift_ns,
        )
    except Exception as e:
        raise InvalidHeaderError(e) from e

    try:
        cv.verify_commit_light_trusting(
            trusted_header.chain_id,
            trusted_vals,
            untrusted_header.commit,
            trust_level,
        )
    except NotEnoughVotingPowerError as e:
        raise NewValSetCantBeTrustedError(e) from e

    try:
        cv.verify_commit_light(
            trusted_header.chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.height,
            untrusted_header.commit,
        )
    except Exception as e:
        raise InvalidHeaderError(e) from e


def verify(
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    commit_verifier: CommitVerifier | None = None,
) -> None:
    """Dispatch adjacent/non-adjacent (verifier.go:135-151)."""
    if untrusted_header.height != trusted_header.height + 1:
        verify_non_adjacent(
            trusted_header, trusted_vals, untrusted_header, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns, trust_level,
            commit_verifier,
        )
    else:
        verify_adjacent(
            trusted_header, untrusted_header, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns,
            commit_verifier,
        )


def verify_backwards(untrusted_header, trusted_header) -> None:
    """Hash-chain check one height backwards (verifier.go:214-244):
    trusted.last_block_id.hash must equal hash(untrusted)."""
    untrusted_header.validate_basic()
    if untrusted_header.chain_id != trusted_header.chain_id:
        raise InvalidHeaderError(ValueError("header belongs to another chain"))
    if untrusted_header.time_ns >= trusted_header.time_ns:
        raise InvalidHeaderError(
            ValueError("expected older header time to be before newer")
        )
    if trusted_header.last_block_id.hash != untrusted_header.hash():
        raise InvalidHeaderError(
            ValueError(
                "trusted header last_block_id does not match hash of "
                "older header"
            )
        )
