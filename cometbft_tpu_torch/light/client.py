"""Light client with bisection ("skipping") verification.

Reference: light/client.go:133-1184. The client tracks a primary provider
plus witnesses, keeps verified light blocks in a trusted store, and
verifies headers either sequentially (adjacent, hash-chained) or by
bisection: try the non-adjacent trust-level check straight to the target;
on NewValSetCantBeTrusted, pivot to an intermediate height and recurse.
Every commit check lands in the batched verifiers, so a deep catch-up is
a few kernel launches rather than thousands of host verifies.

The trusted store defaults to the in-memory :class:`~.store.MemStore`
until the db-backed ``Store`` is ported. ``commit_verifier`` (a
:class:`~.verifier.CommitVerifier`) says where the commit checks run:
None takes the default one, on the GPU.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from ..types.validation import DEFAULT_TRUST_LEVEL, Fraction
from ..types.light_block import LightBlock
from . import verifier
from .errors import (
    BadLightBlockError,
    ConflictingHeadersError,
    FailedHeaderCrossReferencingError,
    LightBlockNotFoundError,
    LightClientError,
    NewValSetCantBeTrustedError,
    NoWitnessesError,
    VerificationFailedError,
)
from .provider import Provider
from .store import MemStore

SECOND_NS = verifier.SECOND_NS

# pivot = trusted + 9/10 * (target - trusted)  (client.go:46-52)
_PIVOT_NUM = 9
_PIVOT_DEN = 10


@dataclass(frozen=True)
class TrustOptions:
    """Subjective-initialization root of trust (light/trust_options.go)."""

    period_ns: int  # trusting period
    height: int
    hash: bytes

    def validate_basic(self) -> None:
        if self.period_ns <= 0:
            raise LightClientError("trusting period must be > 0")
        if self.height <= 0:
            raise LightClientError("trust height must be > 0")
        if len(self.hash) != 32:
            raise LightClientError("trust hash must be 32 bytes")


@dataclass
class Client:
    chain_id: str
    trust_options: TrustOptions
    primary: Provider
    witnesses: list[Provider] = field(default_factory=list)
    trusted_store: MemStore = field(default_factory=MemStore)
    trust_level: Fraction = DEFAULT_TRUST_LEVEL
    max_clock_drift_ns: int = verifier.DEFAULT_MAX_CLOCK_DRIFT_NS
    # verification trace of the latest skipping run
    latest_trace: list[LightBlock] = field(default_factory=list)
    # where the commit checks run (light/verifier.CommitVerifier: device,
    # flavor, pubkey cache); None = the default one, on the GPU
    commit_verifier: verifier.CommitVerifier | None = None

    def __post_init__(self) -> None:
        verifier.validate_trust_level(self.trust_level)
        self.trust_options.validate_basic()
        self._check_trusted_header_using_options()

    # -- initialization ----------------------------------------------------

    def _check_trusted_header_using_options(self) -> None:
        """client.go:303-401: restore from store or fetch + pin the trusted
        header against the subjective trust options."""
        last_h = self.trusted_store.last_light_block_height()
        if last_h > 0:
            return  # previously initialized: keep the store's root of trust
        lb = self._block_from(self.primary, self.trust_options.height)
        if lb.height != self.trust_options.height:
            raise LightClientError(
                f"trusted provider returned height {lb.height}, "
                f"expected {self.trust_options.height}"
            )
        if lb.hash() != self.trust_options.hash:
            raise LightClientError(
                f"trusted header hash mismatch: got {lb.hash().hex()}, "
                f"expected {self.trust_options.hash.hex()}"
            )
        lb.validate_basic(self.chain_id)
        # 2/3 of the block's own validator set must have signed it
        # (initializeWithTrustOptions, client.go:362-401)
        cv = self.commit_verifier or verifier.DEFAULT_COMMIT_VERIFIER
        cv.verify_commit_light(
            self.chain_id,
            lb.validator_set,
            lb.signed_header.commit.block_id,
            lb.height,
            lb.signed_header.commit,
        )
        self.trusted_store.save_light_block(lb)

    # -- public API --------------------------------------------------------

    def trusted_light_block(self, height: int = 0) -> LightBlock:
        """client.go:404-433 (0 = latest trusted)."""
        if height == 0:
            height = self.trusted_store.last_light_block_height()
        return self.trusted_store.light_block(height)

    def last_trusted_height(self) -> int:
        return self.trusted_store.last_light_block_height()

    def first_trusted_height(self) -> int:
        return self.trusted_store.first_light_block_height()

    def update(self, now_ns: int | None = None) -> LightBlock | None:
        """Fetch + verify the primary's latest block (client.go:436-471)."""
        now_ns = self._now(now_ns)
        latest = self._block_from(self.primary, 0)
        last = self.last_trusted_height()
        if latest.height > last:
            self.verify_light_block(latest, now_ns)
            return latest
        return None

    def verify_light_block_at_height(
        self, height: int, now_ns: int | None = None
    ) -> LightBlock:
        """client.go:474-522: return trusted block at height, fetching and
        verifying (forwards or backwards) as needed."""
        if height <= 0:
            raise LightClientError("height must be positive")
        now_ns = self._now(now_ns)
        try:
            return self.trusted_store.light_block(height)
        except LightBlockNotFoundError:
            pass
        lb = self._block_from(self.primary, height)
        self.verify_light_block(lb, now_ns)
        return lb

    def verify_light_block(
        self, new_lb: LightBlock, now_ns: int | None = None
    ) -> None:
        """client.go:558-610: sequential/backwards/skipping dispatch."""
        now_ns = self._now(now_ns)
        new_lb.validate_basic(self.chain_id)
        last = self.last_trusted_height()
        first = self.first_trusted_height()
        if last < 0:
            raise LightClientError("uninitialized client")
        if new_lb.height >= last + 1:
            trusted = self.trusted_store.light_block(last)
            self._verify_skipping(trusted, new_lb, now_ns)
        elif new_lb.height < first:
            self._verify_backwards(new_lb, now_ns)
        else:
            existing = None
            try:
                existing = self.trusted_store.light_block(new_lb.height)
            except LightBlockNotFoundError:
                trusted = self.trusted_store.light_block_before(new_lb.height)
                self._verify_skipping(trusted, new_lb, now_ns)
            if existing is not None and existing.hash() != new_lb.hash():
                raise LightClientError(
                    f"header at height {new_lb.height} conflicts with "
                    f"existing trusted header"
                )

    # -- verification strategies ------------------------------------------

    def _verify_skipping(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> None:
        """Bisection (client.go:706-775). Verified pivots land in the
        trusted store; the full trace is kept in latest_trace."""
        if target.height == trusted.height + 1:
            verifier.verify_adjacent(
                trusted.signed_header,
                target.signed_header,
                target.validator_set,
                self.trust_options.period_ns,
                now_ns,
                self.max_clock_drift_ns,
                self.commit_verifier,
            )
            self.trusted_store.save_light_block(target)
            self.latest_trace = [trusted, target]
            return
        block_cache = [target]
        depth = 0
        verified = trusted
        trace = [trusted]
        while True:
            try:
                verifier.verify(
                    verified.signed_header,
                    verified.validator_set,
                    block_cache[depth].signed_header,
                    block_cache[depth].validator_set,
                    self.trust_options.period_ns,
                    now_ns,
                    self.max_clock_drift_ns,
                    self.trust_level,
                    self.commit_verifier,
                )
            except NewValSetCantBeTrustedError:
                # pivot deeper: fetch an intermediate block
                if depth == len(block_cache) - 1:
                    pivot = (
                        verified.height
                        + (block_cache[depth].height - verified.height)
                        * _PIVOT_NUM
                        // _PIVOT_DEN
                    )
                    interim = self._block_from(self.primary, pivot)
                    block_cache.append(interim)
                depth += 1
                continue
            except Exception as e:
                raise VerificationFailedError(
                    verified.height, block_cache[depth].height, e
                ) from e
            # verified block_cache[depth]
            if depth == 0:
                trace.append(target)
                self.trusted_store.save_light_block(target)
                self.latest_trace = trace
                return
            verified = block_cache[depth]
            self.trusted_store.save_light_block(verified)
            trace.append(verified)
            del block_cache[depth:]
            depth = 0

    def _verify_backwards(self, target: LightBlock, now_ns: int) -> None:
        """Hash-chain walk below the earliest trusted header
        (client.go:933-987)."""
        trusted = self.trusted_store.light_block(self.first_trusted_height())
        if verifier.header_expired(
            trusted.signed_header, self.trust_options.period_ns, now_ns
        ):
            raise LightClientError("can't verify backwards: trusted expired")
        cur = trusted
        for height in range(trusted.height - 1, target.height - 1, -1):
            interim = (
                target
                if height == target.height
                else self._block_from(self.primary, height)
            )
            verifier.verify_backwards(
                interim.signed_header.header, cur.signed_header.header
            )
            self.trusted_store.save_light_block(interim)
            cur = interim

    # -- witness management (client.go:1019-1129) --------------------------

    def compare_first_header_with_witnesses(self, sh) -> None:
        """Each witness must serve the same header; conflicting headers
        raise ConflictingHeadersError (client.go:1131+)."""
        if not self.witnesses:
            return
        errors = []
        bad: list[int] = []
        for i, w in enumerate(self.witnesses):
            try:
                alt = self._block_from(w, sh.height)
            except Exception as e:
                errors.append(e)
                bad.append(i)
                continue
            if alt.hash() != sh.hash():
                raise ConflictingHeadersError(alt, i)
        if len(errors) == len(self.witnesses):
            raise FailedHeaderCrossReferencingError(errors)
        for i in reversed(bad):
            del self.witnesses[i]

    def remove_witnesses(self, indexes: list[int]) -> None:
        if len(indexes) >= len(self.witnesses) and self.witnesses:
            self.witnesses = []
            raise NoWitnessesError()
        for i in sorted(indexes, reverse=True):
            del self.witnesses[i]

    # -- maintenance -------------------------------------------------------

    def cleanup_after(self, height: int) -> None:
        """Drop all trusted blocks above height (client.go:881-907)."""
        last = self.last_trusted_height()
        for h in range(height + 1, last + 1):
            self.trusted_store.delete_light_block(h)

    # -- internals ---------------------------------------------------------

    def _block_from(self, p: Provider, height: int) -> LightBlock:
        lb = p.light_block(height)
        if lb is None:
            raise LightBlockNotFoundError(height)
        try:
            lb.validate_basic(self.chain_id)
        except BadLightBlockError:
            raise
        except Exception as e:
            raise BadLightBlockError(e) from e
        return lb

    @staticmethod
    def _now(now_ns: int | None) -> int:
        return _time.time_ns() if now_ns is None else now_ns
