"""Light client error taxonomy (reference: light/errors.go).

The error TYPE drives control flow: bisection pivots on
NewValSetCantBeTrustedError, a provider that serves a malformed block
raises BadLightBlockError, and witnesses that disagree raise
ConflictingHeadersError, so these are classes, not strings. Names and
fields are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class LightClientError(Exception):
    pass


@dataclass
class OldHeaderExpiredError(LightClientError):
    """Trusted header is outside the trusting period (errors.go:16)."""

    expired_at_ns: int
    now_ns: int

    def __str__(self) -> str:
        return (
            f"old header has expired at {self.expired_at_ns} "
            f"(now: {self.now_ns})"
        )


@dataclass
class InvalidHeaderError(LightClientError):
    """New header could not be verified (errors.go:48)."""

    reason: Exception

    def __str__(self) -> str:
        return f"invalid header: {self.reason}"


@dataclass
class NewValSetCantBeTrustedError(LightClientError):
    """< trust-level of the trusted set signed the new header — the
    bisection signal, NOT a failure (errors.go:38)."""

    reason: Exception

    def __str__(self) -> str:
        return f"cant trust new val set: {self.reason}"


@dataclass
class VerificationFailedError(LightClientError):
    """Verification chain broke between two heights (errors.go:26)."""

    from_height: int
    to_height: int
    reason: Exception

    def __str__(self) -> str:
        return (
            f"verify from #{self.from_height} to #{self.to_height} "
            f"failed: {self.reason}"
        )


@dataclass
class LightBlockNotFoundError(LightClientError):
    """Provider has no block at the height (provider/errors.go:12)."""

    height: int = 0

    def __str__(self) -> str:
        return f"light block at height {self.height} not found"


@dataclass
class NoWitnessesError(LightClientError):
    """All witnesses exhausted (errors.go:77)."""

    def __str__(self) -> str:
        return "no witnesses connected. please reset light client"


@dataclass
class BadLightBlockError(LightClientError):
    """Provider returned a malformed/foreign light block — malevolent
    signal, provider must be dropped (provider/errors.go:22)."""

    reason: Exception

    def __str__(self) -> str:
        return f"bad light block: {self.reason}"


@dataclass
class ConflictingHeadersError(LightClientError):
    """A witness returned a header conflicting with the primary
    (errors.go:84) — input to the attack detector."""

    block: object  # LightBlock from the witness
    witness_index: int = 0

    def __str__(self) -> str:
        return (
            f"witness #{self.witness_index} has a different header at "
            f"height {getattr(self.block, 'height', '?')}"
        )


@dataclass
class FailedHeaderCrossReferencingError(LightClientError):
    """All witnesses failed to respond during cross-checking
    (errors.go:60)."""

    errors: list = field(default_factory=list)

    def __str__(self) -> str:
        return f"all witnesses failed cross-referencing: {self.errors}"
