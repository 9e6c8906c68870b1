"""Light client: trust-period verification over batched commit checks.

Reference: cometbft_tpu/light (client.go, verifier.go, store/, provider/).
The names below are the reference's. Still to port: the attack detector
(``detect_divergence``), ``StoreBackedProvider``, the db-backed ``Store``,
the proof service (``LightService`` and its caches and errors), the RPC
provider and the proxy.
"""

from .client import Client, TrustOptions
from .errors import (
    BadLightBlockError,
    ConflictingHeadersError,
    InvalidHeaderError,
    LightBlockNotFoundError,
    LightClientError,
    NewValSetCantBeTrustedError,
    NoWitnessesError,
    OldHeaderExpiredError,
    VerificationFailedError,
)
from .provider import Provider
from .store import MemStore
from .verifier import (
    CommitVerifier,
    header_expired,
    validate_trust_level,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
)

__all__ = [
    "Client",
    "TrustOptions",
    "Provider",
    "MemStore",
    "CommitVerifier",
    "header_expired",
    "validate_trust_level",
    "verify",
    "verify_adjacent",
    "verify_backwards",
    "verify_non_adjacent",
    "BadLightBlockError",
    "ConflictingHeadersError",
    "InvalidHeaderError",
    "LightBlockNotFoundError",
    "LightClientError",
    "NewValSetCantBeTrustedError",
    "NoWitnessesError",
    "OldHeaderExpiredError",
    "VerificationFailedError",
]
