"""Evidence of Byzantine behavior: pool and verification (reference:
evidence/; the gossip reactor comes with p2p)."""

from .pool import EvidencePool  # noqa: F401
from .verify import verify_evidence, verify_duplicate_vote  # noqa: F401
