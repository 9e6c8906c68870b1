"""Evidence of Byzantine behavior: pool, verification, gossip
(reference: evidence/)."""

from .pool import EvidencePool  # noqa: F401
from .verify import verify_evidence, verify_duplicate_vote  # noqa: F401
from .reactor import EvidenceReactor  # noqa: F401
