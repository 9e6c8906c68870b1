"""The light block provider interface (reference: light/provider.py,
light/provider/provider.go).

A provider serves LightBlocks for one chain. The reference's
StoreBackedProvider reads a node's block and state stores; it comes with
the port of the block store.
"""

from __future__ import annotations

from ..types.light_block import LightBlock


class Provider:
    """Provider interface (provider.go:9-32)."""

    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """Return the light block at ``height`` (0 = latest). Raises
        LightBlockNotFoundError when unavailable."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:  # pragma: no cover - optional
        pass
