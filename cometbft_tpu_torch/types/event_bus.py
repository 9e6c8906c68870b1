"""Typed event bus over pubsub (reference: types/event_bus.go:33,
types/events.go).

Every consensus step, block, and tx publishes here; RPC subscriptions and
the tx/block indexers consume. Event data carries the publishing type's
object plus the ABCI events flattened into composite-keyed attributes
(``{event_type}.{attr_key}`` → values) for query matching.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

from ..libs import pubsub
from ..libs.service import BaseService

# tm.event values (types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_POLKA = "Polka"
EVENT_RELOCK = "Relock"
EVENT_LOCK = "Lock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event: str) -> pubsub.Query:
    return pubsub.Query.parse(f"{EVENT_TYPE_KEY} = '{event}'")


QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
QUERY_TX = query_for_event(EVENT_TX)


def flatten_abci_events(events, base: dict[str, list[str]]) -> dict:
    """composite ``{type}.{key}`` → [values] (pubsub indexing convention)."""
    out = dict(base)
    for ev in events or ():
        for attr in ev.attributes:
            out.setdefault(f"{ev.type}.{attr.key}", []).append(attr.value)
    return out


@dataclass(slots=True)
class EventDataNewBlock:
    block: Any
    block_id: Any
    result_finalize_block: Any = None


@dataclass(slots=True)
class EventDataNewBlockHeader:
    header: Any


@dataclass(slots=True)
class EventDataNewBlockEvents:
    height: int
    events: list = dc_field(default_factory=list)
    num_txs: int = 0


@dataclass(slots=True)
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: Any  # ExecTxResult


@dataclass(slots=True)
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass(slots=True)
class EventDataNewRound:
    height: int
    round: int
    step: str
    proposer_address: bytes = b""


@dataclass(slots=True)
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: Any = None


@dataclass(slots=True)
class EventDataVote:
    vote: Any


@dataclass(slots=True)
class EventDataValidatorSetUpdates:
    validator_updates: list


@dataclass(slots=True)
class EventDataNewEvidence:
    height: int
    evidence: Any


class EventBus(BaseService):
    def __init__(self):
        super().__init__("event-bus")
        self.server = pubsub.Server()

    def on_stop(self) -> None:
        self.server.stop()

    # -- subscription façade ----------------------------------------------

    def subscribe(self, subscriber: str, query, capacity: int | None = 100):
        return self.server.subscribe(subscriber, query, capacity)

    def unsubscribe(self, subscriber: str, query) -> None:
        self.server.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.server.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self.server.num_clients()

    # -- typed publishers --------------------------------------------------

    def _publish(self, event: str, data, extra: dict | None = None) -> None:
        events = {EVENT_TYPE_KEY: [event]}
        if extra:
            for k, v in extra.items():
                events.setdefault(k, []).extend(v)
        self.server.publish(data, events)

    def publish_new_block(self, data: EventDataNewBlock) -> None:
        extra = flatten_abci_events(
            getattr(data.result_finalize_block, "events", None),
            {BLOCK_HEIGHT_KEY: [str(data.block.header.height)]},
        )
        self._publish(EVENT_NEW_BLOCK, data, extra)

    def publish_new_block_header(self, data: EventDataNewBlockHeader) -> None:
        self._publish(
            EVENT_NEW_BLOCK_HEADER,
            data,
            {BLOCK_HEIGHT_KEY: [str(data.header.height)]},
        )

    def publish_new_block_events(self, data: EventDataNewBlockEvents) -> None:
        extra = flatten_abci_events(
            data.events, {BLOCK_HEIGHT_KEY: [str(data.height)]}
        )
        self._publish(EVENT_NEW_BLOCK_EVENTS, data, extra)

    def publish_tx(self, data: EventDataTx) -> None:
        from ..crypto import tmhash

        extra = flatten_abci_events(
            getattr(data.result, "events", None),
            {
                TX_HEIGHT_KEY: [str(data.height)],
                TX_HASH_KEY: [tmhash.sum(data.tx).hex().upper()],
            },
        )
        self._publish(EVENT_TX, data, extra)

    def publish_validator_set_updates(
        self, data: EventDataValidatorSetUpdates
    ) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)

    def publish_new_evidence(self, data: EventDataNewEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data)

    # consensus step events (consumed by the consensus reactor + RPC)
    def publish_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_complete_proposal(self, data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data)

    def publish_lock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_LOCK, data)

    def publish_relock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_RELOCK, data)

    def publish_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data)


class NopEventBus:
    """Publishes nowhere (used by tools that don't need events)."""

    def __getattr__(self, name):
        if name.startswith("publish_"):
            return lambda *a, **k: None
        raise AttributeError(name)
