"""Event pub/sub with query language (reference: libs/pubsub/pubsub.go:90,
libs/pubsub/query/query.go:357).

Subscriptions are matched by *queries* over event attributes — conjunctions
of conditions like ``tm.event = 'NewBlock' AND tx.height > 5``. Supported
operators (the reference's full set, query.go): ``=  <  <=  >  >=  CONTAINS
EXISTS``, joined by ``AND``. Values are single-quoted strings or numbers;
``TIME``/``DATE`` literals are compared as RFC3339 strings (which sort
chronologically, so ordinary string comparison is correct).

Messages are published with an attribute map ``{composite_key: [values]}``;
a condition matches if ANY value under the key satisfies it (reference
semantics, query.go ``Matches``).

Delivery is synchronous-in-order per subscriber via per-subscription
unbounded queues drained by the subscriber (``Subscription.out``); the
server itself runs no goroutine loop — publish fans out under a read lock,
which preserves the reference's guarantee that events are observed in
publish order.
"""

from __future__ import annotations

import queue
import re
import threading
from . import sync as libsync
from dataclasses import dataclass, field
from typing import Any


class PubSubError(Exception):
    pass


class AlreadySubscribedError(PubSubError):
    pass


class NotSubscribedError(PubSubError):
    pass


class QuerySyntaxError(PubSubError):
    pass


# --------------------------------------------------------------------------
# Query language
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND\b)
      | (?P<exists>EXISTS\b)
      | (?P<contains>CONTAINS\b)
      | (?P<timeword>TIME\b|DATE\b)
      | (?P<op><=|>=|=|<|>)
      | (?P<string>'[^']*')
      | (?P<rfc3339>\d{4}-\d{2}-\d{2}
           (?:T\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:\d{2})?)?)
      | (?P<number>-?\d+(?:\.\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_.-]*)
    )""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str  # '=', '<', '<=', '>', '>=', 'CONTAINS', 'EXISTS'
    value: Any = None  # str for =/CONTAINS on strings, float for numeric cmp
    is_number: bool = False

    def matches_values(self, values: list[str]) -> bool:
        if self.op == "EXISTS":
            return True  # key presence already checked by caller
        for v in values:
            if self.op == "CONTAINS":
                if str(self.value) in v:
                    return True
            elif self.is_number:
                try:
                    x = float(v)
                except ValueError:
                    continue
                if _cmp(x, self.op, float(self.value)):
                    return True
            else:
                if _cmp(v, self.op, str(self.value)):
                    return True
        return False


def _cmp(a, op: str, b) -> bool:
    if op == "=":
        return a == b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise QuerySyntaxError(f"unknown operator {op!r}")


class Query:
    """Compiled conjunction of conditions. ``Query.parse("tm.event='Tx'")``."""

    def __init__(self, conditions: list[Condition], source: str = ""):
        self.conditions = conditions
        self._source = source or " AND ".join(
            f"{c.key} {c.op} {c.value!r}" for c in conditions
        )

    @classmethod
    def parse(cls, s: str) -> "Query":
        tokens = cls._tokenize(s)
        conds: list[Condition] = []
        i = 0
        while i < len(tokens):
            kind, val = tokens[i]
            if kind != "key":
                raise QuerySyntaxError(f"expected key at token {i} in {s!r}")
            key = val
            i += 1
            if i >= len(tokens):
                raise QuerySyntaxError(f"dangling key {key!r} in {s!r}")
            kind, val = tokens[i]
            if kind == "exists":
                conds.append(Condition(key, "EXISTS"))
                i += 1
            elif kind == "contains":
                i += 1
                if i >= len(tokens) or tokens[i][0] != "string":
                    raise QuerySyntaxError("CONTAINS needs a string operand")
                conds.append(Condition(key, "CONTAINS", tokens[i][1]))
                i += 1
            elif kind == "op":
                op = val
                i += 1
                if i < len(tokens) and tokens[i][0] == "timeword":
                    # TIME/DATE prefix: RFC3339 literal, compared as a
                    # string (RFC3339 sorts chronologically).
                    i += 1
                    if i >= len(tokens) or tokens[i][0] != "rfc3339":
                        raise QuerySyntaxError("TIME/DATE needs an RFC3339 literal")
                    conds.append(Condition(key, op, tokens[i][1], is_number=False))
                    i += 1
                elif i < len(tokens) and tokens[i][0] == "string":
                    conds.append(Condition(key, op, tokens[i][1]))
                    i += 1
                elif i < len(tokens) and tokens[i][0] == "number":
                    conds.append(
                        Condition(key, op, float(tokens[i][1]), is_number=True)
                    )
                    i += 1
                else:
                    raise QuerySyntaxError(f"missing operand after {op!r}")
            else:
                raise QuerySyntaxError(f"unexpected token {val!r} in {s!r}")
            if i < len(tokens):
                kind, val = tokens[i]
                if kind != "and":
                    raise QuerySyntaxError(f"expected AND, got {val!r}")
                i += 1
                if i >= len(tokens):
                    raise QuerySyntaxError("dangling AND")
        return cls(conds, s)

    @staticmethod
    def _tokenize(s: str) -> list[tuple[str, str]]:
        tokens = []
        pos = 0
        while pos < len(s):
            m = _TOKEN_RE.match(s, pos)
            if not m or m.end() == pos:
                if s[pos:].strip() == "":
                    break
                raise QuerySyntaxError(f"bad token at {s[pos:]!r}")
            pos = m.end()
            kind = m.lastgroup
            val = m.group(kind)
            if kind == "string":
                val = val[1:-1]
            tokens.append((kind, val))
        return tokens

    def matches(self, events: dict[str, list[str]]) -> bool:
        for c in self.conditions:
            values = events.get(c.key)
            if values is None:
                # TIME/DATE-prefixed height-style keys may carry dotted values
                return False
            if not c.matches_values(values):
                return False
        return True

    def __str__(self) -> str:
        return self._source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))


class Empty:
    """Matches everything (reference: libs/pubsub/query.Empty)."""

    def matches(self, events) -> bool:
        return True

    def __str__(self) -> str:
        return "empty"

    def __eq__(self, other) -> bool:
        return isinstance(other, Empty)

    def __hash__(self) -> int:
        return hash("__empty_query__")


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------


@dataclass
class Message:
    data: Any
    events: dict[str, list[str]] = field(default_factory=dict)


class Subscription:
    """Per-subscriber queue. ``out`` yields Messages; ``canceled`` is set
    with a reason when the server drops the subscription (unsubscribe/stop).
    """

    def __init__(self, capacity: int | None):
        self.out: queue.Queue[Message] = queue.Queue(capacity or 0)
        self.canceled = threading.Event()
        self.cancel_reason: str | None = None

    def _cancel(self, reason: str) -> None:
        self.cancel_reason = reason
        self.canceled.set()


class Server:
    """Pubsub hub keyed by (subscriber_id, query) like the reference
    (pubsub.go:90). ``capacity`` bounds each subscription queue; a full
    queue on publish cancels that subscriber (the reference's slow-client
    policy for non-buffered subscriptions).
    """

    def __init__(self, capacity: int | None = None):
        self._mtx = libsync.RLock("libs.pubsub._mtx")
        self._subs: dict[str, dict[Any, Subscription]] = {}
        self._capacity = capacity

    def subscribe(
        self, subscriber: str, query, capacity: int | None = None
    ) -> Subscription:
        with self._mtx:
            by_query = self._subs.setdefault(subscriber, {})
            if query in by_query:
                raise AlreadySubscribedError(f"{subscriber}/{query}")
            sub = Subscription(capacity if capacity is not None else self._capacity)
            by_query[query] = sub
            return sub

    def unsubscribe(self, subscriber: str, query) -> None:
        with self._mtx:
            by_query = self._subs.get(subscriber)
            if not by_query or query not in by_query:
                raise NotSubscribedError(f"{subscriber}/{query}")
            by_query.pop(query)._cancel("unsubscribed")
            if not by_query:
                del self._subs[subscriber]

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._mtx:
            by_query = self._subs.pop(subscriber, None)
            if not by_query:
                raise NotSubscribedError(subscriber)
            for sub in by_query.values():
                sub._cancel("unsubscribed")

    def num_clients(self) -> int:
        with self._mtx:
            return len(self._subs)

    def num_client_subscriptions(self, subscriber: str) -> int:
        with self._mtx:
            return len(self._subs.get(subscriber, {}))

    def publish(self, data: Any, events: dict[str, list[str]] | None = None) -> None:
        msg = Message(data, events or {})
        with self._mtx:
            dead: list[tuple[str, Any]] = []
            for subscriber, by_query in self._subs.items():
                for q, sub in by_query.items():
                    if not q.matches(msg.events):
                        continue
                    try:
                        sub.out.put_nowait(msg)
                    except queue.Full:
                        sub._cancel("slow subscriber")
                        dead.append((subscriber, q))
            for subscriber, q in dead:
                self._subs[subscriber].pop(q, None)
                if not self._subs[subscriber]:
                    del self._subs[subscriber]

    def stop(self) -> None:
        with self._mtx:
            for by_query in self._subs.values():
                for sub in by_query.values():
                    sub._cancel("server stopped")
            self._subs.clear()
