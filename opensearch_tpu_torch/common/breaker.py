"""Circuit breakers: hierarchical memory-budget accounting.

Counterpart of opensearch_tpu/common/breaker.py, a copy with its imports
rewritten (the reference's HierarchyCircuitBreakerService: a parent
breaker over request, fielddata and in-flight children). Estimates are
byte-counted (add_estimate_and_maybe_break / release), and tripping
raises CircuitBreakingException (HTTP 429), the reference's error
contract. The HTTP server charges the in-flight child with each request's
body bytes.
"""

from __future__ import annotations

import threading

from opensearch_tpu_torch.common.errors import CircuitBreakingException

# default child limits as fractions of the configured "total budget"
DEFAULT_TOTAL_BYTES = 4 << 30          # stand-in for the JVM-heap basis
PARENT_FRACTION = 0.95
REQUEST_FRACTION = 0.60
FIELDDATA_FRACTION = 0.40
IN_FLIGHT_FRACTION = 1.00


class CircuitBreaker:
    def __init__(self, name: str, limit_bytes: int, parent: "HierarchyBreakerService | None" = None,
                 overhead: float = 1.0):
        self.name = name
        self.limit = int(limit_bytes)
        self.overhead = overhead
        self.used = 0
        self.trip_count = 0
        self._parent = parent
        self._lock = threading.Lock()

    def add_estimate_and_maybe_break(self, bytes_: int, label: str = "<unknown>") -> None:
        bytes_ = int(bytes_)
        with self._lock:
            new_used = self.used + bytes_
            estimate = int(new_used * self.overhead)
            if bytes_ > 0 and estimate > self.limit:
                self.trip_count += 1
                raise CircuitBreakingException(
                    f"[{self.name}] Data too large, data for [{label}] "
                    f"would be [{estimate}/{_human(estimate)}], which is "
                    f"larger than the limit of [{self.limit}/{_human(self.limit)}]"
                )
            self.used = new_used
        if self._parent is not None and bytes_ > 0:
            try:
                self._parent.check_parent(label)
            except CircuitBreakingException:
                with self._lock:
                    self.used -= bytes_
                raise

    def release(self, bytes_: int) -> None:
        with self._lock:
            self.used = max(0, self.used - int(bytes_))

    def stats(self) -> dict:
        with self._lock:
            used, tripped = self.used, self.trip_count
        return {
            "limit_size_in_bytes": self.limit,
            "limit_size": _human(self.limit),
            "estimated_size_in_bytes": used,
            "estimated_size": _human(used),
            "overhead": self.overhead,
            "tripped": tripped,
        }


def _human(n: int) -> str:
    for unit in ("b", "kb", "mb", "gb", "tb"):
        if abs(n) < 1024 or unit == "tb":
            return f"{n:.1f}{unit}" if unit != "b" else f"{n}b"
        n /= 1024
    return f"{n}b"


class HierarchyBreakerService:
    """Parent + {request, fielddata, in_flight_requests} children."""

    def __init__(self, total_bytes: int = DEFAULT_TOTAL_BYTES,
                 settings: dict | None = None):
        settings = settings or {}
        self.parent_limit = int(settings.get(
            "parent_limit_bytes", total_bytes * PARENT_FRACTION
        ))
        # check_parent() runs from every child's add path at once (http
        # in-flight accounting, search-pool request/fielddata charges), so
        # the trip counter needs its own lock — the children's locks are
        # per-child and never held here
        self._lock = threading.Lock()
        self.parent_trip_count = 0
        self.request = CircuitBreaker(
            "request",
            int(settings.get("request_limit_bytes", total_bytes * REQUEST_FRACTION)),
            parent=self,
        )
        self.fielddata = CircuitBreaker(
            "fielddata",
            int(settings.get("fielddata_limit_bytes", total_bytes * FIELDDATA_FRACTION)),
            parent=self,
            overhead=1.03,
        )
        self.in_flight_requests = CircuitBreaker(
            "in_flight_requests",
            int(settings.get("in_flight_limit_bytes", total_bytes * IN_FLIGHT_FRACTION)),
            parent=self,
        )

    def breaker(self, name: str) -> CircuitBreaker:
        b = getattr(self, name.replace(".", "_"), None)
        if not isinstance(b, CircuitBreaker):
            raise KeyError(name)
        return b

    @property
    def children(self) -> list[CircuitBreaker]:
        return [self.request, self.fielddata, self.in_flight_requests]

    def check_parent(self, label: str) -> None:
        total = sum(c.used for c in self.children)
        if total > self.parent_limit:
            with self._lock:
                self.parent_trip_count += 1
            raise CircuitBreakingException(
                f"[parent] Data too large, data for [{label}] would be "
                f"[{total}/{_human(total)}], which is larger than the limit "
                f"of [{self.parent_limit}/{_human(self.parent_limit)}]"
            )

    def stats(self) -> dict:
        out = {c.name: c.stats() for c in self.children}
        with self._lock:
            parent_tripped = self.parent_trip_count
        out["parent"] = {
            "limit_size_in_bytes": self.parent_limit,
            "limit_size": _human(self.parent_limit),
            "estimated_size_in_bytes": sum(c.used for c in self.children),
            "estimated_size": _human(sum(c.used for c in self.children)),
            "overhead": 1.0,
            "tripped": parent_tripped,
        }
        return out
