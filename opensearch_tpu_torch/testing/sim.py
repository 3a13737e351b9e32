"""Deterministic simulation: virtual time + disruptable in-memory transport.

The analog of the reference's coordination test harness (SURVEY.md §4 tier
3): DeterministicTaskQueue (test/framework/.../coordination/
DeterministicTaskQueue.java:62 — virtual time, runAllTasksInTimeOrder:111,
advanceTime:201) and DisruptableMockTransport (programmable partitions and
delays, no threads, no sockets). Seeded randomness makes every run
replayable; safety properties of the election/publication protocol are
checked over thousands of virtual-time steps in milliseconds of real time.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Any, Callable

from opensearch_tpu_torch.common.timeutil import Clock


class VirtualClock(Clock):
    """timeutil.Clock that reads a DeterministicTaskQueue's virtual time.

    Install with ``timeutil.set_clock`` / ``timeutil.clock_scope`` so
    modules that read wall-clock through the injected clock (recovery
    timestamps, bulk "took", reader-context expiry) advance with the sim
    instead of the host."""

    def __init__(self, queue: "DeterministicTaskQueue"):
        self._queue = queue

    def epoch_millis(self) -> int:
        return self._queue.now_ms

    def monotonic_millis(self) -> int:
        return self._queue.now_ms


@dataclass(order=True)
class _Task:
    time_ms: int
    seq: int
    fn: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class Cancellable:
    def __init__(self, task: _Task):
        self._task = task

    def cancel(self) -> None:
        self._task.cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._task.cancelled


class DeterministicTaskQueue:
    """Virtual-time scheduler. All protocol timers and message deliveries
    run through here, in (time, insertion) order."""

    def __init__(self, seed: int = 0):
        self.now_ms = 0
        self.random = random.Random(seed)
        self._seq = 0
        self._heap: list[_Task] = []

    def clock(self) -> VirtualClock:
        """A timeutil.Clock view of this queue's virtual time."""
        return VirtualClock(self)

    def schedule(self, delay_ms: int, fn: Callable[[], None]) -> Cancellable:
        self._seq += 1
        task = _Task(self.now_ms + max(int(delay_ms), 0), self._seq, fn)
        heapq.heappush(self._heap, task)
        return Cancellable(task)

    def has_tasks(self) -> bool:
        return any(not t.cancelled for t in self._heap)

    def run_one(self) -> bool:
        while self._heap:
            task = heapq.heappop(self._heap)
            if task.cancelled:
                continue
            self.now_ms = max(self.now_ms, task.time_ms)
            task.fn()
            return True
        return False

    def run_until(self, time_ms: int) -> None:
        while self._heap:
            # drop cancelled heads first so the deadline check sees the next
            # LIVE task (a cancelled head must not let later tasks run early)
            while self._heap and self._heap[0].cancelled:
                heapq.heappop(self._heap)
            if not self._heap or self._heap[0].time_ms > time_ms:
                break
            self.run_one()
        self.now_ms = max(self.now_ms, time_ms)

    def run_all(self, max_tasks: int = 100_000) -> None:
        n = 0
        while self.run_one():
            n += 1
            if n >= max_tasks:
                raise RuntimeError("task queue did not quiesce (livelock?)")


class MockTransport:
    """In-memory message bus with programmable disruption.

    Handlers: register(node, action, handler) where
    handler(sender_id, payload) -> response payload (or raises).
    send(...) delivers via the task queue with a random bounded delay;
    blackholed links silently drop (the two-sided NetworkDisruption
    scheme); a dropped request surfaces as a timeout-style failure callback
    after `timeout_ms` of virtual time.
    """

    def __init__(self, queue: DeterministicTaskQueue,
                 min_delay_ms: int = 1, max_delay_ms: int = 20,
                 timeout_ms: int = 1_000):
        self.queue = queue
        self.min_delay_ms = min_delay_ms
        self.max_delay_ms = max_delay_ms
        self.timeout_ms = timeout_ms
        self.handlers: dict[tuple[str, str], Callable] = {}
        self.blackholed: set[tuple[str, str]] = set()
        self.down: set[str] = set()
        # per-directed-link extra delivery delay in ms (slow/flaky links);
        # applies on top of the random base delay, in the direction stored
        self.latency: dict[tuple[str, str], int] = {}
        self.stats = {"sent": 0, "dropped": 0, "delivered": 0}

    # -- disruption schemes (test/framework/.../disruption analog) ---------

    def partition(self, group_a: set[str], group_b: set[str]) -> None:
        for a in group_a:
            for b in group_b:
                self.blackholed.add((a, b))
                self.blackholed.add((b, a))

    def drop_one_way(self, src: str, dst: str) -> None:
        """Asymmetric blackhole: frames src -> dst vanish while dst -> src
        still delivers (the one-sided NetworkDisruption variant — models a
        half-open link where requests arrive but responses are lost, or
        vice versa)."""
        self.blackholed.add((src, dst))

    def restore_one_way(self, src: str, dst: str) -> None:
        self.blackholed.discard((src, dst))

    def set_latency(self, src: str, dst: str, extra_ms: int,
                    symmetric: bool = True) -> None:
        """Add `extra_ms` of delivery delay on src -> dst (and, by default,
        dst -> src) — the NetworkDisruption delay scheme. extra_ms <= 0
        clears the injection."""
        for pair in ([(src, dst), (dst, src)] if symmetric else [(src, dst)]):
            if extra_ms > 0:
                self.latency[pair] = int(extra_ms)
            else:
                self.latency.pop(pair, None)

    def heal(self) -> None:
        """Clear partitions AND latency injections (back to a clean net)."""
        self.blackholed.clear()
        self.latency.clear()

    def isolate(self, node_id: str, others: set[str]) -> None:
        self.partition({node_id}, others - {node_id})

    def take_down(self, node_id: str) -> None:
        self.down.add(node_id)

    def bring_up(self, node_id: str) -> None:
        self.down.discard(node_id)

    def _link_ok(self, a: str, b: str) -> bool:
        return (
            (a, b) not in self.blackholed
            and a not in self.down
            and b not in self.down
        )

    def _link_delay(self, a: str, b: str, base: int) -> int:
        return base + self.latency.get((a, b), 0)

    # -- messaging ---------------------------------------------------------

    def register(self, node_id: str, action: str, handler: Callable) -> None:
        self.handlers[(node_id, action)] = handler

    def send(
        self,
        sender: str,
        target: str,
        action: str,
        payload: Any,
        on_response: Callable[[Any], None] | None = None,
        on_failure: Callable[[Exception], None] | None = None,
        timeout_ms: int | None = None,  # accepted for interface parity
    ) -> None:
        self.stats["sent"] += 1
        # capture the trace context NOW: delivery happens in a later
        # scheduled callback where the sender's contextvars are gone
        from opensearch_tpu_torch.transport.base import trace_header

        trace_ctx = trace_header()
        delay = self._link_delay(
            sender, target,
            self.queue.random.randint(self.min_delay_ms, self.max_delay_ms),
        )

        if not self._link_ok(sender, target):
            self.stats["dropped"] += 1
            if on_failure is not None:
                self.queue.schedule(
                    self.timeout_ms,
                    lambda: on_failure(TimeoutError(f"{action} to {target} timed out")),
                )
            return

        def deliver() -> None:
            # the link (or target) may have failed while in flight
            if not self._link_ok(sender, target):
                self.stats["dropped"] += 1
                if on_failure is not None:
                    self.queue.schedule(
                        self.timeout_ms - delay,
                        lambda: on_failure(TimeoutError(f"{action} to {target} timed out")),
                    )
                return
            handler = self.handlers.get((target, action))
            if handler is None:
                if on_failure is not None:
                    on_failure(RuntimeError(f"no handler for {action} on {target}"))
                return
            self.stats["delivered"] += 1
            from opensearch_tpu_torch.transport.base import handler_trace_scope

            try:
                # the receiving node sees the sender's trace context, same
                # as TcpTransport's header restore
                with handler_trace_scope(trace_ctx):
                    response = handler(sender, payload)
            except Exception as e:  # noqa: BLE001 - remote errors travel back
                if on_failure is not None:
                    back = self.queue.random.randint(self.min_delay_ms, self.max_delay_ms)
                    # bind eagerly: the except variable is unbound once the
                    # block exits
                    self.queue.schedule(back, lambda err=e: on_failure(err))
                return

            def ship(result: Any, error: Exception | None) -> None:
                # draw the return delay ONLY when a message actually travels
                # back — unconditional draws would shift the seeded RNG
                # sequence and perturb every replayable scenario
                if error is not None:
                    if on_failure is not None:
                        back = self._link_delay(
                            target, sender,
                            self.queue.random.randint(
                                self.min_delay_ms, self.max_delay_ms
                            ),
                        )
                        self.queue.schedule(back, lambda: on_failure(error))
                    return
                if on_response is None:
                    return
                back = self._link_delay(
                    target, sender,
                    self.queue.random.randint(
                        self.min_delay_ms, self.max_delay_ms
                    ),
                )

                def respond() -> None:
                    if self._link_ok(target, sender):
                        on_response(result)
                    elif on_failure is not None:
                        on_failure(TimeoutError(f"response from {target} lost"))

                self.queue.schedule(back, respond)

            from opensearch_tpu_torch.transport.base import DeferredResponse

            if isinstance(response, DeferredResponse):
                # handler answers later (replicated write waiting for acks)
                response.on_done(lambda d: ship(d.result, d.error))
            else:
                ship(response, None)

        self.queue.schedule(delay, deliver)
