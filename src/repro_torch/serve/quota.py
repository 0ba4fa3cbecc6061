"""Per-tenant admission control for the port's SIVF serve engine.

PyTorch port's copy of ``repro/serve/quota.py`` (plain Python). The
engine never queues without bound: every submit is checked against the
tenant's :class:`TenantQuota` (and the engine's global queue bound) and
either admitted or rejected *at once* with a typed :class:`Backpressure`
error naming the reason, so a client learns of overload at the submit
call, not through a timeout.

Two quota dimensions:

  * ``max_inflight_searches`` — searches queued or executing for the
    tenant. Admission increments the counter; resolving the request's
    future (success *or* failure) releases it.
  * ``mutation_rows_per_s`` / ``mutation_burst_rows`` — a token bucket
    over mutation *rows* (vectors added or ids removed), so one tenant
    streaming bulk ingest cannot starve the device of search time.
    ``float("inf")`` (the default) disables rate limiting.

All state changes happen under the engine's lock; the bucket takes an
injectable ``clock`` so tests drive refill deterministically.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import time


class BackpressureKind(enum.Enum):
    """Why a submit was rejected (carried on :class:`Backpressure`)."""

    SEARCH_INFLIGHT = "search_inflight"   # tenant's in-flight search cap
    MUTATION_RATE = "mutation_rate"       # tenant's mutation token bucket
    QUEUE_FULL = "queue_full"             # engine-wide request queue bound
    ENGINE_CLOSED = "engine_closed"       # submit after close()


class Backpressure(RuntimeError):
    """Typed submit-time rejection; never raised mid-flight.

    Carries ``kind`` (:class:`BackpressureKind`), ``tenant`` and a human
    ``detail`` string, so callers can switch on the reason (shed load,
    retry with backoff, surface a 429) instead of parsing messages.
    """

    def __init__(self, kind: BackpressureKind, tenant: str,
                 detail: str = ""):
        super().__init__(f"[{kind.value}] tenant={tenant!r}: {detail}")
        self.kind = kind
        self.tenant = tenant
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Static per-tenant limits (engine-wide default or per tenant)."""

    max_inflight_searches: int = 64
    mutation_rows_per_s: float = math.inf
    mutation_burst_rows: int = 8192


class _TokenBucket:
    """Classic token bucket over mutation rows; ``inf`` rate = unlimited."""

    def __init__(self, rate: float, burst: float, clock):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def try_take(self, n: int) -> bool:
        if math.isinf(self.rate):
            return True
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if n > self._tokens:
            return False
        self._tokens -= n
        return True


class TenantState:
    """Mutable per-tenant admission state; guarded by the engine lock."""

    def __init__(self, quota: TenantQuota, clock=time.monotonic):
        self.quota = quota
        self.inflight_searches = 0
        self.bucket = _TokenBucket(quota.mutation_rows_per_s,
                                   quota.mutation_burst_rows, clock)
        self.rejections = {kind: 0 for kind in BackpressureKind}

    def reject(self, kind: BackpressureKind, tenant: str, detail: str):
        self.rejections[kind] += 1
        raise Backpressure(kind, tenant, detail)

    def admit_search(self, tenant: str) -> None:
        cap = self.quota.max_inflight_searches
        if self.inflight_searches >= cap:
            self.reject(BackpressureKind.SEARCH_INFLIGHT, tenant,
                        f"{self.inflight_searches} searches in flight >= "
                        f"max_inflight_searches={cap}")
        self.inflight_searches += 1

    def release_search(self) -> None:
        self.inflight_searches = max(self.inflight_searches - 1, 0)

    def admit_mutation(self, tenant: str, rows: int) -> None:
        if not self.bucket.try_take(rows):
            self.reject(BackpressureKind.MUTATION_RATE, tenant,
                        f"{rows} mutation rows exceed the token bucket "
                        f"(rate={self.quota.mutation_rows_per_s}/s, "
                        f"burst={self.quota.mutation_burst_rows})")
