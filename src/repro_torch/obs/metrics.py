"""Counters, PyTorch port's copy of ``repro/obs/metrics.py``'s
``WindowedCounter`` (numpy-free, no lock)."""
from __future__ import annotations


class WindowedCounter:
    """Label-free cumulative + windowed counter (no lock; callers that
    share one across threads synchronize externally).

    ``total`` accumulates forever; ``window`` is the delta since the last
    :meth:`mark`. :meth:`carry` adopts another instance's state, so a
    rebuilt tiered runtime keeps its cumulative cache counters.
    """

    __slots__ = ("total", "_mark")

    def __init__(self, total: int = 0, mark: int = 0):
        self.total = total
        self._mark = mark

    def add(self, n: int = 1) -> None:
        self.total += n

    @property
    def window(self) -> int:
        return self.total - self._mark

    def mark(self) -> None:
        self._mark = self.total

    def carry(self, other: "WindowedCounter") -> "WindowedCounter":
        self.total, self._mark = other.total, other._mark
        return self
