"""Fingerprint-keyed LRU cache of :class:`~repro_torch.core.spmv.PreparedSpMV`.

Port of ``repro.serve.cache``.  ``prepare()`` is the expensive half of the
paper's story — reorder, tune, tile-build, device upload.  The serving path
amortizes it by keying prepared operators on the matrix *content* hash
(:meth:`repro_torch.sparse.CSRMatrix.fingerprint`, equal to the
reference's), so two matrix ids that alias identical content share one
operator, and re-registering the same traffic pattern after a restart warms
straight back up.

Eviction is byte-budget LRU: each entry is charged its
:meth:`~repro_torch.core.spmv.PreparedSpMV.resident_bytes` — the port's own
value, which exceeds the reference's on the SELL-C-σ, segmented-sum and DIA
routes by their port-only arrays — and inserting past the budget evicts
least-recently-used entries, never the entry just inserted, so a single
operator larger than the whole budget still serves (the cache then holds
exactly that operator).

All hit/miss/evict/prepare accounting is exposed as plain attributes for
deterministic tests, and mirrored into the :mod:`repro_torch.obs` registry
(``serve.cache_hit`` / ``serve.cache_miss`` / ``serve.cache_evict`` counters,
``serve.cache_bytes`` gauge, ``serve.prepare`` timer) when telemetry is on.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Tuple

from repro_torch.core.spmv import _resolve_device, prepare
from repro_torch.obs import get_registry


class OperatorCache:
    """LRU map fingerprint → prepared operator with a byte budget.

    One cache holds operators built with one fixed set of ``prepare()``
    options (``prepare_kwargs``); the engine owns exactly one cache, so the
    fingerprint alone is a sound key.  ``byte_budget=None`` means unbounded.
    With the default ``prepare_fn`` (:func:`repro_torch.core.spmv.prepare`)
    the operators live on ``prepare_kwargs["device"]``, "cuda" unless the
    caller asks for the CPU; it is resolved here, so a cache built for a
    card that is missing raises at construction.
    """

    def __init__(self, byte_budget: Optional[int] = None, prepare_fn=None,
                 **prepare_kwargs):
        if prepare_fn is None:
            prepare_fn = prepare
            prepare_kwargs["device"] = _resolve_device(prepare_kwargs.get("device", "cuda"))
        self._prepare = prepare_fn
        self._prepare_kwargs = dict(prepare_kwargs)
        self.byte_budget = byte_budget
        self._entries: "collections.OrderedDict[str, Tuple[object, int]]" = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.prepares = 0
        self.evictions = 0

    # -- state ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._entries

    @property
    def bytes_in_use(self) -> int:
        return sum(nbytes for _, nbytes in self._entries.values())

    def fingerprints_lru_order(self) -> List[str]:
        """Cached fingerprints, least-recently-used first (for tests/CLI)."""
        return list(self._entries)

    # -- operations ----------------------------------------------------------
    def lookup(self, fingerprint: str):
        """Return the cached operator (LRU-touching it) or None.

        Counts exactly one hit or one miss per call — the accounting the
        fake-clock tests pin against hand-computed expectations.
        """
        reg = get_registry()
        entry = self._entries.get(fingerprint)
        if entry is None:
            self.misses += 1
            reg.counter("serve", "cache_miss")
            return None
        self._entries.move_to_end(fingerprint)
        self.hits += 1
        reg.counter("serve", "cache_hit")
        return entry[0]

    def insert(self, fingerprint: str, op) -> List[str]:
        """Insert (or refresh) an operator; returns evicted fingerprints.

        Eviction pops LRU entries until the budget holds, but never the
        entry being inserted.
        """
        reg = get_registry()
        nbytes = int(op.resident_bytes())
        self._entries[fingerprint] = (op, nbytes)
        self._entries.move_to_end(fingerprint)
        evicted = []
        if self.byte_budget is not None:
            while (self.bytes_in_use > self.byte_budget
                   and len(self._entries) > 1):
                victim, _ = self._entries.popitem(last=False)
                evicted.append(victim)
                self.evictions += 1
                reg.counter("serve", "cache_evict")
        reg.gauge("serve", "cache_bytes", self.bytes_in_use, unit="bytes")
        reg.gauge("serve", "cache_entries", len(self._entries), unit="count")
        return evicted

    def get_or_prepare(self, A, fingerprint: Optional[str] = None):
        """Cached operator for matrix ``A``; prepares (and caches) on miss.

        Returns ``(op, hit)`` so callers can account amortization.  The
        fingerprint may be passed in to skip re-hashing (the engine hashes
        once at ``add_matrix`` time); when omitted it is computed here.  A
        miss runs ``prepare`` inside the caller's call, host setup included.
        """
        if fingerprint is None:
            fingerprint = A.fingerprint()
        op = self.lookup(fingerprint)
        if op is not None:
            return op, True
        reg = get_registry()
        with reg.timer("serve", "prepare"):
            op = self._prepare(A, **self._prepare_kwargs)
        self.prepares += 1
        self.insert(fingerprint, op)
        return op, False
