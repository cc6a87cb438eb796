"""Sparse-format registry + O(1) auto-selection.

Port of ``repro.sparse.registry`` with the full predicate set, so that
:func:`select_format` agrees with the reference on every matrix.
``core.spmv.prepare`` runs the four selectable formats below.  The baselines
``ell``, ``bcsr`` and ``csr5`` are registered by name but never selected, and
``prepare`` refuses them, as in the reference: their containers live in
:mod:`repro_torch.sparse.baselines`, the ELL kernel behind
``kernels.ops.spmv_ell`` and the others' plain versions in ``kernels.ref``.

=================  =========================================  ==============
format             matches                                    role
=================  =========================================  ==============
``diahybrid``      ``diag_fraction ≥ 0.9`` and                DIA + CSR
                   ``row_var > 10``                           remainder
``segsum``         ``row_var > 10`` and ``row_skew ≥ 16``      segmented-sum
``sellcs``         ``row_var > 10`` (irregular, Sec. 6)       SELL-C-σ path
``csrk``           always (fallback)                          paper's path
=================  =========================================  ==============
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.sparse.stats import (
    DIA_FRACTION_MIN,
    REGULAR_ROW_VAR_MAX,
    SEGSUM_ROW_SKEW_MIN,
    MatrixStats,
)


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """A registered sparse format.

    ``matches(stats, device_model)`` must be O(1) — a predicate over the
    summary statistics only.  ``selectable=False`` keeps a format addressable
    by name without the auto selector ever routing to it.
    """

    name: str
    description: str
    matches: Callable[[MatrixStats, str], bool]
    priority: int = 0          # higher wins; ties broken by registration order
    selectable: bool = True


_REGISTRY: Dict[str, FormatSpec] = {}
_ORDER: List[str] = []


def register_format(spec: FormatSpec, *, overwrite: bool = False) -> FormatSpec:
    """Add a format to the registry (a duplicate name raises ``ValueError``
    unless ``overwrite``)."""
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"format {spec.name!r} already registered")
    if spec.name not in _REGISTRY:
        _ORDER.append(spec.name)
    _REGISTRY[spec.name] = spec
    return spec


def get_format(name: str) -> FormatSpec:
    """Look up a registered :class:`FormatSpec` by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown format {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_formats() -> List[str]:
    """All registered format names, in registration order."""
    return list(_ORDER)


def select_format(stats: MatrixStats, device: str = "tpu_v5e") -> str:
    """O(1) format choice: first matching selectable spec in priority order.

    ``device`` is the device-model name forwarded to each predicate.
    """
    specs = sorted(
        (s for s in (_REGISTRY[n] for n in _ORDER) if s.selectable),
        key=lambda s: -s.priority,
    )
    for spec in specs:
        if spec.matches(stats, device):
            return spec.name
    raise LookupError("no registered format matches (csrk fallback missing?)")


# -- built-in registrations --------------------------------------------------

register_format(FormatSpec(
    name="diahybrid",
    description=(
        "Partially-diagonal hybrid (Fukaya et al., arXiv:2105.04937): dense "
        "diagonals as a DIA plane + CSR remainder — the stencil-matrix path"
    ),
    matches=lambda stats, device: (
        stats.diag_fraction >= DIA_FRACTION_MIN
        and stats.row_var > REGULAR_ROW_VAR_MAX
    ),
    priority=30,
))

register_format(FormatSpec(
    name="segsum",
    description=(
        "Speculative segmented-sum CSR (Liu & Vinter, arXiv:1504.06474): "
        "equal-nnz chunks + carry patch — the power-law/empty-row path"
    ),
    matches=lambda stats, device: (
        stats.row_var > REGULAR_ROW_VAR_MAX
        and stats.row_skew >= SEGSUM_ROW_SKEW_MIN
    ),
    priority=20,
))

register_format(FormatSpec(
    name="sellcs",
    description=(
        "SELL-C-σ (Kreutzer et al.): σ-sorted C-row chunks, per-chunk "
        "padding — the irregular-matrix path"
    ),
    matches=lambda stats, device: stats.row_var > REGULAR_ROW_VAR_MAX,
    priority=10,
))

register_format(FormatSpec(
    name="csrk",
    description=(
        "CSR-k (Lane & Booth): CSR + super-row hierarchy, Band-k + "
        "constant-time tuner — the paper's regular-matrix path"
    ),
    matches=lambda stats, device: True,
    priority=0,
))

# benchmark-only baselines: forcible by name, never auto-selected
for _name, _desc in (
    ("ell", "ELLPACK baseline (paper Sec. 2.3) — global max-row padding"),
    ("bcsr", "Block CSR baseline (paper Sec. 2.1)"),
    ("csr5", "CSR5-like competitor stand-in (paper Sec. 2.4)"),
):
    register_format(FormatSpec(
        name=_name, description=_desc,
        matches=lambda stats, device: False,
        priority=-10, selectable=False,
    ))
