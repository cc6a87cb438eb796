"""Format-dispatching SpMV public API — the paper's contribution as a module.

Port of ``repro.core.spmv`` for the CSR-k, SELL-C-σ, segmented-sum and
DIA/CSR-hybrid routes, the one-shot plain-CSR ``spmv``/``spmm``, and
``prepare(A, mesh=...)``, which partitions the operator over row-block
shards (``repro_torch.core.distributed``).
``prepare(A)`` runs the setup pipeline and returns a :class:`PreparedSpMV`
whose ``__call__`` is the SpMV:

  CSR-k (regular matrices): Band-k reorder → constant-time tune (SSRS/SRS
  from rdensity) → CSR-k build → padded tile view (bucketed by slot count)
  → CUDA kernel per call.

  SELL-C-σ (row_var > 10): σ-window sort → C-row chunks → ``[T, C, W]``
  chunk view with each chunk's real width → CUDA kernel per call.  No
  global reordering (``perm`` is the identity).

  Segmented sum (row_var > 10 and row_skew ≥ 16: power-law rows, empty
  rows): the nnz stream cut into equal chunks of ``segsum_chunk`` slots →
  CUDA kernel per call (chunk pass + carry pass).  ``perm`` is the identity.

  DIA/CSR hybrid (diag_fraction ≥ 0.9 and row_var > 10: stencils with a
  fringe): diagonals filling ≥ ``diag_occupancy`` of their rows become a
  ``[n_diag, m]`` plane, the rest a CSR remainder → one CUDA launch per
  call for both.  ``perm`` is the identity.

The JAX ``device=`` string named both the tuning model and where arrays
live; here they are two arguments: ``device_model`` (a name the tuner knows,
default the paper's fitted ``"ampere"`` GPU model) and ``device`` (a
``torch.device``, default ``"cuda"``).  For ``device_model`` in
``("cpu", "rome", "icelake")`` the hierarchy collapses to CSR-2 and the SpMV
runs the plain CSR product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import repro_torch.core.ordering as bandk_mod
import repro_torch.core.tuner as tuner_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs import get_registry
from repro_torch.sparse import (
    CSRkMatrix,
    CSRkTileBuckets,
    CSRkTiles,
    CSRMatrix,
    DIAG_OCCUPANCY,
    DIAHybridMatrix,
    MatrixStats,
    SegSumCSR,
    SELLCSMatrix,
    SELLCSTiles,
    bucket_tiles,
    build_csrk,
    compute_stats,
    diahybrid_from_csr,
    segsum_from_csr,
    select_format,
    sellcs_from_csr,
    tiles_from_csrk,
    tiles_from_sellcs,
)
from repro_torch.sparse._tree import host, tensor_leaves, to_device

_CPU_MODELS = ("cpu", "rome", "icelake")


def _resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class PreparedSpMV:
    """A tuned, reordered, device-resident SpMV operator y = A x.

    ``perm`` maps new index → old index (A was symmetrically permuted), so for
    callers living in the original index space use :meth:`apply_original`.
    ``fingerprint`` is the content hash of the *source* matrix.  ``backend``
    is "csrk" (``csrk``/``tiles``/``tile_buckets`` set), "sellcs"
    (``sell``/``sell_tiles`` set, ``perm`` the identity: the σ-sort is
    internal to the container), "segsum" (``segsum`` set, ``perm`` the
    identity) or "diahybrid" (``dia`` set, ``perm`` the identity).
    """

    csrk: Optional[CSRkMatrix]
    tiles: Optional[CSRkTiles]
    perm: np.ndarray
    params: tuner_mod.TuningParams
    device_model: str
    device: torch.device
    backend: str = "csrk"
    stats: Optional[MatrixStats] = None
    tile_buckets: Optional[CSRkTileBuckets] = None
    value_dtype: str = "f32"
    fingerprint: Optional[str] = None
    spmm_width: Optional[int] = None
    sell: Optional[SELLCSMatrix] = None
    sell_tiles: Optional[SELLCSTiles] = None
    segsum: Optional[SegSumCSR] = None
    dia: Optional[DIAHybridMatrix] = None

    def __post_init__(self):
        # Device-resident permutation arrays, built once so apply_original
        # never re-uploads host numpy per call; argsort gives the inverse.
        perm_host = np.asarray(self.perm)
        object.__setattr__(self, "_perm_dev", torch.from_numpy(perm_host).to(self.device))
        object.__setattr__(
            self, "_inv_perm_dev", torch.from_numpy(np.argsort(perm_host)).to(self.device)
        )

    @property
    def csr(self) -> CSRMatrix:
        if self.csrk is None:
            raise AttributeError(
                f"no CSR view: this operator uses the {self.backend!r} backend"
            )
        return self.csrk.csr

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """SpMV / SpMM in the *reordered* index space.

        Args:
          x: a single vector of shape [n] or a multi-vector block [n, B].

        Returns:
          y = A x of shape [m] (resp. [m, B]); the batched form streams the
          matrix once for all B columns.

        With ``spmm_width=W`` set, every kernel launch is padded to exactly W
        columns (inputs wider than W are split into W-column launches), the
        serving layer's column-independence contract.  The CUDA kernel sums
        each column in the same order whatever the width, so here every
        column's bits depend only on its own input column either way.
        """
        if self.spmm_width is not None:
            W = self.spmm_width
            if x.ndim == 1:
                xw = x.new_zeros((x.shape[0], W))
                xw[:, 0] = x
                return self._dispatch(xw)[:, 0]
            B = x.shape[1]
            outs = []
            for off in range(0, B, W):
                blk = x[:, off:off + W]
                if blk.shape[1] < W:
                    blk = torch.nn.functional.pad(blk, (0, W - blk.shape[1]))
                outs.append(self._dispatch(blk))
            Y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
            return Y[:, :B]
        return self._dispatch(x)

    def _dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """Backend kernel launch at x's natural width (no fixed-width pad)."""
        if self.backend == "sellcs":
            return kops.spmv_sellcs(self.sell_tiles, x)
        if self.backend == "segsum":
            return kops.spmv_segsum(self.segsum, x)
        if self.backend == "diahybrid":
            return kops.spmv_diahybrid(self.dia, x)
        if self.tile_buckets is not None:
            return kops.spmv_csrk_bucketed(self.tile_buckets, x)
        if self.tiles is not None:
            return kops.spmv_csrk(self.tiles, x)
        # CSR-2 (CPU device models): the hierarchy collapses to plain CSR
        if x.ndim == 2:
            return kref.spmm_csr(self.csr, x)
        return kref.spmv_csr(self.csr, x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Explicit multi-vector alias: Y = A X for X of shape [n, B]."""
        if X.ndim != 2:
            raise ValueError(f"matmat expects a [n, B] block, got shape {tuple(X.shape)}")
        return self(X)

    def apply_original(self, x_old: torch.Tensor) -> torch.Tensor:
        """SpMV / SpMM for vectors indexed in the matrix's original ordering."""
        y_new = self(x_old[self._perm_dev])
        return y_new[self._inv_perm_dev]

    # -- introspection -----------------------------------------------------
    def overhead_fraction(self) -> float:
        if self.backend == "sellcs":
            base = (2 * self.sell.nnz + self.sell.m + 1) * 4
            return self.sell.overhead_bytes() / base
        if self.backend == "segsum":
            base = (2 * self.segsum.nnz + self.segsum.m + 1) * 4
            return self.segsum.overhead_bytes() / base
        if self.backend == "diahybrid":
            base = (2 * self.dia.nnz + self.dia.m + 1) * 4
            return self.dia.overhead_bytes() / base
        return self.csrk.overhead_fraction()

    def padding_overhead(self) -> float:
        if self.backend == "sellcs":
            return self.sell.padding_overhead()
        if self.backend == "segsum":
            return self.segsum.padding_overhead()
        if self.backend == "diahybrid":
            return self.dia.padding_overhead()
        return self.tiles.padding_overhead() if self.tiles is not None else 0.0

    def modeled_bytes(self) -> int:
        """Modeled HBM bytes one SpMV moves under the TPU design's accounting.

        Bucketed CSR-k sums per-bucket launches, monolithic uses worst-tile
        padding, SELL-C-σ prices every chunk at the global padded width,
        segmented sum prices all S slots and R partials of every chunk, the
        DIA hybrid one shifted x read per plane slot; the CSR-2 fallback
        counts the raw CSR streams.  Equal to the reference's
        value for the same operator.
        """
        if self.backend == "sellcs":
            return self.sell_tiles.modeled_bytes()
        if self.backend == "segsum":
            return self.segsum.modeled_bytes()
        if self.backend == "diahybrid":
            return self.dia.modeled_bytes()
        if self.tile_buckets is not None:
            return self.tile_buckets.modeled_bytes()
        if self.tiles is not None:
            return self.tiles.modeled_bytes()
        m, n = self.csrk.shape
        return self.csrk.nnz * 8 + (m + 1) * 4 + m * 4 + n * 4

    def resident_bytes(self) -> int:
        """Total bytes of every tensor this operator keeps between calls."""
        leaves = tensor_leaves((
            self.csrk, self.tiles, self.tile_buckets, self.sell, self.sell_tiles,
            self.segsum, self.dia, self._perm_dev, self._inv_perm_dev,
        ))
        return sum(t.numel() * t.element_size() for t in leaves)


def _record_prepared(op: PreparedSpMV) -> PreparedSpMV:
    """Record setup telemetry for a freshly built operator.

    The upload phase waits until the kernel-view tensors are resident (the
    cost callers pay before the first SpMV); nothing runs when telemetry is
    disabled, and the operator is returned unchanged.
    """
    reg = get_registry()
    if not reg.enabled:
        return op
    with reg.timer("prepare", "phase.device_upload"):
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)
    reg.counter("prepare", f"backend.{op.backend}")
    reg.gauge("prepare", "padding_overhead", op.padding_overhead(), unit="fraction")
    reg.gauge("prepare", "overhead_fraction", op.overhead_fraction(), unit="fraction")
    if op.backend == "sellcs":
        tile_count = op.sell_tiles.num_chunks              # C-row chunks
    elif op.backend == "segsum":
        tile_count = op.segsum.num_chunks                  # nnz chunks
    elif op.backend == "diahybrid":
        tile_count = op.dia.n_diag                         # dense diagonals
    else:
        tile_count = op.tiles.num_tiles if op.tiles is not None else 0
    reg.gauge("prepare", "tile_count", tile_count, unit="count")
    if op.stats is not None:
        reg.gauge("prepare", "stats.row_var", op.stats.row_var)
        reg.gauge("prepare", "stats.bandwidth", op.stats.bandwidth, unit="count")
    return op


def _auto_value_dtype(
    A: CSRMatrix,
    stats: Optional[MatrixStats],
    candidates: tuple = ("int8", "bf16"),
) -> str:
    """Pick the cheapest value dtype whose SpMV error clears the bound.

    One host-side probe SpMV against a fixed random x per candidate — int8
    (grouped scales) first, then bf16; the tolerance is half the acceptance
    bound (int8 ≤ 2.5e-2, bf16 ≤ 5e-3 relative).  Same numpy as the
    reference, with the bf16 round-to-nearest-even cast done by torch.
    """
    from repro_torch.optim.compress import (
        INT8_GROUP, dequantize_int8_grouped, quantize_int8_grouped,
    )

    nnz = A.nnz
    if nnz < 4 * INT8_GROUP or (stats is not None and stats.nnz < 4 * INT8_GROUP):
        return "f32"
    vl = host(A.vals).astype(np.float32)
    ci = host(A.col_idx)
    rp = host(A.row_ptr)
    rows = np.repeat(np.arange(A.m), rp[1:] - rp[:-1])
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = np.zeros(A.m, np.float32)
    np.add.at(y, rows, vl * x[ci])
    scale = max(float(np.linalg.norm(y)), 1e-30)

    if "int8" in candidates:
        pad = (-nnz) % INT8_GROUP
        vpad = np.pad(vl, (0, pad))
        q, s = quantize_int8_grouped(vpad, group=INT8_GROUP)
        v8 = dequantize_int8_grouped(q, s, group=INT8_GROUP)[:nnz]
        y8 = np.zeros(A.m, np.float32)
        np.add.at(y8, rows, v8 * x[ci])
        if np.linalg.norm(y8 - y) / scale <= 2.5e-2:
            return "int8"
    if "bf16" in candidates:
        v16 = torch.from_numpy(vl).to(torch.bfloat16).to(torch.float32).numpy()
        y16 = np.zeros(A.m, np.float32)
        np.add.at(y16, rows, v16 * x[ci])
        if np.linalg.norm(y16 - y) / scale <= 5e-3:
            return "bf16"
    return "f32"


def prepare(
    A: CSRMatrix,
    device_model: str = "ampere",
    *,
    device="cuda",
    format: str = "auto",             # "auto" | "csrk" | "sellcs" | "segsum" | "diahybrid"
    reorder: str = "bandk",           # "bandk" | "rcm" | "natural"
    params: tuner_mod.TuningParams | None = None,
    adaptive: bool = False,
    sell_c: int = 8,
    sell_sigma: int | None = None,
    segsum_chunk: int = 512,
    diag_occupancy: float = DIAG_OCCUPANCY,
    value_dtype: str = "f32",         # "f32" | "bf16" | "int8" | "auto"
    tile_layout: str = "bucketed",    # "bucketed" | "monolithic"
    spmm_width: int | None = None,
    mesh=None,
    shard_axis: str = "data",
    x_strategy: str = "auto",
    halo_overlap: bool | None = None,
):
    """Heterogeneous SpMV setup pipeline (paper Sec. 3–4 + registry).

    Args:
      A: the matrix, as a :class:`~repro_torch.sparse.CSRMatrix` of shape
        [m, n] (on any device; setup runs on the host).
      device_model: tuning-model name ("ampere" | "volta" | "tpu_v5e" |
        "cpu" | "rome" | "icelake"); drives the constant-time tuner and the
        format selector.  Unknown names fall through to the TPU model, as in
        the reference tuner.
      device: where the operator's tensors live and its SpMV runs ("cuda"
        unless the caller asks for "cpu"); raises if CUDA is asked for and
        absent.
      format: "auto" computes one-pass :class:`MatrixStats` and dispatches
        through the registry; "csrk" forces the paper's path; "sellcs"
        forces SELL-C-σ (σ-window sort → C-row chunks; no Band-k, ``perm``
        stays the identity); "segsum" forces the segmented-sum CSR
        (equal-nnz chunks + carry; no Band-k, ``perm`` the identity);
        "diahybrid" forces the DIA plane + CSR remainder (no Band-k, ``perm``
        the identity; f32 or bf16 values only).
      reorder: global reordering for the CSR-k path ("bandk" | "rcm" |
        "natural").
      params: explicit :class:`~repro_torch.core.tuner.TuningParams`; None
        runs the constant-time tuner.
      adaptive: use the variance-aware bytes-model tuner (``"tpu_v5e"`` only).
      sell_c / sell_sigma: SELL-C-σ chunk height and sorting window
        (defaults: C=8, σ=16·C).
      segsum_chunk: segmented-sum nnz slots per chunk (rounded up to a 128
        multiple; segsum backend only).
      diag_occupancy: dense-diagonal extraction threshold of the diahybrid
        backend: a diagonal joins the plane when it fills at least this
        fraction of the ``m`` rows.
      value_dtype: storage dtype of the kernel value stream ("f32" | "bf16" |
        "int8" | "auto"); accumulation is always f32.  The CSR-2 fallback
        always computes in f32; diahybrid takes f32 or bf16 ("auto" probes
        bf16 only) and raises ``ValueError`` for int8.
      tile_layout: "bucketed" (one launch per slot bucket) or "monolithic"
        (one launch, every tile padded to the worst tile's slots).
      spmm_width: when set to W ≥ 1, pad every kernel launch to exactly W
        columns (and split wider inputs into W-column launches).
        Single-device operators only (the ``mesh=`` path ignores it).
      mesh: optional :class:`~repro_torch.launch.mesh.ShardMesh` of devices
        of ``device``'s type.  When given, the prepared operator is
        partitioned over ``shard_axis`` and returned as a
        :class:`~repro_torch.core.distributed.ShardedPreparedSpMV`: same
        call surface, the same CUDA kernels run per shard, bit-for-bit
        identical results on the CSR-k and SELL-C-σ routes.
      shard_axis: mesh axis name rows are partitioned over (default "data").
      x_strategy: x distribution for the sharded operator: "auto",
        "replicated", "allgather" or "halo".  Ignored when ``mesh`` is None.
      halo_overlap: staged halo execution for the sharded operator: None
        lets the :class:`~repro_torch.core.distributed.ShardPlan` decide,
        True forces overlap when possible, False forces the blocking
        schedule.  Ignored when ``mesh`` is None.

    Returns:
      A :class:`PreparedSpMV` on ``device`` (or a
      :class:`~repro_torch.core.distributed.ShardedPreparedSpMV` when
      ``mesh`` is given).
    """
    if mesh is not None:
        # The sharded operator partitions the *monolithic* tile view (whole
        # tiles per shard), so the bucketed layout is not built here.
        base = prepare(
            A, device_model, device=device, format=format, reorder=reorder,
            params=params, adaptive=adaptive, sell_c=sell_c, sell_sigma=sell_sigma,
            segsum_chunk=segsum_chunk, diag_occupancy=diag_occupancy,
            value_dtype=value_dtype, tile_layout="monolithic",
        )
        from repro_torch.core.distributed import shard_prepared

        src = base.csrk.csr if base.backend == "csrk" else A
        return shard_prepared(
            base, mesh, axis=shard_axis, x_strategy=x_strategy, A=src,
            halo_overlap=halo_overlap,
        )
    dev = _resolve_device(device)
    if tile_layout not in ("bucketed", "monolithic"):
        raise ValueError(
            f"unknown tile_layout {tile_layout!r} (expected bucketed|monolithic)"
        )
    if spmm_width is not None and spmm_width < 1:
        raise ValueError(f"spmm_width must be >= 1, got {spmm_width}")
    reg = get_registry()
    A = A.to("cpu")
    fingerprint = A.fingerprint()
    stats = None
    if format == "auto":
        with reg.timer("prepare", "phase.stats"):
            stats = compute_stats(A)
            format = select_format(stats, device_model)
    if format not in ("csrk", "sellcs", "segsum", "diahybrid"):
        raise ValueError(
            f"unknown format {format!r} (expected auto|csrk|sellcs|segsum|diahybrid)"
        )
    if value_dtype == "auto":
        with reg.timer("prepare", "phase.value_dtype"):
            # the diahybrid plane has no slot grouping, so no int8 scales
            cands = ("bf16",) if format == "diahybrid" else ("int8", "bf16")
            value_dtype = _auto_value_dtype(A, stats, candidates=cands)
        reg.counter("prepare", f"value_dtype.{value_dtype}")
    if format == "sellcs":
        with reg.timer("prepare", "phase.tile_build"):
            sell = sellcs_from_csr(A, C=sell_c, sigma=sell_sigma)
            sell_tiles = tiles_from_sellcs(sell, value_dtype=value_dtype)
        return _record_prepared(PreparedSpMV(
            csrk=None,
            tiles=None,
            perm=np.arange(A.m),
            params=tuner_mod.TuningParams(ssrs=1, srs=sell_c, k=1, use_inner_parallel=True),
            device_model=device_model,
            device=dev,
            backend="sellcs",
            stats=stats,
            value_dtype=value_dtype,
            fingerprint=fingerprint,
            spmm_width=spmm_width,
            sell=sell.to(dev),
            sell_tiles=sell_tiles.to(dev),
        ))
    if format in ("segsum", "diahybrid"):
        with reg.timer("prepare", "phase.tile_build"):
            seg = dia = None
            if format == "segsum":
                seg = segsum_from_csr(A, chunk_slots=segsum_chunk, value_dtype=value_dtype)
            else:
                dia = diahybrid_from_csr(A, occupancy=diag_occupancy, value_dtype=value_dtype)
        return _record_prepared(PreparedSpMV(
            csrk=None,
            tiles=None,
            perm=np.arange(A.m),
            params=tuner_mod.TuningParams(ssrs=1, srs=1, k=1, use_inner_parallel=True),
            device_model=device_model,
            device=dev,
            backend=format,
            stats=stats,
            value_dtype=value_dtype,
            fingerprint=fingerprint,
            spmm_width=spmm_width,
            segsum=to_device(seg, dev),
            dia=to_device(dia, dev),
        ))

    with reg.timer("prepare", "phase.reorder"):
        if reorder == "bandk":
            perm = bandk_mod.bandk(A, k=3)
        elif reorder == "rcm":
            perm = bandk_mod.rcm(A)
        elif reorder == "natural":
            perm = np.arange(A.m)
        else:
            raise ValueError(f"unknown reorder {reorder!r}")
        Ar = A.symmetric_permute(perm) if reorder != "natural" else A
        if stats is not None and reorder != "natural":
            # post-reordering bandwidth (row-length stats are permutation-invariant)
            stats = compute_stats(Ar)

    with reg.timer("prepare", "phase.tune"):
        if params is None:
            if adaptive and device_model == "tpu_v5e":
                params = tuner_mod.tune_tpu_adaptive(
                    host(Ar.row_ptr), host(Ar.col_idx), Ar.rdensity, Ar.m
                )
            else:
                params = tuner_mod.tune(Ar.rdensity, device=device_model, m=Ar.m)

    with reg.timer("prepare", "phase.tile_build"):
        if params.k >= 3 and device_model not in _CPU_MODELS:
            csrk = build_csrk(Ar, srs=params.srs, ssrs=params.ssrs, k=3)
            tiles = tiles_from_csrk(csrk, value_dtype=value_dtype)
            buckets = bucket_tiles(tiles) if tile_layout == "bucketed" else None
        else:
            csrk = build_csrk(Ar, srs=params.srs, k=2)
            tiles = None
            buckets = None
            value_dtype = "f32"   # CSR-2 fallback computes on raw CSR
    return _record_prepared(PreparedSpMV(
        csrk=csrk.to(dev),
        tiles=None if tiles is None else tiles.to(dev),
        perm=perm,
        params=params,
        device_model=device_model,
        device=dev,
        backend="csrk",
        stats=stats,
        tile_buckets=None if buckets is None else buckets.to(dev),
        value_dtype=value_dtype,
        fingerprint=fingerprint,
        spmm_width=spmm_width,
    ))


def spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """One-shot CSR SpMV (no setup) — the plain-CSR baseline.

    Args:
      A: CSR matrix of shape [m, n].
      x: vector of shape [n], on A's device.

    Returns:
      y = A x of shape [m], computed with the plain PyTorch CSR oracle on
      whatever device A and x live on.
    """
    return kref.spmv_csr(A, x)


def spmm(A: CSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """One-shot CSR SpMM (no setup): Y = A X.

    Args:
      A: CSR matrix of shape [m, n].
      X: multi-vector block of shape [n, B] (raises ``ValueError`` otherwise).

    Returns:
      Y of shape [m, B]; the matrix nnz stream is read once for all B
      right-hand sides.
    """
    if X.ndim != 2:
        raise ValueError(f"spmm expects X of shape [n, B], got {tuple(X.shape)}")
    return kref.spmm_csr(A, X)
