"""JSON export: benchmark-schema records plus run-identifying metadata.

Port of ``repro.obs.export``.  :func:`write_records` wraps ``{"meta": ...,
"records": [...]}`` around ``{"section", "name", "value", "unit"}`` rows, and
:func:`read_records` accepts that shape and the legacy bare record list, so
each package reads the other's files.  :func:`collect_metadata` names the
torch and CUDA versions, the backend and the card in place of the
reference's jax fields.
"""
from __future__ import annotations

import datetime
import json
import os
import platform
import subprocess
import sys
from typing import List, Optional, Tuple

import torch


def _git_sha() -> str:
    """Current commit sha: git first, CI env second, "unknown" last."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=here,
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except Exception:
        pass
    return os.environ.get("GITHUB_SHA", "unknown")


def collect_metadata() -> dict:
    """Identity stamp for one benchmark/telemetry record file.

    Keys: ``git_sha``, ``timestamp`` (UTC ISO-8601), ``torch_version``,
    ``cuda_version`` (None for a CPU-only torch), ``backend`` ("cuda" or
    "cpu"), ``device_kind`` (the card's name, or "cpu"), ``device_count``,
    ``python_version``, ``hostname``.
    """
    on_card = torch.cuda.is_available()
    return {
        "git_sha": _git_sha(),
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if on_card else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "python_version": sys.version.split()[0],
        "hostname": platform.node(),
    }


def write_records(path: str, records: List[dict],
                  meta: Optional[dict] = None) -> None:
    """Write ``{"meta": ..., "records": [...]}`` (meta auto-collected)."""
    payload = {
        "meta": collect_metadata() if meta is None else meta,
        "records": list(records),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def read_records(path: str) -> Tuple[dict, List[dict]]:
    """Read a record file; legacy bare-list files get an empty meta dict."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, list):
        return {}, payload
    return payload.get("meta", {}), payload.get("records", [])
