"""The port's record files against the reference's: each package reads the
other's ``{"meta", "records"}`` files, and both read a legacy bare list."""
import json

import pytest
import torch_threads  # noqa: F401  one torch thread per test process

from repro.obs import read_records as j_read
from repro.obs import write_records as j_write

from repro_torch.obs import MetricsRegistry, collect_metadata, read_records, write_records

RECORDS = [
    {"section": "serve", "name": "latency_p50_ms", "value": 0.25, "unit": "ms"},
    {"section": "serve", "name": "requests", "value": 512.0, "unit": "count"},
    {"section": "prepare", "name": "phase.reorder_ms", "value": 41.5, "unit": "ms"},
]


def test_metadata_names_torch_and_the_device():
    meta = collect_metadata()
    assert {"git_sha", "timestamp", "torch_version", "cuda_version", "backend",
            "device_kind", "device_count", "python_version", "hostname"} <= set(meta)
    assert meta["backend"] in ("cuda", "cpu") and meta["device_count"] >= 1
    assert not any(k.startswith("jax") for k in meta)
    json.dumps(meta)


@pytest.mark.parametrize("writer,reader", [(write_records, j_read), (j_write, read_records)],
                         ids=["port_to_reference", "reference_to_port"])
def test_each_package_reads_the_others_file(tmp_path, writer, reader):
    path = str(tmp_path / "records.json")
    writer(path, RECORDS, meta={"git_sha": "abc", "backend": "cuda"})
    meta, records = reader(path)
    assert meta == {"git_sha": "abc", "backend": "cuda"}
    assert records == RECORDS


def test_registry_records_round_trip_with_collected_meta(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serve", "requests", 3)
    with reg.timer("serve", "dispatch"):
        pass
    path = str(tmp_path / "reg.json")
    write_records(path, reg.records())
    meta, records = j_read(path)
    assert records == reg.records() and meta["torch_version"]
    assert read_records(path) == (meta, records)


@pytest.mark.parametrize("reader", [read_records, j_read], ids=["port", "reference"])
def test_legacy_bare_list_reads_with_empty_meta(tmp_path, reader):
    path = tmp_path / "legacy.json"
    path.write_text(json.dumps(RECORDS))
    assert reader(str(path)) == ({}, RECORDS)
