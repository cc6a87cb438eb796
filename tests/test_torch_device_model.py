"""The port's ``"h100"`` device model and its fit tool against the reference.

``tune(…, "h100")`` is dispatched to ``tune_h100`` (the reference would send
an unknown name to ``tune_tpu``) and applies the fitted base as worked by
hand; the four models both packages know tune alike; ``fit_log_model``, the
fit tool's JSON and its candidate set are the reference's; ``prepare``
defaults to ``"h100"`` and builds the containers the reference builds from
the same params.  Everything runs on the CPU at small sizes.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

import repro.core.tuner as j_tuner
from repro.configs.spmv_suite import load_suite as j_load_suite
from repro.core.spmv import prepare as j_prepare

import repro_torch.core.tuner as t_tuner
from repro_torch.configs.spmv_suite import load_suite as t_load_suite
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.launch import fit_device_model as fdm
from repro_torch.sparse.convert import to_numpy

ROOT = Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)
BOUNDARIES = (2.76, 4.99, 8.0, 11.71, 16.3, 43.74, 71.53)
RDENSITIES = sorted({v for b in BOUNDARIES for v in (b * (1 - 1e-6), b, b * (1 + 1e-6))}
                    | {1.0, 3.0, 5.5, 12.0, 24.0, 50.0, 100.0, 300.0})
SCALE = 512


@pytest.fixture(autouse=True)
def _no_installed_model(monkeypatch):
    """Each test starts from the hand-set models in both packages."""
    monkeypatch.delenv("REPRO_DEVICE_MODEL", raising=False)
    t_tuner.use_device_model(None)
    j_tuner.use_device_model(None)
    yield
    t_tuner.use_device_model(None)
    j_tuner.use_device_model(None)


def by_hand(a: float, b: float, rd: float) -> int:
    return max(math.floor(a - b * math.log(max(rd, 1.0)) + 0.5), 1)


@pytest.mark.parametrize("rd", RDENSITIES)
def test_tune_h100_is_the_fitted_base_worked_by_hand(monkeypatch, rd):
    def no_tpu(*args, **kwargs):
        raise AssertionError("tune(..., 'h100') fell through to tune_tpu")

    monkeypatch.setattr(t_tuner, "tune_tpu", no_tpu)
    p = t_tuner.tune(rd, "h100")
    H = t_tuner.H100
    assert (p.ssrs, p.srs) == (by_hand(H.ssrs_a, H.ssrs_b, rd), by_hand(H.srs_a, H.srs_b, rd))
    assert (p.k, p.use_inner_parallel, p.gather_chunk) == (3, rd >= 8, H.gather_chunk)
    assert p == t_tuner.tune_h100(rd)
    assert t_tuner.DEVICES["h100"] is H


@pytest.mark.parametrize("device", ["volta", "ampere", "tpu_v5e", "cpu"])
def test_shared_models_tune_as_the_reference(device):
    for rd in RDENSITIES:
        for m in (None, 1000, 1 << 20):
            got = dataclasses.asdict(t_tuner.tune(rd, device, m=m))
            assert got == dataclasses.asdict(j_tuner.tune(rd, device, m=m)), (rd, m)


def test_fit_log_model_matches_the_reference():
    rng = np.random.default_rng(0)
    rds = np.exp(rng.uniform(0.0, 4.5, 16))
    for _ in range(4):
        sizes = rng.choice(t_tuner.GPU_SWEEP, 16)
        assert t_tuner.fit_log_model(rds, sizes) == j_tuner.fit_log_model(rds, sizes)


def test_tool_json_reads_alike_in_both_packages(tmp_path, capsys):
    path = tmp_path / "device_model.json"
    assert fdm.main(["--device", "cpu", "--scale", "2048", "--ids", "9,12",
                     "--out", str(path)]) == 0
    out = capsys.readouterr().out
    assert "SSRS = round(" in out and "| 9 | cont-300 | 2048 |" in out
    written = json.loads(path.read_text())
    assert set(written) == {"h100"} and set(written["h100"]) == {"ssrs", "srs", "gather_chunk"}
    t = t_tuner.load_fitted_device_model(str(path), "h100")
    j = j_tuner.load_fitted_device_model(str(path), "h100")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [t.ssrs_a, t.ssrs_b] == written["h100"]["ssrs"]
    assert [t.srs_a, t.srs_b] == written["h100"]["srs"]
    assert t.gather_chunk == t_tuner.H100.gather_chunk
    assert t_tuner.load_fitted_device_model(str(tmp_path / "missing.json"), "h100") is t_tuner.H100


def test_installed_h100_model_leaves_the_tpu_tuner_alone(tmp_path, monkeypatch):
    fitted = t_tuner.DeviceModel("h100", 20.0, 3.0, 14.0, 2.0, gather_chunk=256)
    t_tuner.use_device_model(fitted)
    assert t_tuner.active_h100_model() is fitted
    assert t_tuner.active_tpu_model() is t_tuner.TPU_V5E
    assert (t_tuner.tune(5.0, "h100").ssrs, t_tuner.tune(5.0, "h100").srs) == fitted.base(5.0)
    assert t_tuner.tune(5.0, "h100").gather_chunk == 256
    t_tuner.use_device_model(None)
    assert t_tuner.active_h100_model() is t_tuner.H100
    # the env var names one file; each tuner reads its own entry, the TPU
    # one as the reference does
    path = tmp_path / "both.json"
    path.write_text(json.dumps({
        "h100": {"ssrs": [20.0, 3.0], "srs": [14.0, 2.0], "gather_chunk": 512},
        "tpu_v5e": {"ssrs": [10.0, 1.0], "srs": [11.0, 1.5], "gather_chunk": 256}}))
    monkeypatch.setenv("REPRO_DEVICE_MODEL", str(path))
    t_tuner.use_device_model(None)   # the env var is read once, at the next resolution
    j_tuner.use_device_model(None)
    assert t_tuner.active_h100_model().base(5.0) == fitted.base(5.0)
    for rd in RDENSITIES:
        assert (dataclasses.asdict(t_tuner.tune(rd, "tpu_v5e", m=4096))
                == dataclasses.asdict(j_tuner.tune(rd, "tpu_v5e", m=4096)))


def test_tool_candidates_follow_the_references_skip_rule(monkeypatch):
    sys.path.insert(0, str(ROOT))
    import benchmarks.fit_device_model as j_fdm

    tried = []
    monkeypatch.setattr(j_fdm, "build_csrk", lambda A, srs, ssrs, k: tried.append((ssrs, srs)))
    monkeypatch.setattr(j_fdm, "tiles_from_csrk", lambda c: None)
    monkeypatch.setattr(j_fdm, "time_fn", lambda *a, **k: 1.0)
    ms = {}
    for scale in (2048, 512, 128):
        tried.clear()
        j_fdm.sweep_optima(scale, ids=(9,))
        m = j_load_suite(scale, ids=[9])["cont-300"].m
        ms[m] = list(tried)
        assert fdm.candidates(m) == ms[m]
    assert len(set(map(len, ms.values()))) == len(ms)   # the rule cuts at each size


def test_fit_stands_each_optimum_by_its_most_square_near_pair():
    def row(rd, times):
        best = min(times.values())
        return {"rdensity": rd, "times": times,
                "near": sorted(p for p, t in times.items() if t <= best * (1 + fdm.NEAR))}

    rows = [row(4.0, {(4, 24): 1.00, (12, 12): 1.01, (24, 4): 1.00, (8, 8): 1.5}),
            row(8.0, {(4, 16): 1.00, (8, 8): 1.015, (16, 4): 1.00, (6, 6): 1.3})]
    assert [fdm.representative(r) for r in rows] == [(12, 12), (8, 8)]
    model = fdm.fit(rows)
    a, b = t_tuner.fit_log_model(np.array([4.0, 8.0]), np.array([12, 8]))
    assert model.name == "h100"
    assert (model.ssrs_a, model.ssrs_b) == (model.srs_a, model.srs_b) == (a, b)
    with pytest.raises(ValueError):
        fdm.fit(rows[:1])
    assert fdm.picks({"rdensity": 4.0}, model) == {"fitted": model.base(4.0)}
    assert fdm.picks({"rdensity": 20.0}, model) == {
        "fitted": model.base(20.0), "table": t_tuner.ampere_cases(20.0, *model.base(20.0))}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_tool_refuses_cuda_without_a_card(tmp_path):
    with pytest.raises(RuntimeError):
        fdm.run(scale=2048, ids=(9, 12), out=str(tmp_path / "m.json"), device="cuda")


def _same_tiles(t, j):
    for f in ("vals", "local_col", "local_row", "win_block", "rem_row", "rem_col",
              "rem_val", "val_scale", "tile_nnz"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b), err_msg=f)
    assert (t.shape, t.rows_per_tile, t.window) == (tuple(j.shape), j.rows_per_tile, j.window)


@pytest.mark.parametrize("name", ["ecology1", "cont-300", "brack2"])
def test_prepare_defaults_to_h100_and_builds_the_references_containers(rng, name):
    ids = {"ecology1": 8, "cont-300": 9, "brack2": 12}
    A = t_load_suite(SCALE, ids=[ids[name]])[name]
    Aj = j_load_suite(SCALE, ids=[ids[name]])[name]
    op = t_prepare(A, device="cpu")
    assert op.device_model == "h100" and op.backend == "csrk"
    params = t_tuner.tune(A.rdensity, "h100")
    assert op.params == params
    opj = j_prepare(Aj, device="ampere", params=j_tuner.TuningParams(**dataclasses.asdict(params)))
    assert opj.backend == "csrk"
    np.testing.assert_array_equal(op.perm, opj.perm)
    _same_tiles(op.tiles, opj.tiles)
    assert len(op.tile_buckets.buckets) == len(opj.tile_buckets.buckets)
    for t, j, ti, tj in zip(op.tile_buckets.buckets, opj.tile_buckets.buckets,
                            op.tile_buckets.tile_ids, opj.tile_buckets.tile_ids):
        _same_tiles(t, j)
        np.testing.assert_array_equal(to_numpy(ti), np.asarray(tj))
    assert op.modeled_bytes() == opj.modeled_bytes()
    # the SpMV against the plain CSR product, within the per-row bound
    dense = np.asarray(Aj.todense(), np.float64)
    x = rng.standard_normal(A.n).astype(np.float32)
    y = op.apply_original(torch.from_numpy(x)).numpy().astype(np.float64)
    k = (dense != 0).sum(axis=1)
    bound = (2 * k + 2) * EPS32 * (np.abs(dense) @ np.abs(x.astype(np.float64)))
    assert np.all(np.abs(y - dense @ x) <= bound)
    y_j = np.asarray(opj.apply_original(jnp.asarray(x)), np.float64)
    assert np.all(np.abs(y - y_j) <= 2 * bound)
