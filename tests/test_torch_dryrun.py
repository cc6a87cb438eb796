"""The port's dry run (``repro_torch.launch.dryrun``) on fake tensors, held
against the reference's ``repro.launch.dryrun``.

The reference needs 8 host devices, which the test process must not see,
so it runs once for the module in a subprocess (started when the module's
first test starts, so that it runs beside the port's fake runs) and pickles
its outputs.  It calls its own ``dryrun_cell`` with ``jax.jit`` replaced
by a stand-in that neither lowers nor compiles: every key that does not
come from XLA (``devices``, ``mesh``, ``peak_hbm_per_device``,
``model_flops_global``) is the reference's own arithmetic on its
``input_specs``, at full width, with no full-width compile.  It also gives
its ``cache_shardings`` and XLA's cost analysis of one smoke decode cell.

Held: those keys equal to the reference's, for training and serving alike
(the port keeps params, cache and batch in pieces on a mesh of several
shards, each block once, on its first shard); granite-3-2b's
``decode_32k`` FLOPs on a device within 1% of its share of
2·N·B + 4·B·S·H·hd·n_attn (its data shard's rows, and its model shard's
blocks of attention, MLP and logits); every cell's FLOPs over all devices at least
``model_flops_global``; a decode cell's bytes at least its parameter and
cache bytes; no cross-device bytes on one device, and on the 2 × 4 smoke
train step the all-gather bytes that the pieces' owners, the data
shards and tensor parallelism's blocks imply; the two-point depth
extrapolation equal to the full-depth count on a uniform stack (that of
the roofline and that of ``dryrun_config``); the
report's tables over the CLI's JSON; no
tensor memory allocated by the dry run.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline_sweep as SWEEP
from repro_torch.launch import sharded as SHD
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_meta_mesh, make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.util.sharded import Sharded
from repro_torch.util.tree import leaf_paths, leaves

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.report import dryrun_table, roofline_table  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")), "1x1": ((1, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [("granite-3-2b", "decode_32k", "1x1"), ("granite-3-2b", "decode_32k", "2x4"),
         ("granite-3-2b", "train_4k", "1x1"), ("granite-3-2b", "train_4k", "2x4"),
         ("qwen1.5-32b", "train_4k", "2x2x2")]
CACHE_ARCHS = ("granite-3-2b", "jamba-v0.1-52b", "rwkv6-3b")
REF_ZERO_THRESHOLD = 14 * 1024 ** 3          # the reference's v5e share
SMOKE_DECODE = ShapeConfig("smoke_decode", 64, 4, "decode")

REFERENCE = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
jax.devices()
from jax.sharding import Mesh
from repro.configs.registry import get_config, get_smoke_config
from repro.launch import dryrun as DR, sharding as SH, steps as STEPS
from repro.models.config import ShapeConfig

CELLS, MESHES, CACHE_ARCHS = {cells!r}, {meshes!r}, {cache_archs!r}
devs = np.asarray(jax.devices())
meshes = {{k: Mesh(devs[:int(np.prod(s))].reshape(s), a) for k, (s, a) in MESHES.items()}}

class NoCompile:
    """jax.jit's stand-in: dryrun_cell's own arithmetic, no lowering."""
    def lower(self, *a): return self
    def compile(self): return self
    def memory_analysis(self): return None
    def cost_analysis(self): return {{}}
    def as_text(self): return ""

class Jax:
    def __getattr__(self, name): return getattr(jax, name)
    def jit(self, *a, **k): return NoCompile()

out = {{"cells": {{}}, "cache": {{}}}}
real, DR.jax = DR.jax, Jax()
for arch, shape, mesh in CELLS:
    out["cells"][(arch, shape, mesh)] = DR.dryrun_cell(arch, shape, mesh=meshes[mesh])
DR.jax = real
for arch in CACHE_ARCHS:
    cache = STEPS.abstract_cache(get_config(arch), 128, 32768)
    sh = SH.cache_shardings(cache, meshes["2x4"], 128)
    out["cache"][arch] = [
        (tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), tuple(s.spec))
        for p, s in jax.tree_util.tree_leaves_with_path(sh, is_leaf=lambda s: hasattr(s, "spec"))]
smoke = get_smoke_config("granite-3-2b")
shape = ShapeConfig("smoke_decode", 64, 4, "decode")
out["smoke_decode"] = DR._cell_costs(DR._analysis_cfg(smoke, smoke.layers, shape)[0], shape,
                                     meshes["1x1"])
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """Start the reference's subprocess; :func:`ref` waits for it."""
    d = tempfile.TemporaryDirectory()
    path = os.path.join(d.name, "ref.pkl")
    script = REFERENCE.format(cells=CELLS, meshes=MESHES, cache_archs=CACHE_ARCHS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", script, path], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    state = {"proc": proc, "path": path, "out": None}
    yield state
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    d.cleanup()


@pytest.fixture(scope="module")
def ref(_reference_run):
    st = _reference_run
    if st["out"] is None:
        _, err = st["proc"].communicate(timeout=600)
        assert st["proc"].returncode == 0, err[-4000:]
        with open(st["path"], "rb") as fh:
            st["out"] = pickle.load(fh)
    return st["out"]


def mesh_of(name):
    shape, axes = MESHES[name]
    return make_meta_mesh(shape, axes)


@pytest.fixture(scope="module")
def decode_cells():
    """The port's dry run of granite-3-2b ``decode_32k`` on 1 × 1 and 2 × 4."""
    return {m: DR.dryrun_cell("granite-3-2b", "decode_32k", mesh=mesh_of(m))
            for m in ("1x1", "2x4")}


def placed(arch, shape, mesh, **kw):
    """(state bytes per device, whole bytes by argument) of ``input_specs``."""
    with FakeTensorMode():
        args, _ = STEPS.input_specs(get_config(arch), SHAPES[shape], mesh, **kw)
        state = DR.state_bytes_per_device(args, SHAPES[shape].kind, mesh)
        whole = {k: sum(t.numel() * t.element_size() for t in leaves(v)
                        if isinstance(t, (torch.Tensor, Sharded)))
                 for k, v in args.items()}
    return state, whole


# ---------------------------------------------------------------------------
# the mesh, the constants, the keys
# ---------------------------------------------------------------------------


def test_production_mesh_shape_and_devices():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    assert two.devices == tuple(torch.device("meta", i) for i in range(512))
    assert len(set(one.devices)) == 256


def test_constants_are_the_h100s():
    assert (DR.PEAK_FLOPS, DR.HBM_BW, DR.LINK_BW, DR.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)


def test_decode_cell_keys_and_tiny_mesh(decode_cells, ref):
    for m, r in decode_cells.items():
        assert set(r) == set(ref["cells"][("granite-3-2b", "decode_32k", m)])
        assert r["flops_per_device"] > 0 and r["collective_bytes"]["total"] >= 0
        assert r["dominant"] in r["terms"] and r["fits_hbm"] == (r["peak_hbm_per_device"] <= 80e9)
        assert set(r["collective_bytes"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                              "all-to-all", "collective-permute", "total"}


def test_abstract_specs_need_fake_mode():
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        STEPS.abstract_params(get_smoke_config("granite-3-2b"))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_state_bytes_equal_the_reference(ref, arch, shape, mesh, decode_cells):
    want = ref["cells"][(arch, shape, mesh)]
    kw = {"zero_threshold": REF_ZERO_THRESHOLD} if mesh == "2x2x2" else {}
    state, _ = placed(arch, shape, mesh_of(mesh), **kw)
    assert max(state) == state[0] == want["peak_hbm_per_device"]
    if (arch, shape) == ("granite-3-2b", "decode_32k"):
        got = decode_cells[mesh]
        for k in ("devices", "mesh", "model_flops_global", "peak_hbm_per_device"):
            assert got[k] == want[k], k


def test_zero_escalation_follows_the_threshold():
    """qwen1.5-32b train_4k on 2 × 2 × 2: the FSDP axis grows to pod × data
    over the threshold (the reference's at 14 GiB), and not under it."""
    mesh = mesh_of("2x2x2")
    with FakeTensorMode():
        for thr, grown in ((REF_ZERO_THRESHOLD, True), (1e15, False)):
            _, sh = STEPS.input_specs(get_config("qwen1.5-32b"), SHAPES["train_4k"], mesh,
                                      zero_threshold=thr)
            specs = [tuple(s.spec) for s in leaves(sh["params"])]
            assert any(("pod", "data") in s for s in specs) == grown


def test_train_cell_against_the_reference(ref):
    r = DR.dryrun_cell("granite-3-2b", "train_4k", mesh=mesh_of("1x1"))
    want = ref["cells"][("granite-3-2b", "train_4k", "1x1")]
    for k in ("devices", "mesh", "model_flops_global", "peak_hbm_per_device"):
        assert r[k] == want[k], k
    assert r["flops_per_device"] >= r["model_flops_global"]
    assert r["collective_bytes"]["total"] == 0


def test_cache_shardings_equal_the_reference(ref):
    """Each per-layer cache leaf's spec is the reference's spec of its stacked
    leaf with the (unsplit) stack dimension dropped."""
    mesh = mesh_of("2x4")
    for arch in CACHE_ARCHS:
        cfg = get_config(arch)
        want = dict(ref["cache"][arch])
        with FakeTensorMode():
            cache = STEPS.abstract_cache(cfg, 128, 32768)
        got = SH.cache_shardings(cache, mesh, 128)
        for path, sh in zip(leaf_paths(got), leaves(got)):
            i, name = path[0], path[-1]
            key = (i % cfg.attn_period, name) if cfg.attn_period else (name,)
            assert want[key][0] is None and tuple(sh.spec) == want[key][1:], (arch, path)


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------


def test_decode_flops_match_the_analytic_count(decode_cells):
    """2·N·B + 4·B·S·H·hd·n_attn over the devices: each data shard runs its
    own rows, and each of its model shards its block of the MLP and of the
    logits, and of attention where the heads divide (granite's 32 heads and
    8 kv heads over model 4: a device's share is 1/(data·model))."""
    cfg, shape = get_config("granite-3-2b"), SHAPES["decode_32k"]
    B, S, hd = shape.global_batch, shape.seq_len, cfg.resolved_head_dim
    H, kv, D = cfg.num_heads, cfg.kv_heads, cfg.d_model
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.layers))
    attn_params = n_attn * (D * hd * (H + 2 * kv) + H * hd * D)
    attn = 2 * attn_params * B + 4 * B * S * H * hd * n_attn
    rest = 2 * (cfg.active_param_count() - attn_params) * B       # MLPs and logits
    for m, r in decode_cells.items():
        data, model = MESHES[m][0]
        heads = model if H % model == 0 and kv % model == 0 else 1
        share = (attn / heads + rest / model) / data
        assert abs(r["flops_per_device"] - share) <= 0.01 * share, m


def test_decode_bytes_cover_parameters_and_cache(decode_cells):
    _, whole = placed("granite-3-2b", "decode_32k", mesh_of("1x1"))
    for r in decode_cells.values():
        assert r["hbm_bytes_per_device"] >= whole["params"] + whole["cache"]


def test_smoke_flops_against_xla(ref):
    """XLA's count of a smoke decode cell (unrolled, as the roofline's
    analysis config runs it) against the port's."""
    smoke = get_smoke_config("granite-3-2b")
    cfg = DR._analysis_cfg(smoke, smoke.layers, SMOKE_DECODE)[0]
    mine = DR._cell_costs(cfg, SMOKE_DECODE, mesh_of("1x1"))
    xla = ref["smoke_decode"]
    # XLA adds elementwise work to the matmuls and attention the port counts
    assert 0.95 * xla["flops"] <= mine["flops"] <= xla["flops"]
    assert mine["coll"] == 0 and mine["whiles"] == xla["whiles"] == 0


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", ShapeConfig("t", 32, 4, "train")),
                                        ("jamba-v0.1-52b", SMOKE_DECODE)])
def test_counted_flops_cover_model_flops(arch, shape):
    cfg = get_smoke_config(arch)
    run = DR._fake_run(cfg, shape, mesh_of("2x4"))
    model = (6 if shape.kind == "train" else 2) * cfg.active_param_count() * shape.global_batch * (
        shape.seq_len if shape.kind == "train" else 1)
    assert sum(run["counter"].flops.values()) >= model


def test_smoke_train_all_gather_bytes_follow_the_owners():
    """granite smoke, 2 × 4: each data shard gathers each leaf it uses whole
    onto its device, and the block m of each tensor-parallel leaf (on 2 × 4
    the MLP's and the embedding's) onto its model shard m, so each shard
    receives every piece of those it does not hold; besides, the token rows
    go to the 3 other model shards of the unit and each vocabulary block's
    logits [2, 32, 128] come back.  The gradients go back the same way."""
    cfg, mesh = get_smoke_config("granite-3-2b"), mesh_of("2x4")
    run = DR._fake_run(cfg, ShapeConfig("t", 32, 4, "train"), mesh)
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, ShapeConfig("t", 32, 4, "train"), mesh)
        params = args["params"]
    units = SHD._units(mesh, 4)
    want = 0
    for _, sub, dev in units:
        for path, s in zip(leaf_paths(params), leaves(params)):
            dim = SH.tp_dim(cfg, path[2:] if path[0] == "layers" else path, s.spec, mesh)
            for b, p in zip(s.blocks(), s.pieces):
                to = dev if dim is None else sub.device_at(model=b[dim])
                want += p.numel() * p.element_size() if s.owner(b) != to else 0
    tp = {path[-2] if len(path) > 1 else path[0]
          for path, s in zip(leaf_paths(params), leaves(params))
          if SH.tp_dim(cfg, path[2:] if path[0] == "layers" else path, s.spec, mesh) is not None}
    assert tp == {"mlp", "embedding"}
    Bl, T, M, V = 2, 32, 4, cfg.padded_vocab
    logits = len(units) * (M - 1) * Bl * T * (V // M) * 4
    tokens = len(units) * (M - 1) * Bl * T * 4
    got = run["counter"].collective_bytes()
    assert len(units) == 2 and got["all-gather"] == want + tokens + logits and want > 0
    assert got["reduce-scatter"] == want + logits and got["all-to-all"] == 0
    assert got["all-reduce"] > 0


def test_one_device_moves_nothing(decode_cells):
    assert decode_cells["1x1"]["collective_bytes"]["total"] == 0
    run = DR._fake_run(get_smoke_config("jamba-v0.1-52b"), ShapeConfig("t", 32, 4, "train"),
                       mesh_of("1x1"))
    assert run["counter"].collective_bytes()["total"] == 0


@pytest.mark.parametrize("arch,shape,mesh", [("granite-3-2b", "decode_32k", "1x1"),
                                             ("granite-3-2b", "train_4k", "2x4"),
                                             ("jamba-v0.1-52b", "decode_32k", "1x1")])
def test_depth_extrapolation_is_exact_on_a_uniform_stack(arch, shape, mesh):
    cfg = get_smoke_config(arch)
    unit = cfg.attn_period or 1
    cfg = dataclasses.replace(cfg, layers=3 * unit)
    r = DR.roofline_cell(arch, shape, mesh_of(mesh), cfg_override=cfg)
    full, units = DR._analysis_cfg(cfg, 3, SHAPES[shape])
    c = DR._cell_costs(full, SHAPES[shape], mesh_of(mesh))
    assert units == 3 and r["residual_whiles"] == 0
    assert (r["flops_per_device"], r["hbm_bytes_per_device"], r["collective_bytes_per_device"]) \
        == (c["flops"], c["bytes"], c["coll"])


@pytest.mark.parametrize("shape,mesh", [(ShapeConfig("t", 16, 2, "train"), (1, 2)),
                                        (SMOKE_DECODE, (2, 4))], ids=["train", "decode"])
def test_two_point_dry_run_equals_the_full_depth(shape, mesh, monkeypatch):
    """``dryrun_config`` on a uniform stack deeper than two units (fake runs
    at one and two layers, each device's counts extrapolated) gives the
    full-depth run's counts, collectives and state bytes: granite smoke at 3
    layers, tensor-parallel (the remat train step on 1 × 2, every layer
    split; a decode step on 2 × 4, its MLPs and vocabulary split)."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=3, remat=True)
    mesh = make_meta_mesh(mesh, ("data", "model"))
    two = DR.dryrun_config(cfg, shape, mesh)
    monkeypatch.setattr(DR, "_run", DR._fake_run)
    full = DR.dryrun_config(cfg, shape, mesh)
    for k in ("flops_per_device", "hbm_bytes_per_device", "collective_bytes",
              "peak_hbm_per_device", "terms", "model_flops_global"):
        assert two[k] == full[k], k
    assert full["collective_bytes"]["all-reduce"] > 0


def test_dry_run_allocates_nothing():
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    with FakeTensorMode():
        args, _ = STEPS.input_specs(get_config("granite-3-2b"), SHAPES["decode_32k"],
                                    mesh_of("1x1"))
    t = leaves(args["params"])[0]
    assert isinstance(t, torch.Tensor) and t.device == torch.device("meta", 0)
    assert t.untyped_storage().device.type == "meta"
    assert (torch.cuda.memory_allocated() if torch.cuda.is_available() else 0) == before


# ---------------------------------------------------------------------------
# the CLIs and the report
# ---------------------------------------------------------------------------


def test_cli_json_renders_in_the_report(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    # a batch of 1 runs as one unit on the first shard: the cheapest cell of
    # the 512-device mesh to fake-run
    assert DR.main(["--arch", "rwkv6-3b", "--shape", "long_500k", "--multi-pod",
                    "--json", str(out)]) == 0
    assert "[OK] rwkv6-3b × long_500k × 2x16x16" in capsys.readouterr().out
    cells = json.loads(out.read_text())
    assert cells[0]["devices"] == 512
    table = dryrun_table(str(out)).splitlines()
    assert len(table) == 3 and table[2].startswith("| rwkv6-3b | long_500k | 2x16x16 |")

    roof = tmp_path / "roofline.json"
    assert SWEEP.main(["--out", str(roof), "--variant", "optimized",
                       "--cells", "granite-3-2b:decode_32k"]) == 0
    rows = roofline_table(str(roof), "optimized").splitlines()
    assert len(rows) == 3 and rows[2].startswith("| granite-3-2b | decode_32k |")
    (r,) = json.loads(roof.read_text())
    assert r["units"] == 40 and r["mesh"] == "16x16" and r["residual_whiles"] == 0


def test_cli_needs_a_cell():
    with pytest.raises(SystemExit):
        DR.main([])
