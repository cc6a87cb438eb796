"""The three examples' ports (``repro_torch.launch.quickstart``,
``serve_lm``, ``train_lm``) on the CPU at small sizes.

``quickstart`` is held to the reference's ``prepare`` on the same matrix
and tuning: the port tunes with its ``"h100"`` model, which the reference
does not know, so the reference is given the same params; the tuned
SSRS/SRS, the pointer overhead and the tile view it prints are the
reference's, and max |CSR-k − CSR| is within 1e-4.
``serve_lm`` and ``train_lm`` run end to end; each example raises where
CUDA is asked for (their default) and absent.
"""
import dataclasses
import re

import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs.spmv_suite import grid_laplacian_2d as ref_grid
from repro.core.spmv import prepare as ref_prepare
from repro.core.tuner import TuningParams as RefTuningParams

from repro_torch.core import tuner
from repro_torch.launch import quickstart, serve_lm, train_lm

GRID = 16


def test_quickstart_prints_the_references_quantities(capsys):
    assert quickstart.main(["--grid", str(GRID), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    A = ref_grid(GRID, GRID)
    params = RefTuningParams(**dataclasses.asdict(tuner.tune(A.rdensity, "h100")))
    op = ref_prepare(A, device="ampere", format="csrk", reorder="bandk", params=params)
    assert f"tuned: SSRS={op.params.ssrs} SRS={op.params.srs} " in out
    assert f"pointer-array overhead: {100 * op.overhead_fraction():.3f}%" in out
    assert (f"tile view: {op.tiles.num_tiles} tiles × {op.tiles.slots} nnz slots, "
            f"x-window {op.tiles.window} cols, padding {100 * op.padding_overhead():.1f}%") in out
    err = float(re.search(r"max \|CSR-k − CSR\| = (\S+)", out).group(1))
    assert err < 1e-4 and out.rstrip().endswith("tuned kernel.")


def test_serve_lm_generates(capsys):
    assert serve_lm.main(["--batch", "2", "--prompt-len", "16", "--gen", "6",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2×16:" in out and "decode 5 steps:" in out
    toks = eval(out.split("first request's continuation:")[1].strip())
    assert len(toks) == 6 and all(0 <= t < 4096 for t in toks)


def test_train_lm_trains(capsys):
    assert train_lm.main(["--steps", "12", "--batch", "4", "--seq", "32", "--layers", "2",
                          "--d-model", "96", "--vocab", "512", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"loss: (\S+) → (\S+) on cpu", out).groups())
    assert "model: 2L d=96" in out and 0 < last < first


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
@pytest.mark.parametrize("mod", [quickstart, serve_lm, train_lm])
def test_examples_default_to_the_card(mod):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
