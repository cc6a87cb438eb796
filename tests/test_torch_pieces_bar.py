"""The bf16 bar of the tensor- and expert-parallel pieces
(``chip_smoke.pieces_rms_bar``, phase 23(d), (f) and (g) on the card), held
on the CPU as a plain function of tensors: the per-position RMS over the
vocabulary of the pieces' distance from the f32 logits, rank by rank, at
most ``LM_PIECES_RMS`` times one device's.

Two independent bf16 roundings of the same f32 logits (stochastic, so each
lands on either neighbour) pass it; the three faults that phase 23 plants on
the card (``chip_smoke.planted_faults``), each confined to one position, one
vocabulary shard's block or one head, injected into a copy of one of them,
fail it.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
B, T, V = 2, 12, 8192
MODEL_SHARDS = 4                    # phase 23's model axis: four vocabulary blocks
HEADS, LAYERS = 32, 40              # granite-3-2b, phase 23(f)


def _stochastic_bf16(x: torch.Tensor, seed: int) -> torch.Tensor:
    """``x`` (float32) rounded to one of its two bf16 neighbours, the far one
    with probability its share of the distance: an unbiased rounding whose
    error is independent between seeds."""
    bits = x.view(torch.int32)
    lo = (bits & ~0xFFFF).view(torch.float32)
    hi = ((bits & ~0xFFFF) + 0x10000).view(torch.float32)
    p = (x - lo) / (hi - lo)
    u = torch.from_numpy(np.random.default_rng(seed).random(x.shape, dtype=np.float32))
    return torch.where(u < p, hi, lo).to(torch.bfloat16).float()


@pytest.fixture(scope="module")
def logits():
    f32 = torch.from_numpy(3 * np.random.default_rng(0).standard_normal((B, T, V),
                                                                         dtype=np.float32))
    return f32, _stochastic_bf16(f32, 1), _stochastic_bf16(f32, 2)


def test_two_bf16_roundings_pass(logits):
    f32, one, pieces = logits
    assert not torch.equal(one, pieces)
    ratio = CS.pieces_rms_bar(pieces, one, f32)
    assert ratio.shape == (B * T,)
    assert float(ratio.max()) < CS.LM_PIECES_RMS
    assert torch.equal(ratio, CS.pieces_rms_ratio(pieces, one, f32))
    # the ranks, not the positions, are matched: one device's run with its
    # noise at other positions reads the same
    moved = f32 + (one - f32).roll(3, dims=1)
    torch.testing.assert_close(CS.pieces_rms_ratio(pieces, moved, f32), ratio)


@pytest.mark.parametrize("fault", ["position_from_another", "shard_block_scaled", "head_dropped"])
def test_injected_faults_fail(logits, fault):
    f32, one, pieces = logits
    bad = CS.planted_faults(pieces, f32, MODEL_SHARDS, LAYERS, HEADS)[fault]
    with pytest.raises(AssertionError, match="bf16 logits on pieces"):
        CS.pieces_rms_bar(bad, one, f32)
    # no more ranks move past the bar than the fault touches positions
    moved = int((CS.pieces_rms_ratio(bad, one, f32) > CS.LM_PIECES_RMS).sum())
    assert 1 <= moved <= int((bad != pieces).any(-1).sum())
