"""The port's train step against the reference's, on the CPU at smoke size.

The reference's weights come from its own ``init_params(PRNGKey(0), cfg)``
and are carried into the port's per-layer layout by
``repro_torch.models.convert``; tokens, labels and frontend inputs are
numpy-seeded.  Everything runs float32 (every ``SMOKE_CONFIG`` is).  The
reference's gradients come from ``jax.value_and_grad`` of its train step's
loss (``repro.launch.steps.make_train_step``, lines 57-75, restated below
with the reference's own functions); the port's from ``torch.autograd.grad``.
Held: the loss and MoE aux to ``LOSS_RTOL``; every gradient leaf to
``GRAD_RTOL`` × max |leaf| + ``GRAD_ATOL`` (the ops round in another order;
mamba's scan is the widest, ~5e-5 of its leaf's largest entry); grad_norm and
the learning rate of a step to ``LOSS_RTOL``.  Updated parameters are not
compared across packages: at step 1 Adam moves each parameter by about
lr × sign(g), so a gradient of ~1e-8 that rounds differently moves by ±lr.

The compression takes top-k over each of the reference's stacked leaves (the
port's per-layer leaves grouped by ``stacked_leaf_groups``): fed the
reference's gradients it gives the reference's sparse gradients and
residuals bit for bit, and AdamW on them the reference's update within
``ULPS`` float32 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs import registry as RREG
from repro.launch import steps as RSTEPS
from repro.models import encdec as RED
from repro.models import transformer as RTF
from repro.models.frontends import vlm_prepend as ref_vlm_prepend
from repro.optim import adamw as RADAM
from repro.optim import compress as RCOMP

from repro_torch.configs import registry as REG
from repro_torch.launch import steps as STEPS
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.convert import comp_state_from_reference, params_from_reference
from repro_torch.optim import adamw
from repro_torch.optim import compress
from repro_torch.util.tree import leaves

ARCHS = RREG.all_archs()
KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
ULPS = 4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
B, T = 2, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_loss(cfg, aux_weight=0.01):
    """The reference train step's loss (``make_train_step.loss_fn``)."""

    def loss_fn(params, tokens, labels, extra=None):
        if cfg.is_encdec:
            enc_out = RED.encode(params, extra, cfg)
            logits, _ = RED.decode(params, tokens, enc_out, cfg)
            aux = jnp.zeros((), jnp.float32)
        else:
            inp = tokens
            if cfg.frontend == "vit" and extra is not None:
                inp = ref_vlm_prepend(params, extra, tokens, cfg)
                labels = jnp.pad(labels, ((0, 0), (extra.shape[1], 0)), constant_values=0)
            logits, _, aux = RTF.forward(params, inp, cfg)
        loss = RSTEPS.cross_entropy(logits, labels)
        return loss + aux_weight * aux, (loss, aux)

    return loss_fn


def _inputs(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (batch, T)).astype(np.int32)
    extra = None
    if cfg.is_encdec or cfg.frontend == "vit":
        extra = rng.standard_normal((batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tokens, labels, extra


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


class Reference:
    """The reference's params, inputs, loss and gradients of one smoke arch."""

    def __init__(self, arch, **overrides):
        self.rcfg = dataclasses.replace(RREG.get_smoke_config(arch), **overrides)
        self.pcfg = dataclasses.replace(REG.get_smoke_config(arch), **overrides)
        self.params = (RED if self.rcfg.is_encdec else RTF).init_params(KEY, self.rcfg)
        self.inputs = _inputs(self.rcfg)
        grad_fn = jax.jit(jax.value_and_grad(_ref_loss(self.rcfg), has_aux=True))
        (_, (loss, aux)), grads = grad_fn(self.params, *self.inputs)
        self.loss, self.aux, self.grads = float(loss), float(aux), grads

    def port_params(self):
        return params_from_reference(self.pcfg, _np_tree(self.params))

    def port_grads(self):
        return params_from_reference(self.pcfg, _np_tree(self.grads))


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch, **overrides):
        key = (arch, tuple(sorted(overrides.items())))
        if key not in cache:
            cache[key] = Reference(arch, **overrides)
        return cache[key]

    return get


def _port_grads(cfg, params, inputs):
    """(loss, aux, grads) of the port's train-step loss."""
    loss, aux, grads = STEPS.make_grad_fn(cfg)(params, *_torch(*inputs))
    return float(loss), float(aux), grads


def _assert_grads_close(ours, ref):
    for g, r in zip(leaves(ours), leaves(ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        tol = GRAD_RTOL * float(r.abs().max()) + GRAD_ATOL
        err = float((g - r).abs().max())
        assert err <= tol, (tuple(g.shape), err, tol)


# --- loss ------------------------------------------------------------------------------


@pytest.mark.parametrize("V,pad", [(512, 0), (500, 12)])
def test_cross_entropy_matches_reference(rng, V, pad):
    """Including a padded vocabulary: pad columns hold -1e30, as
    ``mask_pad_vocab`` leaves them."""
    logits = rng.standard_normal((3, 7, V + pad)).astype(np.float32) * 4
    logits[..., V:] = -1e30
    labels = rng.integers(0, V, (3, 7)).astype(np.int32)
    ref = float(RSTEPS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    ours = STEPS.cross_entropy(*_torch(logits, labels))
    assert ours.dtype == torch.float32
    assert abs(float(ours) - ref) <= LOSS_RTOL * abs(ref)
    bf = STEPS.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels))
    assert bf.dtype == torch.float32


# --- loss and gradients of the ten smoke archs -----------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_and_one_step_moves_params(reference, arch):
    ref = reference(arch)
    params = ref.port_params()
    loss, aux, grads = _port_grads(ref.pcfg, params, ref.inputs)
    assert abs(loss - ref.loss) <= LOSS_RTOL * abs(ref.loss)
    assert abs(aux - ref.aux) <= LOSS_RTOL * abs(ref.aux) + 1e-7
    _assert_grads_close(grads, ref.port_grads())

    # one full step: step 1, lr and grad_norm of the reference's gradients,
    # every parameter moved
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ropt = RADAM.AdamWConfig(**dataclasses.asdict(opt_cfg))
    before = [p.clone() for p in leaves(params)]
    new_params, opt, m = STEPS.make_train_step(ref.pcfg, opt_cfg)(
        params, adamw.init(params), *_torch(*ref.inputs))
    assert opt.step.dtype == torch.int32 and int(opt.step) == 1
    assert float(m["lr"]) == float(RADAM.lr_at(ropt, jnp.asarray(1)))
    gn = float(RADAM.global_norm(ref.grads))
    assert abs(float(m["grad_norm"]) - gn) <= LOSS_RTOL * gn
    assert abs(float(m["loss"]) - ref.loss) <= LOSS_RTOL * abs(ref.loss)
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves(new_params)))


# --- remat -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_remat_gives_the_same_gradients(monkeypatch, arch):
    """``remat=True`` checkpoints each layer (a hybrid's period, an encdec
    layer) while autograd records, and gives the gradients of ``remat=False``;
    under inference mode and no_grad nothing is checkpointed."""
    cfg = dataclasses.replace(REG.get_smoke_config(arch), remat=True)
    model = ED if cfg.is_encdec else TF
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    inputs = _inputs(cfg, seed=1)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(model, "checkpoint", counting)
    loss_r, _, g_r = _port_grads(cfg, params, inputs)
    groups = (TF.num_layers(cfg) // max(cfg.attn_period, 1) if not cfg.is_encdec
              else cfg.layers + cfg.encoder_layers)
    assert len(calls) == groups
    loss, _, g = _port_grads(dataclasses.replace(cfg, remat=False), params, inputs)
    assert len(calls) == groups
    assert loss_r == loss
    for a, b in zip(leaves(g_r), leaves(g)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

    def refuse(*a, **kw):
        raise AssertionError("checkpoint called while serving")

    monkeypatch.setattr(model, "checkpoint", refuse)
    tokens, _, extra = _torch(*inputs)
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            STEPS.make_prefill_step(cfg)(params, tokens, extra)


def test_unscanned_layers_are_not_checkpointed(monkeypatch):
    cfg = dataclasses.replace(REG.get_smoke_config("granite-3-2b"), remat=True, scan_layers=False)
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    monkeypatch.setattr(TF, "checkpoint", lambda *a, **kw: pytest.fail("checkpointed"))
    _port_grads(cfg, params, _inputs(cfg))


# --- microbatches ----------------------------------------------------------------------


def test_microbatches_match_reference_scan_path():
    """Two microbatches of two rows of an MoE arch: loss, grad_norm, lr and
    aux of the reference's scanned accumulation."""
    rcfg = RREG.get_smoke_config("llama4-scout-17b-a16e")
    pcfg = REG.get_smoke_config("llama4-scout-17b-a16e")
    rparams = RTF.init_params(KEY, rcfg)
    inputs = _inputs(rcfg, seed=2, batch=4)[:2]
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rstep = jax.jit(RSTEPS.make_train_step(
        rcfg, RADAM.AdamWConfig(**dataclasses.asdict(opt_cfg)), microbatches=2))
    _, _, rm = rstep(rparams, RADAM.init(rparams), *inputs)
    params = params_from_reference(pcfg, _np_tree(rparams))
    _, _, m = STEPS.make_train_step(pcfg, opt_cfg, microbatches=2)(
        params, adamw.init(params), *_torch(*inputs))
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        assert abs(float(m[k]) - float(rm[k])) <= LOSS_RTOL * abs(float(rm[k])), k


# --- compression -----------------------------------------------------------------------

# one arch per stacking: layers, interleaved dense/MoE stacks, hybrid periods,
# encoder and decoder stacks
STACKINGS = [("granite-3-2b", {}), ("kimi-k2-1t-a32b", {"moe_every": 2, "layers": 4}),
             ("jamba-v0.1-52b", {"layers": 16}), ("seamless-m4t-medium", {})]


@pytest.mark.parametrize("min_size", [200, 4096])
@pytest.mark.parametrize("arch,overrides", STACKINGS, ids=[a for a, _ in STACKINGS])
def test_compress_grads_on_the_reference_stacks_equals_reference(reference, arch, overrides,
                                                                 min_size):
    """The reference's own (stacked) gradients through its ``compress_grads``
    twice (error feedback), and the same gradients carried into the port's
    per-layer layout through the port's with ``stacked_leaf_groups``: the
    sparse gradients and residuals carried back are equal bit for bit, and
    so is ``compress_ratio``.  At ``min_size`` 200 a layer's norm scale (128
    entries) stays dense alone but its stack is compressed."""
    ref = reference(arch, **overrides)
    cfg = RCOMP.CompressionConfig(density=0.05, min_size=min_size)
    pcfg = compress.CompressionConfig(**dataclasses.asdict(cfg))
    rstate = RCOMP.init(ref.params)
    state = comp_state_from_reference(ref.pcfg, _np_tree(rstate))
    grads = ref.port_grads()
    groups = STEPS.stacked_leaf_groups(ref.pcfg, grads)
    assert sorted(i for g in groups for i in g) == list(range(len(leaves(grads))))
    for _ in range(2):
        rg, rstate, rm = RCOMP.compress_grads(cfg, ref.grads, rstate)
        g, state, m = compress.compress_grads(pcfg, ref.port_grads(), state, groups=groups)
        assert m["compress_ratio"] == rm["compress_ratio"]
        for a, b in zip(leaves(g) + leaves(state.residual),
                        leaves(params_from_reference(ref.pcfg, _np_tree(rg)))
                        + leaves(comp_state_from_reference(ref.pcfg, _np_tree(rstate)).residual)):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_compressed_update_matches_reference_on_identical_gradients(reference):
    """The reference's granite gradients through each package's
    ``compress_grads`` and ``adamw.apply``: the updated parameters and
    moments within ``ULPS`` float32 ulps, step, lr and grad_norm alike.
    The whole compressed step (its own gradients, which round otherwise and
    may pick other entries at the k boundary) agrees in loss and, exactly
    at the reference's float32, in ``compress_ratio``."""
    ref = reference("granite-3-2b")
    comp = RCOMP.CompressionConfig(density=0.05)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ropt = RADAM.AdamWConfig(**dataclasses.asdict(opt_cfg))
    rg, _, rm = RCOMP.compress_grads(comp, ref.grads, RCOMP.init(ref.params))
    rparams, rstate, rmet = RADAM.apply(ropt, ref.params, rg, RADAM.init(ref.params))

    params, grads = ref.port_params(), ref.port_grads()
    pcomp = compress.CompressionConfig(**dataclasses.asdict(comp))
    g, _, m = compress.compress_grads(pcomp, grads, compress.init(params),
                                      groups=STEPS.stacked_leaf_groups(ref.pcfg, grads))
    assert m["compress_ratio"] == rm["compress_ratio"]
    new_params, state, met = adamw.apply(opt_cfg, params, g, adamw.init(params))
    assert int(state.step) == int(rstate.step) == 1
    assert float(met["lr"]) == float(rmet["lr"])
    assert abs(float(met["grad_norm"]) - float(rmet["grad_norm"])) <= \
        ULPS * EPS32 * float(rmet["grad_norm"])
    for ours, theirs in ((new_params, rparams), (state.mu, rstate.mu), (state.nu, rstate.nu)):
        for a, b in zip(leaves(ours), leaves(params_from_reference(ref.pcfg, _np_tree(theirs)))):
            tol = ULPS * EPS32 * max(float(b.abs().max()), 1e-30)
            torch.testing.assert_close(a, b, rtol=ULPS * EPS32, atol=tol)

    rstep = RSTEPS.make_train_step(ref.rcfg, ropt, compression=comp)
    _, _, _, rsm = jax.jit(rstep)(ref.params, RADAM.init(ref.params), RCOMP.init(ref.params),
                                  *ref.inputs[:2])
    params = ref.port_params()
    step = STEPS.make_train_step(ref.pcfg, opt_cfg, compression=pcomp)
    _, opt, cstate, sm = step(params, adamw.init(params), compress.init(params),
                              *_torch(*ref.inputs[:2]))
    assert int(opt.step) == 1 and isinstance(cstate, compress.CompressionState)
    assert abs(float(sm["loss"]) - float(rsm["loss"])) <= LOSS_RTOL * float(rsm["loss"])
    # under jit the reference's ratio is a float32 array
    assert np.float32(sm["compress_ratio"]) == np.asarray(rsm["compress_ratio"])
