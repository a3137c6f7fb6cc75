"""The port's dense-block dispatch and reduced-precision carry.

``dispatch_plan`` and the re-pricing of a capped round against the JAX
reference, bitwise; ``dispatch_cap >= K`` equal to the masked all-K path;
the ``carry_dtype`` casts; and the driver with a binding cap and with the
bf16 carry against the reference's ``make_feel_sim`` on one key schedule
(``replay_tape``).
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from test_torch_events import _assert_same_run, _small_world  # noqa: E402
from test_torch_events import one_thread  # noqa: E402,F401
from test_torch_federated import assert_runs_agree, run_pair  # noqa: E402

QUANT8 = dict(codec="quant", bit_width=8)
FAULTS = dict(drop_prob=0.35, max_retries=2, reliability_ema=0.3)
FL = dict(num_rounds=3, batch_size=50, learning_rate=0.1)


# ---------------------------------------------------------------------------
# The plan and its accounting
# ---------------------------------------------------------------------------

def _masks():
    rng = np.random.default_rng(0)
    yield [0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0], 3
    yield [0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0], 99
    yield [0.0, 1.0, 0.0, 0.0], 3
    yield [0.0] * 6, 2
    yield [1.0] * 6, 4
    for k, cap in ((16, 5), (16, 16), (33, 8), (100, 16)):
        yield list((rng.random(k) < 0.5).astype(np.float32)), cap


@pytest.mark.parametrize("mask,cap", list(_masks()))
def test_dispatch_plan_matches_reference(mask, cap):
    """Same lanes in the same order (admitted devices first, in device
    order; ties stable), same selection after the cap, same drop count."""
    sel = np.asarray(mask, np.float32)
    j_idx, j_sel, j_drop = jfed.dispatch_plan(jnp.asarray(sel), cap)
    idx, sel_eff, n_drop = tfed.dispatch_plan(torch.from_numpy(sel), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(sel_eff.numpy(), np.asarray(j_sel))
    assert n_drop.dtype == torch.int32 and int(n_drop) == int(j_drop)
    assert int(n_drop) == max(int(sel.sum()) - cap, 0)


def test_dispatch_accounting_matches_reference():
    """A capped round's energy and round time, bitwise: dropped devices
    spend nothing and the slowest device left sets the clock."""
    rng = np.random.default_rng(1)
    k = 12
    sel = (rng.random(k) < 0.7).astype(np.float32)
    t_up = np.where(sel > 0, rng.random(k) * 0.3, np.inf).astype(np.float32)
    fields = dict(energy=(rng.random(k) * sel).astype(np.float32),
                  t_up=t_up, t_train=rng.random(k).astype(np.float32))
    _, sel_eff, _ = jfed.dispatch_plan(jnp.asarray(sel), 4)
    j_e, j_t = jfed._dispatch_accounting(
        types.SimpleNamespace(**{n: jnp.asarray(v)
                                 for n, v in fields.items()}), sel_eff)
    e, t = tfed._dispatch_accounting(
        types.SimpleNamespace(**{n: torch.from_numpy(v)
                                 for n, v in fields.items()}),
        torch.from_numpy(np.array(sel_eff)))
    np.testing.assert_array_equal(e.numpy(), np.asarray(j_e))
    assert float(t) == float(j_t)


# ---------------------------------------------------------------------------
# cap >= K is the masked path; a binding cap drops and re-prices
# ---------------------------------------------------------------------------

def _fl(variant, **kw):
    sub = {"plain": {},
           "compressed": dict(compression=tcomp.CompressionConfig(**QUANT8)),
           "faulty": dict(faults=tf.FaultConfig(**FAULTS))}[variant]
    return tfed.FLConfig(**FL, **sub, **kw)


@pytest.mark.parametrize("variant", ["plain", "compressed", "faulty"])
def test_dispatch_cap_at_least_k_is_the_masked_path(variant):
    """A device keeps its minibatches whatever its lane and the scatter
    restores device order before FedAvg, so ``cap >= K`` gives the
    masked path bit for bit."""
    kw = _small_world()
    k = kw["data"].num_devices
    p_mask, h_mask = tfed.run_federated(fcfg=_fl(variant), **kw)
    assert any(r.n_selected < k for r in h_mask)   # a real permutation
    for cap in (k, k + 3):
        p_disp, h_disp = tfed.run_federated(
            fcfg=_fl(variant, dispatch_cap=cap), **kw)
        _assert_same_run(p_mask, h_mask, p_disp, h_disp)


def test_dispatch_drops_are_priced_out():
    kw = _small_world()
    _, h_disp = tfed.run_federated(fcfg=_fl("plain", dispatch_cap=2), **kw)
    _, h_mask = tfed.run_federated(fcfg=_fl("plain"), **kw)
    assert all(r.n_selected <= 2 for r in h_disp)
    r0d, r0m = h_disp[0], h_mask[0]
    assert r0d.n_dropped > 0
    assert r0d.n_selected + r0d.n_dropped == r0m.n_selected
    assert r0d.energy_total < r0m.energy_total


def test_empty_selection_carries_the_model_under_dispatch():
    kw = _small_world()
    data, model = kw["data"], kw["model"]
    from repro_torch.models import paper_nets as tnets
    import functools
    params = tnets.params_of(model)
    cfg = tfed.FLConfig(**FL, dispatch_cap=3)
    trainer = tfed.make_local_trainer(functools.partial(tnets.loss_fn,
                                                        model), cfg)
    steps = tfed._max_local_steps(cfg, data.capacity)
    none = torch.zeros(data.num_devices)
    idx, sel_eff, n_drop = tfed.dispatch_plan(none, 3)
    out = tfed._train_round(
        trainer, steps, cfg, params, data.images, data.labels, data.mask,
        data.sizes, sel_eff, torch.zeros((data.num_devices, steps, 50),
                                         dtype=torch.long), idx)
    assert int(n_drop) == 0
    for n in params:
        assert torch.equal(out[n], params[n])


# ---------------------------------------------------------------------------
# The reduced-precision carry
# ---------------------------------------------------------------------------

def test_carry_dtype_names():
    assert tfed._carry_dtype(tfed.FLConfig()) is None
    assert tfed._carry_dtype(tfed.FLConfig(carry_dtype="float32")) is None
    assert tfed._carry_dtype(tfed.FLConfig(carry_dtype="bfloat16")) \
        is torch.bfloat16
    assert tfed._carry_dtype(tfed.FLConfig(carry_dtype="float16")) \
        is torch.float16
    with pytest.raises(ValueError) as want:
        jfed._carry_dtype(jfed.FLConfig(carry_dtype="int8"))
    with pytest.raises(ValueError) as got:
        tfed.FLConfig(carry_dtype="int8")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="dispatch_cap"):
        tfed.FLConfig(dispatch_cap=0)


def test_carry_dtype_float32_is_identity():
    kw = _small_world()
    p0, h0 = tfed.run_federated(fcfg=_fl("compressed"), **kw)
    p1, h1 = tfed.run_federated(fcfg=_fl("compressed",
                                         carry_dtype="float32"), **kw)
    _assert_same_run(p0, h0, p1, h1)


def test_carried_state_is_stored_at_reduced_precision():
    """The stream stats and the EF residual are written at the storage
    dtype and read back in f32."""
    st = tst.base_state(torch.arange(12.0).reshape(3, 4))
    diet = tfed._diet_stream_state(st, torch.bfloat16)
    assert diet.hists.dtype == diet.staleness.dtype == torch.bfloat16
    assert tfed._diet_stream_state(st, None) is st
    nxt = tfed._stream_advance(diet, torch.full((3, 4), 1.0 / 3.0),
                               torch.ones(3), torch.ones(3), torch.bfloat16)
    assert nxt.hists.dtype == torch.bfloat16 and nxt.round == 1
    assert float(nxt.hists[0, 0]) == float(torch.tensor(1.0 / 3.0).to(
        torch.bfloat16))


def test_carry_diet_bf16_stays_close_to_f32():
    """A storage rounding, not another algorithm: a compressed run with
    the bf16 carry tracks the f32 one (the reference's limits)."""
    kw = _small_world()
    p32, _ = tfed.run_federated(fcfg=_fl("compressed"), **kw)
    pbf, _ = tfed.run_federated(fcfg=_fl("compressed",
                                         carry_dtype="bfloat16"), **kw)
    for n in p32:
        np.testing.assert_allclose(pbf[n].numpy(), p32[n].numpy(),
                                   atol=5e-3, rtol=5e-2)


def test_ef_foldback_bf16_storage_property():
    """The in-round fold-back is exact in f32 (``r' = r + u`` for a
    failed upload); storing ``r'`` in bf16 costs at most half a bf16 ulp
    (2^-8 relative); an untouched device's residual survives the round
    trip bit for bit."""
    rng = np.random.default_rng(0)
    ccfg = tcomp.CompressionConfig(codec="quant", bit_width=4)
    k, p = 4, 64
    u = torch.from_numpy(rng.standard_normal((k, p)).astype(np.float32))
    r_store = torch.from_numpy(0.3 * rng.standard_normal((k, p)).astype(
        np.float32)).to(torch.bfloat16)
    r32 = r_store.to(torch.float32)
    selected = torch.tensor([1.0, 1.0, 1.0, 0.0])
    success = torch.tensor([1.0, 0.0, 1.0, 1.0])
    _, res = tcomp.apply_codec(
        tcomp.get_codec("quant"), u, r32, selected,
        torch.from_numpy(rng.random((k, p)).astype(np.float32)), ccfg,
        torch.ones(k), torch.ones(k), success=success)
    assert torch.equal(res[1], r32[1] + u[1])
    stored = res.to(torch.bfloat16).to(torch.float32)
    err = (stored[1] - res[1]).abs()
    assert bool(torch.all(err <= 2.0 ** -8 * res[1].abs().clamp_min(1e-30)))
    assert torch.equal(res[3].to(torch.bfloat16), r_store[3])


# ---------------------------------------------------------------------------
# The driver against the reference
# ---------------------------------------------------------------------------

def _pair(jsub, tsub, **kw):
    return run_pair("mlp", 8, 0, 0.1, jsub=jsub, tsub=tsub,
                    sched_extra=dict(allocator="waterfilling"), hidden=8,
                    samples_per_class=200, num_shards=36, **kw)


@pytest.mark.parametrize("variant", ["plain", "faulty"])
def test_driver_with_a_binding_cap_matches_reference(variant):
    """``dispatch_cap`` 3 of K = 8 on an MLP of 8 hidden units: equal
    selections, drops, DAS iterations and delivered counts; the Sub2
    objective to 1e-4; params to atol 1e-4 (f32 rounding of the two
    trainers)."""
    jsub, tsub = dict(dispatch_cap=3), dict(dispatch_cap=3)
    if variant == "faulty":
        jsub["faults"] = jf.FaultConfig(**FAULTS)
        tsub["faults"] = tf.FaultConfig(**FAULTS)
    jp, jm, tp, recs = _pair(jsub, tsub)
    assert sum(r.n_dropped for r in recs) > 0
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4)


def test_driver_with_bf16_carry_matches_reference():
    """Streaming data and 8-bit ``quant`` uplinks with the bf16 carry and
    a binding cap: both sides round the same f32 state to bf16 at the
    same points (round to nearest even).  Params atol 1e-4: a sound run
    reads 1.3e-5, and the same port run with an f32 carry 3.2e-4 off the
    reference's bf16 run, so the limit sees a missing cast.  (A
    stochastic rounding at its noise draw could still go the other way
    where the two trainers' updates differ in the last bits; this world
    has none.)"""
    sub = dict(dispatch_cap=3, carry_dtype="bfloat16")
    jp, jm, tp, recs = _pair(
        dict(sub, stream=jst.StreamConfig(use_kernel=True),
             compression=jcomp.CompressionConfig(**QUANT8)),
        dict(sub, stream=tst.StreamConfig(),
             compression=tcomp.CompressionConfig(**QUANT8)))
    assert sum(r.n_dropped for r in recs) > 0
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4)
