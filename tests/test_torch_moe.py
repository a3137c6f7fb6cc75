"""The port's MoE router and expert dispatches against the JAX package.

``repro_torch.models.moe`` is held against ``repro.models.moe`` on
numpy-seeded tokens and weights (f32): ``route`` (equal expert ids,
gates and the Switch aux loss within 1e-6), and each of the three
dispatches (``dense_grouped``, ``ragged``, ``dense``) within 1e-5 of the
largest output, including ``dense_grouped`` with drops over several
groups and with the one-group fallback, where the kept assignments are
also compared with the reference's own capacity test.  Where nothing
drops, the three dispatches agree with one another.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from test_torch_transformer import _rel, one_thread  # noqa: E402,F401

ROUTE_TOL = 1e-6
TOL = 1e-5
D, F = 32, 48


def _cfgs(**kw):
    fields = dict(d_model=D, d_ff=F, num_experts=8, num_experts_per_tok=2,
                  dtype_compute="float32", dtype_params="float32")
    fields.update(kw)
    return JConfig(**fields), TConfig(**fields)


def _params(jcfg, seed):
    """The reference's init and the port's copy of it."""
    jp = jmoe.moe_init(jax.random.key(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(t, seed):
    return np.random.default_rng(seed).standard_normal((t, D)) \
        .astype(np.float32)


def _ref_keep(jp, x, jcfg):
    """The reference's kept assignments (gs, k) per group, by its own
    one-hot slot count (moe.py:165-168), from its own routing."""
    ids, _, _ = jax.jit(jmoe.route, static_argnums=(2,))(
        jp, jnp.asarray(x), jcfg)
    t, k, e = x.shape[0], jcfg.num_experts_per_tok, jcfg.num_experts
    gs = min(jcfg.moe_group_size, t)
    gs = t if t % gs else gs
    cap = max(int(gs * k * jcfg.moe_capacity_factor / e), min(gs * k, 16))
    keeps = []
    for g in range(t // gs):
        onehot = jax.nn.one_hot(ids[g * gs:(g + 1) * gs], e,
                                dtype=jnp.float32)
        pos = jnp.cumsum(onehot.sum(1), axis=0) - onehot.sum(1)
        keeps.append(np.asarray(jnp.einsum("ske,se->sk", onehot, pos) < cap))
    return np.concatenate(keeps), cap


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 8)])
def test_route_matches_reference(e, k):
    jcfg, tcfg = _cfgs(num_experts=e, num_experts_per_tok=k)
    jp, tp = _params(jcfg, e)
    x = _x(96, k)
    jids, jgate, jaux = jax.jit(jmoe.route, static_argnums=(2,))(
        jp, jnp.asarray(x), jcfg)
    tids, tgate, taux = tmoe.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate),
                               rtol=ROUTE_TOL, atol=ROUTE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=ROUTE_TOL)
    assert tgate.dtype == torch.float32


_REF = {"dense_grouped": jmoe.moe_apply_dense_grouped,
        "ragged": jmoe.moe_apply_ragged, "dense": jmoe.moe_apply_dense}


# Groups of up to 16 tokens never drop (the capacity floor min(gs k, 16)
# holds every expert's at most gs assignments), so the forced drops take
# groups of 32 and more: 4 groups of 32 (E = 4, cap 16), 3 of 64 (E = 8,
# cap 16), and 100 tokens that groups of 32 do not divide: one group of
# 100 (cap 25).
DROPS = [(128, dict(moe_group_size=32, num_experts=4), 4),
         (192, dict(moe_group_size=64), 3),
         (100, dict(moe_group_size=32, num_experts=4), 1)]


@pytest.mark.parametrize("impl,t,extra", [
    ("ragged", 80, {}),
    ("dense", 80, {}),
    ("dense_grouped", 80, {}),                  # one group, no drop
    *[("dense_grouped", t, dict(kw, moe_capacity_factor=0.5))
      for t, kw, _ in DROPS],
    ("dense_grouped", 64, dict(mlp_activation="gelu",
                               moe_capacity_factor=0.5)),
])
def test_dispatch_matches_reference(impl, t, extra):
    jcfg, tcfg = _cfgs(moe_impl=impl, **extra)
    jp, tp = _params(jcfg, t)
    x = _x(t, t + 1)
    want, jaux = jax.jit(_REF[impl], static_argnums=(2, 3))(
        jp, jnp.asarray(x), jcfg, None)
    got, taux = tmoe.moe_apply(tp, torch.from_numpy(x)[None], tcfg)
    assert tuple(got.shape) == (1, t, D)
    assert _rel(want, got[0].numpy()) < TOL
    np.testing.assert_allclose(float(taux), float(jaux), rtol=ROUTE_TOL)
    if impl == "dense_grouped":
        keep_want, cap = _ref_keep(jp, x, jcfg)
        gs = tmoe.group_size(t, tcfg)
        assert cap == tmoe.capacity(gs, tcfg)
        ids, _, _ = tmoe.route(tp, torch.from_numpy(x), tcfg)
        _, keep = tmoe.dispatch_slots(ids.view(t // gs, gs, -1),
                                      tcfg.num_experts, cap)
        np.testing.assert_array_equal(keep.reshape(t, -1).numpy(), keep_want)


def test_dense_grouped_drops_over_several_groups():
    """The forced-drop cases of the parity test above drop assignments in
    at least two of their groups (the fallback in its one group)."""
    for t, kw, groups in DROPS:
        jcfg, tcfg = _cfgs(moe_capacity_factor=0.5, **kw)
        jp, _ = _params(jcfg, t)
        keep, _ = _ref_keep(jp, _x(t, t + 1), jcfg)
        gs = tmoe.group_size(t, tcfg)
        assert t // gs == groups
        dropped = (~keep).reshape(groups, -1).sum(axis=1)
        assert (dropped > 0).sum() >= min(groups, 2), dropped


class _Shapes(TorchDispatchMode):
    """Records the element count of every tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_dense_grouped_builds_no_one_hot_dispatch_tensor():
    """No tensor of the dispatch holds (gs, k, E, cap) elements: the
    reference's one-hot dispatch would be 64 x 2 x 8 x 20 = 20,480 here,
    the port's largest is the (E, cap, F) expert activation."""
    _, tcfg = _cfgs(d_ff=D)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, tcfg)
    x = torch.randn((1, 64, D), generator=gen)
    gs, k, e = 64, 2, 8
    cap = tmoe.capacity(gs, tcfg)
    assert cap == 20
    with _Shapes() as rec:
        tmoe.moe_apply(p, x, tcfg)
    assert rec.largest < gs * k * e * cap / 2, rec.largest


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2)])
def test_dispatches_agree_where_nothing_drops(e, k):
    """A capacity factor of E makes dense_grouped dropless (cap = gs k);
    then all three give the same output."""
    outs = {}
    x = torch.from_numpy(_x(64, 9))[None]
    for impl in ("dense_grouped", "ragged", "dense"):
        _, tcfg = _cfgs(moe_impl=impl, num_experts=e, num_experts_per_tok=k,
                        moe_capacity_factor=float(e), moe_group_size=16)
        p = tmoe.moe_init(torch.Generator().manual_seed(e), tcfg)
        outs[impl] = tmoe.moe_apply(p, x, tcfg)
    want, aux = outs["dense"]
    for impl in ("dense_grouped", "ragged"):
        got, a = outs[impl]
        assert _rel(want.numpy(), got.numpy()) < TOL, impl
        assert float(a) == float(aux)


def test_moe_init_matches_reference_layout():
    """The leaves, shapes and dtypes of the reference's ``moe_init`` (the
    router f32 whatever ``dtype_params``), stacked over layer groups."""
    jcfg, tcfg = _cfgs(dtype_params="bfloat16")
    jp = jax.eval_shape(lambda key: jmoe.moe_init(key, jcfg),
                        jax.random.key(0))
    tp = tmoe.moe_init(torch.Generator(), tcfg, groups=(3,))
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == (3,) + leaf.shape, name
        assert str(tp[name].dtype).split(".")[1] == str(leaf.dtype), name


def test_bf16_dispatch_matches_reference():
    """bf16 tokens and experts (f32 router): the two frameworks round the
    expert products at other places; the serving limit, 2e-2."""
    jcfg, tcfg = _cfgs(dtype_compute="bfloat16")
    jp, tp = _params(jcfg, 11)
    x = _x(64, 12)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = jax.jit(jmoe.moe_apply_dense_grouped, static_argnums=(2, 3))(
        jp, xb, jcfg, None)
    tpb = {k: (v if k == "router" else v.bfloat16()) for k, v in tp.items()}
    got, _ = tmoe.moe_apply(tpb, torch.from_numpy(x).bfloat16()[None], tcfg)
    assert got.dtype == torch.bfloat16
    assert _rel(np.asarray(want.astype(jnp.float32)),
                got[0].float().numpy()) < 2e-2
