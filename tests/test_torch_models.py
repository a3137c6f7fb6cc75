"""The port's paper nets against the JAX reference, on the CPU.

The CNN and MLP of ``repro_torch.models.paper_nets`` carry the
reference's weights through ``repro_torch.convert`` and are held against
``repro.models.paper_nets`` on the same numpy-seeded batches: logits,
loss, masked-loss gradients and accuracy.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import paper_nets as jn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import paper_nets as tn  # noqa: E402

KINDS = ["cnn", "mlp"]


def _pair(kind, seed=3):
    jspec = jn.PaperNetSpec(kind=kind)
    jp = jn.init(jax.random.key(seed), jspec)
    model = convert.paper_net_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tn.PaperNetSpec(kind=kind))
    return jspec, jp, model


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, (b, 28, 28)) / 255.0).astype(np.float32)
    y = rng.integers(0, 10, (b,)).astype(np.int32)
    m = (rng.random(b) > 0.2).astype(np.float32)
    return x, y, m


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b", [1, 50])
def test_logits_match_reference(kind, b):
    """f32 convolutions and matmuls in another order: ~1e-6 of O(1)
    logits."""
    jspec, jp, model = _pair(kind)
    x, _, _ = _batch(b, b)
    want = np.asarray(jn.apply(jp, x, jspec))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradients_match_reference(kind):
    """Masked cross-entropy and its gradient (torch.func.grad vs
    jax.grad): same tolerance reasoning as the logits."""
    jspec, jp, model = _pair(kind)
    x, y, m = _batch(50, 7)
    jl, jg = jax.value_and_grad(jn.loss_fn)(jp, x, y, m, jspec)
    params = tn.params_of(model)
    loss = functools.partial(tn.loss_fn, model)
    tg = torch.func.grad(loss)(params, torch.from_numpy(x),
                               torch.from_numpy(y), torch.from_numpy(m))
    assert float(loss(params, torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(m))) == pytest.approx(float(jl),
                                                             rel=1e-5)
    got = convert.paper_net_to_numpy(tg)
    for layer, leaves in jg.items():
        for name, want in leaves.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(want),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_vmapped_gradients_equal_per_client_gradients(kind):
    """The trainer's vmap(grad) over stacked client params equals one
    grad per client (same arithmetic, batched)."""
    _, _, model = _pair(kind)
    k = 3
    params = {n: torch.stack([t + 0.01 * i for i in range(k)])
              for n, t in tn.params_of(model).items()}
    xs, ys, ms = zip(*(_batch(8, 20 + i) for i in range(k)))
    x, y, m = (torch.from_numpy(np.stack(a)) for a in (xs, ys, ms))
    grad = torch.func.grad(functools.partial(tn.loss_fn, model))
    batched = torch.func.vmap(grad)(params, x, y, m)
    for i in range(k):
        single = grad({n: t[i] for n, t in params.items()}, x[i], y[i], m[i])
        for n in single:
            torch.testing.assert_close(batched[n][i], single[n], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_accuracy_matches_reference(kind):
    jspec, jp, model = _pair(kind, seed=9)
    x, y, _ = _batch(200, 4)
    assert float(tn.accuracy(model, tn.params_of(model), torch.from_numpy(x),
                             torch.from_numpy(y))) == \
        pytest.approx(float(jn.accuracy(jp, x, y, jspec)), abs=1e-7)


@pytest.mark.parametrize("kind,count", [("cnn", 21840), ("mlp", 159010)])
def test_param_counts_and_round_trip(kind, count):
    _, jp, model = _pair(kind)
    params = tn.params_of(model)
    assert tn.num_params(params) == jn.num_params(jp) == count
    back = convert.paper_net_to_numpy(params)
    for layer, leaves in jp.items():
        for name, want in leaves.items():
            np.testing.assert_array_equal(back[layer][name],
                                          np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_init_is_he_normal_with_zero_biases(kind):
    spec = tn.PaperNetSpec(kind=kind)
    model = tn.init(spec, torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p))
        else:
            want = (2.0 / p[0].numel()) ** 0.5
            assert float(p.detach().std()) == pytest.approx(want, rel=0.2)
    assert set(tn.params_of(model)) == set(
        f"{layer}.{leaf}" for layer in
        (("conv1", "conv2", "fc1", "fc2") if spec.kind == "cnn"
         else ("fc1", "fc2")) for leaf in ("weight", "bias"))


def test_masked_loss_ignores_padded_samples():
    _, _, model = _pair("mlp")
    params = tn.params_of(model)
    x, y, m = (torch.from_numpy(a) for a in _batch(10, 1))
    m = torch.zeros(10)
    m[:4] = 1.0
    full = tn.loss_fn(model, params, x, y, m)
    head = tn.loss_fn(model, params, x[:4], y[:4], torch.ones(4))
    torch.testing.assert_close(full, head)
    assert float(tn.loss_fn(model, params, x, y, torch.zeros(10))) == 0.0
