"""The port's optimizer, train steps and training driver against the JAX
package.

``repro_torch.optim`` is held against ``repro.optim`` over five steps of
one gradient stream, for every optimizer form.  The step builders of
``repro_torch.launch.steps`` are held against ``repro.launch.steps`` on
xlstm-125m at ``reduced(num_layers=2)`` from the reference's own train
state (``convert.train_state_from_numpy``): the plain step with one and
two microbatches, and the federated step on the reference test's case
(K = 3, clients 0 and 2 selected, sizes 100 / 999 / 300; all clients in
one pass, and in passes of 1 and 2) and over three steps fed the
reference driver's DAS selections and batches.  f32 within
1e-4 (the frameworks sum in another order; about 1e-7 is read), bf16
compute within 5e-3 (the reference test's limit).  The driver
``repro_torch.launch.train`` runs its CLI on the CPU and must learn the
bigram stream (``test_torch_train_cli.py``); its checkpoints are read by
the reference's reader.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import msgpack_ckpt as jckpt  # noqa: E402
from repro.core import diversity as jdiv  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as tckpt  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_transformer import _port_cfg, one_thread  # noqa: E402,F401

TOL = 1e-4
BF16_TOL = 5e-3
# Microbatched against one batch: the reference's own limit
# (tests/test_system.py::test_microbatched_train_step_matches_mb1).
MB_TOL = 2e-3
# The optimizer on identical gradients: the same f32 operations in the
# same order, so only rounding of the last bit of a moment or parameter.
OPT_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _by_path(tree):
    """Leaves of a nested dict by their '/'-joined path."""
    out = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}/{k}" if path else k, v)
        else:
            out[path] = node

    walk("", tree)
    return out


def _max_err(want, got) -> float:
    """The largest absolute difference over every leaf, by path."""
    w, g = _by_path(want), _by_path(got)
    assert set(w) == set(g)
    return max(float(np.abs(np.asarray(w[k], np.float32)
                            - g[k].float().numpy()).max()) for k in w)


def _batch_to_torch(batch):
    out = {k: _t(v) for k, v in batch.items()}
    for k in ("inputs", "labels"):
        if k in out:
            out[k] = out[k].long()
    return out


def _configs(dtype="float32"):
    jcfg = dataclasses.replace(
        jconfigs.get("xlstm_125m").reduced(num_layers=2),
        dtype_compute=dtype)
    return jcfg, _port_cfg(jcfg)


def _opt_pair(**kw):
    jo = joptim.OptimizerConfig(**kw)
    return jo, toptim.OptimizerConfig(**dataclasses.asdict(jo))


def _state_pair(jcfg, tcfg, jo, seed=0):
    state = jsteps.init_train_state(jax.random.key(seed), jcfg, jo)
    return state, convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), tcfg)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

OPT_CASES = {
    "sgd": dict(name="sgd", momentum=0.0, learning_rate=0.1,
                warmup_steps=0, grad_clip=0.0),
    "sgd_momentum": dict(name="sgd", momentum=0.9, learning_rate=0.1,
                         warmup_steps=3, grad_clip=1.0),
    "adamw": dict(name="adamw", learning_rate=0.01, warmup_steps=0,
                  grad_clip=0.0),
    "adamw_clip_warmup": dict(name="adamw", learning_rate=0.01,
                              warmup_steps=3, grad_clip=1.0),
    "adamw_bf16": dict(name="adamw", learning_rate=0.01, warmup_steps=2,
                       state_dtype="bfloat16", grad_clip=1.0),
    "adamw_cosine": dict(name="adamw", learning_rate=0.01, warmup_steps=2,
                         schedule="cosine", total_steps=6, grad_clip=0.5),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_apply_updates_matches_reference(case):
    """Five steps on one stream of gradients (norms around 3, so the
    clip binds): parameters, moments, count and the metrics."""
    jo, to = _opt_pair(**OPT_CASES[case])
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = joptim.init_state(jp, jo)
    tp = tree_map(_t, params)
    ts = toptim.init_state(tp, to)
    for _ in range(5):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
        jp, js, jm = joptim.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jo)
        tp, ts, tm = toptim.apply_updates(tp, tree_map(_t, g), ts, to)
        assert _max_err(jp, tp) <= OPT_TOL
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_TOL)
    assert int(ts["count"]) == int(js["count"]) == 5
    assert ts["count"].dtype == torch.int32
    for key in ("mu", "nu"):
        if key in js:
            want = jax.tree_util.tree_leaves(js[key])[0].dtype.name
            assert {t.dtype for t in tree_leaves(ts[key])} == {
                getattr(torch, want)}
            assert _max_err(js[key], ts[key]) <= OPT_TOL


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_converges_on_quadratic(name):
    """The reference's convergence case (tests/test_substrates.py)."""
    cfg = toptim.OptimizerConfig(name=name, learning_rate=0.1,
                                 weight_decay=0.0, warmup_steps=0,
                                 grad_clip=0.0)
    params = {"a": torch.tensor([2.0, -3.0]), "b": {"c": torch.tensor([1.5])}}
    state = toptim.init_state(params, cfg)
    for _ in range(200):
        grads = tree_map(lambda p: 2.0 * p, params)
        params, state, _ = toptim.apply_updates(params, grads, state, cfg)
    loss = sum(float(torch.sum(p ** 2)) for p in tree_leaves(params))
    assert loss < 1e-2


def test_grad_clip_scales_by_global_norm():
    cfg = toptim.OptimizerConfig(name="sgd", learning_rate=1.0,
                                 momentum=0.0, grad_clip=1.0, warmup_steps=0)
    p = {"w": torch.zeros(3)}
    state = toptim.init_state(p, cfg)
    new_p, _, m = toptim.apply_updates(
        p, {"w": torch.tensor([30.0, 40.0, 0.0])}, state, cfg)
    torch.testing.assert_close(new_p["w"], torch.tensor([-0.6, -0.8, 0.0]))
    assert float(m["grad_norm"]) == pytest.approx(50.0, rel=1e-6)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_chunked_xent_matches_plain(remat):
    """Chunked (8 chunks) = plain cross-entropy, and the reference's
    chunked value; with ``remat`` the gradients are the plain ones."""
    cfg = tconfigs.get("xlstm_125m").reduced(num_layers=2)
    rng = np.random.default_rng(1)
    hidden = _t(rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    head = _t(rng.standard_normal((cfg.d_model, cfg.vocab_size))
              .astype(np.float32) * 0.05)
    labels = _t(rng.integers(0, cfg.vocab_size, (2, 64))).long()
    h1, w1 = hidden.clone().requires_grad_(), head.clone().requires_grad_()
    chunked = tsteps.chunked_xent(h1, w1, labels, cfg, remat=remat)
    h2, w2 = hidden.clone().requires_grad_(), head.clone().requires_grad_()
    plain = tsteps.cross_entropy(h2 @ w2, labels)
    torch.testing.assert_close(chunked, plain, rtol=1e-5, atol=0)
    want = jsteps.chunked_xent(jnp.asarray(hidden.numpy()),
                               jnp.asarray(head.numpy()),
                               jnp.asarray(labels.numpy()), cfg, None)
    np.testing.assert_allclose(float(chunked.detach()), float(want),
                               rtol=1e-5)
    ga = torch.autograd.grad(chunked, (h1, w1))
    gb = torch.autograd.grad(plain, (h2, w2))
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


def test_cross_entropy_mask():
    rng = np.random.default_rng(2)
    logits = _t(rng.standard_normal((2, 5, 7)).astype(np.float32))
    labels = _t(rng.integers(0, 7, (2, 5))).long()
    mask = torch.tensor([[1.0, 1.0, 0.0, 1.0, 0.0], [0.0] * 5])
    want = jsteps.cross_entropy(jnp.asarray(logits.numpy()),
                                jnp.asarray(labels.numpy()),
                                jnp.asarray(mask.numpy()))
    got = tsteps.cross_entropy(logits, labels, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def test_train_step_microbatches_match_reference():
    """One SGD step at mb 1 and mb 2 (the reference test's case): the
    port's mb 1 against the reference's, and its mb 2 against its mb 1
    (and within f32 rounding of the reference's mb 1)."""
    jcfg, tcfg = _configs()
    jo, to = _opt_pair(name="sgd", momentum=0.0, learning_rate=0.05,
                       grad_clip=0.0, warmup_steps=0)
    key = jax.random.key(3)
    jstate, tstate = _state_pair(jcfg, tcfg, jo, seed=3)
    batch = {"inputs": jax.random.randint(key, (4, 16), 0, jcfg.vocab_size),
             "labels": jax.random.randint(key, (4, 16), 0, jcfg.vocab_size)}
    tb = _batch_to_torch(batch)
    js1, jm = jax.jit(jsteps.make_train_step(jcfg, jo, None, 1))(
        jstate, batch)
    got = {}
    for mb in (1, 2):
        got[mb], tm = tsteps.make_train_step(tcfg, to, mb)(tstate, tb)
        assert _max_err(js1["params"], got[mb]["params"]) <= TOL
        for k in ("ce", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=TOL)
    assert _max_err(tree_map(lambda t: t.numpy(), got[1]["params"]),
                    got[2]["params"]) <= MB_TOL


@pytest.fixture(scope="module")
def federated_case():
    """The reference test's federated case and its result, per compute
    dtype."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jcfg, tcfg = _configs(dtype)
            jo, to = _opt_pair(name="sgd", momentum=0.0, learning_rate=0.1,
                               grad_clip=0.0, warmup_steps=0)
            key = jax.random.key(0)
            jstate, tstate = _state_pair(jcfg, tcfg, jo)
            batch = {
                "inputs": jax.random.randint(key, (3, 2, 16), 0,
                                             jcfg.vocab_size),
                "labels": jax.random.randint(key, (3, 2, 16), 0,
                                             jcfg.vocab_size),
                "selected": jnp.asarray([1.0, 0.0, 1.0]),
                "sizes": jnp.asarray([100.0, 999.0, 300.0]),
            }
            # Compiled without XLA's excess precision, which skips bf16
            # roundings inside fusions: so compiled, the step rounds
            # where its eager form (the reference test's call) and the
            # port do.  With it the compiled bf16 step lands 3.5e-3 from
            # the eager one, and the port 5.4e-3 from it (3.4e-3 from
            # the eager form).
            step = jax.jit(jsteps.make_federated_train_step(
                jcfg, jo, None, num_clients=3)).lower(jstate, batch).compile(
                compiler_options={"xla_allow_excess_precision": False})
            cache[dtype] = (jcfg, tcfg, jo, to, jstate, tstate, batch,
                            step(jstate, batch))
        return cache[dtype]
    return get


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_federated_step_matches_reference(federated_case, dtype, tol):
    """The FedAvg-weighted step against the reference's step: parameters,
    ce and n_selected."""
    jcfg, tcfg, jo, to, jstate, tstate, batch, (jnew, jm) = \
        federated_case(dtype)
    step = tsteps.make_federated_train_step(tcfg, to, num_clients=3)
    tnew, tm = step(tstate, _batch_to_torch(batch))
    assert _max_err(jnew["params"], tnew["params"]) <= tol
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                               rtol=tol)
    assert float(tm["n_selected"]) == float(jm["n_selected"]) == 2.0


def test_federated_step_is_weighted_client_grads(federated_case,
                                                 monkeypatch):
    """The step equals one SGD step on the manually weighted per-client
    gradients (w = [0.25, 0, 0.75]), and its one reduction goes through
    the ``fedavg_agg`` wrapper on the (K, P) matrix of flattened
    gradients (its plain version on the CPU)."""
    _, tcfg, _, to, _, tstate, batch, _ = federated_case("float32")
    tb = _batch_to_torch(batch)
    calls = []
    real = tsteps.fedavg_agg

    def spy(u, w):
        calls.append((tuple(u.shape), u.dtype, w.clone()))
        return real(u, w)

    monkeypatch.setattr(tsteps, "fedavg_agg", spy)
    step = tsteps.make_federated_train_step(tcfg, to, num_clients=3)
    tnew, _ = step(tstate, tb)
    n_params = sum(t.numel() for t in tree_leaves(tstate["params"]))
    assert len(calls) == 1
    assert calls[0][:2] == ((3, n_params), torch.float32)
    torch.testing.assert_close(calls[0][2], torch.tensor([0.25, 0.0, 0.75]))
    w = [0.25, 0.0, 0.75]
    grads = [tsteps._grads(tstate["params"], {"inputs": tb["inputs"][i],
                                              "labels": tb["labels"][i]},
                           tcfg)[1] for i in range(3)]
    want = tree_map(lambda p, *g: p - 0.1 * sum(wi * gi
                                                for wi, gi in zip(w, g)),
                    tstate["params"], *grads)
    assert _max_err(tree_map(lambda t: t.numpy(), want),
                    tnew["params"]) <= TOL
    step(tnew, tb)
    assert len(calls) == 2


@pytest.mark.parametrize("per_pass", [1, 2])
def test_federated_step_in_passes_matches_reference(federated_case,
                                                    per_pass, monkeypatch):
    """Clients in passes of 1 and of 2 (2 + 1 for K = 3): the reference's
    step, and one ``fedavg_agg`` reduction of the whole (K, P) matrix."""
    jcfg, tcfg, jo, to, jstate, tstate, batch, (jnew, jm) = \
        federated_case("float32")
    shapes = []
    real = tsteps.fedavg_agg

    def spy(u, w):
        shapes.append(tuple(u.shape))
        return real(u, w)

    monkeypatch.setattr(tsteps, "fedavg_agg", spy)
    step = tsteps.make_federated_train_step(tcfg, to, num_clients=3,
                                            clients_per_pass=per_pass)
    tnew, tm = step(tstate, _batch_to_torch(batch))
    n_params = sum(t.numel() for t in tree_leaves(tstate["params"]))
    assert shapes == [(3, n_params)]
    assert _max_err(jnew["params"], tnew["params"]) <= TOL
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=TOL)
    assert float(tm["n_selected"]) == 2.0


@pytest.mark.parametrize("k,tokens,want", [
    (8, 4096, 4),        # the trainer's card traffic: 64 x 512 over 8
    (8, 128, 8),         # the CLI's default batch: one pass
    (7, 4096, 4),        # 4 + 3, not 4 passes of 2 or fewer
    (5, 8192, 2),        # 2 + 2 + 1
    (3, 10 ** 6, 1),     # a client past the budget runs alone
])
def test_pass_size(k, tokens, want):
    assert tsteps.pass_size(k, tokens) == want


def test_cli_clients_per_pass_reaches_the_step(monkeypatch):
    """``--clients-per-pass`` (0: ``pass_size``'s choice) is the step's."""
    seen = []
    real = tsteps.make_federated_train_step

    def spy(*args, **kw):
        seen.append(kw["clients_per_pass"])
        return real(*args, **kw)

    monkeypatch.setattr(tsteps, "make_federated_train_step", spy)
    for flag, want in ((["--clients-per-pass", "2"], 2), ([], None)):
        run = ttrain.setup(ttrain.parse_args(
            ["--device", "cpu", "--reduced", "--federated", "4"] + flag))
        assert seen[-1] == want
        assert run.clients.num_clients == 4 and run.dev.type == "cpu"


def _driver_steps(name: str, steps: int = 3):
    """``steps`` steps of the reference driver's loop (``train.py``: its
    synthetic batches, diversity index, fading and DAS schedule), its
    selections and batches fed to the reference's and the port's
    federated steps from one state; yields both states and metrics after
    each step.  ``name`` is the optimizer (lr 3e-3, warmup 10, clip 1)."""
    jcfg, tcfg = _configs()
    k = 4
    jo, to = _opt_pair(name=name, learning_rate=3e-3, warmup_steps=10)
    jstate, tstate = _state_pair(jcfg, tcfg, jo)
    jstep = jax.jit(jsteps.make_federated_train_step(jcfg, jo, None, k))
    tstep = tsteps.make_federated_train_step(tcfg, to, k)
    wcfg = jw.WirelessConfig()
    net = jw.sample_network(jax.random.key(1), k, wcfg)
    sizes = jax.random.randint(jax.random.key(2), (k,), 50, 1500)
    ages = jnp.zeros((k,), jnp.int32)
    hists = jax.random.randint(jax.random.key(3), (k, 10), 0, 30) \
        .astype(jnp.float32)
    scfg = jsch.SchedulerConfig(method="das", n_min=2, iterations_max=4)
    key = jax.random.key(0)
    for _ in range(steps):
        key, kb, kf, ks = jax.random.split(key, 4)
        batch = jtrain.synthetic_lm_batch(kb, 8, 32, jcfg.vocab_size, k)
        idx = jdiv.diversity_index(label_hists=hists, data_sizes=sizes,
                                   ages=ages)
        res = jsch.schedule(ks, idx, ages, sizes, jw.sample_fading(kf, net),
                            net, wcfg, scfg)
        ages = jnp.where(res.selected > 0, 0, ages + 1)
        batch = dict(batch, selected=res.selected,
                     sizes=sizes.astype(jnp.float32))
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _batch_to_torch(batch))
        yield jstate, jm, tstate, tm


def test_federated_steps_follow_reference_driver():
    """Three steps of the reference driver's loop with its selections
    and batches, SGD with momentum.  (AdamW steps on identical data part
    by up to twice the learning rate where a gradient near 0 changes
    sign between the two sums; ``python tests/test_torch_train.py``
    prints both.)"""
    for jstate, jm, tstate, tm in _driver_steps("sgd"):
        assert _max_err(jstate["params"], tstate["params"]) <= TOL
        assert _max_err(jstate["opt"]["mu"], tstate["opt"]["mu"]) <= TOL
        np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                                   rtol=TOL)
        assert float(tm["n_selected"]) == float(jm["n_selected"])


def test_resumes_reference_train_state_mid_run():
    """The reference's AdamW state with bf16 moments after one federated
    step, converted, takes the next step as the reference does."""
    jcfg, tcfg = _configs()
    jo, to = _opt_pair(name="adamw", learning_rate=1e-3, warmup_steps=0,
                       state_dtype="bfloat16")
    jstate, _ = _state_pair(jcfg, tcfg, jo, seed=4)
    key = jax.random.key(4)
    batch = {"inputs": jax.random.randint(key, (2, 2, 16), 0,
                                          jcfg.vocab_size),
             "labels": jax.random.randint(jax.random.key(5), (2, 2, 16), 0,
                                          jcfg.vocab_size),
             "selected": jnp.asarray([1.0, 1.0]),
             "sizes": jnp.asarray([10.0, 30.0])}
    jstep = jax.jit(jsteps.make_federated_train_step(jcfg, jo, None, 2))
    mid, _ = jstep(jstate, batch)
    tmid = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, mid), tcfg)
    assert {t.dtype for t in tree_leaves(tmid["opt"]["mu"])} == {
        torch.bfloat16}
    assert int(tmid["opt"]["count"]) == 1
    jend, _ = jstep(mid, batch)
    tend, _ = tsteps.make_federated_train_step(tcfg, to, 2)(
        tmid, _batch_to_torch(batch))
    assert _max_err(jend["params"], tend["params"]) <= TOL
    assert int(tend["opt"]["count"]) == 2


@pytest.mark.parametrize("make", ["plain", "federated"])
def test_attention_configs_raise(make):
    cfg = tconfigs.get("codeqwen1_5_7b").reduced()
    ocfg = toptim.OptimizerConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP item 17j"):
        if make == "plain":
            tsteps.make_train_step(cfg, ocfg)
        else:
            tsteps.make_federated_train_step(cfg, ocfg, num_clients=2)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _bigram_share(inputs, labels, vocab) -> float:
    inp, lab = (np.asarray(a).reshape(-1, a.shape[-1])
                for a in (inputs, labels))
    assert (inp[:, 1:] == lab[:, :-1]).all()
    return float(np.mean(lab == (inp * 7 + 3) % vocab))


def test_synthetic_lm_batch_bigram_rule():
    """The reference's stream: the rule continues a position from the
    uniform draw before it, so a label follows its input where the rule
    was used and the input was not itself a continuation (about 1/4),
    as in the reference's batches."""
    gen = torch.Generator().manual_seed(0)
    b = ttrain.synthetic_lm_batch(gen, 64, 128, 512, num_clients=4)
    assert b["inputs"].shape == b["labels"].shape == (4, 16, 128)
    assert b["inputs"].dtype == torch.int64
    j = jtrain.synthetic_lm_batch(jax.random.key(0), 64, 128, 512)
    want = _bigram_share(j["inputs"], j["labels"], 512)
    got = _bigram_share(b["inputs"].numpy(), b["labels"].numpy(), 512)
    assert 0.2 < want < 0.3 and abs(got - want) < 0.02


def test_clients_admit_updates_ages():
    """DAS with at least n_min = 2 admitted; the ages of the admitted
    reset and the others grow."""
    gen = torch.Generator().manual_seed(1)
    clients = ttrain.Clients.sample(gen, 6)
    ages0 = torch.tensor([3, 0, 1, 2, 0, 5], dtype=torch.int32)
    clients.ages = ages0.clone()
    out = clients.admit(gen, {"inputs": torch.zeros(1)})
    sel = out["selected"]
    assert sel.shape == (6,) and int(sel.sum()) >= 2
    assert out["sizes"].dtype == torch.float32
    torch.testing.assert_close(
        clients.ages, torch.where(sel > 0, 0, ages0 + 1).to(torch.int32))


def test_checkpoint_loads_in_reference(tmp_path):
    """A port checkpoint of the model's parameters (f32 and bf16 leaves)
    read by the reference's ``load_flat``: the same paths and values."""
    cfg = tconfigs.get("xlstm_125m").reduced(num_layers=2)
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    params["lm_head"] = params["lm_head"].to(torch.bfloat16)
    path = str(tmp_path / "p.msgpack")
    tckpt.save(path, params, meta={"step": 3, "arch": cfg.name})
    flat, meta = jckpt.load_flat(path)
    assert meta == {"step": 3, "arch": cfg.name}
    want = _by_path(params)
    assert set(flat) == set(want)
    for k, t in want.items():
        a = flat[k]
        assert a.shape == tuple(t.shape)
        assert a.dtype.name == str(t.dtype).split(".")[1]
        np.testing.assert_array_equal(a.astype(np.float32),
                                      t.float().numpy())


def _grad_precision(vocab: int) -> str:
    """How far this model's bf16 gradients part from its f32 ones, in the
    reference and in the port (xlstm-125m at ``reduced(num_layers=2)``,
    d_model 256, ``vocab``; one batch of 8 x 128), and the port's bf16
    gradient of the batch against the mean of its two halves'."""
    base = jconfigs.get("xlstm_125m").reduced(num_layers=2,
                                              vocab_size=vocab)
    params = jsteps.transformer.init(jax.random.key(0), base)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, vocab, (8, 128)) for k in ("inputs",
                                                            "labels")}
    got = {}
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(base, dtype_compute=dt)
        tcfg = _port_cfg(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        got["ref", dt] = jax.tree_util.tree_leaves(jax.grad(
            lambda p: jsteps.loss_fn(p, jb, jcfg, None)[0])(params))
        tp = convert.transformer_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg)
        halves = [tree_leaves(tsteps._grads(tp, {
            k: torch.from_numpy(v[sl]) for k, v in batch.items()}, tcfg)[1])
            for sl in (slice(None), slice(0, 4), slice(4, 8))]
        got["port", dt] = halves[0]
        got["port mb 2", dt] = [(a + b) / 2 for a, b in zip(*halves[1:])]

    def rel(a, b):
        a, b = (np.concatenate([np.asarray(x, np.float32).ravel()
                                for x in t]) for t in (a, b))
        return np.linalg.norm(a - b) / np.linalg.norm(a)

    f, h = "float32", "bfloat16"
    return (f"V={vocab}: bf16 vs f32 reference "
            f"{rel(got['ref', f], got['ref', h]):.3g}, port "
            f"{rel(got['port', f], got['port', h]):.3g}; port vs "
            f"reference f32 {rel(got['ref', f], got['port', f]):.3g}, "
            f"bf16 {rel(got['ref', h], got['port', h]):.3g}; port bf16 "
            f"mb 1 vs 2 {rel(got['port', h], got['port mb 2', h]):.3g}")


def main() -> None:
    """Print the readings the step tests hold: the federated step against
    the reference's step compiled without excess precision (the tests'
    form), compiled by default and run eagerly; the three-step driver
    parity with SGD (the test's) and with AdamW; and how far bf16
    gradients part from f32 ones (why ``chip_smoke.py`` holds the
    microbatches' gradients in f32)."""
    torch.set_num_threads(1)
    for vocab in (512, 50304):
        print("gradients, " + _grad_precision(vocab))
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _configs(dtype)
        jo, to = _opt_pair(name="sgd", momentum=0.0, learning_rate=0.1,
                           grad_clip=0.0, warmup_steps=0)
        key = jax.random.key(0)
        jstate, tstate = _state_pair(jcfg, tcfg, jo)
        batch = {"inputs": jax.random.randint(key, (3, 2, 16), 0,
                                              jcfg.vocab_size),
                 "labels": jax.random.randint(key, (3, 2, 16), 0,
                                              jcfg.vocab_size),
                 "selected": jnp.asarray([1.0, 0.0, 1.0]),
                 "sizes": jnp.asarray([100.0, 999.0, 300.0])}
        f = jsteps.make_federated_train_step(jcfg, jo, None, num_clients=3)
        forms = {
            "no excess precision": jax.jit(f).lower(jstate, batch).compile(
                compiler_options={"xla_allow_excess_precision": False}),
            "jit": jax.jit(f), "eager": f}
        want = {k: g(jstate, batch)[0]["params"] for k, g in forms.items()}
        got, _ = tsteps.make_federated_train_step(tcfg, to, 3)(
            tstate, _batch_to_torch(batch))
        eager = tree_map(_t, want["eager"])
        print(f"federated step {dtype}: port vs reference " + ", ".join(
            f"{k} {_max_err(w, got['params']):.2e}" for k, w in want.items())
            + f"; reference jit vs eager {_max_err(want['jit'], eager):.2e}")
    for name in ("sgd", "adamw"):
        errs = [_max_err(j["params"], t["params"])
                for j, _, t, _ in _driver_steps(name)]
        print(f"driver steps, {name}: parameters "
              + ", ".join(f"{e:.2e}" for e in errs))


if __name__ == "__main__":
    main()
