"""The port's FEEL driver against the JAX reference: the slice end to end.

The JAX ``run_federated`` program (DAS with the ``fused_pgd`` allocator,
kernel FedAvg, ``Sub2Params.fast()``) runs a few rounds on the CPU; its
key schedule is replayed with ``jax.random`` to build the port's random
tape (fading gains, minibatch indices, the scheduling draw), and the port
runs the same rounds on the same data, network and initial weights.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import streaming as jstreaming  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, telemetry  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import fedavg_agg as tagg  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402

ROUNDS = 3
DATA_FIELDS = ("images", "labels", "mask", "sizes", "test_images",
               "test_labels")
NET_FIELDS = ("distance_m", "pathloss", "tx_power", "cpu_freq",
              "cycles_per_bit")


def replay_tape(key, net, k, rounds, capacity, max_steps, batch, fcfg=None,
                hists=None, coord_order=None):
    """The reference's draws, by its key schedule: ``split(key, 4)`` into
    carry/fade/sched/train each round, ``split(k_train, K)`` per device,
    ``split(device_key, max_steps)`` per step, then ``randint``.

    ``fcfg`` (the reference's FLConfig) adds its subsystems' draws:
    ``stream`` splits an init key off first and a fifth key each round
    (the ``poisson`` process: rate uniforms, then Poisson counts);
    ``faults`` folds ``0xFA17`` into each round's carry key and splits it
    in four uniforms, and ``0xC407`` into the original key for the
    chronic rates; ``compression`` splits ``k_train`` into the SGD key
    and the quantization-noise key.  ``coord_order`` maps the port's
    flat parameter coordinates to the reference's (for the noise).
    ``events`` (``rounds`` is then the event count) folds ``0xD1A7`` into
    the original key for the diurnal phases (split into the shared
    uniform and the per-device normal) and ``0xA7A1`` into each tick's
    carry key for the availability uniforms.
    """
    stream = fcfg.stream if fcfg is not None else None
    flt = jfaults.active(fcfg.faults) if fcfg is not None else None
    comp = fcfg.compression if fcfg is not None else None
    ecfg = fcfg.events if fcfg is not None else None
    avail_draws = ecfg is not None and ecfg.availability != "always"
    extra = {}
    if flt is not None and flt.drop_prob > 0 and flt.chronic_spread > 0:
        extra["chronic_z"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, 0xC407), (k,))))
    if avail_draws:
        extra["avail_init"] = {}
        if ecfg.availability == "diurnal":
            k_shared, k_dev = jax.random.split(jax.random.fold_in(key,
                                                                  0xD1A7))
            extra["avail_init"] = {
                "shared_u": torch.from_numpy(np.array(
                    jax.random.uniform(k_shared, ()))),
                "z": torch.from_numpy(np.array(
                    jax.random.normal(k_dev, (k,))))}
    if stream is not None:
        assert stream.process == "poisson"
        key, k_init = jax.random.split(key)
        extra["stream_init"] = {"u": torch.from_numpy(np.array(
            jax.random.uniform(k_init, (k,))))}
        st = jstreaming.get_process("poisson").init(k_init, hists, stream)
        lam = st.rates[:, None] * st.affinity
    gains, sched_u, idx, counts, fault_u, noise, avail_u = (
        [], [], [], [], [], [], [])

    def device_idx(dk):
        return jax.vmap(lambda sk: jax.random.randint(sk, (batch,), 0,
                                                      capacity))(
            jax.random.split(dk, max_steps))

    for _ in range(rounds):
        sub = jax.random.split(key, 4 + (stream is not None))
        key, k_fade, k_sched, k_train = sub[:4]
        if stream is not None:
            counts.append(np.asarray(jax.random.poisson(sub[4], lam),
                                     np.float32))
        if flt is not None:
            kd, ko, ks, kt = jax.random.split(
                jax.random.fold_in(key, 0xFA17), 4)
            budget = jfaults.attempt_budget(flt)
            fault_u.append({
                "u_drop": jax.random.uniform(kd, (k, budget)),
                "u_dropout": jax.random.uniform(ko, (k,)),
                "u_strag": jax.random.uniform(ks, (k,)),
                "u_tail": jax.random.uniform(kt, (k,), minval=1e-6,
                                             maxval=1.0)})
        if avail_draws:
            avail_u.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(key, 0xA7A1), (k,))))
        if comp is not None:
            k_train, k_comp = jax.random.split(k_train)
            if comp.codec in ("quant", "adaptive"):
                n = np.asarray(jax.random.uniform(
                    k_comp, (k, len(coord_order))))
                noise.append(n[:, coord_order])
        gains.append(np.asarray(jw.sample_fading(k_fade, net)))
        sched_u.append(np.asarray(jax.random.uniform(k_sched, (k,))))
        idx.append(np.asarray(jax.vmap(device_idx)(
            jax.random.split(k_train, k))))
    if counts:
        extra["stream"] = {"counts": torch.from_numpy(np.stack(counts))}
    if fault_u:
        extra["faults"] = {n: torch.from_numpy(np.stack(
            [np.asarray(u[n]) for u in fault_u])) for n in fault_u[0]}
    if noise:
        extra["comp_noise"] = torch.from_numpy(np.stack(noise))
    if avail_u:
        extra["avail"] = {"u": torch.from_numpy(np.stack(avail_u))}
    return tfed.Draws(torch.from_numpy(np.stack(gains)),
                      torch.from_numpy(np.stack(idx)).long(),
                      torch.from_numpy(np.stack(sched_u)), **extra)


def coord_order(params_np, kind, hidden=None):
    """Index map from the port's flat parameter order to the reference's
    (pytree leaves sorted by name, dense weights (in, out)): the port's
    coordinate i is the reference's ``coord_order[i]``."""
    leaves = jax.tree_util.tree_leaves(params_np)
    offsets, tree, start = [], [], 0
    for leaf in leaves:
        offsets.append(np.arange(start, start + leaf.size,
                                 dtype=np.float32).reshape(leaf.shape))
        start += leaf.size
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params_np), offsets)
    model = convert.paper_net_from_numpy(
        ids, tnets.PaperNetSpec(kind=kind) if hidden is None
        else tnets.PaperNetSpec(kind=kind, mlp_hidden=hidden))
    return torch.cat([t.reshape(-1) for t in
                      tnets.params_of(model).values()]).long().numpy()


def _port_world(data, net, params, kind, hidden=None):
    tdata = convert.dataset_from_numpy(
        **{f: np.asarray(getattr(data, f)) for f in DATA_FIELDS})
    tnet = convert.network_from_numpy(
        **{f: np.asarray(getattr(net, f)) for f in NET_FIELDS})
    model = convert.paper_net_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        tnets.PaperNetSpec(kind=kind) if hidden is None
        else tnets.PaperNetSpec(kind=kind, mlp_hidden=hidden))
    return tdata, tnet, model


# (model, K, network seed, learning rate, final-params atol).  The
# example's learning rate per model.  The CNN's params tolerance is wider
# because the reference's own vmapped CNN trainer on the CPU drifts from
# its per-client result (one client of this world by 6.4e-4 after one
# round); the port matches the per-client reference to 1e-6
# (test_cnn_trainer_matches_the_reference_per_client).
CASES = [("mlp", 12, 0, 0.1, 1e-4), ("cnn", 16, 3, 0.05, 5e-3)]


def run_pair(kind, k, net_seed, lr, jsub=None, tsub=None, sched_extra=None,
             rounds=ROUNDS, hidden=None, samples_per_class=600,
             num_shards=100, with_log=False):
    """The reference's ``make_feel_sim`` and the port's ``run_federated``
    on one world (DAS + ``fused_pgd`` + kernel FedAvg, ``Sub2Params.fast``)
    from one key schedule.  ``jsub``/``tsub`` are the subsystem fields of
    the two FLConfigs (reference and port configs, same values);
    ``sched_extra`` adds to or overrides the scheduler's fields, ``hidden``
    sets the MLP's width, ``samples_per_class`` and ``num_shards`` the
    world's size.  ``rounds`` is the run's :func:`sim_length` (the events
    of an event run).

    Returns ``(reference params, reference metrics, port params, port
    records)``, and the port's ``events.EventLog`` after them with
    ``with_log`` (an event run); with telemetry in ``jsub``/``tsub`` the
    port's frames and then the reference's follow.
    """
    imgs, labels = jsyn.generate(0, samples_per_class=samples_per_class)
    data = jpart.partition(imgs, labels, seed=1, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=num_shards, shard_size=50))
    wcfg = jw.WirelessConfig()
    net = jw.sample_network(jax.random.key(net_seed), k, wcfg)
    spec = jnets.PaperNetSpec(kind=kind) if hidden is None \
        else jnets.PaperNetSpec(kind=kind, mlp_hidden=hidden)
    params = jnets.init(jax.random.key(3), spec)
    sched = {**dict(method="das", n_min=2, iterations_max=4,
                    allocator="fused_pgd"), **(sched_extra or {})}
    fl = dict(num_rounds=rounds, batch_size=50, learning_rate=lr,
              use_kernel_agg=True)
    jfcfg = jfed.FLConfig(**fl, **(jsub or {}))
    key = jax.random.key(4)
    sim = jfed.make_feel_sim(
        loss_fn=functools.partial(jnets.loss_fn, spec=spec),
        eval_fn=functools.partial(jnets.accuracy, spec=spec), wcfg=wcfg,
        scfg=jsch.SchedulerConfig(sub2=jbw.Sub2Params.fast(), **sched),
        fcfg=jfcfg, capacity=data.capacity)
    hists = jfed.client_histograms(data, 10)
    jparams, jmet, *jframes = sim(
        params, data.images, data.labels, data.mask, data.sizes, hists,
        jsyn.to_float(data.test_images), data.test_labels, net, key)
    draws = replay_tape(key, net, k, rounds, data.capacity,
                        jfed._max_local_steps(jfcfg, data.capacity), 50,
                        fcfg=jfcfg, hists=hists,
                        coord_order=coord_order(params, kind, hidden))
    tdata, tnet, model = _port_world(data, net, params, kind, hidden)
    out = (tev.run_events if with_log else tfed.run_federated)(
        model=model, data=tdata, net=tnet, wcfg=tw.WirelessConfig(),
        scfg=tsch.SchedulerConfig(sub2=tbw.Sub2Params.fast(), **sched),
        fcfg=tfed.FLConfig(**fl, **(tsub or {})), draws=draws,
        device="cpu")
    return (jax.device_get(jparams), jax.device_get(jmet)) + tuple(out) \
        + tuple(jax.device_get(f) for f in jframes)


def assert_runs_agree(jmet, recs, jparams=None, tparams=None, atol=None,
                      obj_rtol=1e-4, et_rtol=5e-3):
    """Equal selections, DAS iterations, delivered and dropped counts
    every round; the Sub2 objective rho*E + (1-rho)*T at ``obj_rtol``, E
    and T at ``et_rtol`` (see test_slice_energy_and_time_match_reference);
    final parameters at ``atol``."""
    for r, rec in enumerate(recs):
        np.testing.assert_array_equal(rec.selected, jmet.selected[r])
        assert rec.iterations == int(jmet.iterations[r])
        assert rec.n_selected == int(jmet.n_selected[r])
        assert rec.n_success == int(jmet.n_success[r])
        assert rec.n_dropped == int(jmet.n_dropped[r])
        e, t = float(jmet.energy_total[r]), float(jmet.round_time[r])
        assert 0.5 * rec.energy_total + 0.5 * rec.round_time == \
            pytest.approx(0.5 * e + 0.5 * t, rel=obj_rtol)
        assert rec.energy_total == pytest.approx(e, rel=et_rtol)
        assert rec.round_time == pytest.approx(t, rel=et_rtol)
    if atol is not None:
        got = convert.paper_net_to_numpy(tparams)
        for layer, leaves in jparams.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(got[layer][name],
                                           np.asarray(want), rtol=0,
                                           atol=atol)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{c[0]}-K{c[1]}" for c in CASES])
def slice_runs(request):
    kind, k, net_seed, lr, atol = request.param
    return (*run_pair(kind, k, net_seed, lr), atol)


def test_slice_selections_and_iterations_equal_reference(slice_runs):
    """DAS selection is discrete: the masks and the outer-iteration
    counts must be equal in every round."""
    _, jmet, _, recs, _ = slice_runs
    for r, rec in enumerate(recs):
        np.testing.assert_array_equal(rec.selected, jmet.selected[r])
        assert rec.iterations == int(jmet.iterations[r])
        assert rec.n_selected == int(jmet.n_selected[r])


def test_slice_energy_and_time_match_reference(slice_runs):
    """The Sub2 objective rho*E + (1-rho)*T agrees to rtol 1e-4.  E and
    T separately agree only to rtol 5e-3: the fused descent takes
    normalised steps that amplify last-bit differences (the port's plain
    version differentiates with autograd, the reference kernel
    analytically) along the objective's flat valley, where energy and
    round time trade off at a constant objective — the reason the
    reference holds its own kernel to its oracle at alpha atol 1e-2."""
    _, jmet, _, recs, _ = slice_runs
    for r, rec in enumerate(recs):
        e, t = float(jmet.energy_total[r]), float(jmet.round_time[r])
        assert 0.5 * rec.energy_total + 0.5 * rec.round_time == \
            pytest.approx(0.5 * e + 0.5 * t, rel=1e-4)
        assert rec.energy_total == pytest.approx(e, rel=5e-3)
        assert rec.round_time == pytest.approx(t, rel=5e-3)


def test_slice_final_params_and_accuracy_match_reference(slice_runs):
    """Equal selections give equal FedAvg weights; local SGD on the same
    minibatches then differs by f32 rounding of the convolutions and
    matmuls (MLP: ~1e-7) — and, for the CNN, by the reference's own
    vmapped-trainer drift (see CASES)."""
    jparams, jmet, tparams, recs, atol = slice_runs
    got = convert.paper_net_to_numpy(tparams)
    for layer, leaves in jparams.items():
        for name, want in leaves.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(want),
                                       rtol=0, atol=atol)
    for r, rec in enumerate(recs):
        # A few of the 500 test samples may flip their argmax.
        assert rec.accuracy == pytest.approx(float(jmet.accuracy[r]),
                                             abs=100 * atol)


def test_cnn_trainer_matches_the_reference_per_client():
    """The port's vmapped local SGD of K = 16 CNN clients against the
    reference's gradient steps run client by client (no vmap), on the
    same minibatches: f32 rounding only."""
    k, steps, lr = 16, 9, 0.05
    imgs, labels = jsyn.generate(0, samples_per_class=600)
    data = jpart.partition(imgs, labels, seed=1, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=100, shard_size=50))
    spec = jnets.PaperNetSpec(kind="cnn")
    params = jnets.init(jax.random.key(3), spec)
    keys = jax.random.split(jax.random.key(8), k)
    idx = np.stack([np.asarray(jax.vmap(
        lambda sk: jax.random.randint(sk, (50,), 0, data.capacity))(
            jax.random.split(dk, steps))) for dk in keys])
    images, labs, mask = (np.array(getattr(data, f))
                          for f in ("images", "labels", "mask"))
    grad = jax.jit(jax.grad(functools.partial(jnets.loss_fn, spec=spec)))
    want = []
    for c in range(k):
        p = params
        for s in range(steps):
            rows = idx[c, s]
            g = grad(p, images[c, rows].astype(np.float32) / 255.0,
                     labs[c, rows], mask[c, rows])
            p = jax.tree_util.tree_map(lambda w, gi: w - lr * gi, p, g)
        want.append(p)
    _, _, model = _port_world(data, jw.sample_network(
        jax.random.key(0), k, jw.WirelessConfig()), params, "cnn")
    cfg = tfed.FLConfig(learning_rate=lr)
    trainer = tfed.make_local_trainer(functools.partial(tnets.loss_fn, model),
                                      cfg)
    got = trainer(tnets.params_of(model), torch.from_numpy(images),
                  torch.from_numpy(labs), torch.from_numpy(mask),
                  torch.ones((k, steps)), torch.from_numpy(idx).long())
    for c in range(k):
        port = convert.paper_net_to_numpy({n: t[c] for n, t in got.items()})
        for layer, leaves in want[c].items():
            for name, w in leaves.items():
                np.testing.assert_allclose(port[layer][name], np.asarray(w),
                                           rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Driver pieces
# ---------------------------------------------------------------------------

def _stacked(k=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((k, 3, 5)).astype(np.float32),
              "b": rng.standard_normal((k, 5)).astype(np.float32)}
    w = rng.random(k).astype(np.float32)
    return params, w / w.sum()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fedavg_aggregate_matches_reference(use_kernel):
    """Same weighted sum; K-term f32 sums in another order."""
    params, w = _stacked()
    want = jfed.fedavg_aggregate(params, jnp.asarray(w), use_kernel)
    got = tfed.fedavg_aggregate({n: torch.from_numpy(a)
                                 for n, a in params.items()},
                                torch.from_numpy(w), use_kernel)
    for n in params:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6)


def test_empty_selection_carries_the_model_forward():
    model = tnets.build(tnets.PaperNetSpec(kind="mlp"))
    params = tnets.params_of(model)
    k, cap = 3, 8
    cfg = tfed.FLConfig(batch_size=4, learning_rate=0.1,
                        use_kernel_agg=True)
    trainer = tfed.make_local_trainer(
        functools.partial(tnets.loss_fn, model), cfg)
    out = tfed._train_round(
        trainer, 2, cfg, params, torch.zeros((k, cap, 28, 28),
                                             dtype=torch.uint8),
        torch.zeros((k, cap), dtype=torch.int32), torch.ones((k, cap)),
        torch.full((k,), cap, dtype=torch.int32), torch.zeros(k),
        torch.zeros((k, 2, 4), dtype=torch.long))
    for n in params:
        assert torch.equal(out[n], params[n])


# (field, a good value, a bad value, the error the bad one raises).
PORTED_FIELDS = {
    "dispatch_cap": (3, 0, ValueError),
    "carry_dtype": ("bfloat16", "int8", ValueError),
    "events": (tev.EventConfig(buffer_size=2), object(), TypeError),
    "telemetry": (telemetry.TelemetryConfig(sub2=False), object(),
                  TypeError),
}


@pytest.mark.parametrize("name", sorted(PORTED_FIELDS))
def test_ported_subsystem_fields_are_accepted_and_validated(name):
    good, bad, error = PORTED_FIELDS[name]
    assert getattr(tfed.FLConfig(**{name: good}), name) == good
    with pytest.raises(error, match=name.split("_")[0]):
        tfed.FLConfig(**{name: bad})


def test_entry_point_defaults_to_the_card(monkeypatch):
    """``device=None`` means CUDA; without a card it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    model = tnets.build(tnets.PaperNetSpec(kind="mlp"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.run_federated(model=model, data=None, net=None, wcfg=None,
                           scfg=None, fcfg=tfed.FLConfig())
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _tiny_world(k=6, seed=0):
    from repro_torch.data import partition, synthetic
    imgs, labels = synthetic.generate(seed, samples_per_class=150)
    data = partition.partition(imgs, labels, seed=seed + 1,
                               spec=partition.PartitionSpec(
                                   num_devices=k, num_shards=25,
                                   shard_size=50))
    net = tw.sample_network(torch.Generator().manual_seed(seed), k,
                            tw.WirelessConfig())
    return data, net


@pytest.mark.parametrize("method", ["das", "abs", "random", "full"])
def test_run_without_tape_is_seeded_and_accounts_rounds(method):
    data, net = _tiny_world()
    model = tnets.init(tnets.PaperNetSpec(kind="mlp"),
                       torch.Generator().manual_seed(1))
    kw = dict(model=model, data=data, net=net, wcfg=tw.WirelessConfig(),
              scfg=tsch.SchedulerConfig(method=method, n_min=2,
                                        n_fixed=2 if method == "random"
                                        else None,
                                        allocator="waterfilling",
                                        iterations_max=3),
              fcfg=tfed.FLConfig(num_rounds=3, learning_rate=0.1),
              seed=7, device="cpu", eval_every=2)
    p1, r1 = tfed.run_federated(**kw)
    p2, r2 = tfed.run_federated(**kw)
    for n in p1:
        assert torch.equal(p1[n], p2[n])
    np.testing.assert_equal([dataclasses.astuple(a)[:6] for a in r1],
                            [dataclasses.astuple(b)[:6] for b in r2])
    assert np.isnan(r1[1].accuracy)
    assert 0.0 <= r1[0].accuracy <= 1.0 and 0.0 <= r1[2].accuracy <= 1.0
    for rec in r1:
        assert rec.n_selected >= 2 and rec.n_success == rec.n_selected
        assert rec.n_dropped == 0 and rec.round_time > 0.0
        assert rec.energy_per_device == pytest.approx(
            rec.energy_total / rec.n_selected)
        assert (rec.iterations > 0) == (method == "das")


def test_bad_tape_shape_raises():
    data, net = _tiny_world()
    model = tnets.build(tnets.PaperNetSpec(kind="mlp"))
    draws = tfed.Draws(torch.ones((1, 6)), torch.zeros((1, 6, 1, 50),
                                                       dtype=torch.long))
    with pytest.raises(ValueError, match="batch_idx"):
        tfed.run_federated(model=model, data=data, net=net,
                           wcfg=tw.WirelessConfig(),
                           scfg=tsch.SchedulerConfig(),
                           fcfg=tfed.FLConfig(num_rounds=1), draws=draws,
                           device="cpu")


@pytest.mark.parametrize("cap,epochs", [(50, 1), (120, 2), (1, 3)])
def test_step_schedule_matches_reference(cap, epochs):
    assert tfed._max_local_steps(tfed.FLConfig(local_epochs=epochs), cap) \
        == jfed._max_local_steps(jfed.FLConfig(local_epochs=epochs), cap)
    np.testing.assert_array_equal(tfed._eval_mask(7, 3),
                                  jfed._eval_mask(7, 3))


def test_card_run_matches_cpu_run():
    """Card and CPU from one tape, TF32 off (needs a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data, net = _tiny_world(k=8)
    model = tnets.init(tnets.PaperNetSpec(kind="cnn"),
                       torch.Generator().manual_seed(1))
    cfg = tfed.FLConfig(num_rounds=2, learning_rate=0.05,
                        use_kernel_agg=True)
    draws = tfed.draw_tape(torch.Generator().manual_seed(5), net, 2,
                           data.capacity,
                           tfed._max_local_steps(cfg, data.capacity), 50)
    kw = dict(model=model, data=data, net=net, wcfg=tw.WirelessConfig(),
              scfg=tsch.SchedulerConfig(allocator="fused_pgd",
                                        sub2=tbw.Sub2Params.fast()),
              fcfg=cfg, draws=draws)
    before = tagg.fedavg_agg.launches
    pg, rg = tfed.run_federated(device="cuda", **kw)
    assert tagg.fedavg_agg.launches == before + 2
    pc, rc = tfed.run_federated(device="cpu", **kw)
    for a, b in zip(rg, rc):
        np.testing.assert_array_equal(a.selected, b.selected)
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], rtol=0, atol=1e-4)
