"""The port's S-scenario batch driver against the JAX reference's batch.

The reference's ``run_federated_batch`` program (vmapped over S = 3
network realizations and ``scenario_keys``; DAS with the ``fused_pgd``
allocator, kernel FedAvg, ``Sub2Params.fast()``) runs a few rounds on the
CPU; each scenario's key schedule is replayed with ``jax.random``
(``replay_tape``) and the port's ``run_federated_batch`` runs the same
rounds from the stacked tapes.  Also here: the seed contract of
``scenario_seeds``, batch scenario ``i`` against ``run_federated`` on
scenario ``i``'s seed, the per-lane edges, and the batched FedAvg
kernels' plain versions against ``jax.vmap`` of the reference's kernels.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, telemetry  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.kernels import fedavg_agg as tagg  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402
from test_torch_federated import (NET_FIELDS, _port_world,  # noqa: E402
                                  _tiny_world,
                                  assert_runs_agree, coord_order,
                                  replay_tape)

S = 3
ROUNDS = 3
HIDDEN = 16
FAULTS = dict(drop_prob=0.3, max_retries=2, straggler_prob=0.05,
              reliability_ema=0.2, chronic_spread=0.5, overprovision=2)
SCHED = dict(staleness_weight=0.25, reliability_weight=0.5)
QUANT8 = dict(codec="quant", bit_width=8)


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests launch the CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    """The shapes here are tiny: one intra-op thread, so the test workers
    that share the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_batch_pair(k, net_seed, jsub=None, tsub=None, sched_extra=None,
                   lr=0.1):
    """The reference's ``make_feel_sim_batch`` over ``sample_networks(key
    (net_seed), S, k)`` and ``scenario_keys(key(4), 0, S)``, and the
    port's ``run_federated_batch`` on the same world from each
    scenario's replayed tape, stacked.  Returns ``(reference params,
    reference metrics, port params, port metrics)``, metrics ``(S, R,
    ...)``."""
    imgs, labels = jsyn.generate(0, samples_per_class=600)
    data = jpart.partition(imgs, labels, seed=1, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=100, shard_size=50))
    wcfg = jw.WirelessConfig()
    nets = jw.sample_networks(jax.random.key(net_seed), S, k, wcfg)
    spec = jnets.PaperNetSpec(kind="mlp", mlp_hidden=HIDDEN)
    params = jnets.init(jax.random.key(3), spec)
    sched = {**dict(method="das", n_min=2, iterations_max=4,
                    allocator="fused_pgd"), **(sched_extra or {})}
    fl = dict(num_rounds=ROUNDS, batch_size=50, learning_rate=lr,
              use_kernel_agg=True)
    jfcfg = jfed.FLConfig(**fl, **(jsub or {}))
    keys = jfed.scenario_keys(jax.random.key(4), 0, S)
    sim = jfed.make_feel_sim_batch(
        loss_fn=functools.partial(jnets.loss_fn, spec=spec),
        eval_fn=functools.partial(jnets.accuracy, spec=spec), wcfg=wcfg,
        scfg=jsch.SchedulerConfig(sub2=jbw.Sub2Params.fast(), **sched),
        fcfg=jfcfg, capacity=data.capacity)
    hists = jfed.client_histograms(data, 10)
    jparams, jmet = sim(params, data.images, data.labels, data.mask,
                        data.sizes, hists, jsyn.to_float(data.test_images),
                        data.test_labels, nets, keys)
    order = coord_order(params, "mlp", HIDDEN)
    tapes = [replay_tape(keys[s], jax.tree_util.tree_map(
        lambda a, s=s: a[s], nets), k, ROUNDS, data.capacity,
        jfed._max_local_steps(jfcfg, data.capacity), 50, fcfg=jfcfg,
        hists=hists, coord_order=order) for s in range(S)]
    tdata, tnets_, model = _port_world(
        data, jax.tree_util.tree_map(lambda a: a[0], nets), params, "mlp",
        HIDDEN)
    del tnets_
    stacked = convert.network_from_numpy(
        **{f: np.asarray(getattr(nets, f)) for f in NET_FIELDS})
    tparams, tmet = tfed.run_federated_batch(
        model=model, data=tdata, nets=stacked, wcfg=tw.WirelessConfig(),
        scfg=tsch.SchedulerConfig(sub2=tbw.Sub2Params.fast(), **sched),
        fcfg=tfed.FLConfig(**fl, **(tsub or {})), seeds=list(range(S)),
        draws=tfed._stack_tapes(tapes), device="cpu")
    return jax.device_get(jparams), jax.device_get(jmet), tparams, tmet


def _scenario(tree, s):
    return jax.tree_util.tree_map(lambda a: a[s], tree)


COMPOSED = dict(dispatch_cap=12, carry_dtype="bfloat16")
# (name, K, network seed, reference FLConfig fields, port FLConfig
# fields, scheduler extras, params atol).  "off": every subsystem off,
# on a network draw whose lanes converge after different numbers of DAS
# outer iterations.  "composed": Poisson streaming, faults, 8-bit quant,
# a binding cap (every lane selects all 16 devices, so every lane
# converges in 2 iterations) and the bf16 carry.  Its params are held at
# 1e-3, the quant parity case's limit (tests/test_torch_compression.py):
# a stochastic rounding whose input differs in the last bits between the
# two trainers moves a coordinate by one level of its row max (1.4e-4 to
# 3.9e-4 here; without the codec the same run reads 6e-8).  Its realized
# objective keeps assert_runs_agree's 1e-4 (8.7e-5 at the worst round):
# under faults the round is re-priced on the capped set at the scheduled
# shares, where the two Sub2 solvers' moves along the flat valley show
# (a cap of 5 reads 1.2e-3, network seed 4 9.5e-4).
CONFIGS = [
    ("off", 12, 0, {}, {}, {}, 1e-4),
    ("composed", 16, 3,
     dict(COMPOSED, stream=jst.StreamConfig(use_kernel=True),
          faults=jf.FaultConfig(**FAULTS),
          compression=jcomp.CompressionConfig(**QUANT8)),
     dict(COMPOSED, stream=tst.StreamConfig(),
          faults=tf.FaultConfig(**FAULTS),
          compression=tcomp.CompressionConfig(**QUANT8)), SCHED, 1e-3),
]


@pytest.fixture(scope="module", params=CONFIGS, ids=[c[0] for c in CONFIGS])
def batch_runs(request):
    name, k, net_seed, jsub, tsub, sched, atol = request.param
    torch.set_num_threads(1)
    return (name, atol, *run_batch_pair(k, net_seed, jsub, tsub, sched))


def test_batch_scenarios_match_the_reference_batch(batch_runs):
    """Per scenario and round, ``assert_runs_agree``'s tolerances: equal
    selections, DAS iterations, delivered and dropped counts; the Sub2
    objective at rtol 1e-4, E and T at 5e-3; final params within the
    config's atol of the reference's scenario (CONFIGS; "off" reads
    2.4e-7)."""
    _, atol, jparams, jmet, tparams, tmet = batch_runs
    recs = tfed.batch_metrics_to_records(tmet)
    assert len(recs) == S
    for s in range(S):
        assert_runs_agree(_scenario(jmet, s), recs[s],
                          _scenario(jparams, s),
                          {n: t[s] for n, t in tparams.items()}, atol=atol)


def test_batch_lane_iteration_counts_are_the_references(batch_runs):
    """Each lane's DAS outer iterations are its reference lane's, round
    by round; with every subsystem off the lanes converge after
    different numbers of iterations somewhere, so the freeze of the
    converged lanes is exercised."""
    name, _, _, jmet, _, tmet = batch_runs
    its = tmet.iterations.numpy()
    np.testing.assert_array_equal(its, np.asarray(jmet.iterations))
    if name == "off":
        assert any(len(set(its[:, r])) > 1 for r in range(ROUNDS)), \
            f"every round's lanes took equal iterations {its}"


def test_batch_metrics_shapes(batch_runs):
    name, _, _, _, tparams, tmet = batch_runs
    k = tmet.selected.shape[-1]
    assert tuple(tmet.selected.shape) == (S, ROUNDS, k)
    assert tuple(tmet.energy.shape) == (S, ROUNDS, k)
    for f in ("accuracy", "n_selected", "round_time", "energy_total",
              "iterations", "n_success", "n_dropped"):
        assert tuple(getattr(tmet, f).shape) == (S, ROUNDS), f
    assert all(t.shape[0] == S for t in tparams.values())
    if name == "composed":
        recs = tfed.batch_metrics_to_records(tmet)
        assert sum(r.n_dropped for rs in recs for r in rs) > 0
        assert any(r.n_success < r.n_selected for rs in recs for r in rs)


# ---------------------------------------------------------------------------
# Seeds, singles and edges (port only)
# ---------------------------------------------------------------------------

def _small(k=6, process="poisson", codec="quant", **fl):
    data, _ = _tiny_world(k)
    model = tnets.init(tnets.PaperNetSpec(kind="mlp", mlp_hidden=HIDDEN),
                       torch.Generator().manual_seed(1))
    sub = {} if process is None else dict(
        stream=tst.StreamConfig(process=process),
        faults=tf.FaultConfig(**FAULTS),
        compression=tcomp.CompressionConfig(codec=codec))
    fcfg = tfed.FLConfig(num_rounds=2, learning_rate=0.1,
                         use_kernel_agg=True, **sub, **fl)
    # A short descent: these runs compare the port with itself.
    scfg = tsch.SchedulerConfig(allocator="fused_pgd", n_min=2,
                                sub2=dataclasses.replace(
                                    tbw.Sub2Params.fast(), pgd_iters=30),
                                iterations_max=4, **SCHED)
    return dict(model=model, data=data, wcfg=tw.WirelessConfig(),
                scfg=scfg, fcfg=fcfg)


def _batch(kw, base, start, count, net_base=7):
    k = kw["data"].num_devices
    nets = tw.sample_networks_indexed(net_base, range(start, start + count),
                                      k, kw["wcfg"])
    return tfed.run_federated_batch(
        nets=nets, seeds=tfed.scenario_seeds(base, start, count),
        device="cpu", **kw)


def test_scenario_seeds_depend_on_the_global_index_only():
    """Scenarios 1-2 of a batch that starts at 0 with S = 3 are
    scenarios 0-1 of a batch that starts at 1 with S = 2, bit for bit:
    the networks, the tapes and so the runs depend on (base, i) alone."""
    assert tfed.scenario_seeds(11, 0, 3)[1:] == tfed.scenario_seeds(11, 1, 2)
    assert len(set(tfed.scenario_seeds(11, 0, 64))) == 64
    assert tfed.scenario_seeds(11, 0, 2) != tfed.scenario_seeds(12, 0, 2)
    kw = _small()
    p3, m3 = _batch(kw, 11, 0, 3)
    p2, m2 = _batch(kw, 11, 1, 2)
    for n in p3:
        assert torch.equal(p3[n][1:], p2[n])
    for f in dataclasses.fields(m3):
        assert torch.equal(getattr(m3, f.name)[1:], getattr(m2, f.name)), \
            f.name


@pytest.mark.parametrize("process,codec,cap", [
    (None, None, None), ("poisson", "quant", 3), ("drift", "topk", None),
    ("evict", "adaptive", 2)])
def test_batch_scenario_equals_its_single_run(process, codec, cap):
    """Batch scenario i against ``run_federated`` seeded with scenario
    i's seed on scenario i's network: the same selections, DAS
    iterations, delivered and dropped counts, params within 1e-6."""
    kw = _small(process=process, codec=codec, dispatch_cap=cap)
    seeds = tfed.scenario_seeds(3, 0, S)
    nets = tw.sample_networks(torch.Generator().manual_seed(2), S,
                              kw["data"].num_devices, kw["wcfg"])
    pb, mb = tfed.run_federated_batch(nets=nets, seeds=seeds, device="cpu",
                                      **kw)
    recs = tfed.batch_metrics_to_records(mb)
    for s in range(S):
        ps, rs = tfed.run_federated(net=nets.scenario(s), seed=seeds[s],
                                    device="cpu", **kw)
        for a, b in zip(recs[s], rs):
            np.testing.assert_array_equal(a.selected, b.selected)
            assert (a.iterations, a.n_selected, a.n_success, a.n_dropped) \
                == (b.iterations, b.n_selected, b.n_success, b.n_dropped)
        for n in ps:
            torch.testing.assert_close(pb[n][s], ps[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "kernel", "faulty",
                                     "compressed"])
def test_an_empty_lane_carries_its_model_while_the_others_move(variant):
    """A lane whose selection is empty keeps its model, bit for bit,
    while the lanes beside it train: the empty-set guard is per lane."""
    kw = _small(k=4, process=None)
    data, model = kw["data"], kw["model"]
    cfg = dataclasses.replace(kw["fcfg"],
                              use_kernel_agg=variant != "plain")
    trainer = tfed.make_local_trainer(functools.partial(tnets.loss_fn,
                                                        model), cfg)
    steps = tfed._max_local_steps(cfg, data.capacity)
    params = tfed.tile_params(tnets.params_of(model), 2)
    selected = torch.tensor([[1.0, 1.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
    sizes = data.sizes.expand(2, 4)
    bidx = torch.randint(0, data.capacity, (2, 4, steps, 50),
                         generator=torch.Generator().manual_seed(0))
    args = (trainer, steps, cfg, params, data.images, data.labels,
            data.mask, sizes, selected)
    if variant == "faulty":
        out = tfed._train_round_faulty(*args, selected, bidx)
    elif variant == "compressed":
        codec = tcomp.get_codec("topk")
        cfg = dataclasses.replace(cfg, compression=tcomp.CompressionConfig(
            codec="topk"))
        out, res = tfed._train_round_compressed(
            trainer, steps, cfg, codec, params, data.images, data.labels,
            data.mask, sizes, selected, bidx,
            torch.zeros((2, 4, tfed.flat_param_size(tnets.params_of(
                model)))), torch.ones(2, 4), torch.ones(2, 4), None)
        assert torch.equal(res[1], torch.zeros_like(res[1]))
    else:
        out = tfed._train_round(*args, bidx)
    for n, p in params.items():
        assert torch.equal(out[n][1], p[1])
        assert not torch.equal(out[n][0], p[0])


def test_batch_defaults_to_the_card(monkeypatch):
    """``device=None`` means CUDA; without a card the batch raises
    instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = _small(process=None)
    nets = tw.sample_networks(torch.Generator().manual_seed(0), 2,
                              kw["data"].num_devices, kw["wcfg"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.run_federated_batch(nets=nets, seeds=[0, 1], **kw)


def test_batch_tape_and_networks_are_checked():
    kw = _small(process=None)
    k = kw["data"].num_devices
    nets = tw.sample_networks(torch.Generator().manual_seed(0), 2, k,
                              kw["wcfg"])
    with pytest.raises(ValueError, match="network's rows"):
        tfed.run_federated_batch(nets=nets, seeds=[0, 1, 2], device="cpu",
                                 **kw)
    kw_q = _small(process=None, compression=tcomp.CompressionConfig(
        codec="quant"))
    tape = tfed.draw_tapes([0, 1], nets, 2, kw["data"].capacity,
                           tfed._max_local_steps(kw["fcfg"],
                                                 kw["data"].capacity), 50)
    with pytest.raises(ValueError, match="comp_noise"):
        tfed.run_federated_batch(nets=nets, seeds=[0, 1], draws=tape,
                                 device="cpu", **kw_q)


def test_stacked_networks_match_the_reference_formulas():
    """``network_from_numpy`` takes the reference's stacked (S, K)
    networks; the per-lane formulas (round time, ``num_devices``) then
    read the trailing axis."""
    nets = jw.sample_networks(jax.random.key(1), S, 5, jw.WirelessConfig())
    t = convert.network_from_numpy(
        **{f: np.asarray(getattr(nets, f)) for f in NET_FIELDS})
    assert t.num_devices == 5 and tuple(t.pathloss.shape) == (S, 5)
    rng = np.random.default_rng(0)
    sel = (rng.random((S, 5)) < 0.6).astype(np.float32)
    tt, tu = rng.random((S, 5)).astype(np.float32), \
        rng.random((S, 5)).astype(np.float32)
    want = jax.vmap(jw.round_time)(sel, tt, tu)
    got = tw.round_time(*(torch.from_numpy(a) for a in (sel, tt, tu)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tw.stack_networks([t.scenario(s) for s in range(S)]).pathloss \
        .equal(t.pathloss)


# ---------------------------------------------------------------------------
# The batched FedAvg kernels
# ---------------------------------------------------------------------------

def _fedavg_case(s=3, k=7, p=37, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((s, k, p)).astype(np.float32)
    w = rng.random((s, k)).astype(np.float32)
    m = (rng.random((s, k)) < 0.7).astype(np.float32)
    st = (1.0 + rng.integers(0, 4, (s, k))).astype(np.float32) ** -0.5
    return u, w / w.sum(-1, keepdims=True), m, st


@pytest.mark.parametrize("form", ["plain", "masked", "stale"])
def test_batched_fedavg_plain_versions_match_vmapped_reference(form):
    """(S, K, P) x (S, K) -> (S, P) against ``jax.vmap`` of the
    reference's Pallas kernels (their ``ops`` wrappers) in interpret
    mode: K-term f32 sums in another order."""
    u, w, m, st = _fedavg_case()
    if form == "plain":
        args, jfn, tfn = (u, w), jops.fedavg_agg, tagg.fedavg_agg
    elif form == "masked":
        args, jfn, tfn = (u, w, m), jops.fedavg_agg_masked, \
            tagg.fedavg_agg_masked
    else:
        args, jfn, tfn = (u, w, m, st), jops.fedavg_agg_stale, \
            tagg.fedavg_agg_stale
    want = jax.vmap(functools.partial(jfn, interpret=True))(
        *(jnp.asarray(a) for a in args))
    got = tfn(*(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == (u.shape[0], u.shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for s in range(u.shape[0]):   # each scenario is its own problem
        one = tfn(*(torch.from_numpy(a[s]) for a in args))
        np.testing.assert_allclose(got[s].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_fedavg_route_allows_for_the_scenario_stride():
    assert tagg.route(8, 4096, 7 * 8) == "vec4"
    assert tagg.route(8, 4096, 6) == "vec2"
    assert tagg.route(6, 4096, 7 * 6) == "vec2"
    assert tagg.route(5, 4096, 7 * 5) == "scalar"


@pytest.mark.parametrize("form", ["plain", "masked", "stale"])
@pytest.mark.parametrize("s,k,p", [(16, 100, 21840), (3, 7, 37),
                                   (5, 33, 1026)])
def test_batched_fedavg_on_card_is_each_single_launch(cuda_device, form, s,
                                                      k, p):
    """On the card (needs a CUDA device): after a NaN fill of shared
    memory, scenario s of one batched launch is bit for bit the single
    launch on its rows, two batched launches agree bit for bit, and the
    batch is within 1e-5 of the plain version."""
    from repro_torch.kernels import _check
    u, w, m, st = (torch.from_numpy(a).to(cuda_device)
                   for a in _fedavg_case(s, k, p, seed=s + p))
    fn, plain = {"plain": (tagg.fedavg_agg, tagg.fedavg_agg_plain),
                 "masked": (tagg.fedavg_agg_masked,
                            tagg.fedavg_agg_masked_plain),
                 "stale": (tagg.fedavg_agg_stale,
                           tagg.fedavg_agg_stale_plain)}[form]
    args = {"plain": (u, w), "masked": (u, w, m),
            "stale": (u, w, m, st)}[form]
    before = fn.launches
    outs = []
    for _ in range(2):
        _check.fill_shared_memory(u.device)
        outs.append(fn(*args))
    assert fn.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    for i in range(s):
        _check.fill_shared_memory(u.device)
        one = fn(*(a[i] for a in args))
        assert torch.equal(outs[0][i], one), i
    torch.testing.assert_close(outs[0], plain(*args), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The event lane: run_federated_batch with FLConfig.events
# ---------------------------------------------------------------------------

# The asynchronous mode of the reference's batch-equals-singles event
# case (tests/test_events.py): diurnal availability, a buffer of 2,
# decay 0.5, short ticks; here with live faults, on K = 8 and an MLP of
# 8 hidden units.
EVENTS = dict(availability="diurnal", duty=0.6, buffer_size=2,
              staleness_decay=0.5, tick_horizon=0.02, num_events=6)
EVENT_FAULTS = dict(drop_prob=0.3, max_retries=1, straggler_prob=0.2,
                    straggler_scale=3.0, reliability_ema=0.3)
EVENT_SCHED = dict(method="das", n_min=2, iterations_max=4,
                   allocator="fused_pgd", reliability_weight=0.4,
                   staleness_weight=0.25)


def _event_world(k):
    imgs, labels = jsyn.generate(0, samples_per_class=200)
    return jpart.partition(imgs, labels, seed=1, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=36, shard_size=50))


@pytest.fixture(scope="module")
def event_batch():
    """The reference's ``make_feel_sim_batch`` with events over S = 3
    scenarios (``sample_networks``, ``scenario_keys``), and the port's
    ``run_federated_batch`` with telemetry on and ``run_events`` on the
    stacked replayed tapes, and each scenario's ``run_events`` alone on
    its own tape."""
    torch.set_num_threads(1)
    k, events = 8, EVENTS["num_events"]
    data = _event_world(k)
    wcfg = jw.WirelessConfig()
    nets = jw.sample_networks(jax.random.key(0), S, k, wcfg)
    spec = jnets.PaperNetSpec(kind="mlp", mlp_hidden=8)
    params = jnets.init(jax.random.key(3), spec)
    fl = dict(num_rounds=3, batch_size=50, learning_rate=0.1,
              use_kernel_agg=True)
    jfcfg = jfed.FLConfig(**fl, events=jev.EventConfig(**EVENTS),
                          faults=jf.FaultConfig(**EVENT_FAULTS))
    keys = jfed.scenario_keys(jax.random.key(4), 0, S)
    sim = jfed.make_feel_sim_batch(
        loss_fn=functools.partial(jnets.loss_fn, spec=spec),
        eval_fn=functools.partial(jnets.accuracy, spec=spec), wcfg=wcfg,
        scfg=jsch.SchedulerConfig(sub2=jbw.Sub2Params.fast(),
                                  **EVENT_SCHED),
        fcfg=jfcfg, capacity=data.capacity)
    hists = jfed.client_histograms(data, 10)
    jparams, jmet = sim(params, data.images, data.labels, data.mask,
                        data.sizes, hists, jsyn.to_float(data.test_images),
                        data.test_labels, nets, keys)
    tapes = [replay_tape(keys[s], _scenario(nets, s), k, events,
                         data.capacity,
                         jfed._max_local_steps(jfcfg, data.capacity), 50,
                         fcfg=jfcfg, hists=hists) for s in range(S)]
    tdata, _, model = _port_world(data, _scenario(nets, 0), params, "mlp",
                                  8)
    stacked = convert.network_from_numpy(
        **{f: np.asarray(getattr(nets, f)) for f in NET_FIELDS})
    fcfg = tfed.FLConfig(**fl, events=tev.EventConfig(**EVENTS),
                         faults=tf.FaultConfig(**EVENT_FAULTS))
    kw = dict(model=model, data=tdata, wcfg=tw.WirelessConfig(),
              scfg=tsch.SchedulerConfig(sub2=tbw.Sub2Params.fast(),
                                        **EVENT_SCHED), device="cpu")
    batch = tfed.run_federated_batch(
        nets=stacked, seeds=list(range(S)), draws=tfed._stack_tapes(tapes),
        fcfg=dataclasses.replace(fcfg, telemetry=telemetry.TelemetryConfig()),
        **kw)
    with_log = tev.run_events(net=stacked, seed=list(range(S)),
                              draws=tfed._stack_tapes(tapes), fcfg=fcfg,
                              **kw)
    singles = [tev.run_events(
        net=stacked.scenario(s), seed=s, draws=tapes[s],
        fcfg=dataclasses.replace(fcfg, telemetry=telemetry.TelemetryConfig()),
        **kw) for s in range(S)]
    return (jax.device_get(jparams), jax.device_get(jmet), batch, with_log,
            singles)


def test_event_batch_scenarios_match_the_reference_batch(event_batch):
    """Per scenario the event driver's tolerances
    (tests/test_torch_events.py): equal selections, drops, DAS iterations,
    landed counts and tick lengths; energy and ``0.5 E + 0.5 T`` at
    rtol 5e-3; params at 1e-4.  Some flush applies a stale update."""
    jparams, jmet, (tparams, tmet, _), (_, _, log), _ = event_batch
    recs = tfed.batch_metrics_to_records(tmet)
    assert tuple(tmet.selected.shape) == (S, EVENTS["num_events"], 8)
    for s in range(S):
        assert all(r.round_time == np.float32(0.02) for r in recs[s])
        assert_runs_agree(_scenario(jmet, s), recs[s], _scenario(jparams, s),
                          {n: t[s] for n, t in tparams.items()}, atol=1e-4,
                          obj_rtol=5e-3)
    assert any(f and tau > 0.0 for s in range(S)
               for f, tau in zip(log.flushed[s], log.tau_mean[s]))
    assert len({tuple(f) for f in log.flushed}) > 1, \
        "every scenario flushed on the same events"
    assert any(r.n_success < r.n_selected for rs in recs for r in rs)


def test_event_batch_scenario_is_its_single_run_bitwise(event_batch):
    """Scenario s of the batch against ``run_events`` on its own tape:
    params, records, the buffer's log and every frame leaf bit for bit."""
    _, _, (tparams, tmet, tframes), (lparams, lmet, log), singles = \
        event_batch
    recs = tfed.batch_metrics_to_records(tmet)
    for n in tparams:
        assert torch.equal(tparams[n], lparams[n])
    for f in dataclasses.fields(tmet):
        assert torch.equal(getattr(tmet, f.name), getattr(lmet, f.name))
    for s, (ps, rs, ls, fs) in enumerate(singles):
        for n in ps:
            assert torch.equal(tparams[n][s], ps[n]), (s, n)
        for a, b in zip(recs[s], rs):
            assert dataclasses.astuple(a)[:6] == dataclasses.astuple(b)[:6]
            np.testing.assert_array_equal(a.selected, b.selected)
            assert (a.iterations, a.n_success, a.n_dropped) == \
                (b.iterations, b.n_success, b.n_dropped)
        for field in dataclasses.fields(ls):
            assert getattr(log, field.name)[s] == getattr(ls, field.name)
        assert set(fs) == set(tframes)
        for name, t in fs.items():
            assert torch.equal(tframes[name][s], t), (s, name)


def test_event_batch_with_as_many_scenarios_as_devices():
    """S == K = 4: each scenario's diurnal phase goes with its own
    jitter row (a plain ``(S,) + (S, K)`` broadcast would pair scenario
    phases with devices), so the batch is each single run bit for bit;
    the scenarios' availability differs."""
    k = 4
    from repro_torch.data import partition as tpart
    from repro_torch.data import synthetic as tsyn
    timgs, tlabels = tsyn.generate(0, samples_per_class=100)
    data = tpart.partition(timgs, tlabels, seed=1, spec=tpart.PartitionSpec(
        num_devices=k, num_shards=16, shard_size=50))
    model = tnets.init(tnets.PaperNetSpec(kind="mlp", mlp_hidden=8),
                       torch.Generator().manual_seed(1))
    wcfg = tw.WirelessConfig()
    nets = tw.sample_networks(torch.Generator().manual_seed(6), k, k, wcfg)
    seeds = tfed.scenario_seeds(9, 0, k)
    fcfg = tfed.FLConfig(num_rounds=2, batch_size=50, learning_rate=0.1,
                         events=tev.EventConfig(**dict(
                             EVENTS, num_events=4, phase_spread=2.0)),
                         telemetry=telemetry.TelemetryConfig())
    kw = dict(model=model, data=data, wcfg=wcfg, fcfg=fcfg,
              scfg=tsch.SchedulerConfig(method="das", n_min=1,
                                        iterations_max=3,
                                        allocator="waterfilling"),
              device="cpu")
    pb, mb, log, fb = tev.run_events(net=nets, seed=seeds, **kw)
    avail = []
    for s in range(k):
        ps, rs, ls, fs = tev.run_events(net=nets.scenario(s), seed=seeds[s],
                                        **kw)
        for n in ps:
            assert torch.equal(pb[n][s], ps[n]), (s, n)
        assert [r.n_selected for r in rs] == mb.n_selected[s].tolist()
        assert log.flushed[s] == ls.flushed
        for name, t in fs.items():
            assert torch.equal(fb[name][s], t), (s, name)
        avail.append(fs["avail"])
    assert len({tuple(a.reshape(-1).tolist()) for a in avail}) > 1


def test_event_batch_on_card_matches_the_cpu(cuda_device):
    """On the card (needs a CUDA device), TF32 off: S = 3 scenarios of
    the asynchronous event batch with a binding cap, the bf16 carry,
    streaming, faults and telemetry, against the same run on the CPU
    from one tape: per scenario equal selections, delivered and dropped
    counts and flushes; params within 1e-3 (the bf16 carry's card-vs-CPU
    limit); the event frame's masks equal and floats within 1e-4;
    ``fedavg_agg_stale`` launched once an event for all scenarios."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k, s, events = 8, S, EVENTS["num_events"]
    from repro_torch.data import partition as tpart
    from repro_torch.data import synthetic as tsyn
    imgs, labels = tsyn.generate(0, samples_per_class=200)
    data = tpart.partition(imgs, labels, seed=1, spec=tpart.PartitionSpec(
        num_devices=k, num_shards=36, shard_size=50))
    model = tnets.init(tnets.PaperNetSpec(kind="mlp", mlp_hidden=8),
                       torch.Generator().manual_seed(1))
    wcfg = tw.WirelessConfig()
    nets = tw.sample_networks(torch.Generator().manual_seed(2), s, k, wcfg)
    fcfg = tfed.FLConfig(num_rounds=2, batch_size=50, learning_rate=0.1,
                         use_kernel_agg=True, stream=tst.StreamConfig(),
                         faults=tf.FaultConfig(**EVENT_FAULTS),
                         dispatch_cap=3, carry_dtype="bfloat16",
                         events=tev.EventConfig(**EVENTS),
                         telemetry=telemetry.TelemetryConfig())
    seeds = tfed.scenario_seeds(3, 0, s)
    draws = tfed.draw_tapes(seeds, nets, events, data.capacity,
                            tfed._max_local_steps(fcfg, data.capacity), 50,
                            fcfg, tfed.client_histograms(data, 10))
    kw = dict(model=model, data=data, net=nets, wcfg=wcfg, fcfg=fcfg,
              scfg=tsch.SchedulerConfig(sub2=tbw.Sub2Params.fast(),
                                        **EVENT_SCHED),
              seed=seeds, draws=draws)
    before = tagg.fedavg_agg_stale.launches
    pg, mg, lg, fg = tev.run_events(device=cuda_device, **kw)
    assert tagg.fedavg_agg_stale.launches == before + events
    pc, mc, lc, fc = tev.run_events(device="cpu", **kw)
    assert lg.flushed == lc.flushed
    for name in ("selected", "n_success", "n_dropped"):
        assert torch.equal(getattr(mg, name).cpu(), getattr(mc, name))
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], rtol=0, atol=1e-3)
    for name in ("avail", "free", "in_flight", "buffer_fill", "flushed",
                 "model_version", "staleness_tau"):
        assert torch.equal(fg[name].cpu(), fc[name]), name
    torch.testing.assert_close(fg["clock"].cpu(), fc["clock"], rtol=0,
                               atol=1e-4)
