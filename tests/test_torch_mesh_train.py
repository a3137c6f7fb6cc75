"""Training on a device mesh: the port's DTensor train steps against the
JAX reference on the same mesh and against the port on one device.

Cases at ``reduced(num_layers=2)`` in f32 compute (jamba at its reduced
period), each two steps from one seed's weights with each optimizer of
``_torch_mesh_train_ranks.optimizers``: SGD with momentum (lr 0.1,
global-norm clipping at 10, active for jamba) and AdamW (lr 1e-4 with
warmup, clipping at 1 active):

* the plain step (``make_train_step``) on h2o-danube-3-4b with GQA (4
  query heads on 2 KV heads), qwen3-moe-235b-a22b (``dense_grouped``,
  experts on ``model``, the aux loss), jamba (Mamba, attention, MoE),
  xlstm-125m (sLSTM, mLSTM), qwen3-14b with 6 query heads on 3 KV heads
  (K/V repeated, the heads uneven on the 4-way axis: a rank with no
  head) and whisper-small with its 12 heads and ``encoder_inputs`` (the
  encoder and cross-attention on the mesh); B = 4, 16 tokens (whisper:
  24 frames);
* danube's plain step with ``microbatches=2``;
* the federated step (``make_federated_train_step``) on danube and
  xlstm-125m: K = 4 clients of 2 x 16 tokens, clients 0, 2 and 3
  selected with sizes 100 / 999 / 300 / 40 (the reference test's case,
  one client more), the one-device port in passes of 2.

The meshes are (data=2, model=2) and (data=1, model=4).  The port runs
as 4 gloo ranks a mesh (``tests/_torch_mesh_train_ranks.py``,
subprocesses with a ``FileStore`` here), the reference in a subprocess
a mesh with 4 forced host devices and ``AxisType.Auto`` axes, its
parameters and moments placed by its ``param_specs``; the one-device
port runs here.  With SGD, the parameters, the first moment and the
step count must lie within 1e-4 (absolute, the train steps' f32 limit)
of the reference's (which runs SGD alone), the median parameter leaf
having moved by more than ten times that limit; with either optimizer,
within 1e-5 of the one-device port's.  Each step's metrics are held to
the same limits relative to their size.  Every parameter and moment
(AdamW's two, SGD's one) must be laid out by the reference's
``param_specs``.  The weights checkpointed from the mesh (gathered,
rank 0 writing) must be the one-device file byte for byte.  AdamW's
parameters are not held to the reference: AdamW moves a parameter by
about its rate whatever the gradient, and by up to twice the rate where
a near-zero gradient's sign follows the order of a sum, so at a rate
whose steps pass 1e-4 the two sums' last bits decide, and at a lower
rate no update could fail the check (``optimizers``).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_train_ranks as train_ranks  # noqa: E402
import _torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_torch_mesh_train_ranks.py")
REF_TOL = 1e-4
ONE_DEVICE_TOL = 1e-5
# The median parameter leaf's largest change over the steps, with SGD,
# at least this many times REF_TOL: the comparison sees the updates.
MOVED = 10
B, S, S_ENC, K, STEPS = 4, 16, 24, 4, 2
MESHES = ((2, 2), (1, 4))
SELECTED = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
SIZES = np.array([100.0, 999.0, 300.0, 40.0], np.float32)


def _case(arch, over, kind="plain", microbatches=1):
    return dict(arch=arch, over=over, kind=kind, microbatches=microbatches)


DANUBE = ("h2o_danube_3_4b", dict(num_layers=2, num_kv_heads=2))
XLSTM = ("xlstm_125m", dict(num_layers=2))
CASES = {
    "danube_gqa": _case(*DANUBE),
    "qwen3_moe": _case("qwen3_moe_235b_a22b", dict(num_layers=2)),
    "jamba": _case("jamba_1_5_large_398b", {}),
    "xlstm": _case(*XLSTM),
    "uneven_heads": _case("qwen3_14b",
                          dict(num_layers=2, num_heads=6, num_kv_heads=3)),
    "whisper": _case("whisper_small",
                     dict(num_layers=2, num_heads=12, num_kv_heads=12)),
    "danube_microbatches": _case(*DANUBE, microbatches=2),
    "danube_federated": _case(*DANUBE, kind="federated"),
    "xlstm_federated": _case(*XLSTM, kind="federated"),
}

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    jax.devices()              # the backend holds 4 devices from here on
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs, optim
    from repro.launch import steps
    from repro.sharding import params as sharding_params

    n_data, n_model, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[5]
    mesh = jax.make_mesh((n_data, n_model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ocfg = optim.OptimizerConfig(**json.loads(sys.argv[4]))

    def unflatten(flat):
        tree = {}
        for key, value in flat.items():
            node = tree
            *head, last = key.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = value
        return tree

    def flat(tree, prefix):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, prefix + "/" + k))
            return out
        return {prefix: tree}

    def as_list(spec, ndim):
        return [e if e is None or isinstance(e, str) else list(e)
                for e in tuple(spec) + (None,) * (ndim - len(spec))]

    def run(cfg, case, data, mesh):
        params = unflatten({k[2:]: jnp.asarray(v) for k, v in data.items()
                            if k.startswith("p/")})
        opt = optim.init_state(params, ocfg)
        specs = sharding_params.param_specs(params, cfg, mesh)
        def place(tree):
            return jax.tree_util.tree_map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                tree, specs)
        params = place(params)
        opt = {k: jax.device_put(v, NamedSharding(mesh, P()))
               if k == "count" else place(v) for k, v in opt.items()}
        if case["kind"] == "federated":
            step = steps.make_federated_train_step(
                cfg, ocfg, mesh, data["inputs"].shape[1])
        else:
            step = steps.make_train_step(cfg, ocfg, mesh,
                                         case["microbatches"])
        step = jax.jit(step)
        state, out = {"params": params, "opt": opt}, {}
        for i in range(data["inputs"].shape[0]):
            batch = {k: jnp.asarray(data[k][i])
                     for k in ("inputs", "labels", "encoder_inputs")
                     if k in data}
            if case["kind"] == "federated":
                batch["selected"] = jnp.asarray(data["selected"])
                batch["sizes"] = jnp.asarray(data["sizes"])
            state, metrics = step(state, batch)
            out.update({f"step{i}/{k}": v for k, v in metrics.items()})
        out.update(flat(state["params"], "params"))
        for name in ("mu", "nu"):
            if name in state["opt"]:
                out.update(flat(state["opt"][name], name))
        out["count"] = state["opt"]["count"]
        return {k: np.asarray(v) for k, v in out.items()}

    for name, case in json.loads(sys.argv[3]).items():
        cfg = configs.get(case["arch"]).reduced(**case["over"])
        data = dict(np.load(os.path.join(out_dir, name + ".npz")))
        shapes = unflatten({k[2:]: v for k, v in data.items()
                            if k.startswith("p/")})
        specs = {}
        for tree in ("params", "mu", "nu"):
            specs.update({k: as_list(s, data["p" + k[len(tree):]].ndim)
                          for k, s in flat(sharding_params.param_specs(
                              shapes, cfg, mesh), tree).items()})
        out = run(cfg, case, data, mesh)
        stem = os.path.join(out_dir, f"ref_{n_data}x{n_model}_{name}")
        np.savez(stem + ".npz", **out)
        with open(stem + ".json", "w") as f:
            json.dump(specs, f)
""")


def _flatten(tree, prefix="p"):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.numpy()}


def _data(name: str, case: dict, cfg, rng) -> dict:
    """A case's steps' batches: (STEPS, B, S) token inputs and labels
    (federated: (STEPS, K, B / 2, S) and the selections and sizes);
    whisper's (STEPS, B, S_ENC, D) frame embeddings."""
    lead = (STEPS, K, B // 2) if case["kind"] == "federated" else (STEPS, B)
    out = {k: rng.integers(0, cfg.vocab_size, lead + (S,)).astype(np.int32)
           for k in ("inputs", "labels")}
    if cfg.is_encdec:
        out["encoder_inputs"] = rng.standard_normal(
            (STEPS, B, S_ENC, cfg.d_model)).astype(np.float32)
    if case["kind"] == "federated":
        out.update(selected=SELECTED, sizes=SIZES)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write each case's weights and batches, run the reference (one
    subprocess a mesh) and the port (4 gloo ranks a mesh) at once, and
    the port on one device here.  Returns the directory, the one-device
    outputs and the one-device checkpoint's bytes."""
    out_dir = str(tmp_path_factory.mktemp("mesh_train"))
    rng = np.random.default_rng(0)
    for i, (name, case) in enumerate(CASES.items()):
        cfg = ranks.config(case["arch"], case["over"])
        params = transformer.init(torch.Generator().manual_seed(i), cfg)
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 **_data(name, case, cfg, rng), **_flatten(params))
    cases = json.dumps(CASES)
    ocfg = train_ranks.optimizers()["sgd"]
    ocfg_json = json.dumps({f: getattr(ocfg, f) for f in (
        "name", "momentum", "learning_rate", "warmup_steps", "grad_clip")})
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for d, m in MESHES:
        ref_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(d), str(m), cases,
             ocfg_json, out_dir], env=ref_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        store = os.path.join(out_dir, f"store_{d}x{m}")
        procs += [subprocess.Popen(
            [sys.executable, RANKS, str(r), store, str(d), str(m), cases,
             out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(d * m)]
    one = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, case in CASES.items():
            cfg = ranks.config(case["arch"], case["over"])
            data = dict(np.load(os.path.join(out_dir, f"{name}.npz")))
            params = train_ranks.load(data, cfg)
            for opt, ocfg in train_ranks.optimizers().items():
                state, metrics = train_ranks.train(params, data, cfg, case,
                                                   ocfg, None)
                one[name, opt] = train_ranks.outputs(state, metrics,
                                                     None)[0]
        ckpt = os.path.join(out_dir, "one_device_ckpt.msgpack")
        msgpack_ckpt.save(ckpt, params, meta={"case": name})
        with open(ckpt, "rb") as f:
            ckpt_bytes = f.read()
    finally:
        torch.set_num_threads(threads)
        errors = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode:
                errors.append(err[-3000:])
    assert not errors, "\n---\n".join(errors)
    return out_dir, one, ckpt_bytes


def _load(out_dir, who, mesh, name):
    stem = os.path.join(out_dir, f"{who}_{mesh[0]}x{mesh[1]}_{name}")
    with open(stem + ".json") as f:
        return dict(np.load(stem + ".npz")), json.load(f)


def _errors(got: dict, want: dict) -> dict:
    """Each key's error: the largest absolute difference for the state's
    leaves, relative to the value's size for the metrics."""
    assert set(got) == set(want)
    out = {}
    for k in want:
        g, w = (np.asarray(x, np.float64) for x in (got[k], want[k]))
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max()) if g.size else 0.0
        out[k] = (err / max(float(np.abs(w).max()), 1.0)
                  if k.startswith("step") else err)
    return out


OPTS = tuple(train_ranks.optimizers())
IDS = [f"{n}-{d}x{m}" for (d, m) in MESHES for n in CASES]
PARAMS = [(n, mesh) for mesh in MESHES for n in CASES]
OPT_IDS = [f"{i}-{o}" for i in IDS for o in OPTS]
OPT_PARAMS = [(n, mesh, o) for n, mesh in PARAMS for o in OPTS]


@pytest.mark.parametrize("name,mesh", PARAMS, ids=IDS)
def test_mesh_train_matches_reference_on_its_mesh(runs, name, mesh):
    """With SGD: parameters, the first moment, count and metrics after
    two steps within 1e-4 of the reference on the same mesh, the median
    parameter leaf having moved by more than ten times that."""
    out_dir = runs[0]
    port, _ = _load(out_dir, "port", mesh, f"{name}_sgd")
    ref, _ = _load(out_dir, "ref", mesh, name)
    errs = _errors(port, ref)
    assert max(errs.values()) <= REF_TOL, {
        k: e for k, e in errs.items() if e > REF_TOL}
    start = np.load(os.path.join(out_dir, f"{name}.npz"))
    moved = [float(np.abs(v - start["p" + k[len("params"):]]).max())
             for k, v in ref.items() if k.startswith("params/")]
    assert np.median(moved) > MOVED * REF_TOL, sorted(moved)


@pytest.mark.parametrize("name,mesh,opt", OPT_PARAMS, ids=OPT_IDS)
def test_mesh_train_matches_one_device(runs, name, mesh, opt):
    """The same outputs within 1e-5 of the port's step without a mesh."""
    out_dir, one, _ = runs
    port, _ = _load(out_dir, "port", mesh, f"{name}_{opt}")
    errs = _errors(port, one[name, opt])
    assert max(errs.values()) <= ONE_DEVICE_TOL, {
        k: e for k, e in errs.items() if e > ONE_DEVICE_TOL}


@pytest.mark.parametrize("name,mesh,opt", OPT_PARAMS, ids=OPT_IDS)
def test_mesh_train_placements_are_param_specs(runs, name, mesh, opt):
    """Every parameter and each moment of it stay laid out by the
    reference's ``param_specs`` after the steps."""
    out_dir = runs[0]
    _, port = _load(out_dir, "port", mesh, f"{name}_{opt}")
    _, specs = _load(out_dir, "ref", mesh, name)
    trees = ("params", "mu") if opt == "sgd" else ("params", "mu", "nu")
    specs = {k: s for k, s in specs.items() if k.split("/")[0] in trees}
    assert set(port) == set(specs)
    differ = {k: (port[k], s) for k, s in specs.items() if port[k] != s}
    assert not differ, differ


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_checkpoint_is_the_one_device_file(runs, mesh):
    """``msgpack_ckpt.save`` of DTensor weights (gathered, rank 0 alone
    writing) is byte for byte the file of the same weights on one
    device."""
    out_dir, _, want = runs
    with open(os.path.join(out_dir, f"port_{mesh[0]}x{mesh[1]}_"
                           f"ckpt.msgpack"), "rb") as f:
        assert f.read() == want


def test_federated_step_on_a_mesh_takes_a_client_a_pass():
    """On a mesh the federated step runs one client a pass (autograd a
    client): a larger ``clients_per_pass`` raises rather than being
    dropped."""
    cfg = ranks.config(*XLSTM)
    ocfg = train_ranks.optimizers()["sgd"]
    with pytest.raises(ValueError, match="one client a pass"):
        steps.make_federated_train_step(cfg, ocfg, K, 2, mesh=object())
