"""The port's dry-run planner against the JAX reference's.

* ``launch.specs.input_specs`` for every applicable (arch, shape) on
  both production meshes (68 triples) against ``repro.launch.specs``
  on ``AbstractMesh`` meshes: shapes, dtypes, specs and shard shapes.
* ``launch.dryrun.lower_one`` against the reference's compiled records:
  the reference runs in a subprocess with 4 forced host devices on a
  2x2 mesh with Auto axes (its ``jax.make_mesh`` defaults to Explicit
  axes on jax 0.9, where the embedding gather raises), built here
  because the JAX package is not edited.  ``argument_size_in_bytes`` is
  held equal, byte for byte; the FLOPs within FLOP_RTOL at one layer
  group, where XLA's ``cost_analysis`` counts every layer (it counts a
  ``scan`` body once).  What the counts leave out: the port counts
  matrix products only, XLA elementwise operations too (the port reads
  0.7 % low at qwen3-14b train, 1.4 % at its decode).  The reference's
  MoE dispatch multiplies one-hot tensors (``dense_grouped``'s einsums:
  per group of gs tokens, dispatch and combine 2 gs E cap D each in the
  forward, three more in the backward, and the combine weights 2 gs k E
  cap twice), which the port's gathers replace: those products are
  added to the port's count before it is held (without them it reads
  49 % low).
* The collective plan by a hand count; the sLSTM stand-in against the
  loop it stands in for; the CLI, ``hillclimb`` and the demo on reduced
  configurations.
"""

import json
import os
import runpy
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MESH22 = mesh_lib.Mesh(("data", "model"), (2, 2))
FLOP_RTOL = 0.02
# (arch, kind, batch, seq): the configurations held against the
# reference's compiled program, at reduced() widths and one layer group.
CASES = (("qwen3_14b", "train", 8, 128), ("qwen3_14b", "decode", 8, 256),
         ("qwen3_moe_235b_a22b", "train", 8, 128),
         ("whisper_small", "decode", 8, 256),
         ("xlstm_125m", "decode", 8, 256))
FLOP_CASES = CASES[:3]
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_axes", "num_devices", "cost",
               "memory", "memory_mb1", "collectives", "lower_s",
               "compile_s", "microbatches"}


@pytest.fixture(autouse=True)
def one_thread():
    """Shapes only: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _small(arch):
    """One layer group at reduced() widths (whisper: one encoder layer
    too, which the reference also scans)."""
    kw = {"encoder_layers": 1} if arch == "whisper_small" else {}
    return tconfigs.get(arch).reduced(**kw)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_input_specs_match_the_reference(arch, multi_pod):
    jm = MESHES[multi_pod]
    tm = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    n = 0
    for shape in jshapes.SHAPES:
        if not jshapes.applicable(jcfg, shape)[0]:
            continue
        n += 1
        want = _flat(jspecs.input_specs(jcfg, shape, jm))
        got = _flat(tspecs.input_specs(
            tcfg, tshapes.get_shape(shape.name), tm))
        assert got.keys() == want.keys(), shape.name
        for k, w in want.items():
            spec = w.sharding.spec if w.sharding is not None else ()
            sharding = NamedSharding(jm, w.sharding.spec) \
                if w.sharding is not None else None
            g = got[k]
            assert g.shape == tuple(w.shape), (shape.name, k)
            assert str(g.dtype) == f"torch.{w.dtype}", (shape.name, k)
            assert tuple(g.spec) == tuple(spec), (shape.name, k)
            if sharding is not None:
                assert g.shard_shape(tm) == tuple(
                    sharding.shard_shape(w.shape)), (shape.name, k)
    assert n == (4 if tcfg.supports_long_context() else 3)


_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    jax.devices()              # the backend holds 4 devices from here on
    from jax.sharding import AxisType
    from repro import configs
    from repro.configs import shapes
    from repro.launch import dryrun
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = []
    for arch, kind, batch, seq in json.loads(sys.argv[1]):
        kw = {"encoder_layers": 1} if arch == "whisper_small" else {}
        cfg = configs.get(arch).reduced(**kw)
        rec = dryrun.lower_one(cfg, shapes.InputShape("t", seq, batch, kind),
                               mesh, verbose=False)
        out.append(rec)
    print(json.dumps(out, default=float))
""")


@pytest.fixture(scope="module")
def reference_records():
    """The reference's compiled records of CASES (about 10 s)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    got = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(CASES)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    return dict(zip(CASES, json.loads(got.stdout.strip().splitlines()[-1])))


def _port_record(case):
    arch, kind, batch, seq = case
    return dryrun.lower_one(_small(arch), tshapes.InputShape(
        "t", seq, batch, kind), MESH22, verbose=False)


def _onehot_dispatch_flops(cfg, tokens):
    """The products of the reference's one-hot MoE dispatch and combine
    (``dense_grouped``) in one training step, over all MoE layers."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    gs = min(cfg.moe_group_size, tokens)
    gs = tokens if tokens % gs else gs
    cap = max(int(gs * k * cfg.moe_capacity_factor / e), min(gs * k, 16))
    per_group = (5 * 2 * gs * e * cap * cfg.d_model
                 + 2 * 2 * gs * k * e * cap)
    layers = cfg.num_groups * sum(s.ffn == "moe" for s in cfg.pattern)
    return layers * (tokens // gs) * per_group


@pytest.mark.parametrize("case", CASES, ids=[f"{a}-{k}" for a, k, *_ in CASES])
def test_lower_one_arguments_equal_the_reference(reference_records, case):
    """The record's keys, and the per-device argument bytes equal to the
    byte: parameters, optimizer state, batch (train); parameters the
    step reads, tokens, the position where attention reads it, cache
    (decode: whisper's encoder and xLSTM's unread position are dropped,
    as XLA drops them)."""
    want = reference_records[case]
    got = _port_record(case)
    assert set(got) == set(want) == RECORD_KEYS
    assert got["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    assert (got["mesh"], got["mesh_axes"], got["num_devices"],
            got["microbatches"]) == (want["mesh"], want["mesh_axes"],
                                     want["num_devices"],
                                     want["microbatches"])
    assert set(got["memory"]) >= {"argument_size_in_bytes"}
    assert set(got["collectives"]) == set(want["collectives"])
    assert set(got["collectives"]["counts"]) == \
        set(want["collectives"]["counts"])


@pytest.mark.parametrize("case", FLOP_CASES,
                         ids=[f"{a}-{k}" for a, k, *_ in FLOP_CASES])
def test_lower_one_flops_near_the_reference(reference_records, case):
    want = reference_records[case]["cost"]["flops"]
    got = _port_record(case)["cost"]["flops"]
    arch, kind, batch, seq = case
    cfg = _small(arch)
    if cfg.is_moe:
        got += _onehot_dispatch_flops(cfg, batch * seq) / MESH22.size
    assert abs(got / want - 1.0) < FLOP_RTOL, (got, want)


def test_collective_plan_hand_count():
    """qwen3-14b at reduced() widths and one layer (d 256, 4 heads of 64,
    d_ff 512, vocab 512, f32), training 8 x 16 tokens on 2x2 (data,
    model): 64 tokens a device."""
    cfg = tconfigs.get("qwen3_14b").reduced()
    rec = dryrun.lower_one(cfg, tshapes.InputShape("t", 16, 8, "train"),
                           MESH22, verbose=False)
    f32 = 4
    # FSDP leaves: wq wk wv and the attention's wo (256 x 256), wi wg
    # (256 x 512), the MLP's wo (512 x 256); each shard a quarter.
    shards = [256 * 256 * f32 // 4] * 4 + [256 * 512 * f32 // 4] * 3
    gathered = 2 * sum(shards) * 2          # twice, each over data = 2
    scattered = sum(shards)
    # Gradients all-reduced over data: the token table and lm_head
    # (halves of 512 x 256 over model), norm1, norm2, final_norm (256),
    # q_norm, k_norm (64).
    grads = 2 * (256 * 256 * f32) + 3 * 256 * f32 + 2 * 64 * f32
    # Tensor-parallel all-reduces of 64 x 256 f32 activations: the token
    # lookup, the two wo products (forward), the gradients into wq, wk,
    # wv, wi, wg and the LM head (backward).
    tp = 9 * 64 * 256 * f32
    plan = rec["collectives"]
    assert plan["counts"] == {"all-gather": 14, "all-reduce": 7 + 9,
                              "reduce-scatter": 7, "all-to-all": 0,
                              "collective-permute": 0}
    assert plan["bytes"] == {"all-gather": gathered,
                             "all-reduce": grads + tp,
                             "reduce-scatter": scattered,
                             "all-to-all": 0.0, "collective-permute": 0.0}
    assert plan["total_bytes"] == gathered + grads + tp + scattered
    # Serving reads the weights once and reduces no gradient.
    dec = dryrun.lower_one(cfg, tshapes.InputShape("t", 16, 8, "decode"),
                           MESH22, verbose=False)["collectives"]["counts"]
    assert (dec["all-gather"], dec["reduce-scatter"], dec["all-reduce"]) \
        == (7, 0, 3)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_stand_in_counts_every_step(kind):
    """The meta run's one sLSTM step plus ``slstm_steps_flops`` equals
    the products of the whole loop, counted on CPU tensors."""
    cfg = tconfigs.get("xlstm_125m").reduced()
    shape = tshapes.InputShape("t", 24, 2, kind)
    got = dryrun.lower_one(cfg, shape, mesh_lib.Mesh(("data", "model"),
                                                     (1, 1)),
                           verbose=False)["cost"]["flops"]
    assert dryrun.slstm_steps_flops(cfg, shape) > 0
    gen = torch.Generator().manual_seed(0)
    params = transformer.init(gen, cfg)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
             for k in ("inputs", "labels")}
    ocfg = dryrun.default_optimizer(cfg)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            steps.make_train_step(cfg, ocfg)(
                {"params": params, "opt": optim.init_state(params, ocfg)},
                batch)
        else:
            steps.make_prefill_step(cfg)(params, batch)
    assert got == counter.get_total_flops()


@pytest.fixture
def reduced_zoo(monkeypatch):
    """Every configuration at reduced() widths and every shape at 8 x 64
    tokens, for the CLIs."""
    real_get, real_shape = tconfigs.get, tshapes.get_shape
    monkeypatch.setattr(tconfigs, "get", lambda a: real_get(a).reduced())
    monkeypatch.setattr(tshapes, "get_shape", lambda n: tshapes.InputShape(
        n, 64, 8, real_shape(n).kind))


def test_dryrun_cli_writes_records(reduced_zoo, tmp_path, monkeypatch):
    """``main`` writes a record a pair with its corrected cost, exits 0,
    and exits 1 when a record fails."""
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit) as ok:
        dryrun.main(["--arch", "qwen3-14b", "--out", str(out)])
    assert ok.value.code == 0
    recs = json.loads(out.read_text())
    assert [r["shape"] for r in recs] == ["long_500k", "train_4k",
                                          "prefill_32k", "decode_32k"]
    assert "skipped" in recs[0]
    for r in recs[1:]:
        assert r["cost_corrected"] == r["cost"]
        assert r["mesh"] == "16x16" and r["memory"][
            "argument_size_in_bytes"] > 0

    def fail(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "lower_one", fail)
    with pytest.raises(SystemExit) as bad:
        dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k",
                     "--multi-pod", "--out", str(out)])
    assert bad.value.code == 1
    assert "planted" in json.loads(out.read_text())[0]["error"]


def test_hillclimb_and_demo(reduced_zoo, tmp_path, capsys):
    """Every hill-climb pair with its tag, and the demo's two meshes."""
    out = tmp_path / "h.json"
    hillclimb.main(["--out", str(out), "--pairs", "A,B,C,B2,C2"])
    tags = [r["tag"] for r in json.loads(out.read_text())]
    assert tags == [t for _, t, *_ in hillclimb.PAIRS]
    demo = runpy.run_path(os.path.join(
        ROOT, "examples", "multipod_dryrun_demo_torch.py"))
    demo["main"](["--arch", "qwen3-14b", "--shape", "decode_32k"])
    text = capsys.readouterr().out
    assert "== 16x16 (256 devices) ==" in text
    assert "== 2x16x16 (512 devices) ==" in text
