"""Serving on a device mesh: the port's DTensor path against the JAX
reference on the same mesh and against the port on one device.

Eight cases at ``reduced(num_layers=2)`` in f32 compute (jamba at its
reduced period): h2o-danube-3-4b with GQA (4 query heads on 2 KV heads,
a 16-slot sliding window that the 24-token prompt wraps), qwen2-vl-72b
(embeddings in, M-RoPE), qwen3-moe-235b-a22b (``dense_grouped``, experts
on ``model``), jamba (Mamba, attention, MoE), xlstm-125m (sLSTM, mLSTM),
qwen3-14b with 6 query heads on 3 KV heads, which do not split over
``model``: K/V repeated, the heads uneven on the 4-way axis, the cache
on ``head_dim``; and mixtral-8x22b with 2 experts, expert-parallel on
the 2-way axis and split on ``d_ff`` on the 4-way one; and
whisper-small with its 12 heads (the encoder over 32 frame embeddings,
cross-attention in every decoder block, its K/V in the decode cache).
Each case runs ``forward``, ``prefill`` (B = 2, 24 tokens, padded for 3
more) and 3 ``decode_step`` calls.

The meshes are (data=2, model=2) and (data=1, model=4).  The port runs
as 4 gloo ranks a mesh (``tests/_torch_mesh_ranks.py``, subprocesses
with a ``FileStore`` here and one thread each; this process starts no
group), the reference in a subprocess a mesh with 4 forced host devices
and ``AxisType.Auto`` axes, both from the same weights: one seed's
through the port's ``init`` (the reference's tree, leaf for leaf), as
numpy, to the port through ``convert.transformer_params_from_numpy``
(the reference's own ``init`` would cost some 17 s of this file's
time).
Every output, gathered by ``full_tensor``, must lie within 1e-4 of the
reference's and 1e-5 of the port's on one device, as max-abs error over
the largest magnitude; the logits' and cache leaves' placements must be
the reference's specs (where GSPMD leaves a decode-cache leaf in a
layout no spec names, the port's must equal the prefill cache's).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_torch_mesh_ranks.py")
REF_TOL = 1e-4
ONE_DEVICE_TOL = 1e-5
B, S, STEPS, S_ENC = 2, 24, 3, 32
MESHES = ((2, 2), (1, 4))
CASES = {
    "danube_gqa": ("h2o_danube_3_4b",
                   dict(num_layers=2, num_kv_heads=2, sliding_window=16)),
    "qwen2_vl": ("qwen2_vl_72b", dict(num_layers=2)),
    "qwen3_moe": ("qwen3_moe_235b_a22b", dict(num_layers=2)),
    "jamba": ("jamba_1_5_large_398b", {}),
    "xlstm": ("xlstm_125m", dict(num_layers=2)),
    "uneven_heads": ("qwen3_14b",
                     dict(num_layers=2, num_heads=6, num_kv_heads=3)),
    # 2 experts: expert-parallel on 2x2, each expert's d_ff on 1x4.
    "mixtral_2_experts": ("mixtral_8x22b",
                          dict(num_layers=2, num_experts=2,
                               sliding_window=16)),
    "whisper": ("whisper_small",
                dict(num_layers=2, num_heads=12, num_kv_heads=12)),
}

_REFERENCE = textwrap.dedent("""
    import itertools, json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    jax.devices()              # the backend holds 4 devices from here on
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.models import transformer
    from repro.sharding import params as sharding_params

    n_data, n_model, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[4]
    mesh = jax.make_mesh((n_data, n_model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def spec_of(x):
        sh = x.sharding
        if isinstance(sh, NamedSharding):
            return [e if e is None or isinstance(e, str) else list(e)
                    for e in tuple(sh.spec) + (None,) * (x.ndim - len(sh.spec))]
        for c in itertools.product((None, "data", "model"), repeat=x.ndim):
            named = [e for e in c if e is not None]
            if len(set(named)) == len(named) and sh.is_equivalent_to(NamedSharding(mesh, P(*c)), x.ndim):
                return list(c)
        return None                # no spec names this layout

    def unflatten(flat):
        tree = {}
        for key, value in flat.items():
            node = tree
            *head, last = key.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = value
        return tree

    for name, (arch, over) in json.loads(sys.argv[3]).items():
        cfg = configs.get(arch).reduced(**over)
        data = dict(np.load(os.path.join(out_dir, name + ".npz")))
        params = unflatten({k[2:]: jnp.asarray(v) for k, v in data.items()
                            if k.startswith("p/")})
        specs = sharding_params.param_specs(params, cfg, mesh)
        params = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            params, specs)
        inputs = jnp.asarray(data["inputs"])
        tokens = jnp.asarray(data["tokens"])
        enc = (jnp.asarray(data["encoder_inputs"])
               if "encoder_inputs" in data else None)
        s, steps = inputs.shape[1], tokens.shape[1]
        fwd = jax.jit(lambda p, x: transformer.forward(
            p, x, cfg, mesh, encoder_inputs=enc))
        pre = jax.jit(lambda p, x: transformer.prefill(
            p, x, cfg, mesh, encoder_inputs=enc, pad_to=s + steps))
        dec = jax.jit(lambda p, t, c, i: transformer.decode_step(
            p, t, c, i, cfg, mesh))
        out, got = {}, {}
        logits, aux = fwd(params, inputs)
        out["forward"], out["aux"] = logits, aux
        got["forward"] = spec_of(logits)
        logits, cache = pre(params, inputs)
        out["prefill"], got["prefill"] = logits, spec_of(logits)
        for pos, leaves in cache.items():
            for leaf, t in leaves.items():
                out[f"prefill_cache/{pos}/{leaf}"] = t
                got[f"prefill_cache/{pos}/{leaf}"] = spec_of(t)
        for i in range(steps):
            logits, cache = dec(params, tokens[:, i:i + 1], cache,
                                jnp.int32(s + i))
            out[f"decode{i}"] = logits
        got["decode"] = spec_of(logits)
        for pos, leaves in cache.items():
            for leaf, t in leaves.items():
                out[f"cache/{pos}/{leaf}"] = t
                got[f"cache/{pos}/{leaf}"] = spec_of(t)
        stem = os.path.join(out_dir, f"ref_{n_data}x{n_model}_{name}")
        np.savez(stem + ".npz", **{k: np.asarray(v) for k, v in out.items()})
        with open(stem + ".json", "w") as f:
            json.dump(got, f)
""")


def _flatten(tree, prefix="p"):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.numpy()}


def _inputs(name: str, cfg, rng) -> dict:
    if name == "qwen2_vl":       # the VLM's precomputed patch embeddings
        return {"inputs": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    out = {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encdec:            # whisper's stub frame embeddings
        out["encoder_inputs"] = rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write each case's weights and inputs, run the reference (one
    subprocess a mesh) and the port (4 gloo ranks a mesh) at once, and
    the port on one device here.  Returns the directory and the
    one-device outputs."""
    out_dir = str(tmp_path_factory.mktemp("mesh_serve"))
    rng = np.random.default_rng(0)
    for i, (name, (arch, over)) in enumerate(CASES.items()):
        cfg = ranks.config(arch, over)
        params = transformer.init(torch.Generator().manual_seed(i), cfg)
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 **_inputs(name, cfg, rng),
                 tokens=rng.integers(0, cfg.vocab_size,
                                     (B, STEPS)).astype(np.int32),
                 **_flatten(params))
    cases = json.dumps(CASES)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for d, m in MESHES:
        ref_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(d), str(m), cases,
             out_dir], env=ref_env, stdout=subprocess.PIPE,
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
        for name, (arch, over) in CASES.items():
            cfg = ranks.config(arch, over)
            data = dict(np.load(os.path.join(out_dir, f"{name}.npz")))
            params = ranks.convert.transformer_params_from_numpy(
                ranks.unflatten({k[2:]: v for k, v in data.items()
                                 if k.startswith("p/")}), cfg)
            with torch.no_grad():
                one[name] = ranks.serve(params, data, cfg, None)[0]
    finally:
        torch.set_num_threads(threads)
        errors = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode:
                errors.append(err[-3000:])
    assert not errors, "\n---\n".join(errors)
    return out_dir, one


def _load(out_dir, who, mesh, name):
    stem = os.path.join(out_dir, f"{who}_{mesh[0]}x{mesh[1]}_{name}")
    with open(stem + ".json") as f:
        return dict(np.load(stem + ".npz")), json.load(f)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


IDS = [f"{n}-{d}x{m}" for (d, m) in MESHES for n in CASES]
PARAMS = [(n, mesh) for mesh in MESHES for n in CASES]


@pytest.mark.parametrize("name,mesh", PARAMS, ids=IDS)
def test_mesh_matches_reference_on_its_mesh(runs, name, mesh):
    """Every output (logits of forward, prefill and each decode step, the
    aux loss, the prefill cache and the cache after decode) within 1e-4
    of the reference on the same mesh."""
    out_dir, _ = runs
    port, _ = _load(out_dir, "port", mesh, name)
    ref, _ = _load(out_dir, "ref", mesh, name)
    assert set(port) == set(ref)
    errs = {k: _rel(port[k], ref[k]) for k in ref}
    assert max(errs.values()) <= REF_TOL, {
        k: e for k, e in errs.items() if e > REF_TOL}


@pytest.mark.parametrize("name,mesh", PARAMS, ids=IDS)
def test_mesh_matches_one_device(runs, name, mesh):
    """Every output within 1e-5 of the port run without a mesh."""
    out_dir, one = runs
    port, _ = _load(out_dir, "port", mesh, name)
    assert set(port) == set(one[name])
    errs = {k: _rel(port[k], one[name][k]) for k in port}
    assert max(errs.values()) <= ONE_DEVICE_TOL, {
        k: e for k, e in errs.items() if e > ONE_DEVICE_TOL}


@pytest.mark.parametrize("name,mesh", PARAMS, ids=IDS)
def test_mesh_placements_are_the_references(runs, name, mesh):
    """The logits (batch over data, vocabulary over model) and every
    cache leaf are laid out as the reference lays them out; the decode
    cache stays where prefill put it."""
    out_dir, _ = runs
    _, port = _load(out_dir, "port", mesh, name)
    _, ref = _load(out_dir, "ref", mesh, name)
    assert set(port) == set(ref)
    for key, spec in ref.items():
        if key.startswith("cache/"):
            assert port[key] == port["prefill_" + key], key
            if spec is None:       # GSPMD's layout has no spec
                continue
        assert port[key] == spec, (key, port[key], spec)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_kernel_wrappers_refuse_dtensors(runs, mesh):
    """On a mesh, a DTensor that reaches a kernel wrapper other than
    through flash_attention's mesh entry raises: no quiet plain run."""
    out_dir, _ = runs
    with open(os.path.join(out_dir, f"port_{mesh[0]}x{mesh[1]}_"
                           f"refusals.json")) as f:
        got = json.load(f)
    assert len(got) == 4
    for name, what in got.items():
        assert "not DTensors" in what or "as DTensors" in what, (name, what)


def test_mesh_needs_a_card_unless_asked_for_the_cpu():
    """init_mesh runs on the card by default and raises without one,
    before any process group starts."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_lib.init_mesh(mesh_lib.Mesh(("data", "model"), (1, 1)),
                           dist.HashStore(), 0)
    assert not dist.is_initialized()
