"""The port's dense model zoo against the JAX package.

``repro_torch.models`` (config, common, attention, moe's dense MLP,
transformer) and ``repro_torch.configs`` are held against
``repro.models`` / ``repro.configs`` on the same weights (the
reference's ``init`` converted with
``convert.transformer_params_from_numpy``) and numpy-seeded tokens:
``forward`` logits, ``prefill`` logits and every cache tensor, and
``decode_step``, for the four dense configurations at
``reduced(num_layers=2)`` (f32).  Limit 1e-4 relative to the largest
logit (or cache value): the two frameworks sum matmuls in another
order; about 1e-6 is read.  Attention runs through the
``flash_attention`` wrapper, i.e. its plain version on the CPU.
"""

import ast
import dataclasses
import pathlib
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

DENSE = ("h2o_danube_3_4b", "codeqwen1_5_7b", "qwen3_14b", "stablelm_12b")
MOE_HYBRID = ("mixtral_8x22b", "qwen3_moe_235b_a22b", "jamba_1_5_large_398b")
TOL = 1e-4
# bf16 compute: the two frameworks round bf16 intermediates at other
# places (matmul outputs, activations; the reference also rounds the
# softmax probabilities before p.v, attention.py:137, where the kernel
# keeps them in f32), and two layers carry that to about 1e-2 of the
# largest logit.  The reference's own decode-parity limit
# (tests/test_models.py).
BF16_TOL = 2e-2
EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "serve_decode_torch.py"


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-6))


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: decode_step later updates the port's cache in place."""
    return t.detach().float().numpy().copy()


def _pair(jcfg, seed: int = 0):
    """The reference's params and the port's copy of them."""
    params = jt.init(jax.random.key(seed), jcfg)
    tcfg = _port_cfg(jcfg)
    tp = convert.transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return params, tp, tcfg


def _port_cfg(jcfg):
    from repro_torch.models.config import LayerSpec, ModelConfig
    fields = dataclasses.asdict(jcfg)
    fields["pattern"] = tuple(LayerSpec(**s) for s in fields["pattern"])
    return ModelConfig(**fields)


def _tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _compiled(fn):
    """``fn`` (a reference entry point; its configuration and keyword
    arguments static) compiled with ``jax.jit`` at its first call's
    shapes, without XLA's excess precision: so compiled, bf16 rounds
    after each operation as the eager reference and the port do."""
    held = {}

    def call(*args, **kw):
        static = [i for i, a in enumerate(args) if isinstance(a, JConfig)]
        if not held:
            held["fn"] = jax.jit(fn, static_argnums=static,
                                 static_argnames=tuple(kw)).lower(
                *args, **kw).compile(compiler_options={
                    "xla_allow_excess_precision": False})
        return held["fn"](*[a for i, a in enumerate(args)
                            if i not in static])
    return call


def _run_both(jcfg, b=2, s=37, gen_pad=8, seed=0, steps=1, serving=False,
              jit=False):
    """forward / prefill / ``steps`` decode_steps of both on one set of
    weights (the port's through ``serving_params`` if ``serving``; the
    reference's compiled with ``jax.jit`` if ``jit``, which compiles a
    hybrid stack in a few seconds where op-by-op dispatch compiles each
    operation's shapes): ``decode`` the first step, ``decodes`` every
    step, ``aux`` the forward's MoE aux loss."""
    params, tp, tcfg = _pair(jcfg, seed)
    if serving:
        tp = tt.serving_params(tp, tcfg)
    fwd, pre, dec = jt.forward, jt.prefill, jt.decode_step
    if jit:
        fwd, pre, dec = _compiled(fwd), _compiled(pre), _compiled(dec)
    full = _tokens(jcfg.vocab_size, b, s + steps, seed + 1)
    tfull = torch.from_numpy(full).long()
    out = {}
    jf, jaux = fwd(params, jnp.asarray(full), jcfg)
    tf, taux = tt.forward(tp, tfull, tcfg)
    out["forward"], out["aux"] = (jf, tf), (jaux, taux)
    jl, jc = pre(params, jnp.asarray(full[:, :s]), jcfg, pad_to=s + gen_pad)
    tl, tc = tt.prefill(tp, tfull[:, :s], tcfg, pad_to=s + gen_pad)
    out["prefill"] = (jl, tl)
    out["cache"] = {f"{pos}/{k}": (np.asarray(jc[pos][k]), _np(tc[pos][k]))
                    for pos in jc for k in jc[pos]}
    out["decodes"] = []
    for i in range(steps):
        jd, jc = dec(params, jnp.asarray(full[:, s + i:s + i + 1]), jc,
                     jnp.asarray(s + i), jcfg)
        td, _ = tt.decode_step(tp, tfull[:, s + i:s + i + 1], tc, s + i,
                               tcfg)
        out["decodes"].append((jd, td))
    out["decode"] = out["decodes"][0]
    return out


@pytest.fixture(scope="module")
def dense_runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _run_both(jconfigs.get(arch).reduced(num_layers=2))
        return cache[arch]
    return get


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_reference(arch):
    """The port's copies of the configuration modules: every field, at
    full width and reduced, and the registry's aliases."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.supports_long_context() == j.supports_long_context()
    assert tconfigs.canonical(j.name) == jconfigs.canonical(j.name) == arch
    for shape in jshapes.SHAPES:
        assert tshapes.applicable(t, tshapes.get_shape(shape.name)) == \
            jshapes.applicable(j, shape)


@pytest.mark.parametrize("arch", DENSE + MOE_HYBRID)
def test_param_count_matches_reference(arch):
    """Total and (MoE: top-k of E experts) active parameters."""
    assert tt.param_count(tconfigs.get(arch)) == \
        jt.param_count(jconfigs.get(arch))
    assert tt.active_param_count(tconfigs.get(arch)) == \
        jt.active_param_count(jconfigs.get(arch))


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    x, scale, bias = _x((3, 5, 48), 1), _x((48,), 2), _x((48,), 3)
    if norm == "rmsnorm":
        want = jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
        got = tcommon.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale),
                              1e-6)
    else:
        want = jcommon.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5)
        got = tcommon.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fraction,hd", [(1.0, 64), (0.25, 160)])
def test_rope_matches_reference(fraction, hd):
    """Full and partial rotary (stablelm's 25 %), interleaved pairs."""
    pos = np.tile(np.arange(40)[None], (2, 1)) + np.array([[0], [300]])
    x = _x((2, 40, 3, hd), 4)
    js, jc = jcommon.rope_sin_cos(jnp.asarray(pos), hd, 1e4, fraction)
    ts, tc = tcommon.rope_sin_cos(torch.from_numpy(pos), hd, 1e4, fraction)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    want = jcommon.apply_rope(jnp.asarray(x), js, jc)
    got = tcommon.apply_rope(torch.from_numpy(x), ts, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The model, the four dense configurations at reduced size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(dense_runs, arch):
    want, got = dense_runs(arch)["forward"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_reference(dense_runs, arch):
    run = dense_runs(arch)
    want, got = run["prefill"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL
    for name, (w, g) in run["cache"].items():
        assert g.shape == w.shape, name
        assert _rel(w, g) < TOL, name


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(dense_runs, arch):
    want, got = dense_runs(arch)["decode"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL
    # ... and the reference's own parity: decode == forward at the end.
    fwd = dense_runs(arch)["forward"][0]
    assert _rel(np.asarray(fwd)[:, -1], _np(got)[:, 0]) < TOL


def test_swa_ring_wraparound_matches_reference():
    """tests/test_models.py::test_swa_ring_wraparound: a 100-token prompt
    over a 32-slot ring; the port's ring layout and its decode against
    the reference's."""
    jcfg = jconfigs.get("h2o_danube_3_4b").reduced(sliding_window=32,
                                                   num_layers=2)
    run = _run_both(jcfg, b=1, s=100, seed=3)
    for name, (w, g) in run["cache"].items():
        assert g.shape == w.shape == (2, 1, 32, 4, 64), name
        assert _rel(w, g) < TOL, name
    want, got = run["decode"]
    assert _rel(want, _np(got)) < TOL
    assert _rel(np.asarray(run["forward"][0])[:, -1], _np(got)[:, 0]) < TOL


def test_bias_gelu_layernorm_decoder_matches_reference():
    """The MLP's GELU and the projection biases, which no dense config
    of the zoo turns on: whisper's decoder stack as a plain causal
    decoder with RoPE."""
    jcfg = dataclasses.replace(
        jconfigs.get("whisper_small").reduced(num_layers=2),
        encoder_layers=0, cross_attention=False, pos_embedding="rope")
    params = jt.init(jax.random.key(5), jcfg)
    # Non-zero biases, so the test sees them.
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + rng.standard_normal(a.shape).astype(np.float32)
        * 0.1 if str(path[-1].key).startswith("b") else a, params)
    tcfg = _port_cfg(jcfg)
    tp = convert.transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    full = _tokens(jcfg.vocab_size, 2, 30, 6)
    want, _ = jt.forward(params, jnp.asarray(full), jcfg)
    got, _ = tt.forward(tp, torch.from_numpy(full).long(), tcfg)
    assert _rel(want, _np(got)) < TOL
    _, jc = jt.prefill(params, jnp.asarray(full[:, :29]), jcfg, pad_to=32)
    _, tc = tt.prefill(tp, torch.from_numpy(full[:, :29]).long(), tcfg,
                       pad_to=32)
    jd, _ = jt.decode_step(params, jnp.asarray(full[:, 29:]), jc,
                           jnp.asarray(29), jcfg)
    td, _ = tt.decode_step(tp, torch.from_numpy(full[:, 29:]).long(), tc,
                           29, tcfg)
    assert _rel(jd, _np(td)) < TOL


def test_bf16_compute_matches_reference():
    """bf16 activations with f32 weights (the published setting), held at
    BF16_TOL (see there); at f32 the same model agrees to 1e-6."""
    jcfg = jconfigs.get("h2o_danube_3_4b").reduced(
        num_layers=2, dtype_compute="bfloat16")
    run = _run_both(jcfg, b=2, s=45, seed=7)
    for stage in ("forward", "prefill", "decode"):
        want, got = run[stage]
        assert got.dtype == torch.bfloat16
        assert _rel(want, _np(got)) < BF16_TOL, stage


# ---------------------------------------------------------------------------
# The MoE decoders and the Jamba hybrid at reduced size
# ---------------------------------------------------------------------------

# Prompt lengths: mixtral's past its reduced 128-slot window (the ring
# wraps), jamba's two SSD chunks of 64.
MOE_PROMPT = {"mixtral_8x22b": 150, "qwen3_moe_235b_a22b": 37,
              "jamba_1_5_large_398b": 128}
# bf16: the two frameworks round the products' outputs apart by a bf16
# ulp here and there.  Top-k routing turns such a difference into a
# different expert wherever two router probabilities nearly tie, and
# then that token's logits part by far more than any rounding (the
# reference's own bf16 run reads 0.15-0.38 from its f32 run on jamba at
# reduced size); so the bf16 cases route every token to all E experts
# (top-k = E, renormalized: the output is continuous in the router's
# probabilities), whose choice of k the f32 cases hold.  And rounding
# grows with depth: jamba's 8 reduced layers read 5e-2 - 7e-2 apart in
# bf16 even so (the reference's bf16 against its f32: 6.5e-2), so each
# of its three block kinds (attention + MoE, Mamba + MLP, Mamba + MoE)
# runs as a one-layer model.  ``python tests/test_torch_transformer.py``
# prints the readings.
BF16_CASES = {"mixtral_8x22b": None, "qwen3_moe_235b_a22b": None,
              "jamba_1_5_large_398b/attn+moe": 0,
              "jamba_1_5_large_398b/mamba+mlp": 1,
              "jamba_1_5_large_398b/mamba+moe": 2}


def _bf16_cfg(case):
    arch = case.split("/")[0]
    cfg = jconfigs.get(arch).reduced(dtype_compute="bfloat16")
    cfg = dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts)
    pos = BF16_CASES[case]
    if pos is not None:
        cfg = dataclasses.replace(cfg, num_layers=1,
                                  pattern=cfg.pattern[pos:pos + 1])
    return cfg, MOE_PROMPT[arch]


@pytest.fixture(scope="module")
def moe_runs():
    """f32 at ``reduced()``, and the bf16 cases (see BF16_CASES) from the
    serving copy; the reference compiled (``_compiled``)."""
    cache = {}

    def get(case, dtype="float32"):
        if (case, dtype) not in cache:
            if dtype == "float32":
                cfg, s = jconfigs.get(case).reduced(), MOE_PROMPT[case]
            else:
                cfg, s = _bf16_cfg(case)
            cache[case, dtype] = _run_both(cfg, s=s, steps=3, seed=11,
                                           serving=dtype == "bfloat16",
                                           jit=True)
        return cache[case, dtype]
    return get


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_moe_hybrid_forward_and_aux_match_reference(moe_runs, arch):
    """Logits, and the aux loss summed over the MoE layers."""
    run = moe_runs(arch)
    want, got = run["forward"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL
    jaux, taux = run["aux"]
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_moe_hybrid_prefill_and_cache_match_reference(moe_runs, arch):
    """Last-token logits and every cache tensor: K/V (a ring for
    mixtral's SWA layers) and Mamba's SSD state and conv buffer."""
    run = moe_runs(arch)
    want, got = run["prefill"]
    assert _rel(want, _np(got)) < TOL
    for name, (w, g) in run["cache"].items():
        assert g.shape == w.shape, name
        assert _rel(w, g) < TOL, name


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_moe_hybrid_decode_steps_match_reference(moe_runs, arch):
    """Three decode steps against the reference's, and against forward
    at each position (``reduced()`` dispatches without drops)."""
    run = moe_runs(arch)
    fwd = np.asarray(run["forward"][0])
    s = MOE_PROMPT[arch]
    for i, (want, got) in enumerate(run["decodes"]):
        assert tuple(got.shape) == want.shape
        assert _rel(want, _np(got)) < TOL, i
        assert _rel(fwd[:, s + i], _np(got)[:, 0]) < TOL, i


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_moe_hybrid_bf16_serving_matches_reference(moe_runs, case):
    """bf16 compute, the port from its ``serving_params`` copy (router,
    Mamba's step-size leaves and norms f32) and the reference casting its
    f32 weights at use: forward, prefill and 3 decode steps within
    BF16_TOL."""
    run = moe_runs(case, "bfloat16")
    assert run["forward"][1].dtype == torch.bfloat16
    for stage in ("forward", "prefill"):
        want, got = run[stage]
        assert _rel(want, _np(got)) < BF16_TOL, stage
    for i, (want, got) in enumerate(run["decodes"]):
        assert _rel(want, _np(got)) < BF16_TOL, i


def test_serving_params_keeps_router_and_ssm_leaves_f32():
    """The leaves the reference reads in f32 stay f32 in the serving
    copy; every other weight of jamba's blocks is cast, and no other
    leaf shares their names."""
    cfg = tconfigs.get("jamba_1_5_large_398b").reduced(
        dtype_compute="bfloat16")
    sp = tt.serving_params(tt.init(torch.Generator().manual_seed(0), cfg),
                           cfg)
    f32 = {"router", "dt_bias", "A_log", "D", "norm", "scale"}
    seen = set()

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            seen.add(k)
            want = torch.float32 if k in f32 else torch.bfloat16
            assert v.dtype == want, path + (k,)
    walk(sp, ())
    assert {"router", "dt_bias", "A_log", "D", "wi", "conv"} <= seen
    moe_leaves = set(sp["layers"]["pos0"]["ffn"])
    assert moe_leaves == {"router", "wi", "wg", "wo"}


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_every_architecture_inits_and_runs_forward(arch):
    """Nothing in the zoo is refused: each reduced configuration inits
    and runs one forward on its own kind of input (token ids, or patch
    embeddings for the VLM; frame embeddings into Whisper's encoder)."""
    cfg = tconfigs.get(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    params = tt.init(gen, cfg)
    b, s = 2, 16
    if cfg.input_mode == "embeddings":
        inputs = torch.randn((b, s, cfg.d_model), generator=gen)
    else:
        inputs = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    enc = (torch.randn((b, 24, cfg.d_model), generator=gen)
           if cfg.is_encdec else None)
    logits, aux = tt.forward(params, inputs, cfg, encoder_inputs=enc)
    assert tuple(logits.shape) == (b, s, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


def test_serving_params_and_in_place_cache():
    """The compute-dtype copy gives the same logits as casting at each
    use; norms stay f32; decode_step updates the cache in place and
    takes the position only as a host int."""
    cfg = tconfigs.get("h2o_danube_3_4b").reduced(
        num_layers=2, dtype_compute="bfloat16")
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    sp = tt.serving_params(params, cfg)
    assert sp["layers"]["pos0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert sp["embed"].dtype == sp["lm_head"].dtype == torch.bfloat16
    assert sp["layers"]["pos0"]["norm1"]["scale"].dtype == torch.float32
    assert sp["final_norm"]["scale"].dtype == torch.float32
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, 2, 20, 1)).long()
    assert torch.equal(tt.forward(params, tokens, cfg)[0],
                       tt.forward(sp, tokens, cfg)[0])
    _, cache = tt.prefill(sp, tokens[:, :19], cfg, pad_to=24)
    k0 = cache["pos0"]["k"]
    before = k0.clone()
    _, out = tt.decode_step(sp, tokens[:, 19:], cache, 19, cfg)
    assert out is cache and out["pos0"]["k"] is k0
    assert not torch.equal(k0[:, :, 19], before[:, :, 19])
    with pytest.raises(TypeError, match="host int"):
        tt.decode_step(sp, tokens[:, 19:], cache, torch.tensor(20), cfg)


def test_init_cache_matches_reference_layout():
    """The reference's ``init_cache`` layout, except that an SWA ring
    always holds the whole window, as the reference's ``prefill`` lays
    it (danube's reduced window is 128, so max_len 50 tells them
    apart)."""
    for arch in ("h2o_danube_3_4b", "codeqwen1_5_7b"):
        jcfg = jconfigs.get(arch).reduced(num_layers=2)
        tcfg = tconfigs.get(arch).reduced(num_layers=2)
        for max_len in (50, 300):
            jc = jt.init_cache(jcfg, 2, max_len)
            tc = tt.init_cache(tcfg, 2, max_len)
            assert {p: set(d) for p, d in tc.items()} == \
                {p: set(d) for p, d in jc.items()}
            for i, spec in enumerate(tcfg.pattern):
                want = jc[f"pos{i}"]["k"].shape
                if spec.sliding_window and tcfg.sliding_window:
                    want = want[:2] + (tcfg.sliding_window,) + want[3:]
                for name, t in tc[f"pos{i}"].items():
                    assert tuple(t.shape) == want, (arch, max_len, name)


def test_decode_launches_nothing_on_the_cpu():
    """On CPU tensors the attention path takes the plain version."""
    cfg = tconfigs.get("qwen3_14b").reduced(num_layers=2)
    params = tt.init(torch.Generator().manual_seed(1), cfg)
    before = tfa.flash_attention.launches
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, 1, 9, 2)).long()
    _, cache = tt.prefill(params, tokens, cfg, pad_to=12)
    tt.decode_step(params, tokens[:, -1:], cache, 9, cfg)
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("arch", [
    "h2o-danube-3-4b", "codeqwen1.5-7b", "mixtral-8x22b",
    "qwen3-moe-235b-a22b", "jamba-1.5-large-398b", "qwen2-vl-72b",
    "whisper-small"])
def test_serve_example_runs_on_cpu(arch, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_decode_torch.py", "--device", "cpu", "--arch", arch,
        "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    runpy.run_path(str(EXAMPLE), run_name="__main__")
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "generated 4 tokens x 2 seqs" in out
    assert len(ast.literal_eval(out.split("first sequence:")[1].strip())) == 5


def main() -> None:
    """Print the readings the parity tests hold (relative errors)."""
    torch.set_num_threads(1)
    for arch in DENSE:
        run = _run_both(jconfigs.get(arch).reduced(num_layers=2))
        cache = max(_rel(w, g) for w, g in run["cache"].values())
        print(f"{arch}: " + ", ".join(
            f"{k} {_rel(run[k][0], _np(run[k][1])):.2e}"
            for k in ("forward", "prefill", "decode"))
            + f", cache {cache:.2e} (limit {TOL:g})")
    ring = _run_both(jconfigs.get("h2o_danube_3_4b").reduced(
        sliding_window=32, num_layers=2), b=1, s=100, seed=3)
    print(f"ring (window 32, prompt 100): decode "
          f"{_rel(ring['decode'][0], _np(ring['decode'][1])):.2e}")
    bf16 = _run_both(jconfigs.get("h2o_danube_3_4b").reduced(
        num_layers=2, dtype_compute="bfloat16"), b=2, s=45, seed=7)
    print("bf16 compute: " + ", ".join(
        f"{k} {_rel(bf16[k][0], _np(bf16[k][1])):.2e}"
        for k in ("forward", "prefill", "decode"))
        + f" (limit {BF16_TOL:g})")

    def stages(run):
        return ", ".join(
            [f"{k} {_rel(run[k][0], _np(run[k][1])):.2e}"
             for k in ("forward", "prefill")]
            + [f"decode {i} {_rel(w, _np(g)):.2e}"
               for i, (w, g) in enumerate(run["decodes"])])
    for arch in MOE_HYBRID:
        run = _run_both(jconfigs.get(arch).reduced(), s=MOE_PROMPT[arch],
                        steps=3, seed=11, jit=True)
        print(f"{arch} f32: {stages(run)}, aux {float(run['aux'][0]):.6f} / "
              f"{float(run['aux'][1]):.6f} (limit {TOL:g})")
    for case in BF16_CASES:
        cfg, s = _bf16_cfg(case)
        run = _run_both(cfg, s=s, steps=3, seed=11, serving=True, jit=True)
        print(f"{case} bf16, top-k = E: {stages(run)} (limit {BF16_TOL:g})")
    for arch in MOE_HYBRID:
        for k in ("top-2", "top-k = E"):
            cfg = jconfigs.get(arch).reduced(dtype_compute="bfloat16")
            if k != "top-2":
                cfg = dataclasses.replace(
                    cfg, num_experts_per_tok=cfg.num_experts)
            run = _run_both(cfg, s=MOE_PROMPT[arch], steps=3, seed=11,
                            serving=True, jit=True)
            print(f"{arch} bf16 at every layer, {k}, not held: "
                  f"{stages(run)}")


if __name__ == "__main__":
    main()
