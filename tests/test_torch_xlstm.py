"""The port's xLSTM mixers and xlstm-125m against the JAX package.

``repro_torch.models.xlstm`` is held against ``repro.models.xlstm`` (and
the reference's step-by-step oracle ``kernels/ref.py::mlstm_sequential``)
on numpy-seeded inputs, block by block on converted weights, and the
whole model (``transformer.forward`` / ``prefill`` / ``decode_step``) at
``xlstm_125m.reduced(num_layers=2)``: f32 within 1e-4 of the largest
logit or state value (the two frameworks sum in another order; about
1e-6 is read), bf16 within the serving limit 2e-2.  Gradients of the
train loss and of the chunked form are held against ``jax.grad``, also
where every stabilizer max is a tie.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_transformer import (_np, _pair, _rel,  # noqa: E402
                                    _run_both, one_thread)  # noqa: F401

TOL = 1e-4
BF16_TOL = 2e-2
# The chunked mLSTM against the reference's chunked form: the same
# arithmetic in another summation order (up to 1.8e-05 absolute read at
# |h| <= 19; ``python tests/test_torch_xlstm.py`` prints the readings).
CHUNK_RTOL = CHUNK_ATOL = 1e-5
# Against the sequential oracle the chunking itself reorders the sums:
# the reference holds its own chunked form to it at 2e-4
# (tests/test_models.py::test_mlstm_chunked_matches_sequential).
SEQ_TOL = 2e-4
# Gradients: rtol 1e-4, and an absolute floor of 1e-4 of the leaf's
# largest gradient (elements near zero carry the other leaves' rounding;
# up to 6.5e-06 of the largest is read).
GRAD_RTOL = GRAD_FLOOR = 1e-4
FULL_PARAMS = 162_317_616


def _mlstm_inputs(seed, b=2, s=64, nh=2, hd=16, ig_shift=0.0, fg_shift=3.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    ig = (rng.standard_normal((b, s, nh)) + ig_shift).astype(np.float32)
    fg = (rng.standard_normal((b, s, nh)) + fg_shift).astype(np.float32)
    return q, k, v, ig, fg


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# mLSTM chunked form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 32, 16])
def test_mlstm_chunked_matches_reference(chunk):
    """1, 2 and 4 chunks of a 64-position sequence: h and the carried
    state against the reference's chunked form, h against its sequential
    oracle."""
    ins = _mlstm_inputs(0)
    hj, sj = jx._mlstm_chunked(*map(jnp.asarray, ins), chunk)
    ht, st = tx._mlstm_chunked(*map(_t, ins), chunk)
    _close(hj, ht, CHUNK_RTOL, CHUNK_ATOL)
    for key in ("C", "n", "m"):
        _close(sj[key], st[key], CHUNK_RTOL, CHUNK_ATOL)
    _close(kref.mlstm_sequential(*map(jnp.asarray, ins)), ht, SEQ_TOL,
           SEQ_TOL)


@pytest.mark.parametrize("chunk", [32, 16])
def test_mlstm_chunked_carries_state(chunk):
    """The sequence in two calls, the second starting from the first's
    state: against the reference doing the same, and the concatenation
    against the sequential oracle of the whole sequence."""
    ins = _mlstm_inputs(1)
    first = [a[:, :32] for a in ins]
    second = [a[:, 32:] for a in ins]
    hj1, sj = jx._mlstm_chunked(*map(jnp.asarray, first), chunk)
    hj2, sj2 = jx._mlstm_chunked(*map(jnp.asarray, second), chunk, state=sj)
    ht1, st = tx._mlstm_chunked(*map(_t, first), chunk)
    ht2, st2 = tx._mlstm_chunked(*map(_t, second), chunk, state=st)
    _close(hj2, ht2, CHUNK_RTOL, CHUNK_ATOL)
    for key in ("C", "n", "m"):
        _close(sj2[key], st2[key], CHUNK_RTOL, CHUNK_ATOL)
    whole = kref.mlstm_sequential(*map(jnp.asarray, ins))
    _close(whole, torch.cat([ht1, ht2], dim=1), SEQ_TOL, SEQ_TOL)


def test_mlstm_chunk_guard():
    """The reference's guard decides the chunking: more than 64 chunks
    doubles the chunk, and a length it does not divide is one chunk."""
    ins = _mlstm_inputs(2, s=130)
    for chunk in (1, 7):
        hj, _ = jx._mlstm_chunked(*map(jnp.asarray, ins), chunk)
        ht, _ = tx._mlstm_chunked(*map(_t, ins), chunk)
        _close(hj, ht, CHUNK_RTOL, CHUNK_ATOL)


def _grad_pair(fn_j, fn_t, ins, seed):
    """Gradients of sum(h * cot) for both, with respect to every input."""
    h = np.asarray(fn_j(*map(jnp.asarray, ins)))
    cot = np.random.default_rng(seed).standard_normal(h.shape) \
        .astype(np.float32)
    gj = jax.jit(jax.grad(lambda *a: jnp.sum(fn_j(*a) * cot),
                          argnums=tuple(range(len(ins)))))(
        *map(jnp.asarray, ins))
    ts = [_t(a).requires_grad_() for a in ins]
    gt = torch.autograd.grad(torch.sum(fn_t(*ts) * _t(cot)), ts)
    return gj, gt


@pytest.mark.parametrize("case", ["random", "tied"])
def test_mlstm_chunked_gradient(case):
    """Gradients of the chunked form against ``jax.grad``, finite.  In
    the tied case every forget gate is exactly open (log-sigmoid 0) and
    every input gate equal and low, so each row's stabilizer max is a tie
    over all its sources (and with the carried magnitude) and the
    normalizer's floor ``exp(-m)`` is the one in force.  The port splits
    a tie's gradient evenly as JAX does (``torch.amax``); the stabilizer
    cancels from h exactly, so that split moves the gradients only by
    rounding."""
    if case == "random":
        ins = _mlstm_inputs(3, s=32)
    else:
        q, k, v, _, _ = _mlstm_inputs(4, s=32)
        ig = np.full(q.shape[:3], -8.0, np.float32)
        fg = np.full(q.shape[:3], 200.0, np.float32)
        ins = (q, k, v, ig, fg)
    gj, gt = _grad_pair(lambda *a: jx._mlstm_chunked(*a, 16)[0],
                        lambda *a: tx._mlstm_chunked(*a, 16)[0], ins, 5)
    for a, b in zip(gj, gt):
        assert bool(torch.isfinite(b).all())
        a = np.asarray(a)
        _close(a, b, GRAD_RTOL, GRAD_FLOOR * float(np.abs(a).max()))


# ---------------------------------------------------------------------------
# Blocks on converted weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm_pair():
    """The reference's reduced xLSTM weights, the port's copy, and both
    configurations."""
    jcfg = jconfigs.get("xlstm_125m").reduced(num_layers=2)
    params, tp, tcfg = _pair(jcfg, seed=2)
    return params, tp, jcfg, tcfg


def _mixer(params, pos):
    return jax.tree_util.tree_map(lambda a: a[0],
                                  params["layers"][pos]["mixer"])


@pytest.mark.parametrize("pos,kind", [("pos0", "slstm"), ("pos1", "mlstm")])
def test_block_forward_and_decode(xlstm_pair, pos, kind):
    """``<kind>_forward`` with its final state, then two decode steps
    from it, against the reference (f32)."""
    params, tp, jcfg, cfg = xlstm_pair
    jp = _mixer(params, pos)
    tpm = {k: v[0] for k, v in tp["layers"][pos]["mixer"].items()}
    x = np.random.default_rng(6).standard_normal((2, 70, cfg.d_model)) \
        .astype(np.float32)
    jfwd, jdec = getattr(jx, f"{kind}_forward"), getattr(jx, f"{kind}_decode")
    tfwd, tdec = getattr(tx, f"{kind}_forward"), getattr(tx, f"{kind}_decode")
    jo, js = jfwd(jp, jnp.asarray(x[:, :68]), jcfg, None, return_state=True)
    to, ts = tfwd(tpm, _t(x[:, :68]), cfg, return_state=True)
    assert _rel(jo, to) < TOL
    assert set(js) == set(ts)
    for key in js:
        assert _rel(js[key], ts[key]) < TOL, key
    for i in (68, 69):
        jo, js = jdec(jp, jnp.asarray(x[:, i:i + 1]), js, jcfg, None)
        to, ts = tdec(tpm, _t(x[:, i:i + 1]), ts, cfg)
        assert to.shape == (2, 1, cfg.d_model)
        assert _rel(jo, to) < TOL
        for key in js:
            assert _rel(js[key], ts[key]) < TOL, key


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_model_matches_reference(dtype, tol):
    """prefill of 128 positions (two mLSTM chunks of 64, the state
    carried) with every recurrent state of its cache, one decode step,
    and forward over 129 (a length the chunk does not divide: one
    chunk)."""
    jcfg = dataclasses.replace(
        jconfigs.get("xlstm_125m").reduced(num_layers=2),
        dtype_compute=dtype)
    run = _run_both(jcfg, b=2, s=128, seed=3)
    for stage in ("forward", "prefill", "decode"):
        want, got = run[stage]
        assert got.dtype == getattr(torch, dtype)
        assert _rel(want, _np(got)) < tol, stage
    for name, (want, got) in run["cache"].items():
        assert _rel(want, got) < tol, name


def test_prefill_decode_matches_forward():
    """prefill(S) + decode(S), (S + 1) against forward(S + 2) at the last
    two positions (f32), through the prefill and serve steps; the cache
    updated in place."""
    cfg = tconfigs.get("xlstm_125m").reduced(num_layers=2)
    params = tt.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 42))).long()
    want, _ = tt.forward(params, toks, cfg)
    _, cache = tsteps.make_prefill_step(cfg)(params,
                                             {"inputs": toks[:, :40]})
    serve = tsteps.make_serve_step(cfg)
    c0 = cache["pos1"]["C"]
    assert {t.dtype for t in tree_leaves(cache)} == {torch.float32}
    before = c0.clone()
    for i in (40, 41):
        got, out = serve(params, toks[:, i:i + 1], cache, i)
        assert out is cache and out["pos1"]["C"] is c0
        assert _rel(_np(want[:, i]), _np(got[:, 0])) < TOL
    assert not torch.equal(c0, before)


def test_param_count_and_layout():
    """xlstm-125m: 162,317,616 parameters, and every leaf of the port's
    init has the reference's path, shape and dtype."""
    cfg = tconfigs.get("xlstm_125m")
    assert tt.param_count(cfg) == FULL_PARAMS
    jcfg = jconfigs.get("xlstm_125m")
    assert jt.param_count(jcfg) == FULL_PARAMS
    want = {"/".join(str(getattr(k, "key", k)) for k in path): (
        tuple(leaf.shape), str(leaf.dtype)) for path, leaf in
        jax.tree_util.tree_flatten_with_path(jt.init_shapes(jcfg))[0]}
    with torch.device("meta"):
        got_tree = tt._init(torch.Generator(), cfg)
    got = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}/{k}" if path else k, v)
        else:
            got[path] = (tuple(node.shape), str(node.dtype).split(".")[1])

    walk("", got_tree)
    assert got == want


def test_serving_params_keep_f32_leaves():
    """The bf16 serving copy keeps the leaves the reference reads in f32
    (gate projection and bias, sLSTM recurrence and bias, norms) and
    gives the logits of casting at each use."""
    cfg = tconfigs.get("xlstm_125m").reduced(num_layers=2,
                                             dtype_compute="bfloat16")
    params = tt.init(torch.Generator().manual_seed(1), cfg)
    sp = tt.serving_params(params, cfg)
    sl, ml = sp["layers"]["pos0"]["mixer"], sp["layers"]["pos1"]["mixer"]
    for leaf in (sl["wr"], sl["bias"], sl["norm"], ml["wif"], ml["if_bias"],
                 ml["norm"]):
        assert leaf.dtype == torch.float32
    for leaf in (sl["wx"], sl["wo"], ml["wq"], ml["wup"], ml["wo"]):
        assert leaf.dtype == torch.bfloat16
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20))).long()
    assert torch.equal(tt.forward(params, toks, cfg)[0],
                       tt.forward(sp, toks, cfg)[0])


def test_loss_gradient_matches_jax(xlstm_pair):
    """Every leaf's gradient of the train loss (chunked cross-entropy)
    against ``jax.grad`` of the reference's ``loss_fn``, finite."""
    params, tp, jcfg, cfg = xlstm_pair
    rng = np.random.default_rng(1)
    inp, lab = (rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
                for _ in range(2))
    gj = jax.jit(jax.grad(lambda p: jsteps.loss_fn(
        p, {"inputs": jnp.asarray(inp), "labels": jnp.asarray(lab)}, jcfg,
        None)[0]))(params)
    _, gt = tsteps._grads(tp, {"inputs": _t(inp).long(),
                               "labels": _t(lab).long()}, cfg)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(gj)[0]}
    assert len(want) == len(tree_leaves(gt))
    for path, a in want.items():
        node = gt
        for k in path:
            node = node[k]
        assert bool(torch.isfinite(node).all()), path
        _close(a, node, GRAD_RTOL, GRAD_FLOOR * float(np.abs(a).max()))


def main() -> None:
    """Print the readings the parity tests hold."""
    torch.set_num_threads(1)
    ins = _mlstm_inputs(0)
    seq = np.asarray(kref.mlstm_sequential(*map(jnp.asarray, ins)))
    for chunk in (64, 32, 16):
        hj, _ = jx._mlstm_chunked(*map(jnp.asarray, ins), chunk)
        ht, _ = tx._mlstm_chunked(*map(_t, ins), chunk)
        print(f"mLSTM chunk {chunk}: max abs err against the reference "
              f"{np.abs(np.asarray(hj) - ht.numpy()).max():.2e}, against "
              f"the sequential oracle {np.abs(seq - ht.numpy()).max():.2e} "
              f"(max |h| {np.abs(seq).max():.1f})")
    jcfg = jconfigs.get("xlstm_125m").reduced(num_layers=2)
    for dtype in ("float32", "bfloat16"):
        run = _run_both(dataclasses.replace(jcfg, dtype_compute=dtype),
                        b=2, s=128, seed=3)
        print(f"model {dtype}: " + ", ".join(
            f"{k} {_rel(run[k][0], _np(run[k][1])):.2e}"
            for k in ("forward", "prefill", "decode")))
    params, tp, tcfg = _pair(jcfg, seed=2)
    rng = np.random.default_rng(1)
    inp, lab = (rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
                for _ in range(2))
    gj = jax.grad(lambda p: jsteps.loss_fn(
        p, {"inputs": jnp.asarray(inp), "labels": jnp.asarray(lab)}, jcfg,
        None)[0])(params)
    _, gt = tsteps._grads(tp, {"inputs": _t(inp).long(),
                               "labels": _t(lab).long()}, tcfg)
    worst = max(float(np.abs(np.asarray(a) - b.numpy()).max()
                      / np.abs(np.asarray(a)).max())
                for a, b in zip(jax.tree_util.tree_leaves(gj),
                                _sorted_leaves(gt)))
    print(f"loss gradients: largest error over a leaf's largest gradient "
          f"{worst:.2e} (floor {GRAD_FLOOR:g})")


def _sorted_leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


if __name__ == "__main__":
    main()
