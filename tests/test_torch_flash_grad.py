"""The flash attention gradient and the attention configurations' train
steps against the JAX package.

On the CPU ``flash_attention`` with grad goes through ``_FlashAttention``
(the plain forward and its row log-sum-exp, then
``flash_attention_bwd_plain``), the route the card takes with its
kernels.  Held here:

* ``flash_attention_bwd_plain`` against ``torch.autograd`` through
  ``flash_attention_plain`` over causal / window / cross-attention (Sq !=
  Skv) / ``kv_len`` masks, G in {1, 2, 4} and hd in {64, 120}: f32 within
  1e-6 of each gradient's largest (the same f32 formulas, another order);
* the port's attention gradient against ``jax.grad`` of the reference's
  ``attend_full`` (q chunked by ``attn_chunk``) at hd 64 and at
  stablelm-12b's hd 160 (the widths whose bf16 backward the card serves
  with dK and dV in one kernel and in two): f32 within 1e-5 of the
  largest; bf16 at the reference's kernel-test limit (rtol = atol =
  2e-2), P rounded to bf16 for ``p . v`` on both sides;
* the Functions' ``vmap`` rules: ``vmap(grad)`` over a client axis equals
  a loop of ``autograd.grad`` within 1e-6;
* one plain train step's gradients against ``jax.grad`` of the
  reference's ``loss_fn`` at ``reduced(num_layers=2)``: h2o-danube-3-4b
  at 256 positions (its window of 128 binds), qwen3-14b (qk_norm),
  mixtral-8x22b (MoE and a window), qwen2-vl-72b (M-RoPE positions of an
  image grid), whisper-small (``encoder_inputs``: the encoder's
  non-causal attention and cross-attention) and stablelm-12b at its hd
  160 (``head_dim=160``: partial rotary over 40 of them, LayerNorm);
  rtol 1e-4 with a floor of
  1e-4 of each leaf's largest (``test_torch_xlstm.py``'s limit), of the
  model's largest for a key bias (its gradient is 0: softmax ignores a
  constant added to a row);
* the federated step on danube against the reference's
  ``make_federated_train_step`` (1e-4), a reference train state resuming
  the reference's run, and the federated step's refusals (ROADMAP queue
  3).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_transformer import _pair, _port_cfg, one_thread  # noqa: E402,F401

PLAIN_TOL = 1e-6
ATTN_TOL = 1e-5
# The reference's bf16 kernel-test limit (tests/test_kernels.py::_tol).
BF16_RTOL = BF16_ATOL = 2e-2
VMAP_TOL = 1e-6
GRAD_RTOL = GRAD_FLOOR = 1e-4
STEP_TOL = 1e-4

# (Sq, Skv, masks) of the plain-backward and attention-gradient cases.
MASKS = {
    "causal": (48, 48, dict(causal=True, window=0)),
    "window": (48, 48, dict(causal=True, window=9)),
    "cross": (20, 52, dict(causal=False, window=0)),
    "kv_len": (40, 40, dict(causal=False, window=0, kv_len=29)),
}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _qkv(sq, skv, h, kv, hd, seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                      (b, sq, h, hd))]


# ---------------------------------------------------------------------------
# The plain backward and the Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 120])
@pytest.mark.parametrize("grp", [1, 2, 4])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plain_backward_matches_autograd(one_thread, mask, grp, hd):
    sq, skv, kw = MASKS[mask]
    q, k, v, do = map(torch.from_numpy, _qkv(sq, skv, 2 * grp, 2, hd, grp))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention_plain(q, k, v, **kw)
    want = torch.autograd.grad(out, (q, k, v), do)
    q, k, v, out = (t.detach() for t in (q, k, v, out))
    _, lse = tfa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    got = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for w, g in zip(want, got):
        assert _rel(w, g) <= PLAIN_TOL


def test_lse_of_a_row_that_sees_nothing_is_inf(one_thread):
    q, k, v, do = map(torch.from_numpy, _qkv(6, 6, 2, 1, 64, 0))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=False, window=0,
                                       kv_len=0, with_lse=True)
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())
    assert not bool(o.any())
    for g in tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                           causal=False, window=0,
                                           kv_len=0):
        assert not bool(g.any())


def _jax_attn_grads(q, k, v, do, kw, dtype):
    sq, skv = q.shape[1], k.shape[1]
    jcfg = dataclasses.replace(
        jconfigs.get("h2o_danube_3_4b").reduced(), attn_chunk=16)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(q, k, v):
        out = jattn.attend_full(q, k, v, jcfg, causal=kw["causal"],
                                window=kw["window"])
        return jnp.sum(out.astype(jnp.float32) * do)

    return jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dt) for x in (q, k, v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["causal", "window", "cross", "causal-hd160",
                                  "cross-hd160"])
def test_attention_gradient_matches_jax(one_thread, mask, dtype):
    """q (B, Sq, 8, hd), k / v (B, Skv, 2, hd), hd 64 or (``-hd160``)
    160: the reference's ``attend_full`` (its KV repeated, q in chunks of
    16) under ``jax.grad`` against the port's ``flash_attention`` under
    autograd, on the same inputs and output cotangent."""
    mask, _, width = mask.partition("-hd")
    sq, skv, kw = MASKS[mask]
    q, k, v, do = _qkv(sq, skv, 8, 2, int(width or 64), 3)
    if dtype == "bfloat16":
        q, k, v = (x.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for x in (q, k, v))
    want = _jax_attn_grads(q, k, v, do, kw, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(),
                              (tq, tk, tv))
    for w, g in zip(want, got):
        assert g.dtype == tdt
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        if dtype == "float32":
            assert _rel(w, g) <= ATTN_TOL
        else:
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_vmap_grad_matches_client_loop(one_thread):
    """``vmap(grad)`` over 3 clients (w shared, the rest per client) and
    a loop of ``autograd.grad``: the Functions' vmap rules fold the
    clients into B, one forward and one backward for all."""
    n = 3
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((n, 2, 24, 4, 16))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((n, 2, 30, 2, 16))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n, 2, 30, 2, 16))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))

    def loss(w, x, k, v):
        out = tfa.flash_attention(x @ w, k @ w, v, causal=True, window=7,
                                  kv_len=27)
        return (out * out).sum()

    calls = []
    real = tfa.flash_attention_bwd

    def spy(q, *args, **kw):
        calls.append(q.shape[0])
        return real(q, *args, **kw)

    tfa.flash_attention_bwd = spy
    try:
        got = torch.func.vmap(torch.func.grad(loss),
                              in_dims=(None, 0, 0, 0))(w, x, k, v)
    finally:
        tfa.flash_attention_bwd = real
    assert calls == [n * 2]
    want = torch.stack([_grad_w(loss, w, x[i], k[i], v[i])
                        for i in range(n)])
    assert _rel(want.numpy(), got.numpy()) <= VMAP_TOL


def _grad_w(loss, w, x, k, v):
    w = w.clone().requires_grad_()
    return torch.autograd.grad(loss(w, x, k, v), w)[0]


# ---------------------------------------------------------------------------
# Train steps of the attention configurations
# ---------------------------------------------------------------------------

def _grid_positions(b, s):
    """M-RoPE positions (3, B, S) of an image grid of ceil(s / 4) rows by
    4 columns after a 5-token text prefix, as the VLM's prefill takes."""
    pos = np.zeros((3, b, s), np.int32)
    for i in range(s):
        if i < 5:
            pos[:, :, i] = i
        else:
            j = i - 5
            pos[0, :, i] = 5
            pos[1, :, i] = 5 + j // 4
            pos[2, :, i] = 5 + j % 4
    return pos


# arch -> (batch, seq, extras)
STEP_CASES = {
    "h2o_danube_3_4b": (2, 256, ()),
    "qwen3_14b": (2, 32, ()),
    "mixtral_8x22b": (2, 32, ()),
    "qwen2_vl_72b": (2, 32, ("positions",)),
    "whisper_small": (2, 32, ("encoder_inputs",)),
    "stablelm_12b": (2, 32, ()),
}
# ``reduced`` overrides past ``num_layers=2``: stablelm-12b keeps its
# published head width (reduced() would cut it to 64).
STEP_WIDTHS = {"stablelm_12b": dict(head_dim=160)}


def _step_batch(jcfg, b, s, extras, seed):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("inputs", "labels")}
    if "positions" in extras:
        batch["positions"] = _grid_positions(b, s)
    if "encoder_inputs" in extras:
        batch["encoder_inputs"] = rng.standard_normal(
            (b, 24, jcfg.d_model)).astype(np.float32)
    return batch


def _to_torch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("inputs", "labels", "positions"):
        if k in out:
            out[k] = out[k].long()
    return out


def _by_path(jtree, ttree):
    """(path, reference leaf, port leaf) for every leaf of the
    reference's tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for key in path:
            node = node[str(getattr(key, "key", key))]
        yield path, np.asarray(leaf), node


@pytest.mark.parametrize("arch", sorted(STEP_CASES))
def test_train_step_gradients_match_jax(one_thread, arch):
    b, s, extras = STEP_CASES[arch]
    jcfg = jconfigs.get(arch).reduced(num_layers=2,
                                      **STEP_WIDTHS.get(arch, {}))
    params, tp, tcfg = _pair(jcfg, seed=1)
    batch = _step_batch(jcfg, b, s, extras, seed=2)
    if arch == "h2o_danube_3_4b":
        assert 0 < jcfg.sliding_window < s
    gj = jax.jit(jax.grad(lambda p: jsteps.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        None)[0]))(params)
    _, gt = tsteps._grads(tp, _to_torch(batch), tcfg)
    leaves = list(_by_path(gj, gt))
    assert len(leaves) == len(tree_leaves(gt))
    largest = max(float(np.abs(want).max()) for _, want, _ in leaves)
    for path, want, got in leaves:
        assert bool(torch.isfinite(got).all()), path
        # A key bias adds q . bk to every score of a row, which softmax
        # ignores: its gradient is 0, and both sides read rounding noise
        # (some 1e-10), held against the model's largest gradient.
        scale = largest if str(getattr(path[-1], "key", "")) == "bk" \
            else float(np.abs(want).max())
        np.testing.assert_allclose(
            got.float().numpy(), want.astype(np.float32), rtol=GRAD_RTOL,
            atol=GRAD_FLOOR * scale, err_msg=str(path))


def _danube_pair(jo):
    jcfg = jconfigs.get("h2o_danube_3_4b").reduced(num_layers=2)
    tcfg = _port_cfg(jcfg)
    state = jsteps.init_train_state(jax.random.key(6), jcfg, jo)
    return jcfg, tcfg, state, convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), tcfg)


def _fed_batch(jcfg, k, b, s, seed, selected, sizes):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, jcfg.vocab_size, (k, b, s))
            .astype(np.int32),
            "labels": rng.integers(0, jcfg.vocab_size, (k, b, s))
            .astype(np.int32),
            "selected": np.asarray(selected, np.float32),
            "sizes": np.asarray(sizes, np.float32)}


def _max_err(jtree, ttree) -> float:
    return max(float(np.abs(want.astype(np.float32) - got.float().numpy())
                     .max()) for _, want, got in _by_path(jtree, ttree))


@pytest.mark.parametrize("per_pass", [3, 2])
def test_federated_danube_step_matches_reference(one_thread, per_pass):
    """K = 3 clients of 2 x 160 tokens (past the window of 128), clients
    0 and 2 selected: parameters, ce and n_selected after one SGD step;
    all clients in one pass and in passes of 2."""
    jo = joptim.OptimizerConfig(name="sgd", momentum=0.0, learning_rate=0.1,
                                grad_clip=0.0, warmup_steps=0)
    to = toptim.OptimizerConfig(**dataclasses.asdict(jo))
    jcfg, tcfg, jstate, tstate = _danube_pair(jo)
    batch = _fed_batch(jcfg, 3, 2, 160, 7, [1, 0, 1], [100, 999, 300])
    jnew, jm = jax.jit(jsteps.make_federated_train_step(
        jcfg, jo, None, num_clients=3))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = tsteps.make_federated_train_step(
        tcfg, to, num_clients=3, clients_per_pass=per_pass)(
        tstate, _to_torch(batch))
    assert _max_err(jnew["params"], tnew["params"]) <= STEP_TOL
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                               rtol=STEP_TOL)
    assert float(tm["n_selected"]) == float(jm["n_selected"]) == 2.0


def test_resumes_reference_danube_state_mid_run(one_thread):
    """The reference's AdamW state (bf16 moments) after one federated
    danube step, converted, takes the next step as the reference does."""
    jo = joptim.OptimizerConfig(name="adamw", learning_rate=1e-3,
                                warmup_steps=0, state_dtype="bfloat16")
    to = toptim.OptimizerConfig(**dataclasses.asdict(jo))
    jcfg, tcfg, jstate, _ = _danube_pair(jo)
    batch = _fed_batch(jcfg, 2, 2, 48, 8, [1, 1], [10, 30])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(jsteps.make_federated_train_step(jcfg, jo, None, 2))
    mid, _ = jstep(jstate, jb)
    tmid = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, mid), tcfg)
    assert int(tmid["opt"]["count"]) == 1
    jend, _ = jstep(mid, jb)
    tend, _ = tsteps.make_federated_train_step(tcfg, to, 2)(
        tmid, _to_torch(batch))
    assert _max_err(jend["params"], tend["params"]) <= STEP_TOL
    assert int(tend["opt"]["count"]) == 2


@pytest.mark.parametrize("arch,overrides,match", [
    ("whisper_small", {}, "federated encoder-decoder"),
    ("mixtral_8x22b", {"moe_impl": "ragged"}, "federated ragged MoE"),
])
def test_federated_step_refuses_what_it_cannot_map(arch, overrides, match):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(), **overrides)
    with pytest.raises(NotImplementedError, match=match):
        tsteps.make_federated_train_step(cfg, toptim.OptimizerConfig(), 2)
    tsteps.make_train_step(cfg, toptim.OptimizerConfig())


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "stablelm_12b",
                                  "qwen3_moe_235b_a22b"])
def test_attention_configs_take_both_steps(one_thread, arch):
    """The zoo's other attention configurations at ``reduced()``: one
    plain and one federated step run, finite, and move the parameters."""
    cfg = tconfigs.get(arch).reduced()
    ocfg = toptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=0)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    ocfg)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 33), generator=gen)
    plain, m = tsteps.make_train_step(cfg, ocfg)(
        state, {"inputs": tokens[0, :, :-1], "labels": tokens[0, :, 1:]})
    assert np.isfinite(float(m["ce"]))
    fed, m = tsteps.make_federated_train_step(cfg, ocfg, 2)(
        state, {"inputs": tokens[:, :1, :-1], "labels": tokens[:, :1, 1:],
                "selected": torch.ones(2), "sizes": torch.ones(2)})
    assert np.isfinite(float(m["ce"]))
    for new in (plain, fed):
        moved = [not torch.equal(a, b) for a, b in zip(
            tree_leaves(new["params"]), tree_leaves(state["params"]))]
        assert any(moved)


def test_microbatches_split_positions(one_thread):
    """qwen2-vl's plain step with 2 microbatches splits the (3, B, S)
    M-RoPE positions on their batch axis, as the reference does, and
    lands where one batch does (f32: sums in another order)."""
    jcfg = jconfigs.get("qwen2_vl_72b").reduced(num_layers=2)
    _, tp, tcfg = _pair(jcfg, seed=3)
    batch = _to_torch(_step_batch(jcfg, 4, 32, ("positions",), seed=4))
    ocfg = toptim.OptimizerConfig(name="sgd", momentum=0.0,
                                  learning_rate=0.05, grad_clip=0.0,
                                  warmup_steps=0)
    state = {"params": tp, "opt": toptim.init_state(tp, ocfg)}
    one, m1 = tsteps.make_train_step(tcfg, ocfg, 1)(state, batch)
    two, m2 = tsteps.make_train_step(tcfg, ocfg, 2)(state, batch)
    for a, b in zip(tree_leaves(one["params"]), tree_leaves(two["params"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m1["ce"]), float(m2["ce"]), rtol=1e-5)
