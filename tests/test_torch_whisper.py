"""The encoder-decoder (whisper-small) in the port against the JAX package.

``repro_torch.models`` serves Whisper's backbone: ``encode`` runs the
non-causal encoder over stub frame embeddings (B, S_enc, D) with
sinusoidal absolute positions added; decoder blocks add cross-attention
against per-layer K/V computed once from the encoder output, which
``prefill`` keeps in the decode cache as ``cross_k`` / ``cross_v``; and
``decode_step`` adds the sinusoid's row at the token's position.  Held
against ``repro.models`` on the same weights (the reference's ``init``
converted with ``convert.transformer_params_from_numpy``; the biases
made non-zero, so the test sees them) and numpy-seeded inputs, at
``reduced(num_layers=2)`` (2 encoder and 2 decoder layers, d_model 256,
4 heads of 64):

* ``sinusoidal_positions``;
* ``encode``, and ``forward`` with ``encoder_inputs``;
* ``prefill``'s logits and cache (self-attention K/V, cross K/V);
* several ``decode_step``s past the prompt, and the reference's own
  parity: prefill + decode equals ``forward`` at the last position;
* ``param_count`` at full size.

f32 within 1e-4 of the largest logit (or cache value): the two
frameworks sum matmuls in another order, about 1e-6 is read.  bf16
compute within 2e-2, the reference's own decode-parity limit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "whisper_small"
TOL = 1e-4
BF16_TOL = 2e-2
# Encoder frames (not a multiple of the kernel's 64-row tiles), decoder
# prompt, decode steps.
ENC, PROMPT, STEPS = 70, 12, 3


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


def _setup(dtype_compute="float32", seed=0):
    jcfg = jconfigs.get(ARCH).reduced(num_layers=2,
                                      dtype_compute=dtype_compute)
    tcfg = tconfigs.get(ARCH).reduced(num_layers=2,
                                      dtype_compute=dtype_compute)
    params = jt.init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + rng.standard_normal(a.shape).astype(np.float32)
        * 0.1 if str(path[-1].key).startswith("b") else a, params)
    tp = convert.transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, tp


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, ENC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, PROMPT + STEPS)) \
        .astype(np.int32)
    return enc, toks


def _serve_both(dtype_compute="float32", b=2, seed=0):
    jcfg, tcfg, params, tp = _setup(dtype_compute, seed)
    if dtype_compute == "bfloat16":
        tp = tt.serving_params(tp, tcfg)
    enc, toks = _inputs(jcfg, b, seed + 1)
    jenc, tenc = jnp.asarray(enc), torch.from_numpy(enc)
    ttoks = torch.from_numpy(toks).long()
    out = {"encode": (jt.encode(params, jenc, jcfg, None),
                      tt.encode(tp, tenc, tcfg))}
    out["forward"] = (jt.forward(params, jnp.asarray(toks), jcfg,
                                 encoder_inputs=jenc)[0],
                      tt.forward(tp, ttoks, tcfg, encoder_inputs=tenc)[0])
    pad = PROMPT + STEPS + 1
    jl, jc = jt.prefill(params, jnp.asarray(toks[:, :PROMPT]), jcfg,
                        encoder_inputs=jenc, pad_to=pad)
    tl, tc = tt.prefill(tp, ttoks[:, :PROMPT], tcfg, encoder_inputs=tenc,
                        pad_to=pad)
    out["prefill"] = (jl, tl)
    out["cache"] = {f"{pos}/{k}": (np.asarray(jc[pos][k]), _np(tc[pos][k]))
                    for pos in jc for k in jc[pos]}
    out["decodes"] = []
    for i in range(STEPS):
        s = PROMPT + i
        jd, jc = jt.decode_step(params, jnp.asarray(toks[:, s:s + 1]), jc,
                                jnp.asarray(s), jcfg)
        td, _ = tt.decode_step(tp, ttoks[:, s:s + 1], tc, s, tcfg)
        out["decodes"].append((jd, td))
    return out


@pytest.fixture(scope="module")
def f32_run():
    return _serve_both()


@pytest.mark.parametrize("length,dim", [(64, 256), (448, 768)])
def test_sinusoidal_positions_match_reference(length, dim):
    """The encoder's and (448) the decoder's text context at published
    width.  The tables' exp rounds the last bit apart in a few
    frequencies (XLA's against PyTorch's), which the angle carries as
    position x ulp: 3.1e-5 at 448 positions, 1.2e-4 at the encoder's
    1500."""
    want = np.asarray(jcommon.sinusoidal_positions(length, dim))
    got = tcommon.sinusoidal_positions(length, dim).numpy()
    assert got.shape == want.shape == (length, dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL)


def test_encode_matches_reference(f32_run):
    want, got = f32_run["encode"]
    assert tuple(got.shape) == want.shape == (2, ENC, 256)
    assert _rel(want, _np(got)) < TOL


def test_forward_with_encoder_inputs_matches_reference(f32_run):
    want, got = f32_run["forward"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL


def test_prefill_logits_and_cache_match_reference(f32_run):
    want, got = f32_run["prefill"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL
    assert set(f32_run["cache"]) == {"pos0/k", "pos0/v", "pos0/cross_k",
                                     "pos0/cross_v"}
    for name, (w, g) in f32_run["cache"].items():
        assert g.shape == w.shape, name
        assert _rel(w, g) < TOL, name
    assert f32_run["cache"]["pos0/cross_k"][1].shape == (2, 2, ENC, 4, 64)


def test_decode_steps_match_reference(f32_run):
    fwd = np.asarray(f32_run["forward"][0])
    for i, (want, got) in enumerate(f32_run["decodes"]):
        assert tuple(got.shape) == want.shape
        assert _rel(want, _np(got)) < TOL, i
        # ... and the reference's own parity: decode == forward there.
        assert _rel(fwd[:, PROMPT + i], _np(got)[:, 0]) < TOL, i


def test_bf16_serving_matches_reference():
    run = _serve_both("bfloat16", seed=7)
    stages = [(k, run[k]) for k in ("encode", "forward", "prefill")] + [
        (f"decode {i}", d) for i, d in enumerate(run["decodes"])]
    for stage, (want, got) in stages:
        assert got.dtype == torch.bfloat16
        assert _rel(want, _np(got)) < BF16_TOL, stage


def test_conversion_carries_the_encoder():
    """The reference's tree crosses with its ``encoder`` subtree and the
    decoder blocks' ``norm_cross`` / ``cross`` leaves; a tree without the
    encoder is refused for an encoder-decoder configuration."""
    jcfg, tcfg, params, tp = _setup()
    assert set(tp["encoder"]) == {"layers", "final_norm"}
    assert tuple(tp["encoder"]["layers"]["pos0"]["mixer"]["wq"].shape) == \
        (jcfg.encoder_layers, 256, 256)
    assert {"norm_cross", "cross"} <= set(tp["layers"]["pos0"])
    flat = jax.tree_util.tree_map(np.asarray, params)
    del flat["encoder"]
    with pytest.raises(ValueError, match="encoder"):
        convert.transformer_params_from_numpy(flat, tcfg)


def test_encoder_inputs_required():
    _, tcfg, _, tp = _setup()
    with pytest.raises(ValueError, match="encoder_inputs"):
        tt.prefill(tp, torch.zeros((1, 4), dtype=torch.long), tcfg)


def test_serving_params_keeps_cross_norm_f32():
    """``norm_cross`` (LayerNorm scale and bias) stays f32 in the serving
    copy, as the reference reads it; the cross projections take the
    compute dtype."""
    cfg = tconfigs.get(ARCH).reduced(num_layers=2, dtype_compute="bfloat16")
    sp = tt.serving_params(tt.init(torch.Generator().manual_seed(0), cfg),
                           cfg)
    block = sp["layers"]["pos0"]
    assert {t.dtype for t in block["norm_cross"].values()} == {torch.float32}
    assert {t.dtype for t in block["cross"].values()} == {torch.bfloat16}
    assert "q_norm" not in block["cross"]
    enc = sp["encoder"]
    assert enc["final_norm"]["bias"].dtype == torch.float32
    assert enc["layers"]["pos0"]["mixer"]["wq"].dtype == torch.bfloat16


def test_param_count_matches_reference():
    """The encoder's layers and final norm are counted."""
    assert tt.param_count(tconfigs.get(ARCH)) == \
        jt.param_count(jconfigs.get(ARCH)) == 278_143_488


def main() -> None:
    """Print the readings the tests hold (relative errors)."""
    torch.set_num_threads(1)
    for dtype in ("float32", "bfloat16"):
        run = _serve_both(dtype)
        cache = {k: f"{_rel(w, g):.2e}" for k, (w, g) in run["cache"].items()}
        print(f"{ARCH} {dtype}: "
              + ", ".join(f"{k} {_rel(run[k][0], _np(run[k][1])):.2e}"
                          for k in ("encode", "forward", "prefill"))
              + f", cache {cache}, decodes "
              + ", ".join(f"{_rel(w, _np(g)):.2e}" for w, g in run["decodes"]))
    for length in (448, 1500):
        d = np.abs(np.asarray(jcommon.sinusoidal_positions(length, 768))
                   - tcommon.sinusoidal_positions(length, 768).numpy()).max()
        print(f"sinusoidal_positions({length}, 768): max abs diff {d:.3g}")


if __name__ == "__main__":
    main()
