"""The VLM (qwen2-vl-72b) in the port against the JAX package.

``repro_torch.models`` serves qwen2-vl-72b's backbone: precomputed patch
embeddings (B, S, D) go in through ``embed_inputs``'s pass-through,
attention rotates by M-RoPE over (temporal, height, width) position ids,
and decode feeds generated text tokens through the embedding table.
Held against ``repro.models`` on the same weights (the reference's
``init`` converted with ``convert.transformer_params_from_numpy``) and
numpy-seeded inputs, at ``reduced(num_layers=2)``:

* ``mrope_sin_cos`` at the reduced sections (4, 6, 6) with hd 64, which
  cover 16 of 32 frequency slots (the rest follow the width axis, as
  ``jnp.repeat``'s ``total_repeat_length`` pads), and at the published
  (16, 24, 24) with hd 128;
* ``forward`` over an image grid's three-axis positions;
* the embeddings-input ``prefill`` (logits and every cache tensor) and
  ``decode_step``s past the prompt, and the reference's own parity:
  prefill + decode equals ``forward`` over the prompt with the decoded
  token's embedding appended;
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

ARCH = "qwen2_vl_72b"
TOL = 1e-4
BF16_TOL = 2e-2
# A 4 x 5 grid of patches after a 3-token text prefix (the t, h, w ids of
# Qwen2-VL's get_rope_index: text runs on all three axes, an image holds
# t and spreads h and w over its grid), then text again.
GRID_H, GRID_W, PREFIX = 4, 5, 3
S = PREFIX + GRID_H * GRID_W + 2


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


def grid_positions(b: int) -> np.ndarray:
    """(3, B, S) int32: text positions 0..PREFIX-1 on all axes, the
    grid's patches at t = PREFIX and (h, w) = PREFIX + (row, column),
    then text from one past the largest id."""
    t, h, w = [], [], []
    for i in range(PREFIX):
        t.append(i), h.append(i), w.append(i)
    for r in range(GRID_H):
        for c in range(GRID_W):
            t.append(PREFIX), h.append(PREFIX + r), w.append(PREFIX + c)
    nxt = PREFIX + max(GRID_H, GRID_W)
    for i in range(S - len(t)):
        t.append(nxt + i), h.append(nxt + i), w.append(nxt + i)
    pos = np.array([t, h, w], np.int32)
    return np.broadcast_to(pos[:, None], (3, b, S)).copy()


def _setup(dtype_compute="float32", seed=0):
    jcfg = jconfigs.get(ARCH).reduced(num_layers=2,
                                      dtype_compute=dtype_compute)
    tcfg = tconfigs.get(ARCH).reduced(num_layers=2,
                                      dtype_compute=dtype_compute)
    params = jt.init(jax.random.key(seed), jcfg)
    tp = convert.transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, tp


def _embeds(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)


def _serve_both(dtype_compute="float32", b=2, s=S, steps=3, seed=0):
    """Embeddings prompt -> prefill -> ``steps`` decode steps of text
    tokens, both implementations; and the reference's forward over the
    prompt with the first decoded token's embedding appended."""
    jcfg, tcfg, params, tp = _setup(dtype_compute, seed)
    if dtype_compute == "bfloat16":
        tp = tt.serving_params(tp, tcfg)
    emb = _embeds(b, s, jcfg.d_model, seed + 1)
    toks = np.random.default_rng(seed + 2).integers(
        0, jcfg.vocab_size, (b, steps)).astype(np.int32)
    out = {}
    jl, jc = jt.prefill(params, jnp.asarray(emb), jcfg, pad_to=s + steps)
    tl, tc = tt.prefill(tp, torch.from_numpy(emb), tcfg, pad_to=s + steps)
    out["prefill"] = (jl, tl)
    out["cache"] = {f"{pos}/{k}": (np.asarray(jc[pos][k]), _np(tc[pos][k]))
                    for pos in jc for k in jc[pos]}
    out["decodes"] = []
    for i in range(steps):
        jd, jc = jt.decode_step(params, jnp.asarray(toks[:, i:i + 1]), jc,
                                jnp.asarray(s + i), jcfg)
        td, _ = tt.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]).long(),
                               tc, s + i, tcfg)
        out["decodes"].append((jd, td))
    # The reference's own decode parity: the first decoded token's table
    # row appended to the embeddings prompt.
    row = np.asarray(params["embed"])[toks[:, 0]][:, None]
    jf, _ = jt.forward(params, jnp.asarray(np.concatenate([emb, row], 1)),
                       jcfg)
    out["forward_last"] = np.asarray(jf)[:, -1]
    return out


@pytest.fixture(scope="module")
def f32_run():
    return _serve_both()


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 64),
                                         ((16, 24, 24), 128)])
def test_mrope_sin_cos_matches_reference(sections, hd):
    pos = np.random.default_rng(3).integers(0, 4000, (3, 2, 40))
    js, jc = jcommon.mrope_sin_cos(jnp.asarray(pos), hd, 1e6, sections)
    ts, tc = tcommon.mrope_sin_cos(torch.from_numpy(pos), hd, 1e6, sections)
    assert tuple(ts.shape) == js.shape == (2, 40, hd // 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


def test_mrope_axes_pad_with_the_width_axis():
    """``jnp.repeat(..., total_repeat_length)`` pads a short repeat with
    its last value and truncates a long one."""
    assert tcommon.mrope_axes((4, 6, 6), 32) == \
        [0] * 4 + [1] * 6 + [2] * 22
    assert tcommon.mrope_axes((16, 24, 24), 64) == \
        [0] * 16 + [1] * 24 + [2] * 24
    assert tcommon.mrope_axes((4, 6, 6), 8) == [0] * 4 + [1] * 4
    for sections, slots in (((4, 6, 6), 32), ((4, 6, 6), 8), ((2, 1, 1), 9)):
        want = jnp.repeat(jnp.arange(3), jnp.asarray(sections),
                          total_repeat_length=slots)
        assert tcommon.mrope_axes(sections, slots) == \
            np.asarray(want).tolist()


def test_forward_with_grid_positions_matches_reference():
    """M-RoPE's three axes apart (an image grid), embeddings in."""
    jcfg, tcfg, params, tp = _setup(seed=4)
    emb = _embeds(2, S, jcfg.d_model, 5)
    pos = grid_positions(2)
    want, _ = jt.forward(params, jnp.asarray(emb), jcfg,
                         positions=jnp.asarray(pos))
    got, _ = tt.forward(tp, torch.from_numpy(emb), tcfg,
                        positions=torch.from_numpy(pos).long())
    assert tuple(got.shape) == want.shape == (2, S, jcfg.vocab_size)
    assert _rel(want, _np(got)) < TOL
    # ... and the grid's positions matter: text-like ones give others.
    text, _ = tt.forward(tp, torch.from_numpy(emb), tcfg)
    assert _rel(want, _np(text)) > 1e-3


def test_embeddings_prefill_and_cache_match_reference(f32_run):
    want, got = f32_run["prefill"]
    assert tuple(got.shape) == want.shape
    assert _rel(want, _np(got)) < TOL
    assert set(f32_run["cache"]) == {"pos0/k", "pos0/v"}
    for name, (w, g) in f32_run["cache"].items():
        assert g.shape == w.shape, name
        assert _rel(w, g) < TOL, name


def test_decode_steps_match_reference(f32_run):
    for i, (want, got) in enumerate(f32_run["decodes"]):
        assert tuple(got.shape) == want.shape
        assert _rel(want, _np(got)) < TOL, i
    first = _np(f32_run["decodes"][0][1])[:, 0]
    assert _rel(f32_run["forward_last"], first) < TOL


def test_bf16_serving_matches_reference():
    run = _serve_both("bfloat16", steps=2, seed=6)
    for stage, (want, got) in [("prefill", run["prefill"])] + [
            (f"decode {i}", d) for i, d in enumerate(run["decodes"])]:
        assert got.dtype == torch.bfloat16
        assert _rel(want, _np(got)) < BF16_TOL, stage


def test_param_count_matches_reference():
    assert tt.param_count(tconfigs.get(ARCH)) == \
        jt.param_count(jconfigs.get(ARCH)) == 72_705_384_448


def main() -> None:
    """Print the readings the tests hold (relative errors)."""
    torch.set_num_threads(1)
    for dtype in ("float32", "bfloat16"):
        run = _serve_both(dtype)
        cache = max(_rel(w, g) for w, g in run["cache"].values())
        print(f"{ARCH} {dtype}: prefill "
              f"{_rel(run['prefill'][0], _np(run['prefill'][1])):.2e}, "
              f"cache {cache:.2e}, decodes "
              + ", ".join(f"{_rel(w, _np(g)):.2e}" for w, g in run["decodes"])
              + f", decode vs forward "
              f"{_rel(run['forward_last'], _np(run['decodes'][0][1])[:, 0]):.2e}")


if __name__ == "__main__":
    main()
