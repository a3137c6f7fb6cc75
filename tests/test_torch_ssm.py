"""The port's Mamba (SSD) mixer against the JAX package.

``repro_torch.models.ssm`` is held against ``repro.models.ssm`` on
numpy-seeded inputs and the reference's weights (f32): the chunked SSD
against the reference's chunked form and against its step-by-step
oracle ``kernels/ref.py::ssd_sequential``, with a carried ``h0`` and
through both chunk rules (doubling past 64 chunks, one chunk where the
chunk does not divide the sequence); the block's ``forward`` with its
state; and prefill followed by ``decode`` steps against ``forward``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as kref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from test_torch_transformer import _rel, one_thread  # noqa: E402,F401

# The same arithmetic in another summation order, relative to the
# largest output (or state) value.
TOL = 1e-5
# Against the sequential oracle the chunking itself reorders the sums:
# the reference holds its own chunked form to it at 1e-4
# (tests/test_models.py::test_ssd_chunked_matches_sequential).
SEQ_TOL = 1e-4
FIELDS = dict(d_model=32, ssm_state_dim=8, ssm_expand=2, ssm_head_dim=8,
              ssm_chunk=16, dtype_compute="float32", dtype_params="float32")


def _ssd_inputs(seed, b=2, s=64, nh=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, nh, p)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    dt_s = np.log1p(np.exp(rng.standard_normal((b, s, nh)))) \
        .astype(np.float32)
    log_a = (-dt_s * rng.uniform(1.0, 4.0, nh)).astype(np.float32)
    h0 = rng.standard_normal((b, nh, n, p)).astype(np.float32)
    return xh, bm, cm, log_a, dt_s, h0


def _t(a):
    return torch.from_numpy(np.array(a))


# (s, chunk): 4 chunks; 50 % 16 -> one chunk of 50; 1024 / 8 = 128 > 64
# chunks -> the chunk doubles to 16 (64 chunks).
CHUNKS = [(64, 16), (50, 16), (1024, 8)]


@pytest.mark.parametrize("s,chunk", CHUNKS)
def test_ssd_chunked_matches_reference(s, chunk):
    xh, bm, cm, log_a, dt_s, h0 = _ssd_inputs(s, s=s)
    for init in (None, h0):
        jy, jh = jssm._ssd_chunked(
            *map(jnp.asarray, (xh, bm, cm, log_a, dt_s)), chunk,
            h0=None if init is None else jnp.asarray(init))
        ty, th = tssm._ssd_chunked(
            *map(_t, (xh, bm, cm, log_a, dt_s)), chunk,
            h0=None if init is None else _t(init))
        assert _rel(jy, ty.numpy()) < TOL
        assert _rel(jh, th.numpy()) < TOL
        assert th.dtype == torch.float32


@pytest.mark.parametrize("s,chunk", CHUNKS)
def test_ssd_chunked_matches_sequential_oracle(s, chunk):
    xh, bm, cm, log_a, dt_s, _ = _ssd_inputs(s + 1, s=s)
    want_y, want_h = kref.ssd_sequential(
        *map(jnp.asarray, (xh, bm, cm, log_a, dt_s)))
    ty, th = tssm._ssd_chunked(*map(_t, (xh, bm, cm, log_a, dt_s)), chunk)
    assert _rel(want_y, ty.numpy()) < SEQ_TOL
    assert _rel(want_h, th.numpy()) < SEQ_TOL


def test_ssd_carried_state_continues_the_sequence():
    """Two halves, the second from the first's final state, give the
    whole sequence's outputs and state."""
    xh, bm, cm, log_a, dt_s, _ = _ssd_inputs(7, s=64)
    args = list(map(_t, (xh, bm, cm, log_a, dt_s)))
    y, h = tssm._ssd_chunked(*args, 16)
    y1, h1 = tssm._ssd_chunked(*(a[:, :32] for a in args), 16)
    y2, h2 = tssm._ssd_chunked(*(a[:, 32:] for a in args), 16, h0=h1)
    assert _rel(y.numpy(), torch.cat([y1, y2], dim=1).numpy()) < TOL
    assert _rel(h.numpy(), h2.numpy()) < TOL


def _block(seed, **kw):
    jcfg, tcfg = JConfig(**FIELDS, **kw), TConfig(**FIELDS, **kw)
    jp = jssm.init(jax.random.key(seed), jcfg)
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _xs(seed, b=2, s=48):
    return np.random.default_rng(seed).standard_normal((b, s, 32)) \
        .astype(np.float32)


@pytest.mark.parametrize("s", [48, 40])
def test_forward_with_state_matches_reference(s):
    """48 tokens: 3 chunks of 16; 40: one chunk of 40."""
    jcfg, tcfg, jp, tp = _block(s)
    x = _xs(s + 1, s=s)
    jout, jst = jssm.forward(jp, jnp.asarray(x), jcfg, None,
                             return_state=True)
    tout, tst = tssm.forward(tp, _t(x), tcfg, return_state=True)
    assert _rel(jout, tout.numpy()) < TOL
    assert set(tst) == set(jst)
    for name in jst:
        assert tuple(tst[name].shape) == jst[name].shape, name
        assert _rel(jst[name], tst[name].numpy()) < TOL, name
    out, none = tssm.forward(tp, _t(x), tcfg)
    assert none is None and torch.equal(out, tout)


def test_prefill_then_decode_matches_forward():
    """forward's state after 40 tokens, then 6 decode steps: each step's
    output against forward over the whole sequence at that position, and
    against the reference's decode from the reference's state."""
    jcfg, tcfg, jp, tp = _block(3)
    s, steps = 40, 6
    x = _xs(4, s=s + steps)
    full, _ = tssm.forward(tp, _t(x), tcfg)
    _, state = tssm.forward(tp, _t(x[:, :s]), tcfg, return_state=True)
    _, jstate = jssm.forward(jp, jnp.asarray(x[:, :s]), jcfg, None,
                             return_state=True)
    for i in range(steps):
        xt = x[:, s + i:s + i + 1]
        out, state = tssm.decode(tp, _t(xt), state, tcfg)
        jout, jstate = jssm.decode(jp, jnp.asarray(xt), jstate, jcfg, None)
        assert tuple(out.shape) == (2, 1, 32)
        assert _rel(full[:, s + i].numpy(), out[:, 0].numpy()) < TOL, i
        assert _rel(jout, out.numpy()) < TOL, i
        for name in jstate:
            assert _rel(jstate[name], state[name].numpy()) < TOL, (i, name)


def test_init_matches_reference_layout():
    """The reference's leaves, shapes and dtypes (the step-size bias,
    decay, skip and norm f32 whatever ``dtype_params``), stacked over
    layer groups; the step sizes' bias inverts softplus on [1e-3, 1e-1]
    and the decay's log lies in [0, log 16]."""
    jcfg = JConfig(**dict(FIELDS, dtype_params="bfloat16"))
    tcfg = TConfig(**dict(FIELDS, dtype_params="bfloat16"))
    jp = jax.eval_shape(lambda key: jssm.init(key, jcfg), jax.random.key(0))
    tp = tssm.init(torch.Generator().manual_seed(0), tcfg, groups=(2,))
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == (2,) + leaf.shape, name
        assert str(tp[name].dtype).split(".")[1] == str(leaf.dtype), name
    step = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((step > 1e-3 - 1e-7) & (step < 1e-1 + 1e-7)).all())
    assert bool(((tp["A_log"] >= 0) & (tp["A_log"] <= np.log(16))).all())
    st = tssm.init_state(tcfg, 3, torch.bfloat16, groups=(2,))
    jst = jssm.init_state(jcfg, 3, jnp.bfloat16)
    for name in jst:
        assert tuple(st[name].shape) == (2,) + jst[name].shape, name
        assert str(st[name].dtype).split(".")[1] == str(jst[name].dtype)
