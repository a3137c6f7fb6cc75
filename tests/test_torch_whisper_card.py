"""The encoder-decoder and the VLM on the card, and the flash kernel at
their shapes.

Every test needs a CUDA device and skips without one; the file imports
no JAX, so it runs where only the port's dependencies are installed
(``pytest tests/test_torch_whisper_card.py -k on_card``):

* the flash kernel at whisper's head width hd 64 with one query head per
  KV head (G = 1): cross-attention's non-causal prefill of 64 decoder
  rows against 1500 encoder frames, the encoder's 1500 x 1500 (1500 not
  a multiple of the 64-row tiles), decode against the 1500-frame
  encoder cache and against a 448-slot self-attention cache filled to
  97; and qwen2-vl's G = 8 at hd 128, causal, Sq = 1000.  In f32 and
  bf16 against the plain version, each launch after a NaN fill of
  shared memory and with the keys past ``kv_len`` NaN;
* whisper-small and qwen2-vl-72b at ``reduced()`` from one set of
  weights and inputs on the card and on the CPU, f32 with TF32 off:
  whisper's ``encode``, ``forward`` with ``encoder_inputs``, prefill and
  3 decode steps; qwen2-vl's ``forward`` over an image grid's three-axis
  positions, its embeddings prefill and 3 decode steps; within 1e-4 of
  the largest logit, every attention call through the kernel.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _check  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

TOL = 1e-4
# (B, Sq, Skv, H, KV, hd), masks: the shapes chip_smoke.py's FLASH_EDGES
# adds for paths 18-19.
EDGES = [((2, 64, 1500, 12, 12, 64), dict(causal=False, window=0)),
         ((1, 1500, 1500, 12, 12, 64), dict(causal=False, window=0)),
         ((4, 1, 1500, 12, 12, 64), dict(causal=False, window=0)),
         ((4, 1, 448, 12, 12, 64), dict(causal=False, window=0, kv_len=97)),
         ((1, 1000, 1000, 64, 8, 128), dict(causal=True, window=0))]
# bf16 prefill check (b): rounding to nearest reads about 0, truncation
# about -1 (chip_smoke.py and tests/test_torch_flash.py hold the same).
BIAS_LIMIT = 0.25


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_whisper_and_vlm_shapes_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, sq, skv, h, kv, hd), kw in EDGES:
        q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
                   .to(dtype) for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                                            (b, skv, kv, hd)))
        k[:, kw.get("kv_len", skv):] = float("nan")
        route = tfa.route(dtype, sq)
        routed = tfa.flash_attention.route_launches[route]
        _check.fill_shared_memory(cuda_device)
        got = tfa.flash_attention(q, k, v, **kw)
        assert tfa.flash_attention.route_launches[route] == routed + 1
        qf, kf, vf = q.float(), k.float(), v.float()
        want = tfa.flash_attention_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        assert bool(got.isfinite().all()), (sq, skv, h, kv, hd)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5
        elif route == "prefill_tc":
            want_abs_v = tfa.flash_attention_plain(qf, kf, vf.abs(), **kw)
            assert _check.bf16_prefill_ratio(got, want, want_abs_v,
                                             1e-5) <= 1.0
            assert abs(_check.bf16_rounding_bias(got, want)) <= BIAS_LIMIT
        else:
            assert _check.bf16_rounding_ratio(got, want, 1e-5) <= 1.0


def _grid_positions(b, prefix=3, rows=8, cols=8, tail=2):
    """Text on all three axes, then a rows x cols image at t = prefix
    with h, w over its grid, then text one past the largest id."""
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                          indexing="ij")
    img = torch.stack([torch.zeros(rows * cols, dtype=torch.long),
                       r.flatten(), c.flatten()]) + prefix
    nxt = prefix + max(rows, cols)
    pos = torch.cat([torch.arange(prefix).expand(3, prefix), img,
                     torch.arange(nxt, nxt + tail).expand(3, tail)], dim=1)
    return pos[:, None].expand(3, b, pos.shape[1]).contiguous()


def _serve(params, cfg, device, prompt, toks, enc=None, positions=None,
           full=None):
    def to(t):
        return None if t is None else t.to(device)
    p = tree_map(lambda t: t.to(device), params)
    e, s, steps = to(enc), prompt.shape[1], toks.shape[1]
    out = [transformer.encode(p, e, cfg)] if enc is not None else []
    out.append(transformer.forward(p, to(full), cfg, positions=to(positions),
                                   encoder_inputs=e)[0])
    logits, cache = transformer.prefill(p, to(prompt), cfg, encoder_inputs=e,
                                        pad_to=s + steps)
    out.append(logits)
    for i in range(steps):
        logits, cache = transformer.decode_step(p, to(toks[:, i:i + 1]),
                                                cache, s + i, cfg)
        out.append(logits)
    return [x.float().cpu() for x in out]


def _inputs(arch, gen, b=2, steps=3):
    cfg = configs.get(arch).reduced()
    if cfg.is_encdec:
        s = 40
        enc = torch.randn((b, 150, cfg.d_model), generator=gen)
        full = torch.randint(0, cfg.vocab_size, (b, s + steps), generator=gen)
        return cfg, dict(prompt=full[:, :s], toks=full[:, s:], enc=enc,
                         full=full)
    positions = _grid_positions(b)
    prompt = torch.randn((b, positions.shape[-1], cfg.d_model), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (b, steps), generator=gen)
    return cfg, dict(prompt=prompt, toks=toks, positions=positions,
                     full=prompt)


@pytest.mark.parametrize("arch", ["whisper_small", "qwen2_vl_72b"])
def test_card_matches_cpu_on_card(cuda_device, no_tf32, arch):
    gen = torch.Generator().manual_seed(2)
    cfg, inputs = _inputs(arch, gen)
    params = transformer.init(gen, cfg)
    before = dict(tfa.flash_attention.route_launches)
    card = _serve(params, cfg, cuda_device, **inputs)
    routed = {r: n - before[r]
              for r, n in tfa.flash_attention.route_launches.items()}
    cpu = _serve(params, cfg, "cpu", **inputs)
    for want, got in zip(cpu, card):
        assert float((want - got).abs().max() / want.abs().max()) <= TOL
    # Every attention call on the card launched the kernel: whisper's
    # encode (2 layers), forward and prefill (2 encoder + 1 self + 1
    # cross each) and 3 steps of self + cross; qwen2-vl's 1 layer.
    steps = inputs["toks"].shape[1]
    if cfg.is_encdec:
        want = dict(prefill_tc=0, prefill_f32=10, decode=2 * steps,
                    backward=0, backward_tc=0)
    else:
        want = dict(prefill_tc=0, prefill_f32=2, decode=steps, backward=0,
                    backward_tc=0)
    assert routed == want
