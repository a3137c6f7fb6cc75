"""The MoE decoders and the Jamba hybrid on the card, and the flash
kernel at their query groups.

Every test needs a CUDA device and skips without one; the file imports
no JAX, so it runs where only the port's dependencies are installed
(``pytest tests/test_torch_moe_card.py -k on_card``):

* mixtral-8x22b, qwen3-moe-235b-a22b and jamba-1.5-large-398b at
  ``reduced()`` from one set of weights and tokens on the card and on the
  CPU, f32 with TF32 off, ``dense_grouped`` in groups of 32 tokens at half
  the capacity (so that several groups drop assignments): forward,
  prefill and 3 decode steps within 1e-4 of the largest logit, and every
  MoE call's expert ids and kept assignments equal;
* the flash kernel's prefill at hd 128 and query groups G = 6 (window
  4096, Sq past it), 8 and 16 (Sq not a multiple of 64, ``kv_len`` <
  Skv), and its decode at G = 8, in f32 and bf16 against the plain
  version, each launch after a NaN fill of shared memory and with the
  keys past ``kv_len`` NaN.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _check  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

TOL = 1e-4
ARCHS = ("mixtral_8x22b", "qwen3_moe_235b_a22b", "jamba_1_5_large_398b")
# Groups of 16 tokens or fewer never drop (the capacity's floor).
DISPATCH = dict(moe_group_size=32, moe_capacity_factor=0.5)
# (B, Sq, Skv, H, KV, hd), masks: paths 15-17's query groups.
EDGES = [((1, 4500, 4500, 6, 1, 128), dict(causal=True, window=4096)),
         ((2, 300, 300, 16, 2, 128), dict(causal=True, window=0)),
         ((1, 250, 250, 16, 1, 128), dict(causal=True, window=0,
                                           kv_len=230)),
         ((2, 1, 500, 64, 8, 128), dict(causal=False, window=0,
                                        kv_len=450))]
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


def _recorded(monkeypatch, route=moe.route, slots=moe.dispatch_slots):
    """Record each MoE call's expert ids and kept assignments (wrapping
    the module's own functions, bound at import)."""
    rec = {"ids": [], "keep": []}

    def route_rec(*args, **kw):
        out = route(*args, **kw)
        rec["ids"].append(out[0].cpu())
        return out

    def slots_rec(*args, **kw):
        out = slots(*args, **kw)
        rec["keep"].append(out[1].cpu())
        return out
    monkeypatch.setattr(moe, "route", route_rec)
    monkeypatch.setattr(moe, "dispatch_slots", slots_rec)
    return rec


def _serve(params, tokens, cfg, s, steps):
    logits = [transformer.forward(params, tokens, cfg)[0]]
    out, cache = transformer.prefill(params, tokens[:, :s], cfg,
                                     pad_to=s + steps)
    logits.append(out)
    for i in range(steps):
        out, cache = transformer.decode_step(
            params, tokens[:, s + i:s + i + 1], cache, s + i, cfg)
        logits.append(out)
    return [x.float().cpu() for x in logits]


@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu_on_card(cuda_device, no_tf32, monkeypatch, arch):
    cfg = dataclasses.replace(configs.get(arch).reduced(), **DISPATCH)
    gen = torch.Generator().manual_seed(1)
    params = transformer.init(gen, cfg)
    b, s, steps = 2, 128, 3
    tokens = torch.randint(0, cfg.vocab_size, (b, s + steps), generator=gen)
    runs = {}
    for device in ("cpu", cuda_device):
        rec = _recorded(monkeypatch)
        runs[str(device)] = (_serve(tree_map(lambda t: t.to(device), params),
                                    tokens.to(device), cfg, s, steps), rec)
    (cpu, rec_cpu), (card, rec_card) = runs["cpu"], runs[str(cuda_device)]
    for want, got in zip(cpu, card):
        assert float((want - got).abs().max() / want.abs().max()) <= TOL
    assert len(rec_cpu["ids"]) == len(rec_card["ids"]) > 0
    for key in ("ids", "keep"):
        for want, got in zip(rec_cpu[key], rec_card[key]):
            assert torch.equal(want, got), key
    # The prefill's calls drop assignments in several groups.
    moes = cfg.num_groups * sum(x.ffn == "moe" for x in cfg.pattern)
    for keep in rec_cpu["keep"][moes:2 * moes]:
        assert keep.shape[0] == b * s // 32
        assert int((~keep).any(dim=(1, 2)).sum()) >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_moe_query_groups_on_card(cuda_device, dtype):
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
        assert bool(got.isfinite().all())
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5
        elif route == "prefill_tc":
            want_abs_v = tfa.flash_attention_plain(qf, kf, vf.abs(), **kw)
            assert _check.bf16_prefill_ratio(got, want, want_abs_v,
                                             1e-5) <= 1.0
            assert abs(_check.bf16_rounding_bias(got, want)) <= BIAS_LIMIT
        else:
            assert _check.bf16_rounding_ratio(got, want, 1e-5) <= 1.0
