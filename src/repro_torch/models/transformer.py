"""Model assembly for the dense decoder-only zoo: serving and evaluation.

Port of ``repro.models.transformer`` for configurations whose mixers are
all ``attn`` and whose FFNs are all ``mlp`` (h2o-danube-3-4b,
codeqwen1.5-7b, qwen3-14b, stablelm-12b).  A model is: token embedding ->
``num_groups`` repetitions of the layer ``pattern`` -> final norm -> LM
head.  Layer parameters are stacked per pattern position with a leading
group dim, as in the reference, and run as a Python loop over the groups
(the reference's ``unroll`` mode; without a backward pass ``remat`` has
no meaning).  Any other mixer, MoE FFNs, encoder-decoder models, M-RoPE
or embedding inputs raise ``NotImplementedError`` naming their ROADMAP
item.

Three entry points:

* :func:`forward`      — full-sequence logits (evaluation)
* :func:`prefill`      — prompt -> last-token logits + decode cache
* :func:`decode_step`  — one token + cache -> logits; the cache is
  updated in place

``decode_step`` takes the position ``index`` as a host ``int``: the
serving loop counts positions on the host, so the kernel's ``kv_len``
costs no device-to-host sync.  The reference casts every weight to the
compute dtype at each use; :func:`serving_params` makes that copy once,
after which the same casts are no-ops and a decode step reads only the
compute-dtype weights.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention, common, moe
from repro_torch.models.config import LayerSpec, ModelConfig

Params = Dict[str, Any]

# Leaves the reference reads in f32 whatever the compute dtype.
_F32_KEYS = frozenset({"norm1", "norm2", "final_norm", "q_norm", "k_norm"})


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    mixers = {s.mixer for s in cfg.pattern}
    if cfg.is_encdec or cfg.cross_attention or cfg.pos_embedding != "rope":
        what = ("encoder-decoder models (Whisper: encoder, cross-attention, "
                "sinusoidal positions)", "17g")
    elif cfg.input_mode != "tokens" or cfg.mrope_sections:
        what = "VLM inputs (M-RoPE, embeddings input)", "17f"
    elif mixers - {"attn"} and "attn" in mixers:
        what = "hybrid attention/SSM stacks (Jamba)", "17e"
    elif "mamba" in mixers:
        what = "SSM (Mamba) mixers", "17c"
    elif mixers - {"attn"}:
        what = "xLSTM mixers", "17d"
    elif cfg.is_moe:
        what = "MoE FFNs (router and expert dispatch)", "17b"
    elif any(s.ffn != "mlp" for s in cfg.pattern):
        what = "layers without an MLP", "17"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what[0]} are not ported yet (ROADMAP item {what[1]})")


def _index(index) -> int:
    if isinstance(index, torch.Tensor):
        raise TypeError("decode_step takes index as a host int, not a "
                        "tensor (reading a tensor would sync the device)")
    return operator.index(index)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters on ``gen``'s device, in ``dtype_params`` (norms f32),
    with the reference's nesting: ``{"embed", "layers": {"pos<i>": {...
    stacked (num_groups, ...)}}, "final_norm", "lm_head"}``."""
    check_supported(cfg)
    with torch.device(gen.device):
        return _init(gen, cfg)


def _init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """:func:`init` on the default device."""
    dt = common.dtype_of(cfg.dtype_params)
    grp = (cfg.num_groups,)
    p: Params = {"embed": common.embed_init(gen, cfg.vocab_size,
                                            cfg.d_model, dt)}
    p["layers"] = {
        f"pos{i}": {
            "norm1": common.norm_init(cfg.d_model, cfg.norm_type, grp),
            "mixer": attention.init(gen, cfg, grp),
            "norm2": common.norm_init(cfg.d_model, cfg.norm_type, grp),
            "ffn": moe.mlp_init(gen, cfg, groups=grp),
        } for i in range(len(cfg.pattern))}
    p["final_norm"] = common.norm_init(cfg.d_model, cfg.norm_type)
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         cfg.d_model, dt)
    return p


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    """From shape-only ``meta`` tensors (a CPU generator draws nothing
    into them)."""
    check_supported(cfg)
    with torch.device("meta"):
        return sum(t.numel() for t in _leaves(_init(torch.Generator(), cfg)))


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """A copy of ``params`` with every weight the blocks cast at use in
    the compute dtype (the norms' parameters and ``q_norm``/``k_norm``
    stay f32, as the blocks read them).  The products then see the same
    rounded values as with ``params``."""
    dt = common.dtype_of(cfg.dtype_compute)

    def cast(tree, keep: bool):
        if isinstance(tree, dict):
            return {k: cast(v, keep or k in _F32_KEYS)
                    for k, v in tree.items()}
        return tree if keep else tree.to(dt)

    return cast(params, False)


def _group(tree, g: int):
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


# ---------------------------------------------------------------------------
# Blocks and entry points
# ---------------------------------------------------------------------------

def _block_full(bp: Params, spec: LayerSpec, x: torch.Tensor,
                cfg: ModelConfig, positions, collect_state: bool):
    """Pre-norm residual block.  Returns ``(x, (k, v) or None)``."""
    h = common.apply_norm(bp["norm1"], x, cfg.norm_type, cfg.norm_eps)
    h, kv = attention.forward(bp["mixer"], h, cfg, positions,
                              layer_window=spec.sliding_window,
                              return_kv=collect_state)
    x = x + h
    h = common.apply_norm(bp["norm2"], x, cfg.norm_type, cfg.norm_eps)
    return x + moe.mlp_apply(bp["ffn"], h, cfg), kv


def embed_inputs(params: Params, inputs: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> embeddings in the compute dtype."""
    x = torch.nn.functional.embedding(inputs, params["embed"])
    return x.to(common.dtype_of(cfg.dtype_compute))


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    x = common.apply_norm(params["final_norm"], x, cfg.norm_type,
                          cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head.to(x.dtype)
    if cfg.logits_softcap > 0.0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def default_positions(inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = inputs.shape[:2]
    return torch.arange(s, device=inputs.device)[None].expand(b, s)


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, V) and the MoE aux loss (0 here)."""
    check_supported(cfg)
    x = embed_inputs(params, inputs, cfg)
    positions = default_positions(inputs, cfg)
    for g in range(cfg.num_groups):
        gp = _group(params["layers"], g)
        for i, spec in enumerate(cfg.pattern):
            x, _ = _block_full(gp[f"pos{i}"], spec, x, cfg, positions, False)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(params, x, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Params:
    """Zero decode cache, stacked (num_groups, B, L, KV, hd) per pattern
    position: full-attention layers hold ``max_len`` positions, SWA
    layers a ring of ``sliding_window`` slots, as the reference's
    ``prefill`` lays them out (its ``init_cache`` trims the ring to
    ``max_len`` when that is shorter, and a ring shorter than the window
    would drop visible keys once decoding passes ``max_len``)."""
    check_supported(cfg)
    dtype = dtype or common.dtype_of(cfg.dtype_compute)
    return {f"pos{i}": attention.init_cache(
        cfg, batch, cfg.sliding_window if spec.sliding_window
        and cfg.sliding_window else max_len, dtype, device,
        groups=(cfg.num_groups,)) for i, spec in enumerate(cfg.pattern)}


def _attn_cache_layout(dst: Dict[str, torch.Tensor], k: torch.Tensor,
                       v: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
                       seq_len: int) -> None:
    """Lay prefill K/V into one layer's decode cache ``dst`` (zeros):
    full-attention layers take positions 0..S-1 (the rest stays the
    zero padding up to ``pad_to``); SWA layers scatter the last
    ``window`` entries into ring slots ``pos % window``."""
    if spec.sliding_window and cfg.sliding_window:
        w = cfg.sliding_window
        p0 = max(0, seq_len - w)
        slots = torch.arange(p0, seq_len, device=k.device) % w
        dst["k"][:, slots] = k[:, p0:]
        dst["v"][:, slots] = v[:, p0:]
    else:
        dst["k"][:, :seq_len] = k
        dst["v"][:, :seq_len] = v


def prefill(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
            pad_to: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Process the prompt (B, S); return (last-token logits (B, 1, V),
    decode cache).  Full-attention layers keep S positions zero-padded to
    ``pad_to`` (when larger), SWA layers a ring of ``sliding_window``
    slots."""
    check_supported(cfg)
    x = embed_inputs(params, inputs, cfg)
    positions = default_positions(inputs, cfg)
    b, seq_len = inputs.shape[:2]
    full_len = pad_to if pad_to is not None and pad_to > seq_len else seq_len
    caches = init_cache(cfg, b, full_len, x.dtype, x.device)
    for g in range(cfg.num_groups):
        gp = _group(params["layers"], g)
        for i, spec in enumerate(cfg.pattern):
            x, (k, v) = _block_full(gp[f"pos{i}"], spec, x, cfg, positions,
                                    True)
            _attn_cache_layout(_group(caches[f"pos{i}"], g), k, v, spec,
                               cfg, seq_len)
    return lm_logits(params, x[:, -1:, :], cfg), caches


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                index: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) ids; ``index``: the new token's
    position, a host int.  Returns (logits (B, 1, V), cache), the cache
    updated in place."""
    check_supported(cfg)
    index = _index(index)
    x = embed_inputs(params, tokens, cfg)
    for g in range(cfg.num_groups):
        for i, spec in enumerate(cfg.pattern):
            bp = _group(params["layers"][f"pos{i}"], g)
            h = common.apply_norm(bp["norm1"], x, cfg.norm_type,
                                  cfg.norm_eps)
            h, _ = attention.decode(bp["mixer"], h,
                                    _group(cache[f"pos{i}"], g), index, cfg,
                                    layer_window=spec.sliding_window)
            x = x + h
            h = common.apply_norm(bp["norm2"], x, cfg.norm_type,
                                  cfg.norm_eps)
            x = x + moe.mlp_apply(bp["ffn"], h, cfg)
    return lm_logits(params, x, cfg), cache
