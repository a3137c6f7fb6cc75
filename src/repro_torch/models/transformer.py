"""Model assembly for the zoo: serving, evaluation, training.

Port of ``repro.models.transformer`` for every configuration of the zoo:
the four dense decoders (h2o-danube-3-4b, codeqwen1.5-7b, qwen3-14b,
stablelm-12b), the MoE decoders (mixtral-8x22b, qwen3-moe-235b-a22b),
the Jamba hybrid, xlstm-125m, the VLM (qwen2-vl-72b: precomputed patch
embeddings in, M-RoPE) and the encoder-decoder (whisper-small).  A model
is: input embedding (the token table, or a pass-through of precomputed
frontend embeddings) -> ``num_groups`` repetitions of the layer
``pattern`` -> final norm -> LM head.  Layer parameters are stacked per
pattern position with a leading group dim, as in the reference, and run
as a Python loop over the groups (the reference's ``unroll`` mode; the
train steps' rematerialization is ``launch.steps.chunked_xent``'s).

Whisper-style encoder-decoder: :func:`encode` runs the non-causal
encoder over stub frame embeddings; decoder blocks add cross-attention
against per-layer K/V computed once from the encoder output, which
:func:`prefill` keeps in the decode cache (``cross_k`` / ``cross_v``).

Three entry points:

* :func:`forward`      — full-sequence logits (training / evaluation),
  or the final-norm hidden states (``return_hidden``)
* :func:`prefill`      — prompt -> last-token logits + decode cache
* :func:`decode_step`  — one token + cache -> logits; the cache is
  updated in place (attention K/V and recurrent states alike)

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

from repro_torch.models import attention, common, moe, ssm, xlstm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]

# Leaves the reference reads in f32 whatever the compute dtype: the
# norms (cross-attention's ``norm_cross`` too), xLSTM's gate projections, biases and sLSTM recurrence, the MoE
# router (a rounded router flips top-k choices) and Mamba's step-size
# bias, decay and skip (``D``, which forward casts at use).
_F32_KEYS = frozenset({"norm1", "norm2", "norm_cross", "final_norm",
                       "q_norm", "k_norm", "norm", "wif", "if_bias", "wr",
                       "bias", "router", "dt_bias", "A_log", "D"})
# The encoder's one pattern position (Whisper).
ENC_SPEC = LayerSpec("attn", "mlp")


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
    stacked (num_groups, ...)}}, "final_norm", "lm_head"}``, and for an
    encoder-decoder ``"encoder": {"layers": {"pos0": ... stacked
    (encoder_layers, ...)}, "final_norm"}``."""
    with torch.device(gen.device):
        return _init(gen, cfg)


def _init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """:func:`init` on the default device."""
    dt = common.dtype_of(cfg.dtype_params)
    grp = (cfg.num_groups,)
    p: Params = {"embed": common.embed_init(gen, cfg.vocab_size,
                                            cfg.d_model, dt)}
    p["layers"] = {f"pos{i}": _block_init(gen, spec, cfg, grp,
                                          cfg.cross_attention)
                   for i, spec in enumerate(cfg.pattern)}
    p["final_norm"] = common.norm_init(cfg.d_model, cfg.norm_type)
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         cfg.d_model, dt)
    if cfg.is_encdec:
        p["encoder"] = {
            "layers": {"pos0": _block_init(gen, ENC_SPEC, cfg,
                                           (cfg.encoder_layers,))},
            "final_norm": common.norm_init(cfg.d_model, cfg.norm_type)}
    return p


_MIXER_INIT = {"attn": attention.init, "mamba": ssm.init,
               "mlstm": xlstm.mlstm_init, "slstm": xlstm.slstm_init}


def _block_init(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
                grp: Tuple[int, ...], cross: bool = False) -> Params:
    """One pattern position's stacked block: ``norm1`` and ``mixer``,
    ``norm_cross`` and ``cross`` (cross-attention) if ``cross``, then
    ``norm2`` and ``ffn`` unless the layer has no FFN."""
    p: Params = {"norm1": common.norm_init(cfg.d_model, cfg.norm_type, grp),
                 "mixer": _MIXER_INIT[spec.mixer](gen, cfg, grp)}
    if cross:
        p["norm_cross"] = common.norm_init(cfg.d_model, cfg.norm_type, grp)
        p["cross"] = attention.init(gen, cfg, grp, cross=True)
    if spec.ffn != "none":
        p["norm2"] = common.norm_init(cfg.d_model, cfg.norm_type, grp)
        p["ffn"] = (moe.moe_init if spec.ffn == "moe" else moe.mlp_init)(
            gen, cfg, groups=grp)
    return p


def init_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as shape-only ``meta`` tensors, with
    :func:`init`'s shapes and dtypes and no storage (a CPU generator
    draws nothing into them): the dry-run path."""
    with torch.device("meta"):
        return _init(torch.Generator(), cfg)


def param_count(cfg: ModelConfig) -> int:
    """From :func:`init_shapes`; an encoder-decoder's encoder included."""
    return sum(t.numel() for t in tree_leaves(init_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top-k of E experts), counted as
    the reference counts them: in a MoE model it scales the ``wi`` /
    ``wg`` / ``wo`` leaves of every FFN by ``(E - k) / E``, Jamba's
    dense MLPs too."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    frac = (cfg.num_experts - cfg.num_experts_per_tok) / cfg.num_experts
    layers = init_shapes(cfg)["layers"]
    inactive = sum(int(ffn[name].numel() * frac)
                   for ffn in (pos.get("ffn", {}) for pos in layers.values())
                   for name in ("wi", "wg", "wo") if name in ffn)
    return total - inactive


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """A copy of ``params`` with every weight the blocks cast at use in
    the compute dtype (the norms' parameters, ``q_norm``/``k_norm``,
    xLSTM's gate and recurrent leaves, the MoE router and Mamba's
    ``dt_bias`` / ``A_log`` / ``D`` stay f32, as the blocks read them).
    The products then see the same rounded values as with ``params``."""
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

def _mixer_full(bp: Params, spec: LayerSpec, h: torch.Tensor,
                cfg: ModelConfig, positions, collect_state: bool,
                causal: Optional[bool] = None):
    if spec.mixer == "attn":
        h, kv = attention.forward(bp["mixer"], h, cfg, positions,
                                  layer_window=spec.sliding_window,
                                  causal=causal, return_kv=collect_state)
        return h, ({"k": kv[0], "v": kv[1]} if collect_state else None)
    fwd = {"mamba": ssm.forward, "mlstm": xlstm.mlstm_forward,
           "slstm": xlstm.slstm_forward}[spec.mixer]
    return fwd(bp["mixer"], h, cfg, return_state=collect_state)


def _ffn(bp: Params, spec: LayerSpec, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN half of a block: ``(x, the MoE aux loss or None)``."""
    if spec.ffn == "none":
        return x, None
    h = common.apply_norm(bp["norm2"], x, cfg.norm_type, cfg.norm_eps)
    if spec.ffn == "moe":
        h, aux = moe.moe_apply(bp["ffn"], h, cfg)
        return x + h, aux
    return x + moe.mlp_apply(bp["ffn"], h, cfg), None


def _block_full(bp: Params, spec: LayerSpec, x: torch.Tensor,
                cfg: ModelConfig, positions, collect_state: bool,
                causal: Optional[bool] = None,
                enc_out: Optional[torch.Tensor] = None):
    """Pre-norm residual block: the mixer, cross-attention against
    ``enc_out`` where the block has it, the FFN.  Returns ``(x, aux,
    state)``: the MoE aux loss (None without a MoE FFN), and when
    ``collect_state`` an attention layer's ``{"k", "v"}`` (with
    ``"cross_k"`` / ``"cross_v"`` under cross-attention) or a recurrent
    mixer's final state, else None."""
    h = common.apply_norm(bp["norm1"], x, cfg.norm_type, cfg.norm_eps)
    h, state = _mixer_full(bp, spec, h, cfg, positions, collect_state,
                           causal)
    x = x + h
    if "cross" in bp and enc_out is not None:
        h = common.apply_norm(bp["norm_cross"], x, cfg.norm_type,
                              cfg.norm_eps)
        kv = attention.cross_kv(bp["cross"], enc_out, cfg)
        h, _ = attention.forward(bp["cross"], h, cfg, None,
                                 layer_window=False, kv_override=kv)
        x = x + h
        if collect_state:
            state = dict(state, cross_k=kv[0], cross_v=kv[1])
    x, aux = _ffn(bp, spec, x, cfg)
    return x, aux, state


def embed_inputs(params: Params, inputs: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> embeddings in the compute dtype; float inputs
    (B, S, D) are precomputed frontend embeddings (the VLM's patches,
    the audio frames) and pass through.  Absolute positions add the
    sinusoid of positions 0..S-1."""
    if inputs.is_floating_point():
        x = inputs
    else:
        x = torch.nn.functional.embedding(inputs, params["embed"])
    x = x.to(common.dtype_of(cfg.dtype_compute))
    if cfg.pos_embedding == "absolute":
        pos = common.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
        x = x + pos[None].to(x.dtype)
    return x


def head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The (D, V) LM head."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def final_norm(params: Params, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    return common.apply_norm(params["final_norm"], x, cfg.norm_type,
                             cfg.norm_eps)


def lm_logits(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    x = final_norm(params, x, cfg)
    logits = x @ head_matrix(params, cfg).to(x.dtype)
    if cfg.logits_softcap > 0.0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def default_positions(inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Positions 0..S-1 for each sequence, (B, S); under M-RoPE the same
    on all three axes, (3, B, S) (text-like)."""
    b, s = inputs.shape[:2]
    pos = torch.arange(s, device=inputs.device)[None].expand(b, s)
    return pos[None].expand(3, b, s) if cfg.mrope_sections else pos


def _encoder_out(params: Params, cfg: ModelConfig,
                 encoder_inputs: Optional[torch.Tensor]):
    if not cfg.is_encdec:
        return None
    if encoder_inputs is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         f"encoder_inputs")
    return encode(params, encoder_inputs, cfg)


def encode(params: Params, embeds: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, S_enc, D):
    non-causal attention blocks, then the encoder's final norm."""
    x = embed_inputs(params, embeds, cfg)
    enc = params["encoder"]
    for g in range(cfg.encoder_layers):
        x, _, _ = _block_full(_group(enc["layers"]["pos0"], g), ENC_SPEC, x,
                              cfg, None, False, causal=False)
    return common.apply_norm(enc["final_norm"], x, cfg.norm_type,
                             cfg.norm_eps)


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None,
            encoder_inputs: Optional[torch.Tensor] = None,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, V) and the MoE aux loss, summed over
    the MoE layers (0 without any).  ``inputs``: token ids (B, S) or
    embeddings (B, S, D); ``positions`` (RoPE: (B, S), M-RoPE: (3, B,
    S)) default to :func:`default_positions`; an encoder-decoder needs
    ``encoder_inputs`` (B, S_enc, D).

    ``return_hidden=True`` returns the final-norm hidden states (B, S, D)
    in place of the logits, so the loss can fold the LM head into a
    chunked cross-entropy (``launch.steps.chunked_xent``).
    """
    enc_out = _encoder_out(params, cfg, encoder_inputs)
    x = embed_inputs(params, inputs, cfg)
    if positions is None and cfg.pos_embedding == "rope":
        positions = default_positions(inputs, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        gp = _group(params["layers"], g)
        for i, spec in enumerate(cfg.pattern):
            x, a, _ = _block_full(gp[f"pos{i}"], spec, x, cfg, positions,
                                  False, enc_out=enc_out)
            if a is not None:
                aux = aux + a
    if return_hidden:
        return final_norm(params, x, cfg), aux
    return lm_logits(params, x, cfg), aux


def _layer_cache_init(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      max_len: int, dtype, device,
                      enc_len: Optional[int]) -> Params:
    grp = (cfg.num_groups,)
    if spec.mixer == "mamba":
        c = ssm.init_state(cfg, batch, dtype, device, grp)
    elif spec.mixer == "mlstm":
        c = xlstm.mlstm_init_state(cfg, batch, device, grp)
    elif spec.mixer == "slstm":
        c = xlstm.slstm_init_state(cfg, batch, device, grp)
    else:
        size = (cfg.sliding_window
                if spec.sliding_window and cfg.sliding_window else max_len)
        c = attention.init_cache(cfg, batch, size, dtype, device, groups=grp)
    if cfg.cross_attention and enc_len is not None:
        cross = attention.init_cache(cfg, batch, enc_len, dtype, device,
                                     groups=grp)
        c = dict(c, cross_k=cross["k"], cross_v=cross["v"])
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, enc_len: Optional[int] = None) -> Params:
    """Decode cache, stacked (num_groups, ...) per pattern position.
    Attention layers: zero K/V (B, L, KV, hd) in ``dtype``, full-attention
    layers holding ``max_len`` positions and SWA layers a ring of
    ``sliding_window`` slots, as the reference's ``prefill`` lays them out
    (its ``init_cache`` trims the ring to ``max_len`` when that is
    shorter, and a ring shorter than the window would drop visible keys
    once decoding passes ``max_len``).  Mamba, mLSTM and sLSTM layers:
    the recurrent state's start, in f32 whatever ``dtype`` (Mamba's conv
    buffer of pre-conv inputs in ``dtype``), as the reference's.  Under
    cross-attention with ``enc_len``, each layer also holds ``cross_k`` /
    ``cross_v`` (B, enc_len, KV, hd), which :func:`prefill` fills."""
    dtype = dtype or common.dtype_of(cfg.dtype_compute)
    return {f"pos{i}": _layer_cache_init(spec, cfg, batch, max_len, dtype,
                                         device, enc_len)
            for i, spec in enumerate(cfg.pattern)}


def _store_state(dst: Dict[str, torch.Tensor],
                 state: Dict[str, torch.Tensor]) -> None:
    """Write a recurrent mixer's state (or cross-attention's K/V) into
    its layer's cache slices."""
    for key, t in state.items():
        dst[key].copy_(t)


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
            encoder_inputs: Optional[torch.Tensor] = None,
            pad_to: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Process the prompt (token ids (B, S) or embeddings (B, S, D), at
    :func:`default_positions`); return (last-token logits (B, 1, V),
    decode cache).  Full-attention layers keep S positions zero-padded to
    ``pad_to`` (when larger), SWA layers a ring of ``sliding_window``
    slots, recurrent layers their final state; an encoder-decoder
    encodes ``encoder_inputs`` and keeps each layer's cross-attention
    K/V."""
    enc_out = _encoder_out(params, cfg, encoder_inputs)
    x = embed_inputs(params, inputs, cfg)
    positions = (default_positions(inputs, cfg)
                 if cfg.pos_embedding == "rope" else None)
    b, seq_len = inputs.shape[:2]
    full_len = pad_to if pad_to is not None and pad_to > seq_len else seq_len
    caches = init_cache(cfg, b, full_len, x.dtype, x.device,
                        None if enc_out is None else enc_out.shape[1])
    for g in range(cfg.num_groups):
        gp = _group(params["layers"], g)
        for i, spec in enumerate(cfg.pattern):
            x, _, state = _block_full(gp[f"pos{i}"], spec, x, cfg,
                                      positions, True, enc_out=enc_out)
            dst = _group(caches[f"pos{i}"], g)
            if spec.mixer == "attn":
                _attn_cache_layout(dst, state.pop("k"), state.pop("v"),
                                   spec, cfg, seq_len)
            _store_state(dst, state)
    return lm_logits(params, x[:, -1:, :], cfg), caches


def cache_max_len(cache: Params) -> int:
    """The self-attention cache's length (1 without attention)."""
    for pos in cache.values():
        if "k" in pos:
            return int(pos["k"].shape[2])
    return 1


def _embed_step(params: Params, tokens: torch.Tensor, index: int,
                cache: Params, cfg: ModelConfig) -> torch.Tensor:
    """A decode step's token embeddings; absolute positions add row
    ``index`` of a sinusoid table ``cache_max_len(cache)`` long (the
    reference's ``dynamic_slice`` clamps the row into it)."""
    if cfg.pos_embedding != "absolute":
        return embed_inputs(params, tokens, cfg)
    x = torch.nn.functional.embedding(tokens, params["embed"]).to(
        common.dtype_of(cfg.dtype_compute))
    row = min(index, cache_max_len(cache) - 1)
    pos = torch.arange(row, row + 1, device=x.device)
    return x + common.sinusoid(pos, cfg.d_model)[None].to(x.dtype)


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                index: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) ids; ``index``: the new token's
    position, a host int (M-RoPE: on all three axes).  Returns (logits
    (B, 1, V), cache), the cache updated in place; cross-attention
    attends the cache's encoder K/V."""
    index = _index(index)
    x = _embed_step(params, tokens, index, cache, cfg)
    for g in range(cfg.num_groups):
        for i, spec in enumerate(cfg.pattern):
            bp = _group(params["layers"][f"pos{i}"], g)
            gc = _group(cache[f"pos{i}"], g)
            h = common.apply_norm(bp["norm1"], x, cfg.norm_type,
                                  cfg.norm_eps)
            if spec.mixer == "attn":
                h, _ = attention.decode(bp["mixer"], h, gc, index, cfg,
                                        layer_window=spec.sliding_window)
            else:
                dec = {"mamba": ssm.decode, "mlstm": xlstm.mlstm_decode,
                       "slstm": xlstm.slstm_decode}[spec.mixer]
                h, state = dec(bp["mixer"], h, gc, cfg)
                _store_state(gc, state)
            x = x + h
            if "cross" in bp and "cross_k" in gc:
                h = common.apply_norm(bp["norm_cross"], x, cfg.norm_type,
                                      cfg.norm_eps)
                h, _ = attention.decode(
                    bp["cross"], h, gc, index, cfg, layer_window=False,
                    cross_cache=(gc["cross_k"], gc["cross_v"]))
                x = x + h
            x, _ = _ffn(bp, spec, x, cfg)     # decode drops the aux
    return lm_logits(params, x, cfg), cache
