"""Parameter PartitionSpec assignment (path and shape based, MaxText-style).

Port of ``repro.sharding.params``.  The zoo's parameters are nested
dicts; :func:`param_specs` walks the tree (tensors, ``meta`` ones from
``transformer.init_shapes`` included) and gives each leaf a spec:

* 2-D projections: the contraction-side dim on ``fsdp`` (= pod + data),
  the wide output dim on ``tensor`` (= model): 2-D FSDP x TP.
* MoE expert stacks (E, D, F): expert-parallel over ``tensor`` when E
  divides the model axis; otherwise per-expert tensor parallel on F.
* Vocab-dim tensors (``embed``, ``lm_head``) on ``model`` only.
* The sLSTM's block-diagonal recurrent ``wr``: replicated.
* Stacked layers carry a leading group dim: a ``None`` prefix.
* Norm scales, biases, gate vectors: replicated.
* :func:`_sanitize` then drops every axis that does not divide its dim
  (whisper's vocab 51,865 over a 16-way model axis): an input placement,
  unlike a constraint, cannot pad.

The port's parameter tree has the reference's paths and layouts leaf for
leaf (``transformer.init``), so the rules apply unchanged.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, PartitionSpec

Params = Any


def _axis(mesh: Mesh, logical: Optional[str]):
    return rules.resolve(logical, mesh)


def _spec_for(path: str, ndim: int, shape: tuple, cfg: ModelConfig,
              mesh: Mesh, stacked: bool) -> PartitionSpec:
    """Spec for one leaf; ``stacked``: a leading layer-group dim."""
    lead = (None,) if stacked else ()
    core_ndim = ndim - len(lead)
    fsdp = _axis(mesh, "fsdp")
    tensor = _axis(mesh, "tensor")
    name = path.rsplit("/", 1)[-1]

    if core_ndim <= 1:
        return P(*lead, None)

    # MoE expert stacks: (E, D, F) / (E, F, D).
    if name in ("wi", "wg", "wo") and core_ndim == 3:
        e = shape[len(lead)]
        if tensor is not None and rules.divisible(e, mesh, ("model",)):
            return P(*lead, tensor, fsdp, None)
        return (P(*lead, None, fsdp, tensor) if name in ("wi", "wg")
                else P(*lead, None, tensor, fsdp))

    # Vocab-dim tensors on `model` only: an fsdp-sharded d_model side
    # would reshard the batch-sharded hidden states against the
    # contraction.
    if name == "embed":
        return P(tensor, None)
    if name == "lm_head":
        return P(None, tensor)
    if name == "router":
        return P(*lead, fsdp, None)
    # sLSTM block-diagonal recurrent weights (nh, hd, 4hd): replicated.
    if name == "wr":
        return P(*lead, None, None, None)

    if core_ndim == 2:
        # Output-side projections back to d_model: contraction on tensor.
        if name in ("wo",):
            return P(*lead, tensor, fsdp)
        # Input-side projections from d_model: the wide dim on tensor.
        if name in ("wq", "wk", "wv", "wi", "wg", "wup", "wgate", "wz",
                    "wx"):
            return P(*lead, fsdp, tensor)
        if name in ("wB", "wC", "wdt", "wif", "wx4"):
            return P(*lead, fsdp, None)
        if name == "conv":
            return P(*lead, None, tensor)
        return P(*lead, fsdp, None)

    return P(*lead, *([None] * core_ndim))


def _sanitize(pspec: PartitionSpec, shape: tuple,
              mesh: Mesh) -> PartitionSpec:
    """Drop spec entries that do not divide their dim exactly."""
    out = []
    for dim, entry in zip(shape, tuple(pspec) + (None,) * len(shape)):
        size = rules.entry_size(entry, mesh)
        out.append(entry if (size <= 1 or dim % size == 0) else None)
    return P(*out)


def param_specs(shapes: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """A parameter tree (anything with ``.shape`` at the leaves) -> the
    PartitionSpec tree."""

    def walk(path: str, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        stacked = "/layers/" in path or path.startswith("layers/")
        shape = tuple(node.shape)
        return _sanitize(_spec_for(path, len(shape), shape, cfg, mesh,
                                   stacked), shape, mesh)

    return walk("", shapes)


def param_shardings(shapes: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """The DTensor placements of each leaf (``rules.placements`` of its
    spec)."""
    return rules.tree_spec(param_specs(shapes, cfg, mesh),
                           lambda _, s: rules.placements(s, mesh))
