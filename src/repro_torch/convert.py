"""Carry state across from the JAX package, given as numpy arrays.

The port never imports the reference; a caller (the parity tests)
converts the reference's arrays to numpy and hands them over here, so
both implementations compute on the same weights, network and data.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core import wireless
from repro_torch.data import partition
from repro_torch.models import paper_nets


def paper_net_from_numpy(params_np: Mapping[str, Mapping[str, np.ndarray]],
                         spec: paper_nets.PaperNetSpec) -> nn.Module:
    """A paper net holding the reference's weights.

    ``params_np`` is the reference's nested ``{"fc1": {"w", "b"}, ...}``
    pytree.  A dense ``w`` of shape (in, out) becomes ``nn.Linear``'s
    (out, in) ``weight``; conv weights are OIHW on both sides.
    """
    model = paper_nets.build(spec)
    state = {}
    for layer, leaves in params_np.items():
        w = torch.from_numpy(np.array(leaves["w"], np.float32))
        if w.dim() == 2:
            w = w.T.contiguous()
        state[f"{layer}.weight"] = w
        state[f"{layer}.bias"] = torch.from_numpy(
            np.array(leaves["b"], np.float32))
    model.load_state_dict(state, strict=True)
    return model


def paper_net_to_numpy(params: Mapping[str, torch.Tensor]
                       ) -> dict[str, dict[str, np.ndarray]]:
    """The inverse of :func:`paper_net_from_numpy` for a params dict."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for name, t in params.items():
        layer, kind = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if kind == "weight":
            out.setdefault(layer, {})["w"] = a.T if a.ndim == 2 else a
        else:
            out.setdefault(layer, {})["b"] = a
    return out


def network_from_numpy(*, distance_m, pathloss, tx_power, cpu_freq,
                       cycles_per_bit) -> wireless.NetworkState:
    """A :class:`wireless.NetworkState` of f32 CPU tensors: (K,) leaves,
    or the (S, K) leaves of the reference's stacked ``sample_networks``
    (a batch's networks)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))
    return wireless.NetworkState(t(distance_m), t(pathloss), t(tx_power),
                                 t(cpu_freq), t(cycles_per_bit))


def dataset_from_numpy(*, images, labels, mask, sizes, test_images,
                       test_labels) -> partition.ClientDataset:
    """A :class:`partition.ClientDataset` of CPU tensors."""
    return partition.ClientDataset(
        images=torch.from_numpy(np.array(images, np.uint8)),
        labels=torch.from_numpy(np.array(labels, np.int32)),
        mask=torch.from_numpy(np.array(mask, np.float32)),
        sizes=torch.from_numpy(np.array(sizes, np.int32)),
        test_images=torch.from_numpy(np.array(test_images, np.uint8)),
        test_labels=torch.from_numpy(np.array(test_labels, np.int32)))


def transformer_params_from_numpy(params_np, cfg, device=None) -> dict:
    """The model zoo's parameters from the reference's pytree as numpy.

    ``params_np`` is ``{"embed", "layers": {"pos<i>": {... stacked
    (num_groups, ...)}}, "final_norm", "lm_head"}``, as
    ``repro.models.transformer.init`` builds it; the port keeps the same
    nesting, shapes and (in, out) weight layout, so each leaf becomes a
    tensor of its dtype on ``device``.  ``cfg`` is checked against the
    port's support (``transformer.check_supported``).
    """
    from repro_torch.models import transformer
    transformer.check_supported(cfg)

    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree)).to(device)

    return conv(params_np)

