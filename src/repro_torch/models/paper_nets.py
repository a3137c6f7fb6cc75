"""The paper's two evaluation models (§VI-A.2): a small CNN and an MLP.

Port of ``repro.models.paper_nets`` as ``nn.Module``s.  CNN: two 5x5
VALID convolutions (10 then 20 channels), each followed by ReLU and a
2x2 max pool, a 50-unit ReLU dense layer and the class logits.  MLP: two
dense layers.  The public functions keep the reference's layout: images
are float32 ``(B, H, W)`` in [0, 1]; the conv weights are OIHW as in the
reference; a dense ``w`` of shape (in, out) there is ``weight`` of shape
(out, in) here (``repro_torch.convert`` carries weights across).

:func:`loss_fn` and :func:`accuracy` take the parameters as a dict of
tensors and run the module through ``torch.func.functional_call``, so
the trainer can ``vmap`` them over stacked per-client parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PaperNetSpec:
    kind: str = "cnn"          # cnn | mlp
    image_size: int = 28
    num_classes: int = 10
    mlp_hidden: int = 200
    cnn_hidden: int = 50


def cnn_flat_dim(spec: PaperNetSpec) -> int:
    s = spec.image_size
    s = (s - 4) // 2          # conv 5x5 VALID + pool 2
    s = (s - 4) // 2
    return 20 * s * s


class PaperCNN(nn.Module):
    def __init__(self, spec: PaperNetSpec):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, 5)
        self.conv2 = nn.Conv2d(10, 20, 5)
        self.fc1 = nn.Linear(cnn_flat_dim(spec), spec.cnn_hidden)
        self.fc2 = nn.Linear(spec.cnn_hidden, spec.num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images[:, None, :, :]                       # NCHW
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        return self.fc2(x)


class PaperMLP(nn.Module):
    def __init__(self, spec: PaperNetSpec):
        super().__init__()
        d_in = spec.image_size * spec.image_size
        self.fc1 = nn.Linear(d_in, spec.mlp_hidden)
        self.fc2 = nn.Linear(spec.mlp_hidden, spec.num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.reshape(images.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))


def build(spec: PaperNetSpec) -> nn.Module:
    """The module for ``spec`` (weights uninitialised; see :func:`init`)."""
    if spec.kind == "cnn":
        return PaperCNN(spec)
    if spec.kind == "mlp":
        return PaperMLP(spec)
    raise ValueError(f"unknown paper net kind: {spec.kind!r}")


@torch.no_grad()
def init(spec: PaperNetSpec, gen: torch.Generator,
         device: torch.device | str = "cpu") -> nn.Module:
    """The reference's initialisation: He-normal weights (fan-in
    ``c_in * 5 * 5`` for convolutions), zero biases, drawn from ``gen``."""
    model = build(spec).to(device)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            w = torch.randn(mod.weight.shape, generator=gen,
                            device=mod.weight.device)
            mod.weight.copy_(w * math.sqrt(2.0 / fan_in))
            mod.bias.zero_()
    return model


def params_of(model: nn.Module) -> Params:
    """Detached copies of the model's parameters, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def loss_fn(model: nn.Module, params: Params, images: torch.Tensor,
            labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean softmax cross-entropy (padded-batch safe)."""
    logits = functional_call(model, params, (images,))
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return torch.sum(nll * mask) / denom


def accuracy(model: nn.Module, params: Params, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    logits = functional_call(model, params, (images,))
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


def num_params(params: Params) -> int:
    return sum(p.numel() for p in params.values())
