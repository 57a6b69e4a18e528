"""CNN ensemble (counterpart of thyroid_tpu/models/ensemble/cnn_ensemble.py):
a weighted combination of trained member models.

Methods: accuracy-weighted probability averaging (`weighted_average`, and
any name JAX does not know), `simple_average`, and accuracy-weighted votes
of the members' argmax (`weighted_voting`); member probabilities are softmax(logits / temperature)
in float32, a member's tuple output taken at [0]. The inter-member standard
deviation (ddof 1) is the uncertainty. In JAX the ensemble holds (module,
variables) pairs; here it is a module over its member modules, which hold
their own weights (`build_ensemble_from_members` loads JAX trees into them,
`training/checkpoint.py` `restore_ensemble` the port's checkpoints).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ...ops.platform import DeviceLike, resolve_device
from ..from_jax import load_jax_variables
from ..registry import ModelRegistry, cfg_get

# the reference's measured member accuracies
DEFAULT_MODEL_ACCURACIES: Dict[str, float] = {
    "resnet50": 0.9118,
    "efficientnet_b0": 0.8971,
    "densenet121": 0.8824,
}
METHODS = ("weighted_average", "simple_average", "weighted_voting")


class CNNEnsemble(nn.Module):
    def __init__(self, member_names: Sequence[str],
                 modules: Sequence[nn.Module] = (),
                 model_accuracies: Optional[Mapping[str, float]] = None,
                 method: str = "weighted_average", temperature: float = 1.0):
        super().__init__()
        self.member_names = list(member_names)
        self.members = nn.ModuleList(modules)
        self.model_accuracies = dict(DEFAULT_MODEL_ACCURACIES
                                     if model_accuracies is None
                                     else model_accuracies)
        self.method, self.temperature = method, float(temperature)

    def init_weights(self, generator: torch.Generator) -> None:
        for member in self.members:
            member.init_weights(generator)

    def weights(self, device: DeviceLike = "cpu") -> torch.Tensor:
        """(M,) float32 member weights summing to 1."""
        if self.method == "simple_average":
            w = torch.ones(len(self.member_names))
        else:
            w = torch.tensor([float(self.model_accuracies.get(n, 1.0))
                              for n in self.member_names])
        return (w / w.sum()).to(device)

    def member_probs(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(M, B, num_classes) float32 softmax probabilities per member."""
        probs = []
        for member in self.members:
            logits = member(x, train=train)
            if isinstance(logits, tuple):
                logits = logits[0]
            probs.append(torch.softmax(logits.float() / self.temperature, dim=-1))
        return torch.stack(probs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Combined probabilities (B, num_classes)."""
        probs = self.member_probs(x)
        w = self.weights(x.device).reshape(-1, 1, 1)
        if self.method == "weighted_voting":
            votes = nn.functional.one_hot(probs.argmax(-1), probs.shape[-1])
            return (votes.float() * w).sum(dim=0)
        return (probs * w).sum(dim=0)

    def predict_with_uncertainty(self, x: torch.Tensor):
        """(weighted mean probabilities, inter-member std with ddof 1)."""
        probs = self.member_probs(x)
        w = self.weights(x.device).reshape(-1, 1, 1)
        return (probs * w).sum(dim=0), probs.std(dim=0, correction=1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """log of the combined probabilities clipped to [1e-8, 1], usable as
        distillation-teacher logits."""
        return torch.log(torch.clamp(self(x), 1e-8, 1.0))


def build_ensemble_from_members(
        member_configs: Sequence[Any],
        member_variables: Sequence[Mapping[str, Any]],
        model_accuracies: Optional[Mapping[str, float]] = None,
        method: str = "weighted_average", temperature: float = 1.0,
        device: DeviceLike = None) -> CNNEnsemble:
    """An ensemble of the members `member_configs` builds, each filled from
    its JAX variable tree, in eval mode on `device` (the card unless the
    CPU is asked for)."""
    if len(member_configs) != len(member_variables):
        raise ValueError(f"{len(member_configs)} members but "
                         f"{len(member_variables)} variable trees")
    names: List[str] = []
    modules: List[nn.Module] = []
    for cfg, variables in zip(member_configs, member_variables):
        names.append(cfg if isinstance(cfg, str) else cfg_get(cfg, "name"))
        module = ModelRegistry.create_model(cfg)
        load_jax_variables(module, variables)
        modules.append(module)
    return CNNEnsemble(names, modules, model_accuracies or None, method,
                       temperature).to(resolve_device(device)).eval()


@ModelRegistry.register("cnn_ensemble", "ensemble")
def build_cnn_ensemble(cfg: Any) -> CNNEnsemble:
    """Registry builder: the member modules built, their weights to be
    loaded from checkpoints (training/checkpoint.py restore_ensemble)."""
    members = list(cfg_get(cfg, "members", list(DEFAULT_MODEL_ACCURACIES)))
    num_classes = int(cfg_get(cfg, "num_classes", 2))
    in_channels = int(cfg_get(cfg, "in_channels", 1))
    modules = [ModelRegistry.create_model({"name": m, "num_classes": num_classes,
                                           "in_channels": in_channels})
               for m in members]
    return CNNEnsemble(
        members, modules,
        model_accuracies=dict(cfg_get(cfg, "model_accuracies",
                                      DEFAULT_MODEL_ACCURACIES)),
        method=str(cfg_get(cfg, "method", "weighted_average")),
        temperature=float(cfg_get(cfg, "temperature", 1.0)))
