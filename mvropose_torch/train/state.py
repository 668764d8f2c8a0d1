"""Train state: the model, two AdamW parameter groups and their cosine schedules.

Port of `mvropose_tpu/train/state.py`. The reference's
`optax.multi_transform` of one `adamw(cosine_decay_schedule)` per group
becomes one `torch.optim.AdamW` with a parameter group per label:

  * "kpt" (lr_kpt) and "ang" (lr_ang): betas (0.9, 0.999), eps 1e-8 and
    `TrainConfig.weight_decay` (0.0: torch's AdamW default would be 0.01);
  * each group's lr is `cosine_decay(lr, count, total_steps, eta_min)`,
    optax's `cosine_decay_schedule(lr, total_steps, alpha=eta_min / lr)`,
    evaluated at the update count *before* the increment, so the first update
    uses the initial lr;
  * "frozen" (the backbone under `freeze_backbone`, optax's `set_to_zero`):
    its parameters stop requiring gradients and are in no group, so they stay
    bit-identical.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

# Top-level module names of the keypoint path, the angle head and the
# backbone, as the reference splits its parameters.
KPT_MODULES = ("cnn_stem", "view_embeddings", "fusion_module", "keypoint_enricher", "keypoint_head")
ANG_MODULES = ("angle_head",)
FROZEN_MODULES = ("backbone",)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 100
    steps_per_epoch: int = 100
    lr_kpt: float = 1e-4
    lr_ang: float = 1e-4
    eta_min: float = 1e-6
    loss_weight_kpt: float = 100.0
    loss_weight_fk: float = 0.0  # the single-view step's FK-consistency term
    angle_beta: float = 1.0
    weight_decay: float = 0.0
    freeze_backbone: bool = True

    @property
    def total_steps(self) -> int:
        return self.num_epochs * self.steps_per_epoch


def cosine_decay(lr: float, count: int, total_steps: int, eta_min: float) -> float:
    """optax.cosine_decay_schedule(lr, total_steps, alpha=eta_min / lr)(count)."""
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, total_steps) / total_steps))
    alpha = eta_min / lr
    return lr * ((1.0 - alpha) * cosine + alpha)


def param_groups(model: nn.Module, freeze_backbone: bool = True) -> dict[str, list]:
    """{"kpt" | "ang" | "frozen": [parameters]} by top-level module. A module
    with parameters that no group names raises: it would otherwise train
    under some group's lr, or unfrozen, with no symptom."""
    if any(True for _ in model.parameters(recurse=False)):
        raise ValueError("the model holds parameters outside any top-level module")
    known = set(KPT_MODULES) | set(ANG_MODULES) | set(FROZEN_MODULES)
    groups = {"kpt": [], "ang": [], "frozen": []}
    for name, module in model.named_children():
        params = list(module.parameters())
        if not params:
            continue
        if name not in known:
            raise ValueError(
                f"param module '{name}' is not in any optimizer group (known: {sorted(known)}); "
                "add it to KPT_MODULES/ANG_MODULES/FROZEN_MODULES in train/state.py"
            )
        if freeze_backbone and name in FROZEN_MODULES:
            groups["frozen"] += params
        elif name in ANG_MODULES:
            groups["ang"] += params
        else:
            groups["kpt"] += params
    return groups


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over the "kpt" and "ang" groups (each remembers its initial lr
    as "base_lr"); the "frozen" group's parameters are left out."""
    groups = param_groups(model, cfg.freeze_backbone)
    return torch.optim.AdamW(
        [{"params": groups[g], "lr": lr, "base_lr": lr, "name": g}
         for g, lr in (("kpt", cfg.lr_kpt), ("ang", cfg.lr_ang))],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
    )


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the config and the update count."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    cfg: TrainConfig
    step: int = 0

    def apply_gradients(self) -> None:
        """One AdamW update of the gradients in `.grad`, each group at its
        schedule's lr for the current count; then the count goes up."""
        for group in self.optimizer.param_groups:
            group["lr"] = cosine_decay(group["base_lr"], self.step, self.cfg.total_steps,
                                       self.cfg.eta_min)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Freeze the backbone's parameters under `cfg.freeze_backbone` and build
    the two-group optimizer over the rest."""
    for p in param_groups(model, cfg.freeze_backbone)["frozen"]:
        p.requires_grad_(False)
    return TrainState(model=model, optimizer=make_optimizer(model, cfg), cfg=cfg)
