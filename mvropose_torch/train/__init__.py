"""Training: losses, metrics, the two-group AdamW train state and the
multi-view train and eval steps (counterparts of `mvropose_tpu/train`)."""

from mvropose_torch.train.losses import (
    heatmap_mse_loss,
    masked_multiview_heatmap_loss,
    smooth_l1_loss,
)
from mvropose_torch.train.metrics import add_auc, add_metric, angle_mae, pass_rate_auc, pck_at_k
from mvropose_torch.train.state import TrainConfig, TrainState, create_train_state, make_optimizer
from mvropose_torch.train.step import make_eval_step, make_multi_view_train_step

__all__ = [
    "TrainConfig",
    "TrainState",
    "add_auc",
    "add_metric",
    "angle_mae",
    "create_train_state",
    "heatmap_mse_loss",
    "make_eval_step",
    "make_multi_view_train_step",
    "make_optimizer",
    "masked_multiview_heatmap_loss",
    "pass_rate_auc",
    "pck_at_k",
    "smooth_l1_loss",
]
