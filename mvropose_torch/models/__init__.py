"""torch model zoo: ViT backbone, CNN stem, keypoint/angle heads, fusion,
and the single- and multi-view estimators (counterparts of `mvropose_tpu/models`)."""

from mvropose_torch.models.estimator import (
    EstimatorConfig,
    GeometricAngleHead,
    MultiViewPoseEstimator,
    SingleViewPoseEstimator,
)
from mvropose_torch.models.fusion import MultiViewFusion, SelfAttentionFusion
from mvropose_torch.models.vit import ViTBackbone, ViTConfig

__all__ = ["EstimatorConfig", "GeometricAngleHead", "MultiViewFusion", "MultiViewPoseEstimator",
           "SelfAttentionFusion", "SingleViewPoseEstimator", "ViTBackbone", "ViTConfig"]
