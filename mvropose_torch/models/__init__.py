"""torch model zoo: ViT backbone, CNN stem, keypoint/angle heads, fusion,
and the multi-view estimator (counterparts of `mvropose_tpu/models`)."""

from mvropose_torch.models.estimator import EstimatorConfig, MultiViewPoseEstimator
from mvropose_torch.models.fusion import MultiViewFusion, SelfAttentionFusion
from mvropose_torch.models.vit import ViTBackbone, ViTConfig

__all__ = ["EstimatorConfig", "MultiViewFusion", "MultiViewPoseEstimator", "SelfAttentionFusion",
           "ViTBackbone", "ViTConfig"]
