"""Data constants shared with the reference (`mvropose_tpu/data/dataset.py:39-40`)."""

import numpy as np

# DINOv2/v3 normalization (ImageNet), as used by every reference transform.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
