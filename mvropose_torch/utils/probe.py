"""Backbone feature probe: port of `mvropose_tpu/utils/probe.py`.

PCA-RGB visualization of patch tokens (the original project's DINOv2 PCA
probe): the tokens projected onto their top-3 principal components,
percentile-clipped and rendered as an RGB map - the quick "is the backbone
seeing the robot" check. The PCA is torch's (eigh of the token covariance,
in f32 on the tokens' device), as the reference's is jnp's. An eigenvector's
sign is the solver's choice, so each component here is turned to make its
largest loading positive (sklearn's `svd_flip` on the components); the
reference keeps its solver's sign, so a channel of its map may be this
one's inverse (255 - v, within one level).
"""

from __future__ import annotations

import numpy as np
import torch


def pca_rgb(patch_tokens, grid_hw: tuple[int, int]) -> np.ndarray:
    """(N, D) or (B, N, D) patch tokens -> (gh, gw, 3) / (B, gh, gw, 3) uint8.

    The components are computed over all tokens jointly (the batch pooled),
    as the reference's sklearn-PCA probe."""
    toks = torch.as_tensor(patch_tokens).float()
    lead = toks.shape[:-2]
    flat = toks.reshape(-1, toks.shape[-1])
    X = flat - flat.mean(dim=0, keepdim=True)
    cov = (X.T @ X) / (X.shape[0] - 1)
    _, eigvecs = torch.linalg.eigh(cov)
    comps = eigvecs[:, -3:].flip(-1)  # the top-3 components, largest first
    big = comps.abs().argmax(dim=0)
    comps = comps * torch.sign(comps[big, torch.arange(3)])
    proj = X @ comps  # (M, 3)
    lo = torch.quantile(proj, 0.02, dim=0)
    hi = torch.quantile(proj, 0.98, dim=0)
    norm = ((proj - lo) / (hi - lo + 1e-8)).clamp(0.0, 1.0)
    gh, gw = grid_hw
    out = norm.cpu().numpy().reshape(*lead, gh, gw, 3)
    return (out * 255).astype(np.uint8)


@torch.no_grad()
def probe_backbone(model, images: torch.Tensor) -> np.ndarray:
    """Run a `ViTBackbone` on (B, H, W, 3) images and return the PCA-RGB
    maps of its patch tokens, (B, gh, gw, 3) uint8."""
    out = model(images.permute(0, 3, 1, 2))
    return pca_rgb(out["patch_tokens"], out["grid_hw"])
