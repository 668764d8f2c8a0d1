"""Shared pieces of the torch-port parity tests (`tests/test_torch_*.py`).

Both packages get the same inputs and the same weights: inputs come from a
numpy seed, JAX variables are drawn with numpy over a `jax.eval_shape` tree
and cross into the port through the reference's own `save_params_npz` file.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from mvropose_tpu.train.checkpoint import save_params_npz


def random_variables(shapes, seed: int = 0):
    """numpy-seeded variables for an eval_shape tree, scaled to keep
    activations O(1) so that the comparisons are not of near-zero values:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), BatchNorm running
    variance in [0.5, 1.5], everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [str(getattr(k, "key", k)) for k in path]
        name = names[-1]
        if name == "kernel":
            if len(s.shape) == 3:  # DenseGeneral: (D, H, dh) in, (H, dh, D) out
                fan_in = s.shape[0] if names[-2] in ("query", "key", "value") else s.shape[0] * s.shape[1]
            else:
                fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(s.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=s.shape).astype(s.dtype)
        return (0.1 * rng.normal(size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def export_npz(variables, path) -> str:
    """Write JAX variables as the reference's flat checkpoint file."""
    save_params_npz(path, variables["params"], variables.get("batch_stats"))
    return str(path)


def np32(x) -> np.ndarray:
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)
