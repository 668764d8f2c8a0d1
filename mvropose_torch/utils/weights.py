"""Weights across the two packages, and seeded random weights.

`load_jax_params` fills a port model from the flat names that the
reference's `save_params_npz` writes (`mvropose_tpu/train/checkpoint.py`):
`backbone/block_0/attn/query/kernel`, ..., plus `batch_stats/.../mean|var`.
The port's module attribute names equal the flax module names, except the
stem's auto-named flax submodules (`Conv_0`, `BatchNorm_0`), which are `conv`
and `bn` here. Layouts:

  Dense kernel (in, out), DenseGeneral (D, H, dh) / (H, dh, D)
                                   -> Linear weight (out, in), bias (out,)
  Conv kernel HWIO                 -> Conv2d weight OIHW
  BatchNorm scale/bias + batch_stats mean/var
                                   -> weight/bias/running_mean/running_var
  LayerNorm scale                  -> weight
  Embed embedding                  -> Embedding weight
  Int8Dense kernel_q (Din, Dout) int8, scale, bias (Dout,)
                                   -> Int8Linear kernel_q, scale, bias
  raw parameters (cls_token, pos_embed, ls*/gamma, *_queries) -> as is

Both estimators and every angle head go through the same map (the
geometric head's `angle_head/fc{i}` and `angle_head/out` are Dense layers;
the single-view model has no `view_embeddings`, `fusion_module` or
`keypoint_enricher`). `export_jax_params` is the inverse map, `int8ify` the port of the
reference's `_int8ify` (`mvropose_tpu/cli/main.py`), `random_state`
mirrors `mvropose_tpu/utils/initializers.py::random_variables` (and
`random_flat` exports it as a checkpoint's flat dict), and
`flax_init_state` draws from flax's default initializers, as `model.init`
does, for training from scratch.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from mvropose_torch.models.quantize import QUANTIZED, Int8Linear, quantize_backbone
from mvropose_torch.models.vit import LayerScale, MultiHeadAttention

_MODULE_RENAMES = {"Conv_0": "conv", "BatchNorm_0": "bn"}
_LEAF_RENAMES = {
    Int8Linear: {"kernel_q": "kernel_q", "scale": "scale", "bias": "bias"},
    nn.Linear: {"kernel": "weight", "bias": "bias"},
    nn.Conv2d: {"kernel": "weight", "bias": "bias"},
    nn.LayerNorm: {"scale": "weight", "bias": "bias"},
    nn.BatchNorm2d: {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"},
    nn.Embedding: {"embedding": "weight"},
}


def _targets(model: nn.Module) -> dict[str, torch.Tensor]:
    """Every tensor a checkpoint must fill: parameters and buffers, except
    BatchNorm's training-step counter."""
    out = dict(model.named_parameters())
    out.update(
        (n, b) for n, b in model.named_buffers() if not n.endswith("num_batches_tracked")
    )
    return out


def _convert(module: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if isinstance(module, nn.Linear) and leaf == "kernel":
        return arr.reshape(module.in_features, -1).T
    if isinstance(module, nn.Linear) and leaf == "bias":
        return arr.reshape(-1)
    if isinstance(module, nn.Conv2d) and leaf == "kernel":
        return arr.transpose(3, 2, 0, 1)
    return arr


def plan_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> dict:
    """Map every flat JAX leaf onto the model tensor it fills.

    Returns {torch_name: (target tensor, converted numpy array)}. Strict both
    ways: raises KeyError for a leaf the model has no place for or a model
    tensor no leaf fills, ValueError for a shape mismatch. Arrays are only
    reshaped and transposed, so zero-strided placeholders
    (`np.broadcast_to`) check a layout from shapes alone.
    """
    targets = _targets(model)
    plan = {}
    for jax_name, arr in flat.items():
        parts = jax_name.split("/")
        if parts[0] == "batch_stats":
            parts = parts[1:]
        *path, leaf = (_MODULE_RENAMES.get(p, p) for p in parts)
        try:
            module = model.get_submodule(".".join(path))
        except AttributeError as e:
            raise KeyError(f"{jax_name}: the model has no module {'.'.join(path)!r}") from e
        attr = next(
            (names[leaf] for cls, names in _LEAF_RENAMES.items()
             if isinstance(module, cls) and leaf in names),
            leaf,
        )
        torch_name = ".".join([*path, attr])
        if torch_name not in targets:
            raise KeyError(f"{jax_name}: the model has no tensor {torch_name!r}")
        value = _convert(module, leaf, np.asarray(arr))
        if tuple(value.shape) != tuple(targets[torch_name].shape):
            raise ValueError(
                f"{jax_name} {tuple(np.shape(arr))} -> {torch_name}: got "
                f"{tuple(value.shape)}, the model holds {tuple(targets[torch_name].shape)}"
            )
        plan[torch_name] = (targets[torch_name], value)
    missing = sorted(set(targets) - set(plan))
    if missing:
        stats = [n for n in targets if n.endswith(("running_mean", "running_var"))]
        n_stats = sum(n in plan for n in stats)
        if 0 < n_stats < len(stats):
            # A partial match means the file comes from a different
            # architecture whose parameter shapes happen to coincide.
            raise KeyError(
                f"batch_stats only partially match the model ({n_stats}/{len(stats)} "
                "leaves): the file was exported from a different architecture"
            )
        raise KeyError(f"{len(missing)} model tensors have no checkpoint leaf, e.g. {missing[:5]}")
    return plan


def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray] | str | Path) -> None:
    """Fill `model` in place from a `save_params_npz` file (path) or its
    flat name -> array dict. Every leaf is consumed and every parameter and
    buffer filled, or it raises (see `plan_jax_params`)."""
    if isinstance(flat, (str, Path)):
        with np.load(flat) as data:
            flat = {k: data[k] for k in data.files}
    plan = plan_jax_params(model, flat)
    with torch.no_grad():
        for target, value in plan.values():
            target.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def _jax_layout(model: nn.Module, path: list[str], module: nn.Module, leaf: str,
                arr: np.ndarray) -> np.ndarray:
    """The inverse of `_convert`, with the DenseGeneral shapes of the
    attention projections: query/key/value kernel (D, H, dh) and bias
    (H, dh), out kernel (H, dh, D)."""
    if isinstance(module, nn.Conv2d) and leaf == "kernel":
        return arr.transpose(2, 3, 1, 0)
    if not isinstance(module, nn.Linear):
        return arr
    if leaf == "kernel":
        arr = arr.T
    parent = model.get_submodule(".".join(path[:-1]))
    if isinstance(parent, MultiHeadAttention):
        H = parent.num_heads
        if path[-1] == "out" and leaf == "kernel":
            return arr.reshape(H, -1, arr.shape[-1])
        if path[-1] != "out":
            return arr.reshape(*arr.shape[:-1], H, -1)
    return arr


def export_jax_params(model: nn.Module) -> dict[str, np.ndarray]:
    """The flat name -> array dict that `save_params_npz` would write for
    `model`'s weights, in the reference's layouts; float tensors as f32
    (a bf16 model's weights widened), int8 ones as int8. The inverse of
    `load_jax_params`: loading the result fills every tensor with its value."""
    inverse_modules = {v: k for k, v in _MODULE_RENAMES.items()}
    flat = {}
    for name, t in _targets(model).items():
        *path, attr = name.split(".")
        module = model.get_submodule(".".join(path))
        leaf = next(
            (jax_leaf for cls, names in _LEAF_RENAMES.items() if isinstance(module, cls)
             for jax_leaf, torch_attr in names.items() if torch_attr == attr),
            attr,
        )
        arr = t.detach().cpu()
        arr = (arr.float() if arr.is_floating_point() else arr).numpy()
        arr = _jax_layout(model, path, module, leaf, arr)
        stats = isinstance(module, nn.BatchNorm2d) and leaf in ("mean", "var")
        jax_name = "/".join([*(inverse_modules.get(p, p) for p in path), leaf])
        flat[("batch_stats/" if stats else "") + jax_name] = np.ascontiguousarray(arr)
    return flat


def int8ify(model: nn.Module, flat: Mapping[str, np.ndarray] | None = None,
            attn: bool = False) -> None:
    """Quantize a loaded float estimator's backbone (single- or multi-view) to int8 in
    place (the reference's `_int8ify`): every block's q/k/v/out and fc1/fc2
    become `Int8Linear`s, and `attn` also turns on the int8-probability
    attention. The heads stay float.

    The float kernels come from `flat`, the checkpoint's flat dict, when it
    is given, as the reference quantizes its f32 checkpoint (a bf16 model
    holds rounded weights); else from the model's own weights."""
    backbone = model.backbone
    if flat is None:
        src = export_jax_params(backbone)
    else:
        src = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("backbone/")}
    quantized = quantize_backbone(src)
    vit = dataclasses.replace(backbone.cfg, quant="int8", quant_attn="int8" if attn else None)
    device = backbone.cls_token.device
    for i in range(vit.num_layers):
        block = getattr(backbone, f"block_{i}")
        for layer in QUANTIZED:
            parent_name, child = layer.split("/")
            parent = getattr(block, parent_name)
            old = getattr(parent, child)
            new = Int8Linear(old.in_features, old.out_features, vit.compute_dtype, device)
            load_jax_params(new, {leaf: quantized[f"block_{i}/{layer}/{leaf}"]
                                  for leaf in ("kernel_q", "scale", "bias")})
            setattr(parent, child, new)
        block.attn.int8_attention = attn
    backbone.cfg = vit
    model.cfg = dataclasses.replace(model.cfg, vit=vit)


def random_state(model: nn.Module, seed: int = 0, scale: float = 0.02) -> dict[str, torch.Tensor]:
    """Seeded random state dict for `model` (load it with `load_state_dict`).

    N(0, scale) for every float tensor, drawn in f32 on the CPU in state-dict
    order, so models that differ only in dtype or device get the same
    weights. BatchNorm running variances get 1 + noise, never a bare normal
    (a negative variance makes rsqrt(var + eps) NaN); integer buffers zeros.
    """
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            state[name] = torch.zeros(t.shape, dtype=t.dtype)
            continue
        noise = scale * torch.randn(t.shape, generator=gen)
        state[name] = 1.0 + noise if name.endswith("running_var") else noise
    return state


def random_flat(model: nn.Module, seed: int = 0) -> dict[str, np.ndarray]:
    """`random_state(model, seed)` as a reference checkpoint's flat dict
    (`export_jax_params`). The state is assigned into `model`, so a model on
    the meta device makes no other copy of the weights."""
    model.load_state_dict(random_state(model, seed=seed), assign=True)
    return export_jax_params(model)


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax's truncated normal: N(0, std) cut at +-2 std."""
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def flax_init_state(model: nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded state dict (CPU, f32) from flax's default initializers, tensor
    by tensor as the reference's modules declare them: Dense and Conv
    kernels lecun_normal (truncated normal of variance 1/fan_in), biases 0,
    LayerNorm and BatchNorm scales 1, running means 0 and variances 1, Embed
    tables N(0, 1/dim), cls/pos/register tokens truncated N(0, 0.02), learned
    queries N(0, 1), LayerScale gammas their init value. The draws are
    torch's, not jax.random's: the distributions are flax's, the numbers not."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        module = model.get_submodule(".".join(path))
        shape = tuple(t.shape)
        if not t.is_floating_point():
            value = torch.zeros(shape, dtype=t.dtype)
        elif isinstance(module, (nn.Linear, nn.Conv2d)) and leaf == "weight":
            fan_in = math.prod(shape[1:])  # (out, in[, kh, kw])
            value = _truncated_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)
        elif isinstance(module, nn.Embedding):
            value = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
        elif isinstance(module, (nn.LayerNorm, nn.BatchNorm2d)) and leaf in ("weight",
                                                                              "running_var"):
            value = torch.ones(shape)
        elif leaf in ("cls_token", "pos_embed", "register_tokens"):
            value = _truncated_normal(shape, 0.02, gen)
        elif leaf in ("pose_queries", "global_queries"):
            value = torch.randn(shape, generator=gen)
        elif isinstance(module, LayerScale):
            value = t.detach().float().cpu().clone()
        else:  # biases, BatchNorm shifts and running means
            value = torch.zeros(shape)
        state[name] = value
    return state
