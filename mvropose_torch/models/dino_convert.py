"""DINO checkpoints into the port's ViT backbone: timm, HF DINOv2 and HF DINOv3.

Port of `mvropose_tpu/models/dino_convert.py` and of the reference CLI's
`_graft_backbone_ckpt` (`mvropose_tpu/cli/main.py:333-386`). A torch state
dict maps onto `models/vit.py::ViTBackbone` nearly name for name: the port's
`nn.Linear` weights are (out, in) as timm's and HF's are, its patch
embedding an OIHW `nn.Conv2d` as theirs, so the conversion renames, splits
timm's fused qkv and reshapes the tokens; it never goes through the flax
tree. Heads are a view of the (D,) projections here, so the head count
changes no array.

timm naming (vit_base_patch14_dinov2 family):
  cls_token (1,1,D) | reg_token (1,R,D) | pos_embed (1,1+N,D)
  patch_embed.proj.{weight (D,3,p,p), bias}
  blocks.{i}.norm1.{weight,bias}
  blocks.{i}.attn.qkv.{weight (3D,D), bias (3D,)}
  blocks.{i}.attn.proj.{weight (D,D), bias}
  blocks.{i}.ls1.gamma / ls2.gamma
  blocks.{i}.mlp.fc1.{weight (4D,D), bias} / fc2.{weight (D,4D), bias}
  norm.{weight,bias}
HF DINOv2 names are normalized onto the same slots (`_hf_to_timm_key`); HF
DINOv3 checkpoints (RoPE attention, q_proj/o_proj naming, no pos_embed)
take `convert_dinov3_state_dict` and need ViTConfig(use_rope=True).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _hf_to_timm_key(name: str) -> str:
    """HF dinov2/v3 parameter names onto the timm-style scheme (the
    reference's replacements, in its order)."""
    n = name
    n = n.replace("embeddings.cls_token", "cls_token")
    n = n.replace("embeddings.register_tokens", "reg_token")
    n = n.replace("embeddings.mask_token", "mask_token")
    n = n.replace("embeddings.position_embeddings", "pos_embed")
    n = n.replace("embeddings.patch_embeddings.projection", "patch_embed.proj")
    n = n.replace("embeddings.patch_embeddings.weight", "patch_embed.proj.weight")
    n = n.replace("encoder.layer.", "blocks.")
    n = n.replace("layer.", "blocks.") if n.startswith("layer.") else n
    n = n.replace("attention.attention.query", "attn.q")
    n = n.replace("attention.attention.key", "attn.k")
    n = n.replace("attention.attention.value", "attn.v")
    n = n.replace("attention.output.dense", "attn.proj")
    n = n.replace("layer_scale1.lambda1", "ls1.gamma")
    n = n.replace("layer_scale2.lambda1", "ls2.gamma")
    n = n.replace("layernorm.", "norm.")
    return n


def is_dinov3_state_dict(sd: Mapping[str, np.ndarray]) -> bool:
    """HF DINOv3 ViTs (facebook/dinov3-*) use RoPE attention with separate
    q/k/v/o projections and no position-embedding parameter."""
    return any(".attention.q_proj." in k or ".attention.o_proj." in k for k in sd)


def _block(pre: str, norms: tuple, qkv: tuple, out: tuple, ls: tuple | None, mlp: tuple) -> dict:
    """One block's port names: norms ((w1, b1), (w2, b2)), qkv ((w, b) of
    q, k, v), out (w, b), ls (gamma1, gamma2) or None, mlp ((w1, b1), (w2, b2))."""
    p = {}
    for name, (w, b) in zip(("norm1", "norm2"), norms):
        p[f"{pre}{name}.weight"], p[f"{pre}{name}.bias"] = w, b
    for name, (w, b) in zip(("query", "key", "value", "out"), (*qkv, out)):
        p[f"{pre}attn.{name}.weight"], p[f"{pre}attn.{name}.bias"] = w, b.reshape(-1)
    if ls is not None:
        p[f"{pre}ls1.gamma"], p[f"{pre}ls2.gamma"] = (g.reshape(-1) for g in ls)
    for name, (w, b) in zip(("fc1", "fc2"), mlp):
        p[f"{pre}mlp.{name}.weight"], p[f"{pre}mlp.{name}.bias"] = w, b
    return p


def convert_dinov3_state_dict(sd: Mapping[str, np.ndarray], num_layers: int, num_heads: int,
                              hidden_size: int) -> dict:
    """HF DINOv3ViTModel state dict -> the port's ViTBackbone(use_rope=True)
    state dict (numpy). Mapping (transformers' dinov3_vit):
      embeddings.{cls_token, register_tokens, patch_embeddings.*}
      layer.{i}.{norm1, norm2, attention.{q,k,v,o}_proj,
                 layer_scale{1,2}.lambda1, mlp.{up,down}_proj}
      norm
    k_proj has no bias in DINOv3 (config.key_bias=False): written as zeros,
    the same computation. mask_token is ignored (inference never masks
    patches). Gated-MLP (7B-scale) checkpoints are refused."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if any(".mlp.gate_proj." in k for k in sd):
        raise NotImplementedError(
            "gated-MLP DINOv3 checkpoints (ViT-7B scale) are not supported; "
            "the reference uses vitb16/vitl16 (standard MLP)"
        )
    D = hidden_size
    params = {"cls_token": sd["embeddings.cls_token"].reshape(1, 1, D)}
    if "embeddings.register_tokens" in sd:
        params["register_tokens"] = sd["embeddings.register_tokens"].reshape(1, -1, D)
    params["patch_embed.weight"] = sd["embeddings.patch_embeddings.weight"]  # (D, 3, p, p)
    params["patch_embed.bias"] = sd["embeddings.patch_embeddings.bias"]
    for i in range(num_layers):
        pre = f"layer.{i}."

        def proj(name):
            return (sd[pre + f"attention.{name}.weight"],
                    sd.get(pre + f"attention.{name}.bias", np.zeros(D, np.float32)))

        params.update(_block(
            f"block_{i}.",
            norms=tuple((sd[pre + f"{n}.weight"], sd[pre + f"{n}.bias"])
                        for n in ("norm1", "norm2")),
            qkv=tuple(proj(n) for n in ("q_proj", "k_proj", "v_proj")),
            out=(sd[pre + "attention.o_proj.weight"], sd[pre + "attention.o_proj.bias"]),
            ls=(sd[pre + "layer_scale1.lambda1"], sd[pre + "layer_scale2.lambda1"]),
            mlp=tuple((sd[pre + f"mlp.{n}.weight"], sd[pre + f"mlp.{n}.bias"])
                      for n in ("up_proj", "down_proj")),
        ))
    params["norm.weight"], params["norm.bias"] = sd["norm.weight"], sd["norm.bias"]
    return params


def convert_dino_state_dict(sd: Mapping[str, np.ndarray], num_layers: int, num_heads: int,
                            hidden_size: int) -> dict:
    """-> {name: array} of the port's `ViTBackbone` state dict. Dispatches
    on the naming scheme: timm and HF-DINOv2 absolute-position checkpoints
    map here, HF DINOv3 (RoPE, q_proj/o_proj naming) through
    `convert_dinov3_state_dict`: pair those with ViTConfig(use_rope=True).
    A checkpoint layer past `num_layers` is not read."""
    if hidden_size % num_heads:
        raise ValueError(f"hidden size {hidden_size} is not a multiple of {num_heads} heads")
    if is_dinov3_state_dict(sd):
        return convert_dinov3_state_dict(sd, num_layers, num_heads, hidden_size)
    sd = {_hf_to_timm_key(k): np.asarray(v) for k, v in sd.items()}
    D = hidden_size
    params = {"cls_token": sd["cls_token"].reshape(1, 1, D),
              "pos_embed": sd["pos_embed"].reshape(1, -1, D)}
    if "reg_token" in sd:
        params["register_tokens"] = sd["reg_token"].reshape(1, -1, D)
    params["patch_embed.weight"] = sd["patch_embed.proj.weight"]  # (D, 3, p, p), OIHW
    params["patch_embed.bias"] = sd["patch_embed.proj.bias"]
    for i in range(num_layers):
        pre = f"blocks.{i}."
        if pre + "attn.qkv.weight" in sd:
            ws = np.split(sd[pre + "attn.qkv.weight"], 3, axis=0)  # (3D, D)
            bs = np.split(sd.get(pre + "attn.qkv.bias", np.zeros(3 * D)), 3, axis=0)
        else:  # HF: separate q/k/v
            ws = [sd[pre + f"attn.{c}.weight"] for c in "qkv"]
            bs = [sd.get(pre + f"attn.{c}.bias", np.zeros(D)) for c in "qkv"]
        ls = ((sd[pre + "ls1.gamma"], sd[pre + "ls2.gamma"]) if pre + "ls1.gamma" in sd
              else None)
        params.update(_block(
            f"block_{i}.",
            norms=tuple((sd[pre + f"{n}.weight"], sd[pre + f"{n}.bias"])
                        for n in ("norm1", "norm2")),
            qkv=tuple(zip(ws, bs)),
            out=(sd[pre + "attn.proj.weight"], sd[pre + "attn.proj.bias"]),
            ls=ls,
            mlp=tuple((sd[pre + f"mlp.{n}.weight"], sd[pre + f"mlp.{n}.bias"])
                      for n in ("fc1", "fc2")),
        ))
    params["norm.weight"], params["norm.bias"] = sd["norm.weight"], sd["norm.bias"]
    return params


def load_torch_checkpoint(path) -> dict:
    """A DINO checkpoint as {name: numpy array}: a `.npz` of the state
    dict's names, or a torch `.pth`/`.pt`/`.bin` state dict (loaded with
    `weights_only=True`, on the CPU; a module or a {"state_dict": ...}
    wrapper is unwrapped)."""
    p = str(path)
    if p.endswith(".npz"):
        with np.load(p) as data:
            return {k: data[k] for k in data.files}
    sd = torch.load(p, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: v.float().numpy() if torch.is_tensor(v) and v.is_floating_point()
            else v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()}


def graft_backbone_ckpt(backbone, ckpt_path) -> None:
    """Replace `backbone`'s weights (a float `ViTBackbone`) in place with a
    converted DINO checkpoint, the reference's frozen-pretrained workflow
    (its `_graft_backbone_ckpt`). Names and shapes are checked both ways
    against the backbone's own, so a config the checkpoint does not fit
    fails loudly, with the reference's messages, instead of training a
    half-random backbone."""
    cfg = backbone.cfg
    converted = convert_dino_state_dict(load_torch_checkpoint(ckpt_path), cfg.num_layers,
                                        cfg.num_heads, cfg.hidden_size)
    own = backbone.state_dict()
    if own.keys() != converted.keys():
        missing = sorted(own.keys() - converted.keys())
        extra = sorted(converted.keys() - own.keys())
        raise ValueError(
            f"backbone checkpoint structure mismatch: missing={missing[:5]} "
            f"extra={extra[:5]} (check --hidden-size/--num-layers/"
            f"--register-tokens/--backbone-native-size; a DINOv3 RoPE "
            f"checkpoint additionally needs --rope - it has no pos_embed)"
        )
    bad = [k for k in own if tuple(own[k].shape) != tuple(np.shape(converted[k]))]
    if bad:
        raise ValueError(
            f"backbone checkpoint shape mismatch at {bad[:5]}: "
            f"{[(tuple(own[k].shape), np.shape(converted[k])) for k in bad[:5]]}"
        )
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(np.ascontiguousarray(converted[name])).to(t.dtype))
