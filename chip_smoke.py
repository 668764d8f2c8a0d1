#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, in order; any failure exits non-zero and no phase's failure is caught:
  1. device: require CUDA (there is no CPU fallback), print the card and its
     power limit, turn TF32 off for the comparisons;
  2. build: compile `mvropose_torch/csrc/*.cu` with nvcc for sm_90a, one
     nvcc per source, all started together;
  3. kernels vs plain on the card, each then timed with CUDA events at the
     serve shape, as eager calls and as CUDA-graph replays (device time, in
     the JSON line), in turns plain/kernel/kernel/plain:
       * peak decode (32 maps of 128x128 at T 1 and 2, M = 1, 5, 33, 64, maps
         with a NaN (decoded as the reference's kernel: (0, H) and NaNs),
         all -inf, planted ties, a non-multiple M), then timed beside the
         launch floor (the same kernel on one 4x4 map);
       * LayerNorm and residual LayerNorm ((4100, 768) bf16 -> bf16 and
         bf16 -> f32, a non-multiple M, narrow and non-multiple-of-8 D);
       * the same two with their int8 output (`phase_layernorm_int8`: the
         serve shape in bf16 and f32, D = 3072, 128 and 1024, a constant
         row, a zero bias): x_q, s_x and x + h bit-equal to the LayerNorm
         kernel followed by `quantize_rows`, two calls bit-identical; timed in turns
         against the kernel pair they replace (the LayerNorm kernel, then
         the row quantization kernel) beside their bytes' bound;
       * the fused int8 attention and its values' quantization, bf16 and
         f32, at every head width (`phase_int8_attention`: the serve shape
         (4, 1025, 12, 64), T = 37, 129, 1, 2305, masked keys, an
         all-masked batch element, RoPE's and strided layouts; at d = 32,
         48, 96 and 128 the serve-like (2, 1025, 768 / d, d) and a masked
         case, and the DINO run's d = 48 shapes): the quantized values
         equal, the output within one value step (plus a bf16 ulp in bf16)
         of the plain version, planted rows bit-equal, two calls
         bit-identical; at the serve shape in each dtype the route captured
         in a CUDA graph, whose edge into the attention must be
         programmatic (`attention_graph_edges`); timed in turns
         plain/fused/fused/plain, beside SDPA in the same dtype, with the
         attention's time after the values' kernel in the main path's
         order, at the serve shape and at each width's serve-like shape;
       * the int8 matmul's quantization and GEMM (`phase_int8_matmul`: the
         serve step's products at M = 4100, 768 -> 768, 768 -> 3072 and
         3072 -> 768, and M = 1, 37, 51 at the serve and small widths, each
         x with an all-zero row; bf16 and f32 x, bf16 and f32 out): x_q,
         s_x and the output bit-equal to the plain version (`torch._int_mm`
         and the plain dequant), two calls bit-identical, s_x equal to
         numpy's true division on rows planted where m / 127 and
         m * fl(1/127) round apart; timed in turns plain/kernel/kernel/plain
         beside `torch._int_mm` alone and their bounds;
       * heatmap render ((576, 128, 128) and (576, 512, 512), the full-width
         train batch; (336, 64, 64) and (336, 128, 128), the synthetic
         trainer's; a non-multiple M and W, per-map and small sigma,
         half-pixel ties, keypoints just and far outside the map);
       * the SVD kernel of the pose step (`phase_small_svd`: 64 matrices at
         each of the tick's shape groups, fr3's and fr5's DLT, plane fit,
         homography and the 3 x 3 rotation projection, and the largest it
         takes, (32, 16); rank-deficient, zero-row and zero matrices among
         them; the DLT systems of a real fr3 RANSAC, most with a null space
         of dimension > 1) against torch.linalg.svd through sign-free
         quantities, two calls bit-identical, a shape it does not take
         refused; each group timed beside torch.linalg.svd (eager) and its
         bound; the kernels' SASS size (`cuobjdump -sass`); and the
         geometric3d head's DLT systems, (B J, 2V, 4) at a 4-view serve
         tick and a 3-view trainer batch, with keypoints seen by 0, 1, 2 or
         more views (zero rows), also through the triangulated points where
         2 or more views see them, timed the same way;
     then every launch counter: an empty input counts nothing, one launch one;
  4. the slices, each through `mvropose_torch.cli`'s own parser, with every
     kernel's launches counted over that run only:
       * `serve` at its defaults (4 synthetic 720x1280 cameras, ViT-B/16 at
         512 px, random weights from seed 0, bf16): the peak decode;
       * the same with `--display dir` (`phase_serve_display`): a canvas each
         few ticks, named and sized as the reference's viewer makes them;
       * `cli profile` at its defaults (`phase_profile`: ViT-B/16, 4 views,
         512 px, zero weights): each stage's device ms between CUDA events,
         one peak decode a decode stage;
       * `cli calibrate extrinsics` and `corners` (`phase_cli_calibrate`) on
         ArUco detections written for `write_capture`'s ring of cameras,
         held to the poses the ring drew; `python -m mvropose_torch`;
       * the pose step alone (`phase_pose`: `recover_pose_batch` on a clean
         fr3 rig at the serve shapes, V = 1 and 4, refine off and on) on the
         card against the CPU route (success equal; poses from the exact
         keypoints within 1e-3 rad and 1e-3 of |t|), 5 SVD launches a call
         (10 with refine), never synchronizing; its CUDA-graph replay,
         eager time, device kernels and host aten calls a call;
       * `serve --recover-pose`: the peak decode and 5 SVD launches a tick,
         finite poses and a boolean success a view;
       * `serve --params RUN --calib-dir --camera-keys --summary
         --recover-pose` on a calibrated 4-camera rig that it writes under
         build/ (ZED-like intrinsics and distortion, an ArUco summary in
         radians and degrees) for a single-view geometric and a multi-view
         geometric3d run directory (ViT-B/16 at 512 px, seed-0 weights,
         bf16): 5 and 6 SVD launches a tick (the geometric3d head's DLT);
         then each step alone (`calibrated_step`): its launches, no host
         sync, its device time by graph replay with and without the device
         undistortion, and against the CPU route on the same weights and
         frames (undistorted frames, heatmaps, the angle head);
       * `serve --params RUN/best_params.npz --int8-backbone
         --int8-attention` on a temporary run directory under build/, whose
         model_config.json says fused_ln: true (the same ViT-B/16 and seed-0
         weights, exported with `export_jax_params`): the LayerNorm kernels,
         the peak decode and the fused int8 attention with its quantization,
         12 each a tick, the two int8 LayerNorms 12 each (q, k and v share
         norm1's pair, fc1 reads norm2's), 72 int8 GEMMs and 24 row
         quantizations a tick (out's and fc2's inputs), the final LayerNorm
         once;
       * `serve --params RUN/best_params.npz` on the same run directory
         without --int8-backbone (bf16, fused LN): the LayerNorm kernel 13
         times a tick and the residual LayerNorm 12;
       * `serve --params RUN/best_params.npz --int8-backbone
         --int8-attention --recover-pose --refine-pose` on the same run
         directory: every int8 serve kernel as above, and 10 SVD launches a
         tick;
  5. the bare serve steps, bf16 and int8 + fused LN (on both int8 matmul
     routes: the kernels and the plain chain of `int_mm_route()`, in
     turns), timed on a resident batch and
     checked to never synchronize with the host, with the int8 step's
     `int8_matmul` calls and their one- and two-pass bounds; the int8
     heatmaps against the bf16 model's, identical tokens and heatmaps on
     the two int8 matmul routes, the bf16 ones against f32; the int8 +
     fused-LN serve with the backbone in f32 (`phase_serve_int8_f32`: `serve
     --int8-backbone --int8-attention` on a temporary f32 run directory, 12
     f32 fused int8 attentions and 12 values' quantizations a tick, then the
     bare step's launches and device time); and small f32 and int8 +
     fused-LN models on the card against the CPU (the f32 int8 model's
     attention launches the f32 fused kernel, its matmuls the int8 GEMM and
     quantization kernels);
  6. training, with the render's launches counted over each run only:
       * the full-width multi-view train step (frozen ViT-B/16 at 512 px,
         fr3, 18 groups x 4 views, 128x128 heatmaps, bf16) on batches made
         by `synthesize_multiview_batch`: finite losses, the backbone
         bit-identical, heads and BatchNorm statistics moved, no host-device
         sync; step time, peak memory and the device's busy share;
       * `scripts/torch_train_synthetic.py --mode multi` at its defaults for
         a few hundred steps: the loss must fall;
       * the trainer's other modes (`phase_geometric_trainer`): `--mode
         single --angle-head geometric --fk-loss-weight 0.1` and `--mode
         multi --angle-head geometric3d`, each train step free of host
         syncs, then a few steps of the script with finite losses;
       * `cli train` on captured images (`phase_cli_train`): a capture it
         writes under build/ with the stdlib csv, cv2 and json (an FR3 rig
         of 4 serials x left and right cameras, 1080x1920 JPEGs of 8 views
         a group, the sync CSV, calibration files with distortion, a pose1
         ArUco summary), trained at ViT-B/16 512 px, batch 2, 4 worker
         processes loading, one epoch and then a resumed second epoch (it
         must start at epoch 2, its stream reseeded): one render launch per
         preprocessed batch, no plain render, the first epoch's worker
         batches bit-equal to the in-process prep of the same groups, a
         batch's GT heatmaps against `render_heatmaps_reference`, finite
         losses, best_params.npz read by `serve --params`, `cli visualize`'s
         group panels; groups/s, host load and device step times per batch;
         then 16 groups in turns of 0, 4, 4, 0 workers (`cli_train_turns`):
         host load a train batch and groups/s an epoch, beside the CPUs;
       * `cli eval` (`phase_cli_eval`): on the same capture and run, float
         with --refine-pose --occlusion-masks 2, and --int8-backbone
         --int8-attention; then a DREAM set and an fr5 + fr3 +
         meca_insertion set from the port's generators under build/,
         `cli sync dream`, `cli train` (2 epochs at the int8 receipt's
         192-wide, 4-layer ViT at 128 px; 1 epoch mixed) and `cli eval`
         (float and int8 with --refine-pose; the three robots): the
         reference's report keys in its order, finite values, one render
         launch per preprocessed batch and no plain render, SVD launches
         where pose runs, per forward the int8 run's attention, GEMM and row
         quantization launches (12, 72 and 48 at ViT-B);
       * the DINO checkpoint at d = 48 (`phase_dino_d48`):
         `scripts/torch_train_synthetic.py --freeze-backbone --backbone-ckpt
         runs/synth_sv_frozen/dino_192x4.npz` (the synthetic trainer's
         single-view fr5 model at 128 px, 4 heads of 48) for a few steps, a
         frozen drift of exactly 0; `cli serve --params RUN/best_params.npz
         --int8-backbone --int8-attention` on its run directory in bf16 and
         in f32 (the fused int8 attention's launches at d = 48, 4 a tick,
         by the width counters), `cli eval --int8-backbone
         --int8-attention` on a small fr5 set, and `cli train
         --backbone-ckpt` of the same file (3 heads of 64) for one epoch;
  7. the flash-attention path (T >= 2048), each run's launches counted:
       * the three kernels against the plain branch (bf16 against f32, 8
         shapes: the 768-px serve and train backbones, the fusion bench, the
         fusion's default heads, T = 37 at d = 48, an all-masked batch
         element, T = 1, T = 129); the forward alone against
         `flash_forward_plain` on O (no further from it than the bf16 plain
         branch, a bound that a forward skipping one key tile must miss), m
         and l, and the backward kernels alone against
         `flash_backward_plain` on the forward kernel's statistics, two
         calls bit-identical; the Hopper kernels, all three at every width
         in bf16 and f16 and the split-TF32 forward at every width, build
         without spills; then timed beside SDPA, at
         T = 1025 too, and the backward pair alone beside SDPA's backward
         alone (phase 3);
       * d in {32, 48, 96, 128}, no main path's width (`phase_flash_widths`):
         `fused_self_attention` launches the Hopper forward, dK/dV and dQ
         (the route counters), with and without a mask; the forward and the
         backward alone as above; timed at (8, 2305, 768 / d, d): the
         forward and forward + backward beside the plain branch and SDPA,
         the backward pair alone beside SDPA's backward alone;
       * f32 and f16 CUDA operands at T = 2305 (`phase_f32`): f32 launches
         the split-TF32 forward, dK/dV and dQ (TF32 wgmma,
         `csrc/flash_attention_tf32.cu`) once each, f16 the Hopper forward,
         dK/dV and dQ instantiated for f16 once each; both agree with the
         plain branch in f32, each kernel alone too (the backward pair on
         its forward's m and l), two calls bit-identical; the f32 forward
         and the f32 backward pair alone at every width, and the forward at
         the f32 768-px serve step's (4, 2305, 12, 64) without a mask,
         within F32_TOL of the plain versions and closer to them than a
         one-TF32-product model, which misses F32_TOL; timed in f32 and f16
         beside the plain branch and SDPA, the f32 forward and backward
         pair at every width too, the pair beside SDPA f32's backward (bf16
         at that shape launches one forward);
         `serve --replay-dir` on a directory of PNG frames exits naming the
         missing decoder where cv2 cannot be imported, and serves where it
         can;
       * f16 at (8, 2305, 768 / d, d), every width (`phase_flash_f16`):
         `fused_self_attention` launches the f16 forward, dK/dV and dQ with a
         mask; the forward and the backward pair alone against the plain
         versions, two calls bit-identical; timed without a mask, the
         forward and forward + backward beside the plain branch and SDPA
         f16, the backward pair alone beside SDPA f16's backward alone, and
         the f16 pair in turns with the bf16 pair;
       * `serve --model-size 768`: 12 forward launches per tick; the bare
         768-px step timed, never synchronizing, against the plain path;
       * `serve --params RUN/best_params.npz` on a temporary f32 768-px run
         directory under build/ (model_config.json: FULL_768 with "vit":
         {"dtype": "float32"}, model_size 768; seed-0 weights exported with
         `export_jax_params`): 12 split-TF32 forward launches per tick; the
         bare f32 768-px step timed the same way, its backbone tokens within
         F32_TOL of the plain path's largest token;
       * the unfrozen 768-px train step (fr3, 2 groups x 4 views): backbone
         gradients against the plain path, then steps with 12 launches of
         each kernel per step (phase 6); and the same step with the
         backbone in f32 (1 group x 4 views): 12 launches of each
         split-TF32 kernel per step, its backbone gradients within
         F32_SPREAD times the plain path's own run-to-run spread (plus
         F32_TRAIN_REL) of the plain path's;
       * `SelfAttentionFusion` at B 4, V 8, N 513, D 768 against the plain
         path, and its mask invariance. Every other path launches no flash
         kernel;
  8. a JSON line per kernel (the flash kernels also, for f32 and f16
     operands, `f32_ms`, `f16_ms` and their bounds, the bf16 kernels' times
     at the other widths under `widths` (the int8 attention's too, and its
     f32 instantiations' under `f32_widths`, each with its launches on the
     main paths: d = 48's in the DINO phase), the f16 kernels' at every width
     under `f16_widths`; the forward's bound the larger of its products' and
     its exponentials'; the f32 kernels' source, launches on their main
     paths (the forward: the f32 serve run; dK/dV and dQ: the f32 train
     steps) and times at every width under `f32_widths`; their bounds at the
     f32 rate are printed beside the split-TF32 ones), the card and its
     power limit, then
     the last line
     `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import functools
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from torch.profiler import ProfilerActivity, profile

import mvropose_torch.cli.eval as cli_eval
import mvropose_torch.cli.main as cli_main
import mvropose_torch.models.quantize as quantize_module
import mvropose_torch.models.vit as vit_module
from mvropose_torch.calib.registry import FR3_SERIAL_TO_VIEW as FR3_SERIALS
from mvropose_torch.cli.main import (
    KINDS,
    PoseStep,
    build_parser,
    preprocess,
    read_calibration,
    read_fallback_poses,
    serve,
    serve_step,
    write_run_dir,
)
from mvropose_torch.data.synthetic import (
    make_rig,
    rig_tuple,
    single_view_batch,
    synthesize_multiview_batch,
)
from mvropose_torch.geometry import pnp
from mvropose_torch.geometry.camera import project_points, undistort_map
from mvropose_torch.geometry.robots import forward_kinematics, get_robot
from mvropose_torch.geometry.rotations import (
    matrix_to_quat,
    matrix_to_rodrigues,
    rodrigues_to_matrix,
)
from mvropose_torch.geometry.triangulation import dlt_system, heatmap_projection_matrices
from mvropose_torch.models import (
    EstimatorConfig,
    MultiViewPoseEstimator,
    SelfAttentionFusion,
    ViTConfig,
)
from mvropose_torch.models.quantize import (
    Int8Linear,
    int8_gemm_reference,
    int8_matmul_reference,
    quantize_kernel,
    quantize_rows,
)
from mvropose_torch.models.quantize import int8_matmul as int8_matmul_dispatch
from mvropose_torch.ops import (
    _build,
    attention,
    heatmap_render,
    int8_attention,
    int8_matmul,
    layernorm,
    peak_decode,
    small_svd,
)
from mvropose_torch.pose import PoseDraws, recover_pose_batch, solve_rig_pnp
from mvropose_torch.pose.refine import refine_rig_pose_angles
from mvropose_torch.train import (
    TrainConfig,
    create_train_state,
    make_multi_view_train_step,
    make_single_view_train_step,
)
from mvropose_torch.train.state import ANG_MODULES, KPT_MODULES
from mvropose_torch.utils import graphs
from mvropose_torch.utils.weights import (
    flax_init_state,
    int8ify,
    load_jax_params,
    random_flat,
    random_state,
)

ROOT = Path(__file__).resolve().parent
SERVE_SECONDS = 8.0
# serve --refine-pose runs its eager pose step at seconds a tick (the host):
# long enough for 10 ticks.
REFINE_SERVE_SECONDS = 60.0
# name: (wrapper module, its launch counter, source, the TPU kernel it replaces);
# a flash kernel's counter is its part in `attention.route_launches`.
KERNELS = {
    "peak_decode": (peak_decode, "launches", "mvropose_torch/csrc/peak_decode.cu",
                    "mvropose_tpu/ops/peak_decode.py:28"),  # _decode_kernel
    "layernorm": (layernorm, "launches", "mvropose_torch/csrc/layernorm.cu",
                  "mvropose_tpu/ops/layernorm.py:30"),  # _ln_kernel
    "residual_layernorm": (layernorm, "residual_launches", "mvropose_torch/csrc/layernorm.cu",
                           "mvropose_tpu/ops/layernorm.py:39"),  # _res_ln_kernel
    # The same two with their output quantized per token for the int8 matmuls
    # of q/k/v and fc1: int8_matmul's s_x and x_q lines moved into the LayerNorms.
    "layernorm_int8": (layernorm, "int8_launches", "mvropose_torch/csrc/layernorm.cu",
                       "mvropose_tpu/models/quantize.py:37"),
    "residual_layernorm_int8": (layernorm, "residual_int8_launches",
                                "mvropose_torch/csrc/layernorm.cu",
                                "mvropose_tpu/models/quantize.py:37"),
    # int8_prob_attention whole (logits to the dequantized P V), bf16 and f32,
    # and its values' quantization (both types).
    "int8_attention": (int8_attention, "fused", "mvropose_torch/csrc/int8_attention.cu",
                       "mvropose_tpu/ops/attention.py:29"),
    "int8_attention_f32": (int8_attention, "fused_f32",
                           "mvropose_torch/csrc/int8_attention.cu",
                           "mvropose_tpu/ops/attention.py:29"),
    "int8_quantize_v": (int8_attention, "quantize_v_launches",
                        "mvropose_torch/csrc/int8_attention.cu",
                        "mvropose_tpu/ops/attention.py:70"),
    # int8_matmul: the int8 product with the dequant and bias, and the per-token quantization.
    "int8_matmul": (int8_matmul, "launches", "mvropose_torch/csrc/int8_gemm.cu",
                    "mvropose_tpu/models/quantize.py:37"),
    "int8_quantize_rows": (int8_matmul, "quantize_launches", "mvropose_torch/csrc/int8_gemm.cu",
                           "mvropose_tpu/models/quantize.py:37"),
    "heatmap_render": (heatmap_render, "launches", "mvropose_torch/csrc/heatmap_render.cu",
                       "mvropose_tpu/ops/heatmap_render.py:25"),  # _render_kernel
    # Not Pallas: jnp.linalg.svd of the pose path (the DLT's, and the plane
    # fit's, homography's and rotation projections' of pnp.py:109-183).
    "small_svd": (small_svd, "launches", "mvropose_torch/csrc/small_svd.cu",
                  "mvropose_tpu/geometry/pnp.py:94"),
    # JAX's stock Pallas flash attention (jax 0.9.0), which
    # mvropose_tpu/ops/attention.py:161 calls at T >= 2048 on a TPU.
    "flash_fwd": (attention, "fwd", "mvropose_torch/csrc/flash_attention.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:331"),
    "flash_bwd_dkv": (attention, "dkv", "mvropose_torch/csrc/flash_attention.cu",
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:796"),
    "flash_bwd_dq": (attention, "dq", "mvropose_torch/csrc/flash_attention.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1146"),
}
SERVE_KERNELS = ["peak_decode", "layernorm", "layernorm_int8", "residual_layernorm_int8",
                 "int8_attention", "int8_quantize_v", "int8_matmul", "int8_quantize_rows"]
# The same served with the backbone in f32: the f32 int8 attention.
SERVE_KERNELS_F32 = [k if k != "int8_attention" else "int8_attention_f32" for k in SERVE_KERNELS]
# The same run directory served in bf16 (no --int8-backbone): the float LayerNorms.
FUSED_LN_KERNELS = ["peak_decode", "layernorm", "residual_layernorm"]
FLASH_KERNELS = ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"]
# The int8 attention's head widths besides the serve step's 64.
INT8_WIDTHS = tuple(d for d in attention.HEAD_DIMS if d != 64)
# The least time the card could take: the H100 SXM's published dense rates
# at 700 W (NVIDIA's data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
# The serve default: ViT-B/16 at 512 px (T = 1024 + 1), 4 views, J=8, A=7.
FULL = EstimatorConfig(
    vit=ViTConfig(image_size=512, patch_size=16, hidden_size=768, num_layers=12, num_heads=12),
    num_joints=8, num_angles=7, max_views=4,
)
FULL_LN = dataclasses.replace(FULL, vit=dataclasses.replace(FULL.vit, fused_ln=True))
# `serve --model-size 768`: the same ViT-B/16 at 768 px, T = 48^2 + 1 = 2305 >= 2048.
FULL_768 = dataclasses.replace(FULL, vit=dataclasses.replace(FULL.vit, image_size=768))
# The same with the backbone in f32: what `serve --params` builds from a run
# directory whose model_config.json says "vit": {"dtype": "float32", ...}
# (`read_model_config`; the heads stay in the default bf16).
FULL_768_F32 = dataclasses.replace(FULL_768, vit=dataclasses.replace(FULL_768.vit, dtype="float32"))
# The int8 + fused-LN serve model with its backbone in f32 (a run directory
# whose model_config.json says "vit": {"dtype": "float32", "fused_ln": true}):
# the f32 int8 attention, 12 a tick at (4, 1025, 12, 64).
FULL_LN_F32 = dataclasses.replace(FULL_LN, vit=dataclasses.replace(FULL_LN.vit, dtype="float32"))
# The serve default's widths with the other checkpoint kinds: the
# single-view estimator with the geometric head, the multi-view one with
# geometric3d (its DLT on the SVD kernel, one launch a tick).
FULL_SV_GEO = dataclasses.replace(FULL, angle_head="geometric")
FULL_MV_GEO3D = dataclasses.replace(FULL, angle_head="geometric3d")


def _script(name: str):
    """A script of scripts/ as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, samples: int = 50, warm: int = 5) -> float:
    """Median over `samples` CUDA-event windows of `iters` calls, in ms per
    call, after `warm` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20, samples: int = 50, stream=None) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed in CUDA-event windows, so Python launch overhead is excluded.
    Captured on `stream` where given (the stream an autograd graph's forward
    ran on, so its backward depends on no other stream)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, 1, samples) / iters


def bound(nbytes: float, ops=0.0, kind: str = "bf16") -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type (`ops`
    a count of `kind`, or {kind: count} for work of several types)."""
    ops = ops if isinstance(ops, dict) else {kind: ops}
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


@functools.cache
def exp_per_s() -> float:
    """The card's ex2 rate: 16 a clock on each SM (its special-function
    units) at its top SM clock, the SM count and the clock read from the card."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return 16 * torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6


def with_exp_floor(b: dict, exps: int) -> dict:
    """`bound`'s `b` for work that also takes `exps` exponentials: these run
    on the special-function units beside the tensor cores, so the least time
    is the larger of `b` and their time at `exp_per_s`, both kept under
    "parts" for the printed lines."""
    floor = 1e3 * exps / exp_per_s()
    out = b if b["bound_ms"] >= floor else {"bound_ms": floor, "bound_by": "operations"}
    return {**out, "parts": (b["bound_ms"], floor)}


def fmt_bound(b: dict) -> str:
    """A bound for the printed lines, with its two parts where it has them."""
    parts = b.get("parts")
    return f"{b['bound_ms']:.4f} ({b['bound_by']}" + (
        f": products/bytes {parts[0]:.4f}, exponentials {parts[1]:.4f})" if parts else ")")


def time_in_turns(name: str, shape: str, plain, kernel, iters: int = 20, samples: int = 50):
    """Eager and graph-replay times in turns plain/kernel/kernel/plain ->
    (kernel ms, plain ms), the medians of the graph-replay (device) times."""
    eager = [cuda_ms(f, iters, samples) for f in (plain, kernel, kernel, plain)]
    graph = [graph_ms(f, iters, samples) for f in (plain, kernel, kernel, plain)]
    us = lambda v: "/".join(f"{1e3 * t:.2f}" for t in v)  # noqa: E731
    print(f"{name} {shape}, median of {samples} CUDA-event windows, in turns "
          f"plain/kernel/kernel/plain: eager calls {us(eager)} us per call; "
          f"CUDA-graph replay (device time) {us(graph)} us per call")
    return statistics.median(graph[1:3]), statistics.median(graph[0::3])


def phase_device() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    return {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def spilled_bytes(log: str) -> dict:
    """Spilled bytes (stores + loads) per kernel in nvcc's `-Xptxas -v` output."""
    spills = {}
    for part in log.split("Compiling entry function '")[1:]:
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        spills[part.split("'")[0]] = int(found[1]) + int(found[2]) if found else 0
    return spills


# The Hopper kernels of the build: the flash forward, dK/dV and dQ at every
# head width in bf16, in f16 and (split TF32) in f32, the int8 attention at
# every head width in bf16 and f32, and the int8 GEMM's two schedules
# (`int8_gemm_sm90_kernel<kSplit>`).
FLASH_PARTS = attention.FLASH_PARTS
# The width-templated kernels' instantiations by element type: the parts it
# has, and the pattern of one's mangled name (`part` filled in; the width its
# group).
HOPPER_TYPES = {"bf16": (FLASH_PARTS, r"flash_{part}_sm90_kernelILi(\d+)E13__nv_bfloat16E"),
                "f16": (FLASH_PARTS, r"flash_{part}_sm90_kernelILi(\d+)E6__halfE"),
                "tf32": (FLASH_PARTS, r"flash_{part}_tf32_sm90_kernelILi(\d+)EE"),
                "int8 bf16": (("attention",), r"int8_{part}_sm90_kernelILi(\d+)E13__nv_bfloat16E"),
                "int8 f32": (("attention",), r"int8_{part}_sm90_kernelILi(\d+)EfE")}
HOPPER_KERNELS = len(attention.HEAD_DIMS) * sum(len(p) for p, _ in HOPPER_TYPES.values()) + 2


def phase_build() -> None:
    """Build the kernels; the Hopper kernels (`*_sm90_kernel`, each flash
    instantiation) must all be there and must not spill, and ptxas must not
    have serialized any kernel's wgmma products (its C75xx notes)."""
    t0 = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - t0
    lib = _build.library_path()
    print(f"build: {lib.relative_to(ROOT)} in {seconds:.2f} s")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        text = log.read_text().strip()
        print(text)
        hopper = {k: v for k, v in spilled_bytes(text).items() if "sm90_kernel" in k}
        widths = {(part, ty): sorted(int(w) for k in hopper
                                     for w in re.findall(pattern.format(part=part), k))
                  for ty, (parts, pattern) in HOPPER_TYPES.items() for part in parts}
        check(len(hopper) == HOPPER_KERNELS and not any(hopper.values()) and
              all(w == list(attention.HEAD_DIMS) for w in widths.values()),
              f"the Hopper kernels' spilled bytes: {hopper}")
        serialized = [line for line in text.splitlines()
                      if "wgmma.mma_async instructions are serialized" in line]
        check(not serialized, "ptxas serialized the wgmma products of a Hopper kernel:\n"
              + "\n".join(serialized))
        print(f"Hopper kernels: {len(hopper)}, none spills; instantiations at "
              + ", ".join(f"d = {w} ({kind}, {ty})" for (kind, ty), w in widths.items()))


def _tie_maps(rng) -> np.ndarray:
    maps = rng.normal(size=(4, 64, 64)).astype(np.float32)
    maps[0, 40, 3] = maps[0, 7, 60] = 9.0  # the earlier raster index wins
    maps[1] = 0.5  # constant map: index 0
    maps[2, 5, 10] = maps[2, 5, 11] = maps[2, 5, 12] = 7.0
    maps[3, 63, 63] = maps[3, 0, 63] = 8.0
    return maps


def _poisoned_maps(rng) -> np.ndarray:
    """128x128 maps with a NaN (in cluster rank 0's quarter, at the last index,
    two in two ranks), all -inf, a tie across ranks, and a finite control."""
    maps = 4.0 * rng.normal(size=(6, 128, 128)).astype(np.float32)
    maps[0, 3, 5] = np.nan
    maps[1, 127, 127] = np.nan
    maps[2, 64, 0] = maps[2, 100, 9] = np.nan
    maps[3] = -np.inf
    maps[4, 10, 10] = maps[4, 70, 70] = maps[4, 120, 3] = 40.0
    return maps


def _decode_err(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    """Max abs difference per column of two (M, 8) decodes, equal values
    (-inf too) 0 apart, a NaN equal to a NaN (the reference decodes a NaN map
    to NaNs), and inf between a NaN and a number."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    gap = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return torch.nan_to_num(gap, nan=float("inf")).amax(dim=0).cpu().numpy()


def phase_peak_decode() -> dict:
    """Kernel vs plain on the card. Argmax exact, confidence 1e-6, soft-argmax
    1e-3 px (f32 sums in another order), raw peak exact, a NaN equal to a
    NaN: maps with a NaN decode to (0, H), NaN peak, confidence and soft
    sums, as the reference's kernel. Cases: the serve shape at T 1 and 2,
    M = 1, 5, 33, 64 (8, 8, 4 and 2 blocks a map on 132 SMs), the NaN,
    -inf and tie maps at the serve size, a non-multiple M and small maps.
    Then timed in turns against the plain version, and against one 4x4 map
    (the launch floor: the same kernel with next to no work)."""
    rng = np.random.default_rng(0)
    serve_maps = 4.0 * rng.normal(size=(32, 128, 128)).astype(np.float32)
    cases = [
        ("serve_t1", serve_maps, 1.0),
        ("serve_t2", serve_maps, 2.0),
        *((f"m{M}", 4.0 * rng.normal(size=(M, 128, 128)).astype(np.float32), 1.0)
          for M in (1, 5, 33, 64)),
        ("poisoned", _poisoned_maps(rng), 1.0),
        ("poisoned_t2", _poisoned_maps(rng), 2.0),
        ("nonmultiple_m", rng.normal(size=(5, 32, 32)).astype(np.float32), 1.0),
        ("ties", _tie_maps(rng), 1.0),
    ]
    max_err = 0.0
    for name, maps, temperature in cases:
        x = torch.from_numpy(maps).cuda()
        got = peak_decode.peak_decode_cuda(x, temperature)
        torch.cuda.synchronize()
        want = peak_decode.peak_decode_reference(x, temperature)
        err = _decode_err(got, want)
        check(err[0] == 0 and err[1] == 0, f"{name}: argmax differs ({err[:2]})")
        check(err[4] <= 1e-6, f"{name}: confidence differs by {err[4]}")
        check(err[2] <= 1e-3 and err[3] <= 1e-3, f"{name}: soft-argmax differs by {err[2:4]}")
        check(err[5] == 0 and err[6] == 0 and err[7] == 0, f"{name}: peak/padding differ")
        nan = torch.isnan(x.flatten(1)).any(1)
        check(bool((got[nan, 0] == 0).all() and (got[nan, 1] == x.shape[1]).all()
                   and torch.isnan(got[nan][:, 2:6]).all()),
              f"{name}: a NaN map's decode {got[nan]}")
        max_err = max(max_err, float(err.max()))
        print(f"kernel vs plain [{name} {tuple(maps.shape)} T={temperature}, "
              f"{peak_decode.cluster_blocks(maps.shape[0], peak_decode._sm_count(0))} blocks a "
              f"map, "
              f"{int(nan.sum())} NaN maps]: max abs err per column "
              f"{np.array2string(err, precision=9)}")
    x = torch.from_numpy(serve_maps).cuda()
    ms, plain_ms = time_in_turns("peak decode", "(32, 128, 128)",
                                 lambda: peak_decode.peak_decode_reference(x),
                                 lambda: peak_decode.peak_decode_cuda(x))
    tiny = torch.from_numpy(rng.normal(size=(1, 4, 4)).astype(np.float32)).cuda()
    floor, serve_again = _in_turns(lambda f: graph_ms(f), lambda: peak_decode.peak_decode_cuda(x),
                                   lambda: peak_decode.peak_decode_cuda(tiny))
    b = bound(x.numel() * 4 + 32 * 8 * 4)
    print(f"peak decode (32, 128, 128), CUDA-graph replay in turns serve/floor/floor/serve: "
          f"{1e3 * serve_again:.2f} us against the launch floor (the same kernel on one 4x4 map) "
          f"{1e3 * floor:.2f} us; bound {1e3 * b['bound_ms']:.2f} us ({b['bound_by']})")
    # Reads the maps once, writes (32, 8) f32 rows; no PyTorch call decodes peaks.
    return {"peak_decode": {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
                            "library_ms": None, "launch_floor_ms": floor}}


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor, slack: float = 1e-5) -> float:
    """The largest gap beyond `slack`, in bf16 ulps of the larger of the two
    values. The slack is the f32 outputs' bound: near y = 0 the f32 results
    (bias minus a near-equal product) differ by f32 rounding of their
    operands, which is many bf16 ulps of y itself."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    gap = ((g - w).abs() - slack).clamp_min(0.0)
    return float((gap / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _ln_operands(M: int, D: int, dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    x = (0.5 + 3.0 * torch.randn(M, D, generator=gen)).to(dtype)
    h = torch.randn(M, D, generator=gen).to(dtype)
    g = 1.0 + 0.1 * torch.randn(D, generator=gen)
    b = 0.1 * torch.randn(D, generator=gen)
    return [t.cuda() for t in (x, h, g, b)]


def phase_layernorm() -> dict:
    """LayerNorm and residual LayerNorm kernels vs their plain versions on
    the card: f32 outputs within 1e-5 abs, bf16 outputs within one bf16 ulp
    beyond that, the residual x + h exact."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("serve", 4100, 768, bf16, bf16), ("serve_final", 4100, 768, bf16, f32),
             ("nonmultiple_m", 37, 768, bf16, bf16), ("narrow_d", 4100, 192, bf16, bf16),
             ("tail_d", 37, 100, bf16, f32), ("f32", 37, 768, f32, f32)]
    err = {"layernorm": 0.0, "residual_layernorm": 0.0}
    for i, (name, M, D, inp, out) in enumerate(cases):
        x, h, g, b = _ln_operands(M, D, inp, seed=10 + i)
        y = layernorm.layernorm_cuda(x, g, b, 1e-6, out)
        xn, yr = layernorm.residual_layernorm_cuda(x, h, g, b, 1e-6, out)
        torch.cuda.synchronize()
        xn_ref, yr_ref = layernorm.residual_layernorm_reference(x, h, g, b, 1e-6, out)
        check(torch.equal(xn, xn_ref), f"{name}: the residual x + h is not exact")
        gaps = []
        y_ref = layernorm.layernorm_reference(x, g, b, 1e-6, out)
        for kname, got, want in (("layernorm", y, y_ref), ("residual_layernorm", yr, yr_ref)):
            gap = float((got.float() - want.float()).abs().max())
            if out == bf16:
                ulps = _bf16_ulps(got, want)
                check(ulps <= 1.0, f"{name}: {kname} is {ulps} bf16 ulps from the plain version")
            else:
                check(gap <= 1e-5, f"{name}: {kname} differs by {gap}")
            err[kname] = max(err[kname], gap)
            gaps.append(gap)
        print(f"kernel vs plain [{name} ({M}, {D}) {inp} -> {out}]: LayerNorm max abs err "
              f"{gaps[0]:.3g}, residual LayerNorm {gaps[1]:.3g}, residual sum exact")
    x, h, g, b = _ln_operands(4100, 768, bf16, seed=20)
    g16, b16 = g.to(bf16), b.to(bf16)
    # The library call: torch's LayerNorm on bf16 in and out, a near relative
    # (two-pass variance, bf16 gain and bias); no call fuses the residual.
    library_ms = graph_ms(lambda: torch.nn.functional.layer_norm(x, (768,), g16, b16, 1e-6))
    print(f"library: torch F.layer_norm (4100, 768) bf16 -> bf16 {1e3 * library_ms:.2f} us per "
          f"call (CUDA-graph replay)")
    row = 4100 * 768 * 2  # bytes of one bf16 (4100, 768) tensor
    out = {}
    for kname, plain, kernel, nbytes, lib in (
        ("layernorm", lambda: layernorm.layernorm_reference(x, g, b, 1e-6),
         lambda: layernorm.layernorm_cuda(x, g, b, 1e-6), 2 * row, library_ms),
        ("residual_layernorm", lambda: layernorm.residual_layernorm_reference(x, h, g, b, 1e-6),
         lambda: layernorm.residual_layernorm_cuda(x, h, g, b, 1e-6), 4 * row, None),
    ):
        ms, plain_ms = time_in_turns(kname, "(4100, 768) bf16 -> bf16", plain, kernel)
        out[kname] = {"max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms,
                      **bound(nbytes + 2 * 768 * 4), "library_ms": lib}
    # At the serve shape the operands (12.6 and 25.2 MB) stay in the 50 MB L2
    # across graph replays, so the kernels can beat the memory bound; at 8x
    # the rows (100 and 200 MB) they cannot stay there.
    x, h, g, b = _ln_operands(8 * 4100, 768, bf16, seed=21)
    for kname, kernel, nbytes in (
        ("layernorm", lambda: layernorm.layernorm_cuda(x, g, b, 1e-6), 16 * row),
        ("residual_layernorm", lambda: layernorm.residual_layernorm_cuda(x, h, g, b, 1e-6),
         32 * row),
    ):
        print(f"{kname} (32800, 768) bf16 -> bf16, operands beyond L2: "
              f"{1e3 * graph_ms(kernel, iters=10, samples=20):.2f} us per call (CUDA-graph "
              f"replay), bound {1e3 * bound(nbytes)['bound_ms']:.2f} us")
    return out


# The int8 LayerNorms' cases: the serve shape in bf16 and f32 (f32 at 768:
# 6 chunks a lane), a wide row (3072: 12 chunks a lane), the small f32 int8 model's width and
# a bf16 -> f32 pair, at non-multiple row counts.
LN_INT8_CASES = [("serve", 4100, 768, torch.bfloat16, torch.bfloat16),
                 ("serve_f32", 4100, 768, torch.float32, torch.float32),
                 ("wide", 37, 3072, torch.bfloat16, torch.bfloat16),
                 ("small_f32", 51, 128, torch.float32, torch.float32),
                 ("bf16_f32", 37, 1024, torch.bfloat16, torch.float32)]


def phase_layernorm_int8() -> dict:
    """The LayerNorm kernels' int8 output against the LayerNorm kernel
    followed by `quantize_rows` (`LN_INT8_CASES`): x_q, s_x and x + h
    bit-equal, with a constant row (zero bias too: s_x at the 1e-6 floor);
    two calls bit-identical. Then at (4100, 768) bf16, CUDA-graph replays in
    turns: each int8 LayerNorm against its plain chain (the plain LayerNorm,
    then `quantize_rows`) and against the pair it replaces (the LayerNorm
    kernel, then `int8_quantize_rows_cuda`), each beside its bytes' bound."""
    for i, (name, M, D, inp, out) in enumerate(LN_INT8_CASES):
        x, h, g, b = _ln_operands(M, D, inp, seed=30 + i)
        x[M // 2] = 1.0  # a constant row: its LayerNorm is the bias
        for bias in (b, torch.zeros_like(b)):
            want = quantize_rows(layernorm.layernorm_cuda(x, g, bias, 1e-6, out))
            xn_ref, y = layernorm.residual_layernorm_cuda(x, h, g, bias, 1e-6, out)
            want_r = quantize_rows(y)
            runs = [layernorm.layernorm_int8_cuda(x, g, bias, 1e-6, out) for _ in range(2)]
            xn, got_r = layernorm.residual_layernorm_int8_cuda(x, h, g, bias, 1e-6, out)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for got, ref in
                       ((runs[0], want), (runs[1], want), (got_r, want_r))
                       for a, c in zip(got, ref))
            check(same and torch.equal(xn, xn_ref),
                  f"int8 LayerNorm {name} ({M}, {D}) {inp} -> {out}: x_q, s_x or x + h differ "
                  f"from the LayerNorm kernel followed by quantize_rows")
        print(f"int8 LayerNorms vs the LayerNorm kernel + quantize_rows [{name} ({M}, {D}) "
              f"{inp} -> {out}, a constant row, zero bias too]: x_q, s_x and x + h bit-equal; "
              f"two calls bit-identical")
    x, h, g, b = _ln_operands(4100, 768, torch.bfloat16, seed=40)

    def timer(fn):
        return graph_ms(fn, iters=10, samples=20)

    row, tail = 2 * 4100 * 768, 2 * 768 * 4 + 4100 * 768 + 4 * 4100  # bf16 rows; params, x_q, s_x
    out = {}
    for kname, plain, pair, kernel, nbytes in (
        ("layernorm_int8", lambda: quantize_rows(layernorm.layernorm_reference(x, g, b, 1e-6)),
         lambda: int8_matmul.int8_quantize_rows_cuda(layernorm.layernorm_cuda(x, g, b, 1e-6)),
         lambda: layernorm.layernorm_int8_cuda(x, g, b, 1e-6), row + tail),
        ("residual_layernorm_int8",
         lambda: quantize_rows(layernorm.residual_layernorm_reference(x, h, g, b, 1e-6)[1]),
         lambda: int8_matmul.int8_quantize_rows_cuda(
             layernorm.residual_layernorm_cuda(x, h, g, b, 1e-6)[1]),
         lambda: layernorm.residual_layernorm_int8_cuda(x, h, g, b, 1e-6), 3 * row + tail),
    ):
        ms, plain_ms = time_in_turns(kname, "(4100, 768) bf16 -> x_q, s_x", plain, kernel)
        new, pair_ms = _in_turns(timer, pair, kernel)
        bd = bound(nbytes)
        print(f"{kname} (4100, 768) bf16, us per call, CUDA-graph replay, in turns: the pair it "
              f"replaces (the LayerNorm kernel, then int8_quantize_rows) {1e3 * pair_ms:.2f}, "
              f"the int8 output {1e3 * new:.2f} ({pair_ms / new:.2f}x); bound "
              f"{1e3 * bd['bound_ms']:.2f} ({bd['bound_by']}), the int8 output at "
              f"{bd['bound_ms'] / ms:.2f} of it")
        out[kname] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bd,
                      "library_ms": None, "pair_ms": pair_ms,
                      "work": "(4100, 768) bf16 -> x_q, s_x; pair: the LayerNorm kernel, then "
                              "int8_quantize_rows_cuda"}
    return out


# Fused int8 attention cases: (name, B, T, H, d, mask, layout), each in
# bf16 and f32. Masks as `_flash_mask` ("random" drops 30 % of the keys, "all"
# also every key of batch element 1); layouts: "proj" q, k, v views of their
# projections (B, T, H, d), the serve path's; "rope" q and k (B, H, T, d)
# storage seen as (B, T, H, d), as RoPE leaves them; "strided" q, k, v
# slices of one (B, T, 3, H, d) tensor.
INT8_CASES = [
    ("serve", 4, 1025, 12, 64, None, "proj"),
    ("serve_masked_rope", 4, 1025, 12, 64, "all", "rope"),
    ("t37", 2, 37, 3, 64, "random", "proj"),
    ("t129_strided", 2, 129, 2, 64, "random", "strided"),
    ("t1", 3, 1, 2, 64, None, "proj"),
    ("all_masked_t300", 3, 300, 2, 64, "all", "strided"),
    ("t2305", 1, 2305, 2, 64, "random", "proj"),  # T > 1536: the quantization in two rounds
    # `cli eval --int8-backbone --int8-attention`'s backbone attentions (no
    # RoPE, no key mask): the FR3 capture's ViT-B/16 at 512 px, 2 groups x 8
    # views (`phase_cli_eval_capture`); the DREAM twin's 192-wide ViT/16 at
    # 128 px (3 heads of 64) at eval batch 16 (`phase_cli_eval_small`) and
    # 50 (`scripts/torch_int8_receipt.py`).
    ("eval_capture", 16, 1025, 12, 64, None, "proj"),
    ("eval_twin", 16, 65, 3, 64, None, "proj"),
    ("eval_twin_receipt", 50, 65, 3, 64, None, "proj"),
    # The other head widths: the serve-like (2, 1025, 768 / d, d), and a
    # masked case in the RoPE or the strided layout (T = 300: a last key tile
    # of 44 keys at 128 a tile, 44 at 64 and 12 at 32).
    *[case for d in INT8_WIDTHS for case in (
        (f"d{d}_serve", 2, 1025, 768 // d, d, None, "proj"),
        (f"d{d}_masked", 3, 300, 2, d, "all" if d in (48, 128) else "random",
         "rope" if d in (32, 96) else "strided"),
    )],
    # The synthetic trainer's 192-wide ViT/16 at 128 px with the DINO
    # checkpoint's 4 heads of 48 (`phase_dino_d48`): its serve step (4
    # cameras, T = 65) and `cli eval`'s batches of 16.
    ("d48_twin_serve", 4, 65, 4, 48, None, "proj"),
    ("d48_twin_eval", 16, 65, 4, 48, None, "proj"),
]
INT8_SERVE = (4, 1025, 12, 64)  # the int8 serve step's attention: 4 views at 512 px
INT8_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _int8_operands(B: int, T: int, H: int, layout: str, seed: int, mask_kind=None,
                   planted: bool = False, dtype=torch.bfloat16, d: int = 64):
    """(B, T, H, d) q, k, v of `dtype` on the card in `layout` and a mask.
    Random: q, k ~ 2 N(0, 1), v ~ N(0, 1) (the CPU tests' scales). Planted:
    only channel 0 of q and k is nonzero, q in {0, +-512}, k in {+-1}, so
    every logit is the row's max or far below it (e in {0, 1} but for a
    subnormal e at d = 128 that rounds out of pq and z), and q = 0 rows are
    uniform."""
    gen = torch.Generator().manual_seed(seed)
    if planted:
        q, k = torch.zeros(B, T, H, d), torch.zeros(B, T, H, d)
        q[..., 0] = 512.0 * torch.randint(-1, 2, (B, T, H), generator=gen)
        k[..., 0] = 2.0 * torch.randint(0, 2, (B, T, H), generator=gen) - 1.0
        v = torch.randn(B, T, H, d, generator=gen)
    else:
        q, k, v = (s * torch.randn(B, T, H, d, generator=gen) for s in (2.0, 2.0, 1.0))
    q, k, v = (t.to("cuda", dtype) for t in (q, k, v))
    if layout == "rope":
        q, k = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k))
    elif layout == "strided":
        q, k, v = torch.stack([q, k, v], dim=2).unbind(2)  # strides (T 3 H d, 3 H d, d, 1)
    return q, k, v, _flash_mask(mask_kind, B, T, gen)


def _int8_bound(out: torch.Tensor, want: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """The CPU tests' bound: one value step sv of the channel, plus, for a
    bf16 output, 2^-7 of |want| (its ulp); sv (B H, d) -> (B, T, H, d)."""
    B, T, H, d = want.shape
    step = sv.reshape(B, 1, H, d)
    if out.dtype == torch.float32:
        return step.expand(B, T, H, d)
    w = want.float().abs()
    return step + torch.exp2(torch.floor(torch.log2(w.clamp_min(1e-30))) - 7)


def int8_attention_bound(B: int, T: int, H: int, d: int, dtype, passes: int = 1) -> dict:
    """The least time of the int8 attention at (B, T, H, d): the logits
    QK^T once (bf16; f32 as three TF32 products, the split that holds f32's
    rounding) and the int8 P V, 2 B H T^2 d operations a product; q and k
    read once in their type, the int8 values and their scales read once, O
    written once; with the B H T^2 exponentials' floor. `passes` = 2 counts
    the logits' products twice, as the kernel computes them (its two passes
    over the keys): a reading of the design, not of the function's work."""
    pairs, elems = B * H * T * T, B * T * H * d
    f32 = dtype == torch.float32
    ops = {"tf32" if f32 else "bf16": passes * (3 if f32 else 1) * 2 * pairs * d,
           "int8": 2 * pairs * d}
    nbytes = (3 * (4 if f32 else 2) * elems + B * H * d * int8_attention._fused_tp(T)
              + 4 * B * H * d)
    return with_exp_floor(bound(nbytes, ops), pairs)


def int8_case(i: int, name: str, B: int, T: int, H: int, d: int, mask_kind, layout: str,
              dname: str) -> float:
    """One INT8_CASES case in one dtype -> the kernel's largest gap from the
    plain version: vt and sv of `int8_quantize_v_cuda` equal
    `quantize_v_plain`'s; the fused kernel on those values within `_int8_bound` of `int8_attention_reference` (the
    non-bit-equal outputs counted), the whole `int8_prob_attention`
    (quantization + kernel) of `int8_prob_attention_reference`; planted
    rows bit-equal; two calls bit-identical."""
    dtype = INT8_DTYPES[dname]
    shape = (B, T, H, d)
    q, k, v, mask = _int8_operands(B, T, H, layout, seed=100 + i, mask_kind=mask_kind,
                                   dtype=dtype, d=d)
    Tp = int8_attention._fused_tp(T)
    runs = [int8_attention.int8_quantize_v_cuda(v) for _ in range(2)]
    vt, sv = runs[0]
    outs = [int8_attention.int8_attention_cuda(q, k, vt, sv, mask) for _ in range(2)]
    whole = int8_attention.int8_prob_attention(q, k, v, mask)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)) and torch.equal(*outs),
          f"int8 {dname} {name}: two calls on the same inputs differ")
    vt_ref, sv_ref = int8_attention.quantize_v_plain(v, Tp)
    check(torch.equal(vt, vt_ref) and torch.equal(sv, sv_ref),
          f"int8 {dname} {name}: {int((vt != vt_ref).sum())} quantized values and "
          f"{int((sv != sv_ref).sum())} scales differ from the plain version")
    vq, _ = int8_attention.quantize_v_reference(v)
    want = int8_attention.int8_attention_reference(q, k, vq, sv, mask)
    want_whole = int8_attention.int8_prob_attention_reference(q, k, v, mask)
    out = outs[0]
    check(out.dtype == dtype and out.shape == shape and bool(torch.isfinite(out).all()),
          f"int8 {dname} {name}: output {out.dtype} {out.shape}")
    gap = (out.float() - want.float()).abs()
    gap_whole = (whole.float() - want_whole.float()).abs()
    bound_ = _int8_bound(out, want, sv)
    check(bool((gap <= bound_).all()) and bool((gap_whole <= bound_).all()),
          f"int8 {dname} {name}: {float((gap / bound_).max())} and "
          f"{float((gap_whole / bound_).max())} of the bound from the plain version")
    differ = int((out != want).sum())
    print(f"fused int8 attention vs plain [{dname} {name} (B, T, H, d) = {shape} mask "
          f"{mask_kind}, {layout}]: quantized values and scales equal; kernel on them max abs "
          f"err {float(gap.max()):.4g} ({float((gap / bound_).max()):.3f} of the bound), "
          f"{differ} of {out.numel()} outputs not bit-equal; whole function max abs err "
          f"{float(gap_whole.max()):.4g}; two calls bit-identical")
    q, k, v, mask = _int8_operands(B, T, H, layout, seed=200 + i, mask_kind=mask_kind,
                                   planted=True, dtype=dtype, d=d)
    vt, sv = int8_attention.int8_quantize_v_cuda(v)
    out = int8_attention.int8_attention_cuda(q, k, vt, sv, mask)
    torch.cuda.synchronize()
    want = int8_attention.int8_prob_attention_reference(q, k, v, mask)
    check(torch.equal(out, want), f"int8 {dname} {name} planted: "
                                  f"{int((out != want).sum())} outputs differ from the plain "
                                  f"version")
    print(f"fused int8 attention planted rows [{dname} {name}]: bit-equal to the plain version")
    return float(gap.max())


def int8_times(B: int, T: int, H: int, d: int, dname: str, timer) -> tuple:
    """At (B, T, H, d) in one dtype, CUDA-graph replays: the whole function
    in turns plain/fused/fused/plain, each kernel alone against its plain
    version, and SDPA in the same dtype (a near relative: float
    probabilities) -> (the kernel's entry, the values' quantization's)."""
    dtype = INT8_DTYPES[dname]
    q, k, v, _ = _int8_operands(B, T, H, "proj", seed=300, dtype=dtype, d=d)
    Tp = int8_attention._fused_tp(T)
    vt, sv = int8_attention.int8_quantize_v_cuda(v)
    vq, _ = int8_attention.quantize_v_reference(v)
    fused, plain = _in_turns(
        timer, lambda: int8_attention.int8_prob_attention_reference(q, k, v),
        lambda: int8_attention.int8_prob_attention(q, k, v))
    kernel, kernel_plain = _in_turns(
        timer, lambda: int8_attention.int8_attention_reference(q, k, vq, sv),
        lambda: int8_attention.int8_attention_cuda(q, k, vt, sv))
    quant, quant_plain = _in_turns(timer, lambda: int8_attention.quantize_v_plain(v, Tp),
                                   lambda: int8_attention.int8_quantize_v_cuda(v))
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = timer(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
    kb = int8_attention_bound(B, T, H, d, dtype)
    design = int8_attention_bound(B, T, H, d, dtype, passes=2)["bound_ms"]
    qb = bound(v.element_size() * v.numel() + vt.numel() + 4 * sv.numel())
    print(f"int8 attention {(B, T, H, d)} {dname}, ms per call, CUDA-graph replay, in turns "
          f"plain/fused/fused/plain: whole function fused {fused:.4f}, plain {plain:.4f}; "
          f"the attention after the values' kernel, in the main path's order (the whole "
          f"function less that kernel alone, with the programmatic edge) {fused - quant:.4f}; "
          f"fused kernel alone {kernel:.4f} (plain {kernel_plain:.4f}), bound {fmt_bound(kb)} (ex2 at "
          f"{exp_per_s():.4g}/s), at {kb['bound_ms'] / kernel:.3f} of it (the kernel's two "
          f"passes of logits: {design:.4f}, at {design / kernel:.3f}); values' quantization "
          f"kernel {quant:.4f} (plain {quant_plain:.4f}, bound {qb['bound_ms']:.4f}), "
          f"{100 * quant / fused:.1f} % of the fused route; SDPA {dname} (float probabilities, "
          f"a near relative) {sdpa:.4f}")
    entry = {"ms": kernel, "plain_ms": kernel_plain, "bound_ms": kb["bound_ms"],
             "bound_by": kb["bound_by"], "two_pass_bound_ms": design, "library_ms": None,
             "fused_route_ms": fused, "in_order_ms": fused - quant, "plain_route_ms": plain,
             "sdpa_ms": sdpa}
    return entry, {"ms": quant, "plain_ms": quant_plain, **qb}


def attention_graph_edges(dname: str) -> dict:
    """Whether a CUDA graph captured from the stream keeps the attention's
    programmatic dependent launch behind the values' kernel (f32: behind the
    pre-pass that splits k, which follows the values' kernel): the whole
    `int8_prob_attention` at INT8_SERVE in one dtype captured in one torch
    CUDA graph, its edges read through the driver (`utils/graphs.py`), the
    edge into the attention required programmatic, the replayed output held
    bit-equal to the eager one."""
    q, k, v, _ = _int8_operands(*INT8_SERVE[:3], "proj", seed=301, dtype=INT8_DTYPES[dname])
    eager = int8_attention.int8_prob_attention(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        captured = int8_attention.int8_prob_attention(q, k, v)
    edges = graphs.kernel_edges(graph)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    into = [(src, kind) for src, dst, kind, _ in edges if "int8_attention_sm90_kernel" in dst]
    before = "int8_quantize_v_kernel" if dname == "bf16" else "int8_split_k_kernel"
    equal = torch.equal(captured, eager)
    print(f"int8 attention {dname} in a CUDA graph (the values' kernel and the attention captured "
          f"from the stream): edges (from, to, type, port) {edges}; replayed output bit-equal "
          f"to the eager one: {equal}")
    check(equal, f"int8 attention {dname}: a graph replay differs from the eager call")
    check(len(into) == 1 and before in into[0][0] and into[0][1] == graphs.PROGRAMMATIC,
          f"int8 attention {dname}: no programmatic edge from {before}: {edges}")
    return {"edges": edges, "replay_bit_equal": equal}


def phase_int8_attention() -> dict:
    """The fused int8 attention on the card against its plain versions, and
    the values' quantization kernel against its own, bf16 and f32, every
    INT8_CASES case (`int8_case`, every head width). Then, at INT8_SERVE in
    each dtype, `attention_graph_edges`, and there and at the serve-like (2,
    1025, 768 / d, d) of each other width (under "widths" and "f32_widths"),
    `int8_times`."""
    max_err = {name: {} for name in INT8_DTYPES}  # by width; the quantized values equal
    for dname in INT8_DTYPES:
        for i, (name, B, T, H, d, mask_kind, layout) in enumerate(INT8_CASES):
            gap = int8_case(i, name, B, T, H, d, mask_kind, layout, dname)
            max_err[dname][d] = max(max_err[dname].get(d, 0.0), gap)

    def timer(fn):
        return graph_ms(fn, iters=5, samples=20)

    result = {}
    for dname in INT8_DTYPES:
        kname = "int8_attention" if dname == "bf16" else "int8_attention_f32"
        edges = attention_graph_edges(dname)
        entry, quant = int8_times(*INT8_SERVE, dname, timer)
        result[kname] = {"max_abs_err": max_err[dname][64], **entry,
                         "graph_edge": [e for e in edges["edges"]
                                        if "int8_attention_sm90_kernel" in e[1]]}
        result.setdefault("int8_quantize_v", {"max_abs_err": 0.0, **quant, "library_ms": None})
        result["int8_quantize_v"][f"{dname}_ms"] = quant["ms"]
        widths = {}
        for d in INT8_WIDTHS:
            entry, quant = int8_times(2, 1025, 768 // d, d, dname, timer)
            widths[str(d)] = {"shape": [2, 1025, 768 // d, d], "max_abs_err": max_err[dname][d],
                              **entry, "quantize_v_ms": quant["ms"],
                              "quantize_v_bound_ms": quant["bound_ms"]}
        result[kname]["widths" if dname == "bf16" else "f32_widths"] = widths
    return result


# The int8 serve step's products (ViT-B/16 at 512 px, M = 4 views x 1025
# tokens): (name, Din, Dout, calls a block). q, k, v and out are 768 -> 768.
INT8_MM_ROWS = 4 * 1025
INT8_MM_SERVE = [("qkv_out", 768, 768, 4), ("fc1", 768, 3072, 1), ("fc2", 3072, 768, 1)]
# The int8 eval's products: the FR3 capture's ViT-B/16 (M = 16 views x 1025
# tokens) and the DREAM twin's 192-wide blocks (M = 16 x 65 in
# `phase_cli_eval_small`, 50 x 65 in the receipt): (name, M, Din, Dout).
INT8_MM_EVAL = [
    *[(f"eval_capture_{name}", 16 * 1025, din, dout) for name, din, dout, _ in INT8_MM_SERVE],
    *[(f"eval_twin{tag}_{name}", B * 65, din, dout) for tag, B in (("", 16), ("_receipt", 50))
      for name, din, dout in (("qkv_out", 192, 192), ("fc1", 192, 768), ("fc2", 768, 192))],
]
# The kernels against the plain version: the serve products, then few rows
# (M = 1, 37, 51) at the serve widths and the small int8 model's (hidden 128,
# MLP 512, `phase_small_reference`), then the eval's. Every x has an all-zero
# row (M > 1).
INT8_MM_CASES = [
    *[(name, INT8_MM_ROWS, din, dout) for name, din, dout, _ in INT8_MM_SERVE],
    ("m1", 1, 768, 768), ("m37_fc1", 37, 768, 3072), ("m37_fc2", 37, 3072, 768),
    ("m51_small", 51, 128, 128), ("m51_small_fc1", 51, 128, 512), ("m51_small_fc2", 51, 512, 128),
    *INT8_MM_EVAL,
    # The GEMM's tiles ragged in both directions (5 row tiles by 3 column
    # tiles); the narrowest and widest operands the route takes. (The eval
    # capture's M = 16400 gives blocks of 3 and 4 tiles: the warpgroups'
    # turns end unevenly.)
    ("odd_tiles", 519, 768, 576), ("k16_n8", 200, 16, 8), ("k4096_n4104", 300, 4096, 4104),
]


def _int8_mm_operands(M: int, din: int, dout: int, dtype, seed: int):
    """x (M, din) on the card, N(0, 1) rows scaled by 2^U(-4, 4) (row maxima
    spread over many binades), row M // 2 all zero; a quantized N(0, 0.02)
    weight (kernel_q column-major, as `Int8Linear` holds it), its scale and
    an N(0, 0.02) bias."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(M, din, generator=gen) * torch.exp2(8 * torch.rand(M, 1, generator=gen) - 4)
    if M > 1:
        x[M // 2] = 0.0
    kq, scale = quantize_kernel((0.02 * torch.randn(din, dout, generator=gen)).numpy(), in_dims=1)
    bias = 0.02 * torch.randn(dout, generator=gen)
    kq = torch.from_numpy(np.ascontiguousarray(kq.T)).cuda().t()
    return x.to("cuda", dtype), kq, torch.from_numpy(scale).cuda(), bias.cuda()


def check_division() -> None:
    """The repaired division of `quantize_rows`: on 4100 rows of 768 whose
    max m has m / 127 and m * fl(1/127) apart in f32, s_x of the plain
    version and of the kernel on the card equal numpy's f32 true division,
    for bf16 and f32 x. Prints how many rows the old form (a Python divisor,
    which torch on CUDA makes a product with the reciprocal) gets wrong."""
    reciprocal = np.float32(1.0) / np.float32(127.0)
    maxima = np.arange(4.0, 8.0, 2.0**-5).astype(np.float32)  # bf16-representable
    maxima = maxima[maxima / np.float32(127.0) != maxima * reciprocal]
    rng = np.random.default_rng(11)
    M, K = INT8_MM_ROWS, 768
    x = np.clip(rng.normal(size=(M, K)), -3.9, 3.9).astype(np.float32)
    x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    x[np.arange(M), rng.integers(0, K, size=M)] = (
        rng.choice(maxima, size=M) * rng.choice([-1.0, 1.0], size=M)).astype(np.float32)
    m = np.abs(x).max(axis=1)
    want = m / np.float32(127.0)
    for dtype in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(x).to("cuda", dtype)
        for label, (_, sx) in (("plain", quantize_rows(xt)),
                               ("kernel", int8_matmul.int8_quantize_rows_cuda(xt))):
            got = sx.cpu().numpy()[:, 0]
            check(np.array_equal(got, want),
                  f"s_x of the {label} quantization ({dtype}) differs from the true division in "
                  f"{int((got != want).sum())} rows")
    old = (torch.from_numpy(m).cuda() / 127.0).cpu().numpy()
    print(f"int8 quantization's division, {M} planted rows of {K} (m / 127 and m * fl(1/127) "
          f"apart): s_x of the plain version and of the kernel equal numpy's true division, bf16 "
          f"and f32 x; the old form (m / 127.0 on the card) differs in {int((old != want).sum())} "
          f"of {M} rows")


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of `fn`, launched back to back without a
    synchronize (the queue stays far below its depth), after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / calls


def host_costs() -> dict:
    """The int8 matmul's host cost a call at 768 -> 768 (the serve loop is
    bound by its host): the plain chain and the kernels' route in turns, each
    wrapper alone, the medians of 6 turns each."""
    x, kq, scale, bias = _int8_mm_operands(INT8_MM_ROWS, 768, 768, torch.bfloat16, seed=600)
    xq, sx = int8_matmul.int8_quantize_rows_cuda(x)
    bf = torch.bfloat16
    fns = {"plain_chain": lambda: int8_matmul_reference(x, kq, scale, bias, bf),
           "kernels": lambda: int8_matmul_dispatch(x, kq, scale, bias, bf),
           "quantize_wrapper": lambda: int8_matmul.int8_quantize_rows_cuda(x),
           "gemm_wrapper": lambda: int8_matmul.int8_gemm_cuda(xq, sx, kq, scale, bias, bf)}
    t = {name: [] for name in fns}
    for _ in range(3):
        for name in [*fns, *reversed(fns)]:
            t[name].append(host_us(fns[name]))
    out = {name: statistics.median(v) for name, v in t.items()}
    print("int8 matmul host cost a call at (4100, 768) -> 768 bf16, us, medians of 6 turns: "
          + ", ".join(f"{name} {v:.2f}" for name, v in out.items()))
    return out


def gemm_graph_edges() -> dict:
    """Whether a CUDA graph captured from the stream keeps the GEMM's
    programmatic dependent launch: a block's six products (768 -> 768 four
    times, fc1, fc2 at M = 4100, bf16) captured in one torch CUDA graph, its
    edges read through the driver (`utils/graphs.py`; type 1: programmatic),
    and the replayed outputs held bit-equal to the eager ones."""
    cases = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    ops = [_int8_mm_operands(INT8_MM_ROWS, din, dout, torch.bfloat16, seed=900 + i)
           for i, (din, dout) in enumerate(cases)]
    pairs = [int8_matmul.int8_quantize_rows_cuda(x) for x, *_ in ops]

    def block():
        return [int8_matmul.int8_gemm_cuda(xq, sx, kq, scale, bias, torch.bfloat16)
                for (xq, sx), (_, kq, scale, bias) in zip(pairs, ops)]

    eager = block()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        captured = block()
    kinds = [(kind, port) for _, _, kind, port in graphs.kernel_edges(graph)]
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(captured, eager))
    out = {"edges": len(kinds), "programmatic": sum(t == 1 for t, _ in kinds),
           "edge_types_ports": kinds, "replay_bit_equal": equal}
    print(f"int8 GEMM in a CUDA graph (a block's six products captured from the stream): "
          f"{out['edges']} edges, {out['programmatic']} of them programmatic (type, port: "
          f"{kinds}); replayed outputs bit-equal to the eager ones: {equal}")
    check(equal, "int8 GEMM: a graph replay differs from the eager calls")
    check(len(kinds) == len(cases) - 1 and all(k == (1, 1) for k in kinds),
          f"int8 GEMM: the captured block lost its programmatic dependent launch: edges (type, "
          f"port) {kinds}, want {len(cases) - 1} of (1, 1)")
    return out


def phase_int8_matmul() -> dict:
    """The int8 matmul's two kernels on the card against the plain version
    (`quantize_rows`, `int8_gemm_reference`: `torch._int_mm` and the plain
    dequant), bit-equal at every INT8_MM_CASES shape for bf16 and f32 x and
    bf16 and f32 out: x_q and s_x, the output, and the whole `int8_matmul`
    (the dispatcher) against `int8_matmul_reference`; two calls
    bit-identical; the repaired division (`check_division`). Then, at each
    serve product (bf16 x and out), CUDA-graph replays in turns plain/kernel/
    kernel/plain of the quantization, the GEMM and the whole function, and
    `torch._int_mm` alone (int32 out), each beside its bound; the host cost
    a call (`host_costs`)."""
    check_division()
    err = {"gemm": 0.0, "quantize": 0.0}  # max abs gaps from the plain version (checked 0)
    for i, (name, M, din, dout) in enumerate(INT8_MM_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            x, kq, scale, bias = _int8_mm_operands(M, din, dout, dtype, seed=400 + i)
            runs = [int8_matmul.int8_quantize_rows_cuda(x) for _ in range(2)]
            xq, sx = runs[0]
            xq_ref, sx_ref = quantize_rows(x)
            torch.cuda.synchronize()
            check(torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1]),
                  f"int8 quantization {name} {dtype}: two calls differ")
            err["quantize"] = max(err["quantize"], float((xq.int() - xq_ref.int()).abs().max()),
                                  float((sx - sx_ref).abs().max()))
            check(torch.equal(xq, xq_ref) and torch.equal(sx, sx_ref),
                  f"int8 quantization {name} {dtype}: {int((xq != xq_ref).sum())} values and "
                  f"{int((sx != sx_ref).sum())} scales differ from the plain version")
            for out_dtype in (torch.bfloat16, torch.float32):
                outs = [int8_matmul.int8_gemm_cuda(xq, sx, kq, scale, bias, out_dtype)
                        for _ in range(2)]
                whole = int8_matmul_dispatch(x, kq, scale, bias, out_dtype)
                want = int8_gemm_reference(xq_ref, sx_ref, kq, scale, bias, out_dtype)
                want_whole = int8_matmul_reference(x, kq, scale, bias, out_dtype)
                torch.cuda.synchronize()
                check(torch.equal(outs[0], outs[1]), f"int8 GEMM {name}: two calls differ")
                err["gemm"] = max(err["gemm"], float((outs[0].float() - want.float()).abs().max()))
                check(outs[0].shape == (M, dout) and outs[0].dtype == out_dtype
                      and bool(torch.isfinite(outs[0]).all()),
                      f"int8 GEMM {name}: output {outs[0].dtype} {tuple(outs[0].shape)}")
                check(torch.equal(outs[0], want) and torch.equal(whole, want_whole),
                      f"int8 GEMM {name} {dtype} -> {out_dtype}: {int((outs[0] != want).sum())} "
                      f"outputs (whole function {int((whole != want_whole).sum())}) differ from "
                      f"the plain version, max abs "
                      f"{float((outs[0].float() - want.float()).abs().max()):.4g}")
        print(f"int8 matmul vs plain [{name} (M, Din, Dout) = {(M, din, dout)}, zero row]: x_q, "
              f"s_x and the output bit-equal for bf16 and f32 x, bf16 and f32 out, the whole "
              f"function too; two calls bit-identical")
        del x, kq, scale, bias, xq, sx, xq_ref, sx_ref, runs, outs, whole, want, want_whole

    def timer(fn):
        return graph_ms(fn, iters=10, samples=20)

    host = host_costs()
    edges = gemm_graph_edges()
    per, block = {}, {k: 0.0 for k in ("quantize", "quantize_plain", "gemm", "gemm_plain",
                                       "whole", "whole_plain", "int_mm")}
    work = {k: 0.0 for k in ("q_bytes", "g_bytes", "one_bytes", "ops", "int_mm_bytes")}
    M = INT8_MM_ROWS
    for name, din, dout, calls in INT8_MM_SERVE:
        x, kq, scale, bias = _int8_mm_operands(M, din, dout, torch.bfloat16, seed=500)
        xq, sx = int8_matmul.int8_quantize_rows_cuda(x)
        bf = torch.bfloat16
        t = {}
        t["quantize"], t["quantize_plain"] = _in_turns(
            timer, lambda: quantize_rows(x), lambda: int8_matmul.int8_quantize_rows_cuda(x))
        t["gemm"], t["gemm_plain"] = _in_turns(
            timer, lambda: int8_gemm_reference(xq, sx, kq, scale, bias, bf),
            lambda: int8_matmul.int8_gemm_cuda(xq, sx, kq, scale, bias, bf))
        t["whole"], t["whole_plain"] = _in_turns(
            timer, lambda: int8_matmul_reference(x, kq, scale, bias, bf),
            lambda: int8_matmul_dispatch(x, kq, scale, bias, bf))
        t["int_mm"] = timer(lambda: torch._int_mm(xq, kq))
        # Bytes: each input read once, each output written once.
        w = {"q_bytes": 2 * M * din + M * din + 4 * M,
             "g_bytes": M * din + din * dout + 4 * M + 8 * dout + 2 * M * dout,
             "one_bytes": 2 * M * din + din * dout + 8 * dout + 2 * M * dout,
             "ops": 2 * M * din * dout,
             "int_mm_bytes": M * din + din * dout + 4 * M * dout}
        per[name] = {**t, "quantize_bound": bound(w["q_bytes"])["bound_ms"],
                     "gemm_bound": bound(w["g_bytes"], w["ops"], "int8")["bound_ms"],
                     "whole_bound": bound(w["q_bytes"] + w["g_bytes"], w["ops"],
                                          "int8")["bound_ms"],
                     "one_pass_bound": bound(w["one_bytes"], w["ops"], "int8")["bound_ms"]}
        per[name]["l2_bytes"] = int8_matmul.gemm_l2_bytes(M, din, dout)
        print(f"int8 GEMM {name} ({M}, {din}) -> {dout}: operand bytes from L2 into shared memory "
              f"{per[name]['l2_bytes'] / 1e6:.2f} MB (a design reading: each tile's A and B "
              f"panels), beside the bound {1e3 * per[name]['gemm_bound']:.2f} us")
        print(f"int8 matmul {name} ({M}, {din}) -> {dout} bf16, us per call, CUDA-graph replay "
              f"in turns plain/kernel/kernel/plain: quantization {1e3 * t['quantize']:.2f} (plain "
              f"{1e3 * t['quantize_plain']:.2f}, bound {1e3 * per[name]['quantize_bound']:.2f}); "
              f"GEMM {1e3 * t['gemm']:.2f} (plain: torch._int_mm + dequant "
              f"{1e3 * t['gemm_plain']:.2f}, bound {1e3 * per[name]['gemm_bound']:.2f}); whole "
              f"function {1e3 * t['whole']:.2f} (plain {1e3 * t['whole_plain']:.2f}, two-pass "
              f"bound {1e3 * per[name]['whole_bound']:.2f}, one-pass bound "
              f"{1e3 * per[name]['one_pass_bound']:.2f}); torch._int_mm alone (int32 out) "
              f"{1e3 * t['int_mm']:.2f}")
        for k in block:
            block[k] += calls * t[k]
        for k in work:
            work[k] += calls * w[k]
        del x, kq, scale, bias, xq, sx
    # A block's two quantizations by the rows kernel: out's input (768) and
    # fc2's (3072); the LayerNorm kernels write q/k/v's and fc1's pairs.
    quant_block = per["qkv_out"]["quantize"] + per["fc2"]["quantize"]
    quant_plain_block = per["qkv_out"]["quantize_plain"] + per["fc2"]["quantize_plain"]
    q_bytes_block = (3 * M * 768 + 4 * M) + 3 * M * 3072 + 4 * M  # bf16 in, int8 + s_x out
    qb = bound(q_bytes_block)
    gb = bound(work["g_bytes"], work["ops"], "int8")
    one = bound(work["one_bytes"], work["ops"], "int8")
    two = 1e3 * 12 * bound(q_bytes_block + work["g_bytes"], work["ops"], "int8")["bound_ms"]
    for name, din in (("qkv_out", 768), ("fc2", 3072)):
        t, qbd = per[name]["quantize"], per[name]["quantize_bound"]
        print(f"int8_quantize_rows ({M}, {din}) bf16: {1e3 * t:.2f} us, bound {1e3 * qbd:.2f} us "
              f"(bytes), at {qbd / t:.2f} of it")
    print(f"int8 matmul, one block's products at M = {M} (the serve step runs 12): quantizations "
          f"{1e3 * quant_block:.2f} us (2 calls: out, fc2; plain {1e3 * quant_plain_block:.2f}, "
          f"bound {1e3 * qb['bound_ms']:.2f}); GEMMs {1e3 * block['gemm']:.2f} us (6 calls; plain "
          f"{1e3 * block['gemm_plain']:.2f}, torch._int_mm alone {1e3 * block['int_mm']:.2f}, "
          f"bound {1e3 * gb['bound_ms']:.2f} {gb['bound_by']}); a serve step's 24 + 72 calls "
          f"{12 * (quant_block + block['gemm']):.4f} ms against the two-pass bound {two / 1e3:.4f} "
          f"ms and the one-pass bound {12 * one['bound_ms']:.4f} ms; the plain chain's "
          f"{12 * block['whole_plain']:.4f} ms")
    return {
        "int8_matmul": {"max_abs_err": err["gemm"], "ms": block["gemm"],
                        "plain_ms": block["gemm_plain"],
                        **gb, "library_ms": block["int_mm"],
                        "work": "one block's six products at M = 4100: 4 x 768->768, "
                                "768->3072, 3072->768; library: torch._int_mm, int32 out",
                        "per_product": per, "one_pass_bound_ms": one["bound_ms"],
                        "step_ms": 12 * (quant_block + block["gemm"]),
                        "step_two_pass_bound_ms": two / 1e3,
                        "step_plain_chain_ms": 12 * block["whole_plain"], "host_us": host,
                        "graph_edges": edges},
        "int8_quantize_rows": {"max_abs_err": err["quantize"], "ms": quant_block,
                               "plain_ms": quant_plain_block, **qb, "library_ms": None,
                               "work": "one block's two quantizations at M = 4100: "
                                       "768 (out), 3072 (fc2), bf16",
                               "per_width_ms": {"768": per["qkv_out"]["quantize"],
                                                "3072": per["fc2"]["quantize"]}},
    }


def _render_rows(M: int, H: int, W: int, seed: int, sigma=(2.0, 2.0), ties: bool = False,
                 outside: bool = False) -> torch.Tensor:
    """(M, 3) rows [x, y, 1/(2 sigma^2)] on the card, made as the dispatcher
    makes them: keypoints anywhere in the map and up to 8 px past its edge;
    sigma uniform in the given range (per map when it is a range); optional
    half-pixel ties and points just and far outside."""
    rng = np.random.default_rng(seed)
    kp = np.stack([rng.uniform(-8, W + 8, M), rng.uniform(-8, H + 8, M)], -1).astype(np.float32)
    if ties:
        kp[: M // 2] = np.floor(kp[: M // 2]) + 0.5  # (c - x)^2 equal for c = x -/+ 0.5
    if outside:
        edge = np.array([[-0.5, H / 2], [W - 0.3, H / 2], [W / 2, -1.7], [-1000.0, -1000.0],
                         [1e4, 30.0], [W / 2, 1e5]], np.float32)
        kp[: len(edge)] = edge
    sig = torch.from_numpy(rng.uniform(*sigma, M).astype(np.float32))
    inv = 1.0 / (2.0 * (sig * sig))
    return torch.cat([torch.from_numpy(kp), inv[:, None]], dim=1).cuda()


def phase_heatmap_render() -> dict:
    """Render kernel vs its plain version on the card. Bound: 1e-6 absolute
    on values in [0, 1] (the Pallas-vs-jnp bound of tests/test_ops.py:39);
    the kernel runs the plain version's f32 operations in the same order with
    the same expf, so it is expected to agree bit for bit, and the number of
    differing values is printed."""
    cases = [
        ("train_gt", 576, 128, 128, (2.0, 2.0), False, False),
        ("train_blob", 576, 512, 512, (3.0, 3.0), False, False),
        ("twin_gt", 336, 64, 64, (2.0, 2.0), False, False),
        ("twin_blob", 336, 128, 128, (3.0, 3.0), False, False),
        ("nonmultiple_m_w", 37, 50, 70, (2.0, 2.0), False, False),
        ("per_map_sigma_small", 64, 64, 64, (0.3, 6.0), False, False),
        ("half_pixel_ties", 40, 64, 64, (2.0, 2.0), True, False),
        ("outside", 12, 64, 64, (2.0, 5.0), False, True),
    ]
    max_err = 0.0
    for i, (name, M, H, W, sigma, ties, outside) in enumerate(cases):
        rows = _render_rows(M, H, W, seed=50 + i, sigma=sigma, ties=ties, outside=outside)
        got = heatmap_render.render_heatmaps_cuda(rows, H, W)
        torch.cuda.synchronize()
        want = heatmap_render.render_heatmaps_reference(rows, H, W)
        err = float((got - want).abs().max())
        differ = int((got != want).sum())
        check(err <= 1e-6, f"{name}: render kernel differs from the plain version by {err}")
        if outside:
            far = got[3:6].flatten(1).amax(1)
            check(bool((far == 0).all()), f"{name}: a far-outside map is not all zeros")
        max_err = max(max_err, err)
        print(f"kernel vs plain [{name} ({M}, {H}, {W}) sigma {sigma}]: max abs err {err:.3g}, "
              f"{differ} of {got.numel()} values differ; {int((got == 0).sum())} zeros")
    out = {}
    for shape, (M, H, W, s) in (("(576, 128, 128)", (576, 128, 128, 2.0)),
                                ("(576, 512, 512)", (576, 512, 512, 3.0))):
        rows = _render_rows(M, H, W, seed=60, sigma=(s, s))
        out[shape] = time_in_turns(
            "heatmap render", f"{shape} f32, sigma {s}",
            lambda: heatmap_render.render_heatmaps_reference(rows, H, W),
            lambda: heatmap_render.render_heatmaps_cuda(rows, H, W),
            iters=5 if H == 512 else 20, samples=20,
        )
    ms, plain_ms = out["(576, 512, 512)"]
    # The f32 maps written once (the rows read are 7 KB); no PyTorch call renders.
    return {"heatmap_render": {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                               **bound(576 * 512 * 512 * 4 + 576 * 3 * 4), "library_ms": None}}


# Flash-attention cases: (name, B, T, H, d, mask). Masks: "view" masks view
# b % V of batch element b (views of 513 tokens), "random" drops 30 % of the
# keys, "all" drops 30 % and every key of batch element 1. The train_768
# operands lie as the backbone's do after RoPE: (B, H, T, d) storage seen as
# (B, T, H, d); the others are contiguous (B, T, H, d), as a projection's.
FLASH_CASES = [
    ("serve_768", 4, 2305, 12, 64, None),  # the 768-px serve backbone
    ("train_768", 8, 2305, 12, 64, None),  # the 768-px train backbone
    ("fusion_bench", 4, 4104, 12, 64, "view"),  # 8 views of 513, one masked
    ("fusion_default_heads", 2, 2052, 8, 96, "view"),  # SelfAttentionFusion's 8 heads at D = 768
    ("t37_d48", 2, 37, 4, 48, "random"),
    ("all_masked", 3, 300, 2, 64, "all"),
    ("t1", 3, 1, 2, 32, None),
    ("t129", 2, 129, 3, 64, "random"),  # one row past a 128-row block
]
HEADS_OUTER = {"train_768"}
# Times, graph replay in turns: the full-width shapes and the backbone at
# 512 px (T = 1025: train 72 images, serve 4), which stays on the plain path.
FLASH_TIMED = [("serve_768", 4, 2305, None), ("train_768", 8, 2305, None),
               ("fusion_bench", 4, 4104, "view"), ("train_512", 72, 1025, None),
               ("serve_512", 4, 1025, None)]
# A kernel's error may exceed the plain branch's by this much: at T = 1 the
# plain branch's dQ and dK are exactly 0 (a softmax over one key), the
# kernels' a difference of two f32 sums of the same products (5e-8 on the card).
FLASH_ERR_FLOOR = 1e-6
# A backward kernel alone against `flash_backward_plain` in f32 on the same
# saved statistics: each gradient within this share of the plain gradient's
# largest magnitude. The kernels round P and dS to bf16 before the second
# products and their outputs to bf16 (half an ulp is up to 2^-8 of a value):
# 2^-6 is four such roundings of the largest value; FLASH_ERR_FLOOR beside
# it for gradients that are 0 in exact arithmetic (T = 1).
BACKWARD_TOL = 2.0 ** -6
# The f16 Hopper pair, the same way with f16's half ulp (2^-11): 2^-9.
F16_BACKWARD_TOL = 2.0 ** -9
# The forward kernel alone against `flash_forward_plain` in f32 on the same
# bf16 (f16) values. O no further from it than the plain branch's O in the
# operands' dtype is (or FLASH_ERR_FLOOR): both round to that dtype the
# probabilities they multiply by V and the O they return, and the plain
# branch its logits as well, so the kernel's error is the smaller (in bf16
# measured 2.3x to 4x smaller on an H100). The bound scales with O itself,
# not with V: at T = 2305 a typical |O| is ~0.03 beside max|v| ~5.
# `forward_alone` shows that it is tight enough to fail a kernel that skips
# one key tile. m (base 2) within STAT_TOL where a row has an attended key
# (its logits are f32 sums of the same products in another order, ~1e-5
# here; a shift of m by 2^-10 moves P by 0.07 % and leaves O as it is) and
# exactly bf16's lowest finite value where it has none; l within 2 STAT_TOL
# relative (it moves with m).
STAT_TOL = 2.0 ** -10
# The f32 route's kernels (f32 operands, `phase_f32`: the split-TF32
# forward, dK/dV and dQ) against the plain versions in f32 on the same
# values, as a share of the largest magnitude: f32 products (the split drops
# ~2^-20 of each) summed in another order over T = 2305 keys, ~1e-6 (the f32
# plain forward is itself ~1e-6 from f64), each tile's sum rounded toward
# zero on the tensor cores, and the exponentials' 2 ulps. One TF32 product
# each misses it 100-fold or more.
F32_TOL = 1e-5
F32_SHAPE = (2, 2305, 12, 64)  # the 768-px serve backbone's T at 2 images
F32_SERVE_SHAPE = (4, 2305, 12, 64)  # the f32 768-px serve step's forward: 4 cameras


def backward_tol(route: str) -> float:
    """The bound of a backward route's gradients against the plain version
    in f32, as a share of the plain gradient's largest magnitude."""
    return {"wgmma_f16": F16_BACKWARD_TOL, "wgmma_tf32": F32_TOL}.get(route, BACKWARD_TOL)


def _flash_mask(kind, B: int, T: int, gen):
    if kind is None:
        return None
    if kind == "view":
        views = torch.arange(T) // 513
        return (views[None, :] != (torch.arange(B) % (T // 513))[:, None]).cuda()
    mask = torch.rand(B, T, generator=gen) > 0.3
    if kind == "all":
        mask[1] = False
    return mask.cuda()


def _flash_operands(B: int, T: int, H: int, d: int, mask_kind, seed: int,
                    heads_outer: bool = False, dtype=torch.bfloat16):
    """(B, T, H, d) leaves q, k, v of `dtype`, a cotangent dO and a mask; with
    `heads_outer` q, k, v are (B, H, T, d) storage seen as (B, T, H, d)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, d, generator=gen).to("cuda", dtype) for _ in range(4))
    if heads_outer:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    return [t.requires_grad_() for t in (q, k, v)], do, _flash_mask(mask_kind, B, T, gen)


def dropped_tile_gap(q, k, v, mask_u8, o_ref):
    """max |O - o_ref| of a forward that skips keys [tile, 2 tile), the
    second key tile of the Hopper forward (`attention.forward_key_tile`), as
    a kernel with a wrong tile loop would (None where T < 2 tile): what the
    O bound of `forward_alone` must reject."""
    T, tile = q.shape[1], attention.forward_key_tile()
    if T < 2 * tile:
        return None
    keep = torch.cat([torch.arange(tile), torch.arange(2 * tile, T)]).to(q.device)
    o, _, _ = attention.flash_forward_plain(
        q.float(), k[:, keep].float(), v[:, keep].float(),
        None if mask_u8 is None else mask_u8[:, keep])
    return float((o.float() - o_ref).abs().max())


def forward_alone(q, k, v, mask, tol_o: float) -> dict:
    """The Hopper forward alone against `flash_forward_plain` in f32 on the
    same bf16 (f16) values: O within tol_o (the plain branch's O error in
    that dtype), m and l within STAT_TOL, 2 STAT_TOL (an all-masked row's m
    exact), and two calls bit-identical; a forward that skips one key tile
    must miss tol_o. -> {route: [err O, m, l]}, with the skipped tile's O gap
    under its own key."""
    mask_u8 = attention.mask_bytes(mask)
    o_ref, m_ref, l_ref = attention.flash_forward_plain(q.float(), k.float(), v.float(), mask_u8)
    attended = m_ref > attention.MASKED_LOGIT  # rows with an attended key
    dropped = dropped_tile_gap(q, k, v, mask_u8, o_ref)
    check(dropped is None or dropped > tol_o,
          f"forward alone: O's bound {tol_o} passes a forward that skips a key tile ({dropped})")
    errs = {f"a forward skipping a key tile (O bound {tol_o:.3g})": [
        float("nan") if dropped is None else dropped]}
    route = attention.kernel_route(q.shape[-1], q.dtype)
    runs = [attention.flash_forward_cuda(q, k, v, mask_u8) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{route}: two forward calls on the same inputs differ")
    o, m, l = runs[0]
    check(torch.equal(m[~attended], m_ref[~attended]),
          f"{route}: an all-masked row's m is not bf16's lowest finite value")
    errs[route] = [float((o.float() - o_ref).abs().max()),
                   float((m - m_ref)[attended].abs().max()) if bool(attended.any()) else 0.0,
                   float(((l - l_ref) / l_ref).abs().max())]
    for part, e, tol in zip(("O", "m", "l"), errs[route], (tol_o, STAT_TOL, 2 * STAT_TOL)):
        check(e <= tol, f"{route} forward alone: {part} is {e} from flash_forward_plain, "
                        f"above {tol}")
    return errs


def backward_alone(q, k, v, mask, do) -> dict:
    """The dQ and dK/dV kernels alone against `flash_backward_plain` in f32
    on the same saved statistics (the forward kernel's m and l, di of its
    O): each gradient within its route's `backward_tol` of the plain one's
    largest magnitude (plus FLASH_ERR_FLOOR), and two calls bit-identical.
    -> {route: [err dQ, dK, dV]}."""
    mask_u8 = attention.mask_bytes(mask)
    o, m, l = attention.flash_forward_cuda(q, k, v, mask_u8)
    args = (q, k, v, mask_u8, do, m, l, attention.row_dot(do, o))
    want = attention.flash_backward_plain(q.float(), k.float(), v.float(), mask_u8, do.float(),
                                          *args[5:])
    route = attention.kernel_route(q.shape[-1], q.dtype, "dkv")
    tols = [backward_tol(route) * float(w.abs().max()) + FLASH_ERR_FLOOR for w in want]
    runs = [(attention.flash_backward_dq_cuda(*args), *attention.flash_backward_dkv_cuda(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{route}: two backward calls on the same inputs differ")
    errs = [float((g.float() - w).abs().max()) for g, w in zip(runs[0], want)]
    for part, e, tol in zip(("dQ", "dK", "dV"), errs, tols):
        check(e <= tol, f"{route} {part} alone is {e} from flash_backward_plain, above {tol}")
    return {route: errs}


def _grads(fn, qkv, mask, do):
    """O, dQ, dK, dV of fn on the leaves qkv, cotangent do."""
    out = fn(*qkv, mask)
    return [out.detach(), *torch.autograd.grad(out, qkv, do.to(out.dtype))]


def _flash_bounds(B: int, T: int, H: int, d: int, mask, dtype=torch.bfloat16) -> dict:
    """Per kernel: its products over the keys this data attends (2 B H T^2 d
    FLOPs each without a mask), the operands read once and outputs written
    once. Forward: 2 products, reads q, k, v, writes O (the timed call saves
    no statistics); dK/dV: 4 products, reads q, k, v, dO and the f32 m, l,
    di, writes dK, dV; dQ: 3 products, reads the same, writes dQ. bf16 and
    f16 at the tensor cores' rate; f32 as three TF32 products per product
    at TF32's rate (its route's arithmetic; the same work at the f32 rate
    beside it as "f32_rate_bound_ms", for the printed lines); the forward's
    exponentials, one per query and attended key, at `with_exp_floor`'s."""
    pairs = H * T * (B * T if mask is None else int(mask.sum()))
    x = B * T * H * d * torch.finfo(dtype).bits // 8
    stat, mbytes = B * H * T * 4, 0 if mask is None else B * T
    kind = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[dtype]
    work = {"flash_fwd": (4 * x + mbytes, 2 * 2 * pairs * d),
            "flash_bwd_dkv": (6 * x + 3 * stat + mbytes, 4 * 2 * pairs * d),
            "flash_bwd_dq": (5 * x + 3 * stat + mbytes, 3 * 2 * pairs * d)}
    out = {}
    for name, (nbytes, ops) in work.items():
        if dtype == torch.float32:
            out[name] = bound(nbytes, 3 * ops, "tf32")
            out[name]["f32_rate_bound_ms"] = bound(nbytes, ops, "f32")["bound_ms"]
        else:
            out[name] = bound(nbytes, ops, kind)
    f32_rate = out["flash_fwd"].get("f32_rate_bound_ms")
    out["flash_fwd"] = with_exp_floor(out["flash_fwd"], pairs)
    if f32_rate is not None:
        out["flash_fwd"]["f32_rate_bound_ms"] = f32_rate
    return out


def flash_case(i: int, name: str, B: int, T: int, H: int, d: int, mask_kind) -> tuple:
    """One FLASH_CASES shape: O, dQ, dK and dV of the kernels no further from
    the plain branch in f32 on the same bf16 values than the bf16 plain
    branch is (FLASH_ERR_FLOOR aside), with a random dO; then the forward
    and the backward kernels alone (`forward_alone`, `backward_alone`). ->
    (the kernels' O/dQ/dK/dV errors, the forward's and the backward's
    errors alone)."""
    qkv, do, mask = _flash_operands(B, T, H, d, mask_kind, seed=70 + i,
                                    heads_outer=name in HEADS_OUTER)
    ref = _grads(attention.flash_attention_reference,
                 [t.detach().float().requires_grad_() for t in qkv], mask, do)
    gaps = {}
    for path, fn in (("kernel", attention.flash_attention_cuda),
                     ("plain", attention.flash_attention_reference)):
        got = _grads(fn, qkv, mask, do)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got), f"{name}: {path} not finite")
        gaps[path] = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
        del got
    del ref
    for part, e_kernel, e_plain in zip(("O", "dQ", "dK", "dV"), gaps["kernel"], gaps["plain"]):
        check(e_kernel <= max(e_plain, FLASH_ERR_FLOOR),
              f"{name}: the kernels' {part} is {e_kernel} from f32, the bf16 plain "
              f"branch's {e_plain}")
    fwd = forward_alone(*(t.detach() for t in qkv), mask, max(gaps["plain"][0], FLASH_ERR_FLOOR))
    alone = backward_alone(*(t.detach() for t in qkv), mask, do)
    fmt = lambda v: "/".join(f"{e:.3g}" for e in v)  # noqa: E731
    layout = ", heads outer" if name in HEADS_OUTER else ""
    print(f"flash kernels vs f32 plain [{name} (B, T, H, d) = {(B, T, H, d)} mask {mask_kind}"
          f"{layout}; route {attention.kernel_route(d)}]: O/dQ/dK/dV max abs err kernels "
          f"{fmt(gaps['kernel'])}, bf16 plain {fmt(gaps['plain'])}; forward alone vs "
          f"flash_forward_plain, O/m/l(rel): " + ", ".join(f"{r} {fmt(e)}" for r, e in fwd.items())
          + "; backward alone vs flash_backward_plain, dQ/dK/dV: "
          + ", ".join(f"{r} {fmt(e)}" for r, e in alone.items())
          + "; two calls bit-identical")
    return gaps["kernel"], fwd, alone


def _in_turns(timer, first, second) -> tuple:
    """timer() of first/second/second/first -> (median of second, of first)."""
    t = [timer(f) for f in (first, second, second, first)]
    return statistics.median(t[1:3]), statistics.median(t[0::3])


def backward_times(B: int, T: int, mask_kind, timer, H: int = 12, d: int = 64,
                   dtype=torch.bfloat16) -> dict:
    """At (B, T, H, d) in `dtype`: the dK/dV and dQ kernels alone on one
    forward's statistics; their plain versions (the plain branch's forward
    and its gradients: dK, dV or dQ); SDPA's backward alone
    (`torch.autograd.grad` on a saved SDPA forward, the library yardstick of
    the pair, timed only here). -> ms by key."""
    bench = _script("torch_bench_attention_fusion")
    qkv, do, mask = _flash_operands(B, T, H, d, mask_kind, seed=81, dtype=dtype)
    q, k, v = (t.detach() for t in qkv)
    mask_u8 = attention.mask_bytes(mask)
    o, m, l = attention.flash_forward_cuda(q, k, v, mask_u8)
    args = (q, k, v, mask_u8, do, m, l, attention.row_dot(do, o))
    out = {"flash_bwd_dkv": timer(lambda: attention.flash_backward_dkv_cuda(*args)),
           "flash_bwd_dq": timer(lambda: attention.flash_backward_dq_cuda(*args))}
    plain = attention.flash_attention_reference
    out["flash_bwd_dkv_plain"] = timer(lambda: torch.autograd.grad(plain(*qkv, mask), qkv[1:], do))
    out["flash_bwd_dq_plain"] = timer(lambda: torch.autograd.grad(plain(*qkv, mask), qkv[:1], do))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        saved = bench.sdpa(*qkv, mask)
    out["sdpa_bwd"] = graph_ms(lambda: torch.autograd.grad(saved, qkv, do, retain_graph=True),
                               iters=2, samples=10, stream=side)
    return out


def _fmt_times(times: dict) -> str:
    """`attention_times`' kernel, plain and SDPA times of both parts."""
    return "; ".join(f"{part}: kernel {times['kernel'][part]:.4f}, plain "
                     f"{times['plain'][part]:.4f}, SDPA {times['library'][part]:.4f}"
                     for part in ("fwd", "fwd_bwd"))


def _fmt_backward(t: dict, bounds: dict) -> str:
    """`backward_times`' kernels, plain versions and bounds, and the pair beside SDPA's."""
    pair = t["flash_bwd_dkv"] + t["flash_bwd_dq"]
    return ("; ".join(f"{k}: {t[k]:.4f}, plain (forward + its gradients) {t[k + '_plain']:.4f}, "
                      f"bound {bounds[k]['bound_ms']:.4f} ({bounds[k]['bound_by']})"
                      for k in FLASH_KERNELS[1:])
            + f"; pair {pair:.4f}, SDPA's backward alone (the pair's three gradients) "
            f"{t['sdpa_bwd']:.4f} (the pair {pair / t['sdpa_bwd']:.2f}x it)")


def _width_times(times: dict, t: dict, bounds: dict) -> dict:
    """{kernel: times} of one width for the JSON line: the forward's from
    `attention_times`, the backward's from `backward_times`."""
    out = {"flash_fwd": {"ms": times["kernel"]["fwd"], "plain_ms": times["plain"]["fwd"],
                         "bound_ms": bounds["flash_fwd"]["bound_ms"],
                         "bound_by": bounds["flash_fwd"]["bound_by"],
                         "library_ms": times["library"]["fwd"]}}
    for k in FLASH_KERNELS[1:]:
        out[k] = {"ms": t[k], "plain_ms": t[k + "_plain"], "bound_ms": bounds[k]["bound_ms"],
                  "bound_by": bounds[k]["bound_by"], "library_ms": t["sdpa_bwd"]}
    return out


def phase_flash() -> dict:
    """The three flash-attention kernels against the plain branch on the
    card (`flash_case` at every FLASH_CASES shape). Then times by CUDA-graph
    replay, in turns plain/kernel/kernel/plain, of the forward and the
    forward + backward, beside torch's SDPA (the library yardstick, timed
    only here), at the full-width shapes and at T = 1025; and of the dK/dV
    and dQ kernels alone (`backward_times`) at the 768-px train shape and
    the fusion bench shape."""
    bench = _script("torch_bench_attention_fusion")
    err = dict.fromkeys(FLASH_KERNELS, 0.0)
    for i, case in enumerate(FLASH_CASES):
        ek, _, _ = flash_case(i, *case)
        err["flash_fwd"] = max(err["flash_fwd"], ek[0])
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], ek[1])
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], ek[2], ek[3])

    def timer(fn):
        return graph_ms(fn, iters=2, samples=10)

    out = {}
    for name, B, T, mask_kind in FLASH_TIMED:
        qkv, do, mask = _flash_operands(B, T, 12, 64, mask_kind, seed=80)
        out[name] = times = bench.attention_times(*qkv, mask, do, timer)
        bounds = _flash_bounds(B, T, 12, 64, mask)
        print(f"flash attention [{name} (B, T, H, d) = {(B, T, 12, 64)} mask {mask_kind}], ms "
              f"per call, CUDA-graph replay, plain/kernel/kernel/plain: {_fmt_times(times)}; "
              f"forward bound {fmt_bound(bounds['flash_fwd'])}")
        del qkv, do
    alone = {}
    for name, B, T, mask_kind in (("train_768", 8, 2305, None), ("fusion_bench", 4, 4104, "view")):
        alone[name] = t = backward_times(B, T, mask_kind, timer)
        gen = torch.Generator().manual_seed(0)
        bounds = _flash_bounds(B, T, 12, 64, _flash_mask(mask_kind, B, T, gen))
        print(f"flash backward alone [{name} (B, T, H, d) = {(B, T, 12, 64)} mask {mask_kind}], ms "
              f"per call, CUDA-graph replay: {_fmt_backward(t, bounds)}")
    bounds = _flash_bounds(8, 2305, 12, 64, None)
    result = _width_times(out["train_768"], alone["train_768"], bounds)
    for kname in FLASH_KERNELS:
        # No one PyTorch call computes dK, dV (or dQ) alone: the backward's
        # library time is SDPA's backward, which computes the pair's three gradients.
        result[kname]["max_abs_err"] = err[kname]
    return result


# Each width's kernels against the plain versions: T = 2305 with a mask (batch
# element 1 all masked), contiguous as a projection's output, and T = 129 (one
# row past a 128-row block) without, heads outer as after RoPE; the model's
# width kept (768 / d heads). No main path runs these widths.
FLASH_WIDTHS = (32, 48, 96, 128)
WIDTH_CASES = [(2, T, 768 // d, d, mask_kind, heads_outer) for d in FLASH_WIDTHS
               for T, mask_kind, heads_outer in ((2305, "all", False), (129, None, True))]


def width_route_check(B: int, T: int, H: int, d: int, mask_kind, heads_outer: bool,
                      dtype=torch.bfloat16) -> tuple:
    """`fused_self_attention` forward + backward at one shape in `dtype`
    (use_flash=True: T = 129 is below the rule's threshold): one launch of
    each of the forward, dK/dV and dQ on the dtype's route
    (`attention.route_launches`); O no further from the plain branch in f32
    than the plain branch in `dtype` is (FLASH_ERR_FLOOR aside), and the
    gradients in bf16 too, in f16 within F16_BACKWARD_TOL of the largest
    (the f16 plain branch's softmax rounds its logits to f16); then the
    forward and the backward kernels alone (`forward_alone`,
    `backward_alone`). -> (the forward's errors alone, the backward's)."""
    qkv, do, mask = _flash_operands(B, T, H, d, mask_kind, seed=97 + d, heads_outer=heads_outer,
                                    dtype=dtype)
    _reset_launches()
    got = _grads(lambda q, k, v, m: attention.fused_self_attention(q, k, v, True, m),
                 qkv, mask, do)
    torch.cuda.synchronize()
    by_route = dict(attention.route_launches)
    want = {(part, attention.kernel_route(d, dtype, part)): 1 for part in FLASH_PARTS}
    check(by_route == want, f"d = {d}: fused_self_attention launched {by_route}, not {want}")
    ref = _grads(attention.flash_attention_reference,
                 [t.detach().float().requires_grad_() for t in qkv], mask, do)
    plain = _grads(attention.flash_attention_reference, qkv, mask, do)
    e_plain = [float((x.float() - c).abs().max()) for x, c in zip(plain, ref)]
    for i, (part, a, c) in enumerate(zip(("O", "dQ", "dK", "dV"), got, ref)):
        e_kernel = float((a.float() - c).abs().max())
        tol = (max(e_plain[i], FLASH_ERR_FLOOR) if i == 0 or dtype == torch.bfloat16
               else F16_BACKWARD_TOL * float(c.abs().max()) + FLASH_ERR_FLOOR)
        check(e_kernel <= tol, f"d = {d} T = {T} {dtype}: the kernels' {part} is {e_kernel} "
                               f"from f32, above {tol} (the plain branch's {e_plain[i]})")
    del got, ref, plain
    q, k, v = (t.detach() for t in qkv)
    return (forward_alone(q, k, v, mask, max(e_plain[0], FLASH_ERR_FLOOR)),
            backward_alone(q, k, v, mask, do))


def _print_width_check(case: tuple, dtype, fwd: dict, bwd: dict) -> None:
    fmt = lambda v: "/".join(f"{e:.3g}" for e in v)  # noqa: E731
    layout = "heads outer" if case[5] else "contiguous"
    print(f"flash kernels {dtype} at {case[:4]} mask {case[4]}, {layout}: fused_self_attention "
          f"launched the forward, dK/dV and dQ of route {attention.kernel_route(case[3], dtype)} "
          f"once each, within their bounds of the f32 plain branch; forward alone vs "
          f"flash_forward_plain, O/m/l(rel): " + ", ".join(f"{r} {fmt(e)}" for r, e in fwd.items())
          + "; backward alone vs flash_backward_plain, dQ/dK/dV: "
          + ", ".join(f"{r} {fmt(e)}" for r, e in bwd.items()) + "; two calls bit-identical")


def phase_flash_widths() -> dict:
    """The bf16 kernels at FLASH_WIDTHS (`flash_fwd_sm90_kernel<d>`,
    `flash_dkv_sm90_kernel<d>`, `flash_dq_sm90_kernel<d>`): at each
    WIDTH_CASES shape `width_route_check`. Then at the 768-px train shape
    with the model's width kept, (8, 2305, 768 / d, d) bf16 without a mask,
    by CUDA-graph replay: the forward and the forward + backward beside the
    plain branch and SDPA (in turns plain/kernel/kernel/plain), the dK/dV
    and dQ kernels alone (`backward_times`) beside SDPA's backward alone,
    each kernel's bound and the forward's exponentials' floor. ->
    {kernel: {d: times}}."""
    for case in WIDTH_CASES:
        _print_width_check(case, torch.bfloat16, *width_route_check(*case))
    bench = _script("torch_bench_attention_fusion")

    def timer(fn):
        return graph_ms(fn, iters=2, samples=10)

    result = {k: {} for k in FLASH_KERNELS}
    for d in FLASH_WIDTHS:
        B, T, H = 8, 2305, 768 // d
        qkv, do, _ = _flash_operands(B, T, H, d, None, seed=95)
        times = bench.attention_times(*qkv, None, do, timer)
        del qkv, do
        t = backward_times(B, T, None, timer, H, d)
        bounds = _flash_bounds(B, T, H, d, None)
        print(f"flash kernels [(B, T, H, d) = {(B, T, H, d)}], ms per call, CUDA-graph replay: "
              f"{_fmt_times(times)} (forward / SDPA "
              f"{times['kernel']['fwd'] / times['library']['fwd']:.3f}); forward bound "
              f"{fmt_bound(bounds['flash_fwd'])}; "
              f"backward alone: {_fmt_backward(t, bounds)}")
        for k, v in _width_times(times, t, bounds).items():
            result[k][d] = v
    return result


def phase_flash_f16() -> dict:
    """f16 at the 768-px train shape with the model's width kept, (8, 2305,
    768 / d, d), at every width of HEAD_DIMS (`flash_fwd_sm90_kernel<d,
    __half>`, `flash_dkv_sm90_kernel<d, __half>`, `flash_dq_sm90_kernel<d,
    __half>`): with a mask (batch element 1 all masked) `width_route_check`
    in f16; then without a mask, by CUDA-graph replay, the forward and the
    forward + backward beside the plain branch and SDPA f16 (in turns
    plain/kernel/kernel/plain), the dK/dV and dQ kernels alone beside SDPA
    f16's backward alone (`backward_times`), and the f16 pair against the
    bf16 pair in turns bf16/f16/f16/bf16. -> {kernel: {d: times}}."""
    bench = _script("torch_bench_attention_fusion")

    def timer(fn):
        return graph_ms(fn, iters=2, samples=10)

    def pair(dtype, B, T, H, d):
        qkv, do, _ = _flash_operands(B, T, H, d, None, seed=96, dtype=dtype)
        q, k, v = (t.detach() for t in qkv)
        o, m, l = attention.flash_forward_cuda(q, k, v)
        args = (q, k, v, None, do, m, l, attention.row_dot(do, o))
        return lambda: (attention.flash_backward_dkv_cuda(*args),
                        attention.flash_backward_dq_cuda(*args))

    result = {k: {} for k in FLASH_KERNELS}
    for d in attention.HEAD_DIMS:
        B, T, H = 8, 2305, 768 // d
        case = (B, T, H, d, "all", False)
        _print_width_check(case, torch.float16, *width_route_check(*case, dtype=torch.float16))
        qkv, do, _ = _flash_operands(B, T, H, d, None, seed=95, dtype=torch.float16)
        times = bench.attention_times(*qkv, None, do, timer)
        del qkv, do
        t = backward_times(B, T, None, timer, H, d, torch.float16)
        bf16_pair, f16_pair = _in_turns(timer, pair(torch.bfloat16, B, T, H, d),
                                        pair(torch.float16, B, T, H, d))
        bounds = _flash_bounds(B, T, H, d, None, torch.float16)
        print(f"flash f16 kernels [(B, T, H, d) = {(B, T, H, d)}], no mask, ms per call, "
              f"CUDA-graph replay: {_fmt_times(times)} (forward / SDPA "
              f"{times['kernel']['fwd'] / times['library']['fwd']:.3f}); forward bound "
              f"{fmt_bound(bounds['flash_fwd'])}; "
              f"backward alone: {_fmt_backward(t, bounds)}; pairs in turns bf16/f16/f16/bf16: "
              f"f16 {f16_pair:.4f}, bf16 {bf16_pair:.4f} ({f16_pair / bf16_pair:.3f}x)")
        for k, v in _width_times(times, t, bounds).items():
            result[k][d] = v
        for k in FLASH_KERNELS[1:]:
            result[k][d].update(pair_ms=f16_pair, bf16_pair_ms=bf16_pair)
    return result


# The counters kept by route, each read as a sum: the flash kernels' parts
# over their routes, the int8 attention's routes over the head widths.
_ROUTED = {**{(attention, p): attention.part_launches for p in ("fwd", "dkv", "dq")},
           **{(int8_attention, r): int8_attention.route_launches for r in ("fused", "fused_f32")}}


def _reset_launches() -> None:
    for module, counter, _, _ in KERNELS.values():
        if (module, counter) not in _ROUTED:
            setattr(module, counter, 0)
    attention.route_launches.clear()
    int8_attention.width_launches.clear()


def _read_launches() -> dict:
    return {name: _ROUTED[module, counter](counter) if (module, counter) in _ROUTED
            else getattr(module, counter) for name, (module, counter, _, _) in KERNELS.items()}


def _flash_zeros(n: int, d: int = 32, dtype=torch.bfloat16):
    """Operands of the flash kernels for n tokens: q, k, v, mask, dO, m, l, di."""
    q = torch.zeros(1, n, 2, d, dtype=dtype, device="cuda")
    stat = torch.ones(1, 2, n, device="cuda")
    return q, q, q, None, q, stat, stat, stat


def phase_counters() -> None:
    """Each wrapper counts where it launches its kernel and nowhere else: an
    empty input launches nothing and counts nothing, one launch counts one."""
    g, b = torch.ones(8, device="cuda"), torch.zeros(8, device="cuda")
    g16, b16 = torch.ones(16, device="cuda"), torch.zeros(16, device="cuda")
    calls = {
        "peak_decode": lambda n: peak_decode.peak_decode_cuda(torch.ones(n, 4, 4, device="cuda")),
        "layernorm": lambda n: layernorm.layernorm_cuda(torch.ones(n, 8, device="cuda"), g, b),
        "residual_layernorm": lambda n: layernorm.residual_layernorm_cuda(
            torch.ones(n, 8, device="cuda"), torch.ones(n, 8, device="cuda"), g, b),
        "layernorm_int8": lambda n: layernorm.layernorm_int8_cuda(
            torch.ones(n, 16, device="cuda"), g16, b16),
        "residual_layernorm_int8": lambda n: layernorm.residual_layernorm_int8_cuda(
            torch.ones(n, 16, device="cuda"), torch.ones(n, 16, device="cuda"), g16, b16),
        "heatmap_render": lambda n: heatmap_render.render_heatmaps_cuda(
            torch.zeros(n, 3, device="cuda"), 4, 4),
        "small_svd": lambda n: small_svd.small_svd_cuda(torch.zeros(n, 4, 3, device="cuda")),
        "int8_quantize_v": lambda n: int8_attention.int8_quantize_v_cuda(
            torch.zeros(1, n, 2, 64, dtype=torch.bfloat16, device="cuda")),
        "int8_quantize_rows": lambda n: int8_matmul.int8_quantize_rows_cuda(
            torch.zeros(n, 16, device="cuda")),
        "int8_matmul": lambda n: int8_matmul.int8_gemm_cuda(
            torch.zeros(n, 16, dtype=torch.int8, device="cuda"), torch.ones(n, 1, device="cuda"),
            torch.zeros(8, 16, dtype=torch.int8, device="cuda").t(), g, None, torch.float32),
        "int8_attention": lambda n: int8_attention.int8_attention_cuda(
            *(torch.zeros(1, n, 2, 64, dtype=torch.bfloat16, device="cuda"),) * 2,
            torch.zeros(2, 64, int8_attention._fused_tp(n), dtype=torch.int8, device="cuda"),
            torch.ones(2, 64, device="cuda")),
        "int8_attention_f32": lambda n: int8_attention.int8_attention_cuda(
            *(torch.zeros(1, n, 2, 64, device="cuda"),) * 2,
            torch.zeros(2, 64, int8_attention._fused_tp(n), dtype=torch.int8, device="cuda"),
            torch.ones(2, 64, device="cuda")),
    }
    calls = list(calls.items())
    for d, dtype in ((32, torch.bfloat16), (64, torch.bfloat16), (64, torch.float32),
                     (64, torch.float16), (96, torch.float16)):  # every route of every part
        def on(fn, d=d, dtype=dtype):
            def call(n):
                fn(*_flash_zeros(n, d, dtype))
            return call
        calls += [
            ("flash_fwd", on(lambda *z: attention.flash_attention_cuda(*z[:3]))),
            ("flash_bwd_dkv", on(attention.flash_backward_dkv_cuda)),
            ("flash_bwd_dq", on(attention.flash_backward_dq_cuda)),
        ]
    for name, call in calls:
        for n, want in ((0, 0), (3, 1)):
            _reset_launches()
            call(n)
            got = _read_launches()
            check(got == {k: want if k == name else 0 for k in KERNELS},
                  f"{name} on {n} rows counted {got}")
    torch.cuda.synchronize()
    print("launch counters: an empty input counts nothing, one launch counts one, "
          "for every kernel, the flash kernels on every route")


def _tf32_alone(q, k, v, mask) -> list:
    """The split-TF32 forward alone against `flash_forward_plain` in f32 on
    the same values: O within F32_TOL of the plain O's largest magnitude
    (plus FLASH_ERR_FLOOR) and closer to it than the one-TF32-product
    model's O (`flash_forward_tf32_model(.., products=1)`, what a forward
    that dropped the small terms computes), m and l as in `forward_alone`,
    two calls bit-identical. -> [err O, m, l, the one-product model's O]."""
    mask_u8 = attention.mask_bytes(mask)
    runs = [attention.flash_forward_cuda(q, k, v, mask_u8) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{q.dtype}: two forward calls on the same inputs differ")
    o, m, l = runs[0]
    o_ref, m_ref, l_ref = attention.flash_forward_plain(q.float(), k.float(), v.float(), mask_u8)
    one = attention.flash_forward_tf32_model(q, k, v, mask_u8, products=1)[0]
    e_one = float((one - o_ref).abs().max())
    del one
    attended = m_ref > attention.MASKED_LOGIT
    check(torch.equal(m[~attended], m_ref[~attended]),
          f"{q.dtype}: an all-masked row's m is not bf16's lowest finite value")
    errs = [float((o.float() - o_ref).abs().max()), float((m - m_ref)[attended].abs().max()),
            float(((l - l_ref) / l_ref).abs().max())]
    tols = [F32_TOL * float(o_ref.abs().max()) + FLASH_ERR_FLOOR, STAT_TOL, 2 * STAT_TOL]
    for part, e, t in zip(("O", "m", "l"), errs, tols):
        check(e <= t, f"{q.dtype} {part} alone is {e} from the plain version, above {t}")
    check(errs[0] < e_one, f"{q.dtype} d = {q.shape[-1]}: the forward's O error {errs[0]} is not "
                           f"below the one-TF32-product model's {e_one}")
    return [*errs, e_one]


def _tf32_backward_alone(q, k, v, mask, do) -> list:
    """The split-TF32 dQ and dK/dV kernels alone against
    `flash_backward_plain` in f32 on the same saved statistics (the f32
    forward kernel's m and l, di of its O): each gradient within F32_TOL of
    the plain gradient's largest magnitude, where the one-TF32-product
    model (`flash_backward_tf32_model(.., products=1)`, what a pair that
    dropped the small terms computes) must lie beyond F32_TOL; two calls
    bit-identical. -> [dQ, dK, dV errors, then the one-product model's], as
    shares of the largest magnitude."""
    mask_u8 = attention.mask_bytes(mask)
    o, m, l = attention.flash_forward_cuda(q, k, v, mask_u8)
    args = (q, k, v, mask_u8, do, m, l, attention.row_dot(do, o))
    runs = [(attention.flash_backward_dq_cuda(*args), *attention.flash_backward_dkv_cuda(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    d = q.shape[-1]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"f32 d = {d}: two backward calls on the same inputs differ")
    want = attention.flash_backward_plain(*args)
    one = attention.flash_backward_tf32_model(*args, products=1)
    errs, e_one = [], []
    for part, g, w, g1 in zip(("dQ", "dK", "dV"), runs[0], want, one):
        top = float(w.abs().max())
        errs.append(float((g - w).abs().max()) / top)
        e_one.append(float((g1 - w).abs().max()) / top)
        check(errs[-1] <= F32_TOL, f"f32 d = {d}: {part} alone is {errs[-1]} of the largest "
                                   f"|{part}| from flash_backward_plain, above {F32_TOL}")
        check(e_one[-1] > F32_TOL, f"f32 d = {d}: the one-TF32-product model's {part} "
                                   f"({e_one[-1]}) passes the bound {F32_TOL}")
    return errs + e_one


def phase_f32() -> dict:
    """f32 and f16 operands at T >= 2048 on the card: `fused_self_attention`
    at F32_SHAPE with a mask (batch element 1 all masked) launches one
    forward, one dK/dV and one dQ of the dtype's route (f32: the split-TF32
    kernels of `csrc/flash_attention_tf32.cu`; f16: the Hopper kernels
    instantiated for f16). Against the plain branch in f32 on the same
    values: f32's O and gradients within F32_TOL of their largest
    magnitude, f16's O no further than the f16 plain branch's O
    (FLASH_ERR_FLOOR aside) and its gradients within F16_BACKWARD_TOL; the
    forward alone (f32 `_tf32_alone`, f16 `forward_alone`) and the backward
    alone on the forward's m and l (f32 `_tf32_backward_alone`, f16
    `backward_alone`); the same values in bf16 launch one forward. The f32
    forward and backward pair alone at every width, (2, 2305, 768 / d, d)
    with the same mask, at d = 48 and 128 read through RoPE's heads-outer
    strides, and the forward at F32_SERVE_SHAPE without a mask, the shape
    and the mask of the f32 768-px serve step. Then, without a mask, the
    forward and forward + backward timed in turns plain/kernel/kernel/plain
    beside SDPA, and the dK/dV and dQ kernels alone beside SDPA's backward
    alone (`backward_times`); and at every width in f32 the forward alone,
    in turns with the plain branch's forward, beside SDPA f32, and the
    dK/dV and dQ kernels alone beside SDPA f32's backward alone. ->
    {kernel: {"f32_ms", "f32_plain_ms", "f32_library_ms", "f32_bound_ms",
    the same with f16_, and "f32_widths"}}; the bounds at the f32 rate are
    printed beside the split-TF32 ones, not returned."""
    B, T, H, d = F32_SHAPE
    gen = torch.Generator().manual_seed(90)
    base = [torch.randn(B, T, H, d, generator=gen).cuda() for _ in range(4)]
    mask = _flash_mask("all", B, T, gen)
    fmt = lambda v: "/".join(f"{e:.3g}" for e in v)  # noqa: E731
    for dtype in (torch.float32, torch.float16):
        q, k, v, do = (t.to(dtype) for t in base)
        ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        routes = {part: attention.kernel_route(d, dtype, part) for part in FLASH_PARTS}
        _reset_launches()
        got = _grads(lambda q, k, v, m: attention.fused_self_attention(q, k, v, key_mask=m),
                     ts, mask, do)
        torch.cuda.synchronize()
        launches, by_route = _read_launches(), dict(attention.route_launches)
        want = {(part, route): 1 for part, route in routes.items()}
        check(launches == {k: int(k in FLASH_KERNELS) for k in KERNELS} and by_route == want,
              f"{dtype} at T = {T} launched {by_route}, not {want}")
        ref = _grads(attention.flash_attention_reference,
                     [t.detach().float().requires_grad_() for t in (q, k, v)], mask, do.float())
        errs = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
        tols = [backward_tol(routes["dkv"]) * float(b.abs().max()) + FLASH_ERR_FLOOR for b in ref]
        if dtype == torch.float16:  # O: no further than the f16 plain branch's
            with torch.no_grad():
                o_plain = attention.flash_attention_reference(q, k, v, mask)
            tols[0] = max(float((o_plain.float() - ref[0]).abs().max()), FLASH_ERR_FLOOR)
            del o_plain
        check(got[0].dtype == dtype and all(e <= t for e, t in zip(errs, tols)),
              f"{dtype} at T = {T}: O/dQ/dK/dV {errs} from f32 plain, bounds {tols}")
        del got, ref, ts
        if dtype == torch.float32:
            fwd_alone = {routes["fwd"]: _tf32_alone(q, k, v, mask)}
            bwd_alone = {routes["dkv"]: _tf32_backward_alone(q, k, v, mask, do)}
            bwd_note = (f"dQ/dK/dV (shares of the largest; bound {F32_TOL:g})/one-TF32-product "
                        "model dQ/dK/dV")
        else:
            fwd_alone = forward_alone(q, k, v, mask, tols[0])
            bwd_alone = backward_alone(q, k, v, mask, do)
            bwd_note = f"dQ/dK/dV (bound {F16_BACKWARD_TOL:.3g} of the largest)"
        print(f"flash kernels {dtype} {F32_SHAPE} mask all (routes {routes}): "
              f"fused_self_attention launched {by_route}; O/dQ/dK/dV max abs err vs f32 plain "
              f"{fmt(errs)} (bounds {fmt(tols)}); alone vs flash_forward_plain, O/m/l(rel)"
              f"{'/one-TF32-product model O' if dtype == torch.float32 else ''}: "
              + ", ".join(f"{r} {fmt(e)}" for r, e in fwd_alone.items())
              + f"; vs flash_backward_plain on the forward's m and l, {bwd_note}: "
              + ", ".join(f"{r} {fmt(e)}" for r, e in bwd_alone.items())
              + "; two calls bit-identical")
    with torch.no_grad():
        _reset_launches()
        out = attention.fused_self_attention(*(t.bfloat16() for t in base[:3]), key_mask=mask)
        torch.cuda.synchronize()
        launches = _read_launches()
    check(launches == {k: int(k == "flash_fwd") for k in KERNELS} and
          bool(torch.isfinite(out).all()), f"bf16 at T = {T} launched {launches}")
    del out, base
    alone = {}
    for w in attention.HEAD_DIMS:
        qkv, do_w, mask_w = _flash_operands(B, T, 768 // w, w, "all", seed=91 + w,
                                            heads_outer=w in (48, 128), dtype=torch.float32)
        q, k, v = (t.detach() for t in qkv)
        alone[w] = (_tf32_alone(q, k, v, mask_w), _tf32_backward_alone(q, k, v, mask_w, do_w))
        del qkv, q, k, v
    qkv = _flash_operands(*F32_SERVE_SHAPE, None, seed=93, dtype=torch.float32)[0]
    serve_alone = _tf32_alone(*(t.detach() for t in qkv), None)
    del qkv
    print(f"flash f32 kernels alone (route {attention.kernel_route(64, torch.float32)}) at "
          f"(2, 2305, 768 / d, d) mask all (d = 48, 128 heads outer, as after RoPE): the forward "
          f"vs flash_forward_plain, O (bound {F32_TOL:g} of the largest |O|)/m/l(rel)/one-TF32-"
          f"product model O; the backward pair vs flash_backward_plain, dQ/dK/dV (bound "
          f"{F32_TOL:g} of the largest)/one-TF32-product model dQ/dK/dV: "
          + ", ".join(f"d = {w} forward {fmt(f)}, backward {fmt(b)}" for w, (f, b) in alone.items())
          + f"; the forward at the f32 768-px serve step's {F32_SERVE_SHAPE}, no mask: "
          f"{fmt(serve_alone)}; all-masked rows' m exact; two calls bit-identical")

    def timer(fn):
        return graph_ms(fn, iters=2, samples=10)

    bench = _script("torch_bench_attention_fusion")
    result = {k: {} for k in FLASH_KERNELS}
    for dtype, tag in ((torch.float32, "f32"), (torch.float16, "f16")):
        qkv, do, _ = _flash_operands(B, T, H, d, None, seed=90, dtype=dtype)
        times = bench.attention_times(*qkv, None, do, timer)
        del qkv, do
        t = backward_times(B, T, None, timer, H, d, dtype)
        bounds = _flash_bounds(B, T, H, d, None, dtype)
        print(f"flash kernels {tag} {F32_SHAPE} no mask (routes "
              f"{[attention.kernel_route(d, dtype, part) for part in FLASH_PARTS]}), ms per call, "
              f"CUDA-graph replay, plain/kernel/kernel/plain: {_fmt_times(times)} (forward / SDPA "
              f"{times['kernel']['fwd'] / times['library']['fwd']:.3f}); backward alone: "
              f"{_fmt_backward(t, bounds)}; bounds "
              + ", ".join(f"{k} {fmt_bound(b)}" for k, b in bounds.items())
              + (", at the f32 rate " + ", ".join(f"{k} {b['f32_rate_bound_ms']:.4f}"
                                                  for k, b in bounds.items())
                 if tag == "f32" else ""))
        result["flash_fwd"].update({f"{tag}_ms": times["kernel"]["fwd"],
                                    f"{tag}_plain_ms": times["plain"]["fwd"],
                                    f"{tag}_library_ms": times["library"]["fwd"]})
        for kname in FLASH_KERNELS[1:]:
            result[kname].update({f"{tag}_ms": t[kname], f"{tag}_plain_ms": t[kname + "_plain"],
                                  f"{tag}_library_ms": t["sdpa_bwd"]})
        for kname, b in bounds.items():
            result[kname][f"{tag}_bound_ms"] = b["bound_ms"]
        del times, t
    for kname in FLASH_KERNELS:
        result[kname]["f32_widths"] = {}
    for w in attention.HEAD_DIMS:
        Hw = 768 // w
        q, k, v = (t.detach() for t in _flash_operands(B, T, Hw, w, None, seed=92,
                                                       dtype=torch.float32)[0])
        with torch.no_grad():
            ms, plain_ms = _in_turns(
                timer, lambda: attention.flash_attention_reference(q, k, v),
                lambda: attention.flash_forward_cuda(q, k, v, save_stats=False))
            library_ms = timer(lambda: bench.sdpa(q, k, v))
        del q, k, v
        t = backward_times(B, T, None, timer, Hw, w, torch.float32)
        bounds = _flash_bounds(B, T, Hw, w, None, torch.float32)
        b = bounds["flash_fwd"]
        result["flash_fwd"]["f32_widths"][w] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        for kname in FLASH_KERNELS[1:]:
            result[kname]["f32_widths"][w] = {
                "ms": t[kname], "plain_ms": t[kname + "_plain"], "library_ms": t["sdpa_bwd"],
                "bound_ms": bounds[kname]["bound_ms"], "bound_by": bounds[kname]["bound_by"]}
        print(f"flash f32 kernels [(B, T, H, d) = {(B, T, Hw, w)}], no mask, ms per call, "
              f"CUDA-graph replay: forward in turns plain/kernel/kernel/plain: kernel {ms:.4f}, "
              f"plain {plain_ms:.4f}, SDPA f32 {library_ms:.4f} (kernel / SDPA "
              f"{ms / library_ms:.3f}), bound {fmt_bound(b)}, at the f32 rate "
              f"{b['f32_rate_bound_ms']:.4f}; backward alone: {_fmt_backward(t, bounds)}; at the "
              f"f32 rate dK/dV {bounds['flash_bwd_dkv']['f32_rate_bound_ms']:.4f}, dQ "
              f"{bounds['flash_bwd_dq']['f32_rate_bound_ms']:.4f}")
        del t
    return result


@contextlib.contextmanager
def blocked(module: str):
    """Within this block `module` cannot be imported (None in sys.modules)."""
    saved = sys.modules.get(module, ...)
    sys.modules[module] = None
    try:
        yield
    finally:
        if saved is ...:
            del sys.modules[module]
        else:
            sys.modules[module] = saved


def phase_replay() -> None:
    """`serve --replay-dir` through the CLI's parser on a directory of 4
    PNG frames, at toy size (2 views, 32 px, one layer). With cv2, the
    replay source's frame decoder, not importable (blocked in this process
    where the machine has it), serve exits naming it and ROADMAP queue 1
    item 7 before any source starts (until that check, every source failed
    and serve said only that none initialized); where cv2 imports, it serves."""
    (ROOT / "build").mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as frames:
        has_cv2 = importlib.util.find_spec("cv2") is not None
        for i in range(4):  # without cv2 serve refuses before it reads a frame
            path = Path(frames) / f"frame{i}.png"
            if has_cv2:
                import cv2

                cv2.imwrite(str(path), rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8))
            else:
                path.touch()
        args = build_parser().parse_args([
            "serve", "--replay-dir", frames, "--views", "2", "--fps", "60", "--frame-hw", "32",
            "48", "--model-size", "32", "--hidden-size", "64", "--num-layers", "1",
            "--duration", "1"])
        with blocked("cv2"):
            try:
                serve(args)
                said = "(served)"
            except SystemExit as e:
                said = str(e)
        check("cv2" in said and "item 7" in said, f"serve --replay-dir without cv2: {said}")
        print(f"serve --replay-dir, cv2 not importable ({'blocked' if has_cv2 else 'absent'}): "
              f"exits before any source starts: {said}")
        if has_cv2:
            stats, last = serve(args)
            check(last is not None and all(np.isfinite(a).all() for a in last),
                  f"serve --replay-dir: result {last}")
            print(f"serve --replay-dir with cv2: {stats.ticks} ticks from 4 PNG frames")


def _serve(argv: list, label: str, kernels: list, seconds: float = SERVE_SECONDS,
           outputs: tuple = ((4, 8, 2), (4, 8), (1, 7))) -> dict:
    """`cli serve` through the CLI's parser for `seconds` -> every kernel's
    launches in that run; `outputs` the shapes of a tick's keypoints,
    confidences and angles (the serve default's: 4 cameras, J = 8, A = 7)."""
    args = build_parser().parse_args(["serve", "--views", "4", "--duration", str(seconds),
                                      *argv])
    _reset_launches()
    stats, last = serve(args)
    launches = _read_launches()
    check(last is not None, f"{label}: serve returned no result")
    pose = "--recover-pose" in argv
    check(len(last) == (6 if pose else 3), f"{label}: serve returned {len(last)} outputs")
    xy, conf, ang = last[:3]
    check((xy.shape, conf.shape, ang.shape) == tuple(outputs),
          f"{label}: serve output shapes {xy.shape}, {conf.shape}, {ang.shape}")
    if pose:  # per-camera rvec, tvec and a boolean success, as the reference's infer
        rvec, tvec, success = last[3:]
        check(rvec.shape == tvec.shape == (4, 3) and success.shape == (4,)
              and success.dtype == np.bool_, f"{label}: pose outputs {rvec.shape}, "
              f"{tvec.shape}, {success.shape} {success.dtype}")
    check(all(np.isfinite(a).all() for a in last), f"{label}: serve output is not finite")
    check(stats.ticks >= 10, f"{label}: served only {stats.ticks} ticks")
    for name in KERNELS:
        if name in kernels:
            check(launches[name] > 0, f"{label}: the serve run launched no {name} kernel")
        else:
            check(launches[name] == 0, f"{label}: the serve run launched {name}: {launches}")
    print(f"serve [{label}]: {stats.ticks} ticks ({stats.frames_processed} camera frames) in "
          f"{seconds:.0f} s: {stats.fps:.2f} tick/s = {stats.camera_fps:.2f} "
          f"camera-frames/s; kernel launches {launches}; host "
          f"{1e3 * stats.total_step_time_s / stats.ticks:.2f} ms/tick, fetch "
          f"{1e3 * stats.total_fetch_time_s / stats.ticks:.2f} ms/tick"
          + (f"; last tick's success {last[5].tolist()}" if pose else ""))
    return launches


def seed0_flat(cfg: EstimatorConfig = FULL) -> dict:
    """The seed-0 random weights of `cfg` (the serve default's) as a
    reference checkpoint's flat dict (f32)."""
    return random_flat(MultiViewPoseEstimator(cfg, device="meta"))


def _int8_model(flat: dict, device, cfg: EstimatorConfig = FULL_LN) -> MultiViewPoseEstimator:
    """What `serve --int8-backbone --int8-attention` builds from the run dir."""
    model = MultiViewPoseEstimator(cfg, device=device).eval()
    load_jax_params(model, flat)
    int8ify(model, flat, attn=True)
    return model


def _model(cfg: EstimatorConfig, device, state) -> MultiViewPoseEstimator:
    model = MultiViewPoseEstimator(cfg, device=device).eval()
    model.load_state_dict(state)
    return model


def int8_matmul_work(model, step) -> tuple:
    """The `Int8Linear` calls of one `step()` of `model` and their work ->
    (calls, operations, one-pass bytes, two-pass bytes): 2 M Din Dout int8
    operations a call. One pass (a kernel that would quantize in its own
    prologue): x read once in the layer's dtype, kernel_q, scale and bias
    read once, the output written once. Two passes (the port's kernels): a
    quantization of a layer's own x (out's and fc2's) reads x and writes x_q
    and s_x; a pair given to the layer (q, k and v share norm1's, fc1 reads
    norm2's: the LayerNorm kernels write them) costs its x_q and s_x written
    once; each GEMM reads x_q, s_x, kernel_q, scale and bias and writes the
    output."""
    work, pairs = [], []  # the pairs' x_q held, so that no id is reused within the step

    def count(module, inputs, out):
        x, (din, dout) = inputs[0], module.kernel_q.shape
        shared = isinstance(x, tuple)
        xq = x[0] if shared else x
        rows, esize = xq.numel() // din, out.element_size()
        quantize = 0
        if not shared:
            quantize = rows * din * esize + rows * din + 4 * rows
        elif not any(xq is seen for seen in pairs):  # a pair's first use
            pairs.append(xq)
            quantize = rows * din + 4 * rows
        work.append((2 * rows * din * dout,
                     rows * din * esize + din * dout + 8 * dout + rows * dout * esize,
                     quantize + rows * din + 4 * rows + din * dout + 8 * dout
                     + rows * dout * esize))

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, Int8Linear)]
    try:
        step()
    finally:
        for hook in hooks:
            hook.remove()
    return (len(work), sum(w[0] for w in work), sum(w[1] for w in work),
            sum(w[2] for w in work))


def _never_syncs(step) -> None:
    # The double-buffered serve loop overlaps host and device only if the
    # step never waits for the device (no pageable copy, no .item()).
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_step(flat: dict) -> float:
    """The bare serve steps on a resident batch, bf16 and int8 + fused LN,
    timed in turns, and the int8 step on its two int8 matmul routes (the
    kernels; the plain chain, `int_mm_route`) in turns, none synchronizing
    with the host; the int8 backbone tokens and heatmaps against the bf16
    model's on the same weights, the two int8 matmul routes' against each
    other, and the bf16 heatmaps against the same weights in f32 (TF32
    off). With random N(0, 0.02) weights the blocks add little to the
    residual stream, so these gaps are small by construction: accuracy
    against the reference is held by the CPU tests.
    -> the bf16 vs f32 heatmap gap."""
    dev = torch.device("cuda")
    state = random_state(MultiViewPoseEstimator(FULL, device="meta"), seed=0)
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3), dtype=np.uint8)
    ).to(dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    view_ids = torch.arange(4, device=dev)[None]
    bf16, int8 = _model(FULL, dev, state), _int8_model(flat, dev)
    with torch.inference_mode():
        steps = {name: (lambda m=m: serve_step(m, frames, mask, 512, (720, 1280)))
                 for name, m in (("bf16", bf16), ("int8_ln", int8))}

        def int8_int_mm_step():
            with int8_matmul.int_mm_route():
                return steps["int8_ln"]()

        steps["int8_ln_int_mm"] = int8_int_mm_step
        turns = [(n, cuda_ms(steps[n], 1, samples=30))
                 for n in ("bf16", "int8_ln", "int8_ln", "bf16")]
        for step in steps.values():
            _never_syncs(step)
        calls, ops, one_bytes, two_bytes = int8_matmul_work(int8, steps["int8_ln"])
        b, b2 = bound(one_bytes, ops, "int8"), bound(two_bytes, ops, "int8")
        print(f"int8_matmul in one int8 + fused-LN serve step: {calls} products, "
              f"{ops / 1e9:.2f} G int8 operations; one-pass bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {one_bytes / 1e6:.2f} MB read and written); two-pass bound (the "
              f"kernels' quantization, then the GEMM) {b2['bound_ms']:.4f} ms "
              f"({b2['bound_by']}: {two_bytes / 1e6:.2f} MB)")
        graph = {name: graph_ms(step, iters=1, samples=30) for name, step in steps.items()}
        mm_routes = [(n, graph_ms(steps[n], iters=1, samples=30))
                     for n in ("int8_ln_int_mm", "int8_ln", "int8_ln", "int8_ln_int_mm")]
        torch.cuda.synchronize()
        imgs = preprocess(frames, 512)[None]
        outs, tokens = {}, {}
        for name, model in (("bf16", bf16), ("int8_ln", int8)):
            torch.cuda.reset_peak_memory_stats()
            outs[name] = model(imgs, view_ids, mask[None])
            print(f"forward peak memory [{name}]: "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            tokens[name] = model.backbone(imgs[0].permute(0, 3, 1, 2))["patch_tokens"]
        with int8_matmul.int_mm_route():
            outs["int8_ln_int_mm"] = int8(imgs, view_ids, mask[None])
            tokens["int8_ln_int_mm"] = int8.backbone(imgs[0].permute(0, 3, 1, 2))["patch_tokens"]
        del bf16, int8
        f32_cfg = dataclasses.replace(FULL, dtype="float32",
                                      vit=dataclasses.replace(FULL.vit, dtype="float32"))
        f32 = _model(f32_cfg, dev, state)
        outs["f32"] = f32(imgs, view_ids, mask[None])
        del f32
    print("serve step (preprocess + model + decode, 4x720x1280 u8 resident), ms/step, "
          "median of 30, in turns: " + ", ".join(f"{n} {t:.3f}" for n, t in turns)
          + "; CUDA-graph replay (device time): "
          + ", ".join(f"{n} {t:.3f}" for n, t in graph.items())
          + "; its int8 matmul routes in turns int_mm/kernel/kernel/int_mm (CUDA-graph replay): "
          + ", ".join(f"{n} {t:.3f}" for n, t in mm_routes)
          + "; no host-device sync inside any step")
    same = all(torch.equal(a, b) for a, b in zip(outs["int8_ln"], outs["int8_ln_int_mm"]))
    check(same and torch.equal(tokens["int8_ln"], tokens["int8_ln_int_mm"]),
          "int8 + fused LN: the int8 matmul kernels and the plain chain (torch._int_mm) give "
          f"other tokens (max abs diff "
          f"{float((tokens['int8_ln'] - tokens['int8_ln_int_mm']).abs().max()):.4g}) or heatmaps")
    print("int8 + fused LN, the int8 matmul kernels vs the plain chain (int_mm_route): patch "
          "tokens, heatmaps and angles identical")
    check(bool(torch.isfinite(outs["int8_ln"][0]).all()), "int8 heatmaps not finite")
    a, b = tokens["int8_ln"], tokens["bf16"]
    check(bool(torch.isfinite(a).all()), "int8 backbone tokens not finite")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    print(f"int8 + fused-LN vs bf16 backbone, same weights: patch-token cosine min "
          f"{float(cos.min()):.6f}, mean {float(cos.mean()):.6f}; max abs diff "
          f"{float((a - b).abs().max()):.6g} (bf16 tokens max abs {float(b.abs().max()):.6g})")
    gaps = {}
    for name, ref in (("bf16 vs f32 (TF32 off)", "f32"), ("int8 + fused LN vs bf16", "bf16")):
        a = "bf16" if ref == "f32" else "int8_ln"
        hm, ang = outs[a]
        hm_ref, ang_ref = outs[ref]
        check(bool(torch.isfinite(hm).all() and torch.isfinite(ang).all()), f"{a} not finite")
        gap = gaps[ref] = float((hm.float() - hm_ref.float()).abs().max())
        agree = float((hm.flatten(3).argmax(-1) == hm_ref.flatten(3).argmax(-1)).float().mean())
        print(f"{name}, same weights: heatmap max abs diff {gap:.6g} ({ref} heatmap max abs "
              f"{float(hm_ref.abs().max()):.6g}), argmax agreement {agree:.4f} of 32 maps, "
              f"angle max abs diff {float((ang - ang_ref).abs().max()):.6g}")
    return gaps["f32"]


# A tick of the int8 + fused-LN serve: 12 blocks, each one fused attention
# with its values' quantization, six products (q, k, v, out, fc1, fc2), two
# int8 LayerNorms (q, k and v share norm1's pair, fc1 reads norm2's) and two
# row quantizations (out's and fc2's inputs); and the final LayerNorm.
INT8_TICK = {"int8_attention": 12, "int8_quantize_v": 12, "int8_matmul": 72,
             "int8_quantize_rows": 24, "layernorm_int8": 12, "residual_layernorm_int8": 12,
             "layernorm": 1}


def check_pose_tick(label: str, launches: dict, per_tick: int) -> None:
    ticks = launches["peak_decode"]
    check(launches["small_svd"] == per_tick * ticks,
          f"{label}: {launches['small_svd']} SVD launches for {ticks} ticks, not {per_tick} each")


def check_int8_tick(label: str, launches: dict, attention_kernel: str) -> None:
    ticks = launches["peak_decode"]
    for name, per_tick in INT8_TICK.items():
        name = attention_kernel if name == "int8_attention" else name
        check(launches[name] == per_tick * ticks,
              f"{label}: {launches[name]} {name} launches for {ticks} ticks, not {per_tick} each")


def phase_serve_int8_f32() -> dict:
    """`serve --params RUN/best_params.npz --int8-backbone --int8-attention`
    through the CLI's parser on a temporary run directory under build/ whose
    model_config.json is FULL_LN_F32's ("vit": {"dtype": "float32",
    "fused_ln": true}; ViT-B/16 at 512 px, seed-0 weights exported with
    `export_jax_params`), at the CLI's other defaults (4 synthetic 720x1280
    cameras): a tick launches the f32 fused int8 attention and its values'
    quantization 12 times each, one peak decode, the int8 matmul kernels
    and LayerNorms as the bf16 int8 serve, and no bf16 int8 attention. Then
    the bare step on a resident batch: its launches, no host-device sync,
    its device time by CUDA-graph replay. -> launches."""
    dev = torch.device("cuda")
    flat = seed0_flat(FULL_LN_F32)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run:
        write_run_dir(run, FULL_LN_F32, 512, flat)
        launches = _serve(["--params", str(Path(run) / "best_params.npz"), "--int8-backbone",
                           "--int8-attention"], "f32 int8 + fused LN", SERVE_KERNELS_F32)
    check_int8_tick("f32 int8 serve", launches, "int8_attention_f32")
    model = _int8_model(flat, dev, FULL_LN_F32)
    del flat
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3), dtype=np.uint8)
    ).to(dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        step = lambda: serve_step(model, frames, mask, 512, (720, 1280))  # noqa: E731
        step()
        _reset_launches()
        xy, conf, ang = step()
        torch.cuda.synchronize()
        got = _read_launches()
        want = {k: 0 for k in KERNELS}
        want.update(INT8_TICK, int8_attention=0, int8_attention_f32=12, peak_decode=1)
        check(got == want and bool(torch.isfinite(conf).all()), f"f32 int8 step launched {got}")
        _never_syncs(step)
        device_ms = graph_ms(step, iters=1, samples=30)
        eager_ms = cuda_ms(step, 1, samples=30)
    print(f"serve step f32 int8 + fused LN (ViT-B/16 at 512 px, backbone f32; preprocess + model "
          f"+ decode, 4x720x1280 u8 resident): CUDA-graph replay (device time) {device_ms:.3f} "
          f"ms; eager {eager_ms:.3f} ms/step (CUDA events, median of 30); a step launches "
          f"{got['int8_attention_f32']} f32 int8 attentions, {got['int8_quantize_v']} values' "
          f"quantizations, {got['peak_decode']} peak decode; no host-device sync")
    return launches


@contextlib.contextmanager
def plain_attention():
    """Within this block every attention takes the plain branch: the flash
    threshold raised in this process, for the comparisons of this script."""
    saved, attention.FLASH_MIN_TOKENS = attention.FLASH_MIN_TOKENS, 2**62
    try:
        yield
    finally:
        attention.FLASH_MIN_TOKENS = saved


def phase_serve_768() -> dict:
    """`serve --model-size 768` through the CLI's parser at its other
    defaults (4 synthetic 720x1280 cameras, ViT-B/16 at T = 2305, seed-0
    random weights, bf16): the forward kernel 12 times per tick (one per
    block), the peak decode once, no other kernel. -> launches."""
    launches = _serve(["--model-size", "768"], "bf16 768 px", ["peak_decode", "flash_fwd"])
    ticks = launches["peak_decode"]
    check(launches["flash_fwd"] == 12 * ticks,
          f"serve 768: {launches['flash_fwd']} forward launches for {ticks} ticks, not 12 each")
    return launches


def phase_serve_768_f32() -> dict:
    """`serve --params RUN/best_params.npz` through the CLI's parser on a
    temporary run directory under build/ whose model_config.json is
    FULL_768_F32's (model_size 768, "vit": {"dtype": "float32", ...}), its
    seed-0 weights exported with `export_jax_params` (~350 MB), at the
    CLI's other defaults (4 synthetic 720x1280 cameras): the split-TF32
    forward 12 times per tick (route "wgmma_tf32"), the peak decode once, no
    other kernel. -> launches."""
    flat = seed0_flat(FULL_768_F32)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run:
        write_run_dir(run, FULL_768_F32, 768, flat)
        del flat
        launches = _serve(["--params", str(Path(run) / "best_params.npz")], "f32 768 px",
                          ["peak_decode", "flash_fwd"])
        by_route = dict(attention.route_launches)
    ticks = launches["peak_decode"]
    check(launches["flash_fwd"] == 12 * ticks and by_route == {("fwd", "wgmma_tf32"): 12 * ticks},
          f"serve f32 768: {by_route} for {ticks} ticks, not 12 split-TF32 forwards each")
    return launches


def phase_step_768(gap_512: float, cfg: EstimatorConfig = FULL_768) -> None:
    """The bare 768-px serve step of `cfg` (the backbone bf16, or f32 in
    FULL_768_F32) on a resident batch: its launches (12 forwards of the
    dtype's route, one peak decode), device time by graph replay (beside the
    same step with the plain attention), the no-host-sync check, and its
    heatmaps against the same weights on the plain path (argmax agreement,
    the gap), beside 512 px's bf16-vs-f32 gap; in f32 the backbone tokens
    within F32_TOL of the plain path's largest token."""
    dev = torch.device("cuda")
    dtype = cfg.vit.compute_dtype
    route = attention.kernel_route(cfg.vit.hidden_size // cfg.vit.num_heads, dtype)
    model = _model(cfg, dev, random_state(MultiViewPoseEstimator(cfg, device="meta"), seed=0))
    frames = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, size=(4, 720, 1280, 3), dtype=np.uint8)
    ).to(dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    view_ids = torch.arange(4, device=dev)[None]
    with torch.inference_mode():
        step = lambda: serve_step(model, frames, mask, 768, (720, 1280))  # noqa: E731
        step()
        _reset_launches()
        step()
        torch.cuda.synchronize()
        got, by_route = _read_launches(), dict(attention.route_launches)
        check(got == {k: {"flash_fwd": 12, "peak_decode": 1}.get(k, 0) for k in KERNELS}
              and by_route == {("fwd", route): 12},
              f"768-px {dtype} step launched {got}, {by_route}")
        _never_syncs(step)
        device_ms = graph_ms(step, iters=1, samples=30)
        eager_ms = cuda_ms(step, 1, samples=30)
        imgs = preprocess(frames, 768)[None]
        torch.cuda.reset_peak_memory_stats()
        hm = model(imgs, view_ids, mask[None])[0]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        tokens = model.backbone(imgs[0].permute(0, 3, 1, 2))["patch_tokens"]
        with plain_attention():
            plain_device_ms = graph_ms(step, iters=1, samples=30)
            torch.cuda.reset_peak_memory_stats()
            hm_plain = model(imgs, view_ids, mask[None])[0]
            plain_peak_gib = torch.cuda.max_memory_allocated() / 2**30
            tokens_plain = model.backbone(imgs[0].permute(0, 3, 1, 2))["patch_tokens"]
    check(bool(torch.isfinite(hm).all()), "768-px heatmaps not finite")
    tok_cos = torch.nn.functional.cosine_similarity(tokens, tokens_plain, dim=-1)
    gap = float((hm.float() - hm_plain.float()).abs().max())
    agree = float((hm.flatten(3).argmax(-1) == hm_plain.flatten(3).argmax(-1)).float().mean())
    check(agree >= 0.9, f"768-px heatmaps: argmax agreement {agree} with the plain path")
    tok_gap = float((tokens - tokens_plain).abs().max())
    # f32: the kernel's O is within F32_TOL of the plain O in each block; the
    # tokens (after the final LayerNorm) are held to the same share.
    tok_tol = F32_TOL * float(tokens_plain.abs().max()) if dtype == torch.float32 else None
    check(tok_tol is None or tok_gap <= tok_tol,
          f"768-px f32 backbone tokens {tok_gap} from the plain path's, above {tok_tol}")
    print(f"serve step 768 px, backbone {dtype} (preprocess + model + decode, 4x720x1280 u8 "
          f"resident): eager {eager_ms:.3f} ms/step (CUDA events, median of 30); CUDA-graph "
          f"replay (device time) {device_ms:.3f} ms with the kernel ({route}), "
          f"{plain_device_ms:.3f} ms with the plain attention; forward peak memory "
          f"{peak_gib:.2f} GiB kernel, {plain_peak_gib:.2f} GiB plain; 12 forward launches + 1 "
          f"peak decode per step; no host-device sync")
    print(f"768 px kernel vs plain attention, same weights (backbone {dtype}): heatmap max abs "
          f"diff {gap:.6g} (heatmap max abs {float(hm_plain.abs().max()):.6g}), argmax agreement "
          f"{agree:.4f} of 32 maps; for scale, 512 px bf16 vs f32 heatmap gap {gap_512:.6g}; "
          f"backbone patch tokens: cosine min {float(tok_cos.min()):.6f}, max abs diff "
          f"{tok_gap:.6g}{'' if tok_tol is None else f' (bound {tok_tol:.6g})'} (plain max abs "
          f"{float(tokens_plain.abs().max()):.6g}); the seed-0 N(0, 0.02) weights keep the "
          f"blocks' share of the residual stream small, so these gaps are small by construction")


def _cosines(a: dict, b: dict) -> dict:
    return {k: float(torch.nn.functional.cosine_similarity(a[k].flatten().float(),
                                                           b[k].flatten().float(), dim=0))
            for k in a}


def _rel_errs(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| per tensor."""
    return {k: float((got[k].float() - want[k].float()).norm()
                     / want[k].float().norm().clamp_min(1e-30)) for k in want}


# The unfrozen 768-px train step (`cli train --no-freeze-backbone --model-size
# 768` on the port): ViT-B/16 at 768 px, fr3, 2 groups x 4 views, 128x128
# heatmaps, bf16, flax_init_state seed 1.
UNFROZEN_768 = dataclasses.replace(FULL_768, freeze_backbone=False)
TRAIN_768_GROUPS, TRAIN_768_STEPS, TRAIN_768_TIMED = 2, 3, 5
# The same step with the backbone in f32 (`"vit": {"dtype": "float32"}`, as
# the reference's scripts/train_synthetic.py:58 makes the ViT off the TPU):
# the split-TF32 forward, dK/dV and dQ, 12 of each a step. 1 group x 4 views
# (cut from 2): the plain attention's comparison step keeps f32 logits and
# probabilities of (4, 12, 2305, 2305), ~1 GB each a layer, for the backward.
UNFROZEN_768_F32 = dataclasses.replace(
    UNFROZEN_768, vit=dataclasses.replace(UNFROZEN_768.vit, dtype="float32"))
TRAIN_768_F32_GROUPS = 1
# f32: each backbone gradient (the key biases aside) within F32_SPREAD
# times the plain path's own spread plus F32_TRAIN_REL (relative, L2) of the
# plain path's. The step is not deterministic: two runs of it on the plain
# path gave gradients 1.0-1.1 % apart where they are sums that cancel to
# ~1e-5 of their terms (the blocks' norm2 weights) on an H100, in bf16 and
# f32 alike, and the kernel path lay 2.2-2.8 times that spread from the
# plain path's; a kernel off by a one-TF32-product error (~5e-3 of the
# largest) moves those sums far beyond it. Where the spread is 0, each
# attention's O and gradients within F32_TOL of the plain versions' allow
# 10 F32_TOL after the 12 blocks. (bf16: the gradients' cosine >= 0.999 alone.)
F32_TRAIN_REL = 10 * F32_TOL
F32_SPREAD = 5.0


def phase_train_768(cfg: EstimatorConfig = UNFROZEN_768, groups: int = TRAIN_768_GROUPS) -> dict:
    """One step from the same state and batch with the kernels and with the
    plain attention: per backbone tensor the gradients' cosine >= 0.999
    (the attention key biases aside: their gradient is 0 in exact arithmetic,
    softmax being invariant to a per-query constant, so both are rounding
    noise), the worst relative error (for an f32 backbone, against the plain
    path's own spread between two runs of that step: at most F32_SPREAD
    times it plus F32_TRAIN_REL), both step times and peak memories. Then
    TRAIN_768_STEPS steps with the kernels: finite losses, the backbone and every head
    module moved, 12 launches of each flash kernel per step on the
    backbone dtype's route, two renders per batch, no host-device sync. ->
    launches of those steps."""
    dev = torch.device("cuda")
    robot = get_robot("fr3")
    rig = rig_tuple(make_rig(n_views=4, image_hw=(768, 768)), dev)
    model = MultiViewPoseEstimator(cfg, device=dev)
    init = flax_init_state(model, seed=1)
    tcfg = TrainConfig(freeze_backbone=False)
    data_gen = torch.Generator(dev).manual_seed(0)
    dtype = cfg.vit.compute_dtype
    route = attention.kernel_route(cfg.vit.hidden_size // cfg.vit.num_heads, dtype)
    label = f"{groups} groups x 4 views, 128x128 heatmaps, backbone {dtype}"

    def make_batch() -> dict:
        return synthesize_multiview_batch(robot, rig, data_gen, groups,
                                          image_hw=(768, 768), heatmap_hw=(128, 128))

    batch = make_batch()
    runs = {}
    for path in ("kernel", "plain"):
        with contextlib.ExitStack() as stack:
            if path == "plain":
                stack.enter_context(plain_attention())
            for _ in range(2):  # a warm-up step, then the compared one
                model.load_state_dict(init)
                state = create_train_state(model, tcfg)
                step = make_multi_view_train_step(state.cfg)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset_launches()
                loss = step(state, batch, torch.Generator(dev).manual_seed(1))["loss"]
            runs[path] = {
                "loss": float(loss), "launches": _read_launches(),
                "by_route": dict(attention.route_launches),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                          if n.startswith("backbone.")},
            }
            times = []  # then TRAIN_768_TIMED more steps on the same batch, timed
            for _ in range(TRAIN_768_TIMED):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                step(state, batch, torch.Generator(dev).manual_seed(1))
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            runs[path]["ms"] = statistics.median(times)
            if path == "plain" and dtype == torch.float32:  # the plain path's own spread
                model.load_state_dict(init)
                state = create_train_state(model, tcfg)
                make_multi_view_train_step(state.cfg)(state, batch,
                                                      torch.Generator(dev).manual_seed(1))
                runs[path]["grads_again"] = {n: p.grad.detach().clone()
                                             for n, p in model.named_parameters()
                                             if n.startswith("backbone.")}
    want = {k: 12 if k in FLASH_KERNELS else 0 for k in KERNELS}
    by_route = {(part, route): 12 for part in FLASH_PARTS}
    check(runs["kernel"]["launches"] == want and runs["kernel"]["by_route"] == by_route,
          f"train 768 {dtype}: {runs['kernel']['launches']}, {runs['kernel']['by_route']}")
    check(runs["plain"]["launches"] == dict.fromkeys(KERNELS, 0),
          f"train 768 {dtype} plain: {runs['plain']['launches']}")
    gk, gp = runs["kernel"]["grads"], runs["plain"]["grads"]
    noise = [k for k in gk if k.endswith("attn.key.bias")]
    cos = _cosines({k: v for k, v in gk.items() if k not in noise}, gp)
    worst_cos = min(cos, key=cos.get)
    rels = _rel_errs({k: v for k, v in gk.items() if k not in noise},
                     {k: v for k, v in gp.items() if k not in noise})
    rel_name = max(rels, key=rels.get)
    rel = rels[rel_name]
    check(cos[worst_cos] >= 0.999, f"train 768: {worst_cos} gradient cosine {cos[worst_cos]}")
    spread_note = ""
    if dtype == torch.float32:
        spread = _rel_errs({k: v for k, v in runs["plain"].pop("grads_again").items()
                            if k not in noise}, {k: v for k, v in gp.items() if k not in noise})
        tols = {k: F32_SPREAD * spread[k] + F32_TRAIN_REL for k in rels}
        worst = max(rels, key=lambda k: rels[k] / tols[k])
        check(rels[worst] <= tols[worst],
              f"train 768 {dtype}: {worst} gradient {rels[worst]} from the plain path's, above "
              f"{tols[worst]} ({F32_SPREAD:g} x the plain path's own spread {spread[worst]} "
              f"+ {F32_TRAIN_REL:g})")
        spread_note = (f"; the plain path's own spread between two runs: at most "
                       f"{max(spread.values()):.4g} ({max(spread, key=spread.get)}), "
                       f"{spread[rel_name]:.4g} on {rel_name}; closest to its bound "
                       f"(F32_SPREAD {F32_SPREAD:g} x spread + {F32_TRAIN_REL:g}): "
                       f"{worst}, "
                       f"{rels[worst]:.4g} against {tols[worst]:.4g}")
    del gk, gp, runs["kernel"]["grads"], runs["plain"]["grads"]
    print(f"train step 768 px unfrozen [ViT-B/16, fr3, {label}; flash route {route}], one step "
          f"from the same state and batch, then "
          f"{TRAIN_768_TIMED} more timed (median, CUDA events): kernel "
          f"{runs['kernel']['ms']:.3f} ms, peak memory {runs['kernel']['peak_gib']:.2f} GiB, loss "
          f"{runs['kernel']['loss']:.6f}; plain attention {runs['plain']['ms']:.3f} ms, "
          f"{runs['plain']['peak_gib']:.2f} GiB, loss {runs['plain']['loss']:.6f}; "
          f"backbone gradients, kernel vs plain: min cosine {cos[worst_cos]:.6f} ({worst_cos}; "
          f"{len(noise)} key biases aside), worst relative error {rel:.4g} ({rel_name})"
          + spread_note)

    model.load_state_dict(init)
    state = create_train_state(model, tcfg)
    step = make_multi_view_train_step(state.cfg)
    dropout_gen = torch.Generator(dev).manual_seed(2)
    _reset_launches()
    losses = [step(state, make_batch(), dropout_gen)["loss"] for _ in range(TRAIN_768_STEPS - 1)]
    made = {}
    _never_syncs(lambda: made.update(batch=make_batch()))
    _never_syncs(lambda: losses.append(step(state, made["batch"], dropout_gen)["loss"]))
    torch.cuda.synchronize()
    launches, by_route = _read_launches(), dict(attention.route_launches)
    want = {k: (TRAIN_768_STEPS * 12 if k in FLASH_KERNELS else
                2 * TRAIN_768_STEPS if k == "heatmap_render" else 0) for k in KERNELS}
    check(launches == want
          and by_route == {(part, route): TRAIN_768_STEPS * 12 for part in FLASH_PARTS},
          f"train 768 {dtype}: {TRAIN_768_STEPS} steps launched {launches}, {by_route}, "
          f"want {want} on route {route}")
    loss = torch.stack(losses).cpu()
    check(bool(torch.isfinite(loss).all()), f"train 768: loss not finite: {loss.tolist()}")
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, init[k].to(v.device))}
    for name in ("backbone", *KPT_MODULES, *ANG_MODULES):
        check(any(k.startswith(name + ".") and "running_" not in k for k in moved),
              f"train 768: no parameter of {name} moved")
    print(f"train 768 px unfrozen [{label}], {TRAIN_768_STEPS} steps with the kernels: losses "
          f"{[round(v, 4) for v in loss.tolist()]}; the backbone and every head module moved; "
          f"launches {launches}; no host-device sync in the batch render or the step")
    return launches


def phase_fusion() -> None:
    """`SelfAttentionFusion` on the card (B = 4, V = 8, N = 513, D = 768, 12
    heads, view 8 masked and filled with large garbage), run three ways:
    bf16 through the kernels (one launch of each), bf16 on the plain path,
    and f32 on the plain path (the yardstick; TF32 off). The output and the
    gradients of the tokens and of every parameter (the key bias aside, as
    in the train phase): the kernel path's relative error against f32 must
    be at most 1.5x the bf16 plain path's. (The key projection's weight
    gradient is a sum with much cancellation, sum_t x_t dk_t with
    sum_t dk_t = 0, so both bf16 paths are far from each other there.) Then
    the reference's mask-invariance check: the 7 real views' outputs equal
    those of the 7 views alone."""
    dev = torch.device("cuda")
    B, V, N, D = 4, 8, 513, 768
    init = flax_init_state(SelfAttentionFusion(D, num_heads=12, device="meta"), seed=3)
    gen = torch.Generator(dev).manual_seed(4)
    toks = torch.randn(B, V, N, D, generator=gen, device=dev)
    toks[:, 7] *= 40.0
    mask = torch.ones(B, V, dtype=torch.bool, device=dev)
    mask[:, 7] = False
    ct = torch.randn(B, V, N, D, generator=gen, device=dev)
    runs, launched = {}, {}
    for path, dtype in (("kernel", torch.bfloat16), ("plain", torch.bfloat16),
                        ("f32", torch.float32)):
        fusion = SelfAttentionFusion(D, num_heads=12, dtype=dtype, device=dev)
        fusion.load_state_dict(init)
        with plain_attention() if path != "kernel" else contextlib.nullcontext():
            t = toks.clone().requires_grad_()
            _reset_launches()
            out = fusion(t, mask)
            (out.float() * ct).sum().backward()
            launched[path] = _read_launches()
        runs[path] = {"out": out.detach().float(), "tokens": t.grad,
                      **{n: p.grad for n, p in fusion.named_parameters() if n != "self_attn.key.bias"}}
        if path == "kernel":
            kernel_fusion = fusion
    check(launched["kernel"] == {k: int(k in FLASH_KERNELS) for k in KERNELS},
          f"fusion: kernel pass launched {launched['kernel']}")
    check(launched["plain"] == dict.fromkeys(KERNELS, 0), "fusion: plain pass launched")
    rel = {path: _rel_errs(runs[path], runs["f32"]) for path in ("kernel", "plain")}
    ratio = {k: rel["kernel"][k] / max(rel["plain"][k], 1e-30) for k in rel["kernel"]}
    worst = max(ratio, key=ratio.get)
    check(all(rel["kernel"][k] <= 1.5 * rel["plain"][k] for k in ratio),
          f"fusion: {worst} is {rel['kernel'][worst]} from f32 through the kernels, "
          f"{rel['plain'][worst]} on the bf16 plain path")
    cos = _cosines({k: v for k, v in runs["kernel"].items()}, runs["plain"])
    low = min(cos, key=cos.get)
    with torch.no_grad():
        out8 = kernel_fusion(toks, mask)[:, :7]
        out7 = kernel_fusion(toks[:, :7].contiguous(), mask[:, :7])
    inv = float((out8.float() - out7.float()).abs().max())
    inv_cos = float(torch.nn.functional.cosine_similarity(out8.flatten().float(),
                                                          out7.flatten().float(), dim=0))
    check(inv <= 0.1 and inv_cos >= 0.9999,
          f"fusion: masked garbage view moved the real views by {inv} (cosine {inv_cos})")
    print(f"SelfAttentionFusion [B {B}, V {V}, N {N}, D {D}, 12 heads, view 8 masked]: relative "
          f"error against f32, kernel / bf16 plain path: output {rel['kernel']['out']:.4g} / "
          f"{rel['plain']['out']:.4g}, token gradient {rel['kernel']['tokens']:.4g} / "
          f"{rel['plain']['tokens']:.4g}, largest ratio {ratio[worst]:.3f} ({worst}: "
          f"{rel['kernel'][worst]:.4g} / {rel['plain'][worst]:.4g}); kernel vs plain cosine min "
          f"{cos[low]:.6f} ({low}); mask invariance: 7 real views with the masked garbage view "
          f"vs alone (T = 4104 vs 3591) max abs diff {inv:.4g}, cosine {inv_cos:.6f}")


def _small_reference(label: str, cfg: EstimatorConfig, scale: float, int8: bool,
                     hm_tol: float, ang_tol: float) -> dict:
    state = random_state(MultiViewPoseEstimator(cfg, device="meta"), seed=2, scale=scale)
    for k in state:
        if k.endswith(("norm1.weight", "norm2.weight", "norm3.weight", "norm.weight")):
            state[k] = state[k] + 1.0  # LayerNorm gains near 1 keep activations O(1)
    frames = np.random.default_rng(3).integers(0, 256, size=(3, 96, 120, 3), dtype=np.uint8)
    mask = np.array([True, False, True])
    outs = {}
    for dev in ("cpu", "cuda"):
        model = _model(cfg, dev, state)
        if int8:
            int8ify(model, attn=True)
        f, m = torch.from_numpy(frames).to(dev), torch.from_numpy(mask).to(dev)
        _reset_launches()
        with torch.inference_mode():
            hm, ang = model(preprocess(f, 64)[None], torch.arange(3, device=dev)[None], m[None])
            xy, _, _ = serve_step(model, f, m, 64, (96, 120))
        outs[dev] = [t.float().cpu().numpy() for t in (hm, ang, xy)]
        launches = _read_launches()  # the card's run, the last
    (hm_c, ang_c, xy_c), (hm_g, ang_g, xy_g) = outs["cpu"], outs["cuda"]
    gap, ang_gap = float(np.abs(hm_g - hm_c).max()), float(np.abs(ang_g - ang_c).max())
    check(gap <= hm_tol and ang_gap <= ang_tol, f"{label}: card vs CPU gap {gap}, {ang_gap}")
    top2 = np.sort(hm_c[0].reshape(3, 8, -1), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 10 * gap
    check(bool(clear.any()), f"{label}: no heatmap with a clear peak to compare")
    check(bool((xy_g[clear] == xy_c[clear]).all()), f"{label}: keypoints differ, card vs CPU")
    print(f"small {label} model card vs CPU (f32, TF32 off): heatmap max abs diff {gap:.3g} "
          f"(bound {hm_tol:g}), angle max abs diff {ang_gap:.3g} (bound {ang_tol:g}), "
          f"keypoints equal on {int(clear.sum())}/24 clear maps; kernel launches on the card "
          f"{launches}")
    return launches


def phase_small_reference() -> dict:
    """Small models on the card against the same models on the CPU, in f32.
    Float: heatmaps and angles 1e-3 (f32 convolution and matmul algorithms
    differ). int8 + fused LN (hidden 128, MLP 512, M = 51 rows): heatmaps
    1e-4 and angles 1e-2, about 10x and 3x what a value on an int8 rounding
    boundary rounding the other way can move them (on the CPU alone, a 1e-4
    relative input perturbation moved this model's heatmaps by 9e-6 and its
    angles by 3.5e-3). Keypoints equal wherever the top-2 heatmap margin is
    10x the gap. The f32 int8 model's attention takes the "fused_f32"
    route: the f32 fused kernel in each block, never the bf16 one; its int8
    matmuls take the kernels of `csrc/int8_gemm.cu`, its LayerNorms the int8
    output. -> the int8 model's launches."""
    vit = ViTConfig(image_size=64, patch_size=16, hidden_size=128, num_layers=2, num_heads=2,
                    dtype="float32")
    cfg = EstimatorConfig(vit=vit, num_joints=8, num_angles=7, heatmap_size=(32, 32),
                          max_views=4, dtype="float32")
    _small_reference("float", cfg, 0.2, False, 1e-3, 1e-3)
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(vit, fused_ln=True))
    launches = _small_reference("int8 + fused-LN", cfg, 0.1, True, 1e-4, 1e-2)
    check(launches["int8_attention_f32"] > 0 and launches["int8_attention"] == 0
          and launches["int8_matmul"] > 0 and launches["int8_quantize_rows"] > 0
          and launches["layernorm_int8"] > 0 and launches["residual_layernorm_int8"] > 0,
          f"the f32 int8 model launched {launches}")
    return launches


# The pose step's SVD shape groups on a serve tick at 4 views x 16
# hypotheses (64 matrices each): fr3's (N = 8) DLT, plane fit and
# homography, the rotation projection, and fr5's (N = 7); then the
# kernel's largest shape.
SVD_GROUPS = [("dlt", 16, 12), ("plane", 8, 3), ("homography", 16, 9), ("rotation", 3, 3),
              ("dlt_fr5", 14, 12), ("plane_fr5", 7, 3), ("homography_fr5", 14, 9),
              ("largest", 32, 16)]
SVD_TOL = {"sigma": 2e-5, "null_vector": 1e-4, "gram": 4e-5, "rotation": 1e-5,
           "orthogonality": 1e-5}  # the last as tests/test_torch_pnp.py::assert_svd_close


def _svd_operands(m: int, n: int, seed: int, batch: int = 64) -> torch.Tensor:
    """Random f32 matrices with rank-deficient ones (a column spanned by the
    others, two for n > 2), zero rows (gated points) and an all-zero one."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, m, n)).astype(np.float32)
    if n > 1:
        a[1, :, -1] = a[1, :, :-1] @ rng.normal(size=n - 1)
    if n > 2:
        a[2, :, -2:] = a[2, :, :-2] @ rng.normal(size=(n - 2, 2))
    a[3, : m // 2] = 0.0
    a[4] = 0.0
    return torch.from_numpy(a).cuda()


def svd_errors(a: torch.Tensor, got: tuple, want) -> dict:
    """The kernel's (U, S, Vh) against torch.linalg.svd's through sign-free
    quantities, in f64: singular values over the largest; 1 - |<v, v'>| of
    the last right singular vector where its singular value is simple (no
    entry where none is); |(A Vh^T)^T (A Vh^T) - diag(S^2)| over S_0^2;
    |Vh Vh^T - I|; for 3 x 3 input the projected rotation U D Vh where it
    is unique (rank >= 2)."""
    U, S, Vh = (None if x is None else x.double().cpu() for x in got)
    A, wS, wVh = a.double().cpu(), want.S.double().cpu(), want.Vh.double().cpu()
    scale = wS[:, :1].clamp(min=1e-30)
    av = A @ Vh.transpose(1, 2)
    gram = av.transpose(1, 2) @ av - torch.diag_embed(
        torch.nn.functional.pad(S ** 2, (0, Vh.shape[-1] - S.shape[-1])))
    errs = {"sigma": float(((S - wS) / scale).abs().max()),
            "gram": float((gram / scale[..., None] ** 2).abs().max()),
            "orthogonality": float((Vh @ Vh.transpose(1, 2)
                                    - torch.eye(Vh.shape[-1], dtype=Vh.dtype)).abs().max())}
    simple = wS[:, -1] < wS[:, -2] - 1e-3 * scale[:, 0]
    if A.shape[-2] >= A.shape[-1] and simple.any():
        dots = (Vh[:, -1] * wVh[:, -1]).sum(-1).abs()
        errs["null_vector"] = float((1 - dots[simple]).max())
    if U is not None:
        def rot(u, vh):
            det = torch.linalg.det(u @ vh)
            return u @ (torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)[..., None]
                        * vh)
        unique = wS[:, 1] > 1e-6 * scale[:, 0]
        errs["rotation"] = float((rot(U, Vh) - rot(want.U.double().cpu(), wVh))[unique].abs().max())
    return errs


def fr3_ransac_dlt(device: str = "cuda") -> torch.Tensor:
    """The (64, 16, 12) DLT systems that one RANSAC builds on the clean fr3
    rig at 4 views x 16 hypotheses (`pose_rig(4, 64)`, `phase_pose`'s draws),
    taken from the pose step's first `small_svd` call: the input the serve
    tick's DLT SVD sees, most of it with a null space of dimension > 1
    (FR3's coincident keypoints)."""
    _, pred, bases, Ks, xy = pose_rig(4, 64, device)
    draws = PoseDraws.draw((), 4, 8, 7, False, torch.Generator().manual_seed(9))
    d = PoseDraws(*(None if x is None else x.to(device) for x in dataclasses.astuple(draws)))
    systems, real = [], pnp.small_svd

    def record(a, compute_u=False):
        systems.append(a.clone())
        return real(a, compute_u)

    pnp.small_svd = record
    try:
        clean_pose(xy, pred, bases, Ks, d, refine=False)
    finally:
        pnp.small_svd = real
    return systems[0].reshape(-1, 16, 12)


# The geometric3d head's DLT, (B J, 2V, 4): a serve tick (fr3, J = 8, 4
# views, B = 1), a trainer batch (fr5, J = 7, 3 views, B = 16) and `cli
# eval`'s FR3 batches on 8 view slots (J = 8, B = 8: (16, 4) systems, the
# kernel's <N = 4, W = 16>).
TRI_GROUPS = [("tri_serve", "fr3", 1, 4), ("tri_trainer", "fr5", 16, 3),
              ("tri_eval_8v", "fr3", 8, 8)]
TRI_TOL = 1e-3  # m, the triangulated points where 2 or more views weigh


def triangulation_systems(robot_name: str, B: int, V: int, seed: int) -> tuple:
    """The DLT systems `triangulate_keypoints` builds for B samples of the
    robot seen by a ring of V cameras (720 x 1280, in 128 x 128 heatmap
    pixels, 0.1 px of noise), weights in [0.3, 1] except: keypoint 0 seen by
    no view, 1 by view 0 alone, 2 by views 0 and 1 -> (A (B J, 2V, 4) on the
    card, observing views (B J,))."""
    robot = get_robot(robot_name)
    rng = np.random.default_rng(seed)
    K, rv, tv = rig_tuple(make_rig(n_views=V, image_hw=(720, 1280)))
    P = heatmap_projection_matrices(rv, tv, K, (720, 1280), (128, 128))  # (V, 3, 4)
    scale = 60.0 if robot.angle_unit == "deg" else 1.0
    angles = torch.from_numpy((rng.uniform(-0.5, 0.5, (B, robot.n_joints)) * scale)
                              .astype(np.float32))
    pts = robot.keypoints_from_fk(forward_kinematics(robot, angles))  # (B, J, 3)
    uvw = torch.einsum("vij,bkj->bkvi", P, torch.cat([pts, torch.ones_like(pts[..., :1])], -1))
    xy = uvw[..., :2] / uvw[..., 2:] + torch.from_numpy(
        rng.normal(scale=0.1, size=(*uvw.shape[:-1], 2)).astype(np.float32))  # (B, J, V, 2)
    w = torch.from_numpy(rng.uniform(0.3, 1.0, size=xy.shape[:-1]).astype(np.float32))
    w[:, 0] = 0.0
    w[:, 1, 1:] = 0.0
    w[:, 2, 2:] = 0.0
    A = dlt_system(xy, P, w)
    return A.reshape(-1, 2 * V, 4).cuda(), (w > 0).sum(-1).flatten().numpy()


def _points(Vh: torch.Tensor) -> torch.Tensor:
    X = Vh[..., -1, :].double().cpu()
    return X[..., :3] / (X[..., 3:] + 1e-12)


def sass_sizes(lib: Path, name: str = "small_svd_kernel") -> dict:
    """Instructions (16 bytes each) of each instantiation of the kernel
    template `name` in `lib`, keyed by its template arguments ("12,16"), from
    `cuobjdump -sass` (the toolkit's, beside nvcc)."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    sizes = {}
    for part in out.split("Function : ")[1:]:
        found = re.search(name + r"I((?:Li\d+E)+)E", part.split("\n", 1)[0])
        if found:
            sizes[",".join(re.findall(r"Li(\d+)E", found[1]))] = len(
                re.findall(r"/\*[0-9a-f]{4,}\*/", part))
    return sizes


# The SVD kernel's instantiations on the serve tick: (n, lanes a matrix).
SVD_TICK_KERNELS = ("12,16", "9,16", "3,8", "3,4")


def phase_small_svd() -> dict:
    """The SVD kernel against torch.linalg.svd on the card at each of the
    pose step's shape groups (and the largest it takes) and on the DLT
    systems of a real fr3 RANSAC, two calls bit-identical, a shape it does
    not take refused; then each group timed: the kernel as graph replays,
    both as eager calls (torch.linalg.svd waits for the device, so no graph
    holds it), beside its bound; and the kernels' SASS size."""
    results, max_err = {}, 0.0
    groups = [(name, _svd_operands(m, n, seed=100 + i))
              for i, (name, m, n) in enumerate(SVD_GROUPS)]
    for name, a in [*groups, ("fr3_ransac", fr3_ransac_dlt())]:
        _, m, n = a.shape
        three = (m, n) == (3, 3)
        got = small_svd.small_svd_cuda(a, compute_u=three)
        again = small_svd.small_svd_cuda(a, compute_u=three)
        torch.cuda.synchronize()
        check(all(x is None or torch.equal(x, y) for x, y in zip(got, again)),
              f"small_svd {name}: two calls differ")
        errs = svd_errors(a, got, torch.linalg.svd(a, full_matrices=True))
        check(all(v <= SVD_TOL[k] for k, v in errs.items()), f"small_svd {name}: {errs}")
        max_err = max(max_err, errs["sigma"])
        kernel = functools.partial(small_svd.small_svd_cuda, a, three)
        plain = functools.partial(torch.linalg.svd, a, full_matrices=True)
        eager = [cuda_ms(f, 20, 20) for f in (plain, kernel, kernel, plain)]
        replay = graph_ms(kernel, 20, 20)
        k = min(m, n)
        # Bytes: A read, S, Vh (and U) written once. Operations: Golub and Van
        # Loan's count for S and V of an m x n matrix, 4 m n^2 + 8 n^3, in f32.
        b = bound(4 * 64 * (m * n + k + n * n + (9 if three else 0)), 64 * (4 * m * n * n + 8 * n ** 3),
                  "f32")
        results[name] = {"shape": [64, m, n], "ms": replay,
                         "eager_ms": statistics.median(eager[1:3]),
                         "plain_ms": statistics.median(eager[0::3]), **b, "errors": errs}
        print(f"small_svd [{name} (64, {m}, {n})] vs torch.linalg.svd: {errs}; eager in turns "
              f"plain/kernel/kernel/plain " + "/".join(f"{1e3 * t:.2f}" for t in eager)
              + f" us; kernel graph replay {1e3 * replay:.2f} us; bound "
              f"{1e3 * b['bound_ms']:.4f} us ({b['bound_by']})")
    for i, (name, robot_name, B, V) in enumerate(TRI_GROUPS):
        a, obs = triangulation_systems(robot_name, B, V, seed=120 + i)
        _, m, n = a.shape
        got = small_svd.small_svd_cuda(a)
        again = small_svd.small_svd_cuda(a)
        torch.cuda.synchronize()
        check(all(x is None or torch.equal(x, y) for x, y in zip(got, again)),
              f"small_svd {name}: two calls differ")
        want = torch.linalg.svd(a, full_matrices=True)
        errs = svd_errors(a, got, want)
        seen = torch.from_numpy(obs >= 2)
        errs["points_m"] = float((_points(got[2]) - _points(want.Vh))[seen].abs().max())
        check(all(v <= (TRI_TOL if k == "points_m" else SVD_TOL[k]) for k, v in errs.items()),
              f"small_svd {name}: {errs}")
        max_err = max(max_err, errs["sigma"])
        kernel = functools.partial(small_svd.small_svd_cuda, a)
        plain = functools.partial(torch.linalg.svd, a, full_matrices=True)
        eager = [cuda_ms(f, 20, 20) for f in (plain, kernel, kernel, plain)]
        replay = graph_ms(kernel, 20, 20)
        batch = a.shape[0]
        b = bound(4 * batch * (m * n + n + n * n), batch * (4 * m * n * n + 8 * n ** 3), "f32")
        results[name] = {"shape": [batch, m, n], "ms": replay,
                         "eager_ms": statistics.median(eager[1:3]),
                         "plain_ms": statistics.median(eager[0::3]), **b, "errors": errs,
                         "observing_views": {str(k): int((obs == k).sum())
                                             for k in sorted(set(obs.tolist()))}}
        print(f"small_svd [{name} ({batch}, {m}, {n}): the geometric3d DLT, "
              f"{results[name]['observing_views']} systems by observing views] vs "
              f"torch.linalg.svd: {errs}; eager in turns plain/kernel/kernel/plain "
              + "/".join(f"{1e3 * t:.2f}" for t in eager)
              + f" us; kernel graph replay {1e3 * replay:.2f} us; bound "
              f"{1e3 * b['bound_ms']:.4f} us ({b['bound_by']})")
    for shape in ((4, 33, 4), (4, 5, 17)):
        try:
            small_svd.small_svd_cuda(torch.zeros(shape, device="cuda"))
            refused = False
        except ValueError:
            refused = True
        check(refused, f"small_svd took the shape {shape}")
    sass = sass_sizes(_build.library_path())
    check(all(k in sass for k in SVD_TICK_KERNELS), f"small_svd SASS: kernels {sorted(sass)}")
    print("small_svd SASS instructions of the tick's kernels (n, lanes a matrix): "
          + ", ".join(f"({k}) {sass[k]}" for k in SVD_TICK_KERNELS)
          + f"; all {len(sass)} kernels {sum(sass.values())} ({16 * sum(sass.values())} bytes)")
    dlt = results["dlt"]
    # torch.linalg.svd is both the plain version and the one PyTorch call.
    return {"small_svd": {"max_abs_err": max_err, "ms": dlt["ms"], "plain_ms": dlt["plain_ms"],
                          "bound_ms": dlt["bound_ms"], "bound_by": dlt["bound_by"],
                          "library_ms": dlt["plain_ms"], "shape": dlt["shape"],
                          "groups": results, "sass_instructions": {
                              **{k: sass[k] for k in SVD_TICK_KERNELS}, "all": sum(sass.values())}}}


POSE_K = [[737.0, 0.0, 640.0], [0.0, 737.0, 360.0], [0.0, 0.0, 1.0]]  # serve's nominal K


def pose_rig(views: int, seed: int, device) -> tuple:
    """A clean fr3 rig on `device` at the serve shapes: (V, 8, 128, 128)
    logit heatmaps peaked on the keypoints' pixels in a 720x1280 frame (the
    cameras ~3.5 m away, every keypoint in the frame), the true angles off
    by ~0.05 rad as the prediction, identity bases, the nominal K, and the
    keypoints' exact pixels (V, 8, 2)."""
    robot = get_robot("fr3")
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-1, 1, 7).astype(np.float32)
    pred = torch.from_numpy(angles + rng.normal(scale=0.05, size=7).astype(np.float32))
    obj = robot.keypoints_from_fk(forward_kinematics(robot, torch.from_numpy(angles)))
    K = torch.tensor(POSE_K)
    xys = []
    while len(xys) < views:
        rvec = torch.from_numpy(rng.normal(size=3).astype(np.float32))
        shift = torch.tensor([*rng.uniform(-0.15, 0.15, 2), 3.5], dtype=torch.float32)
        xy = project_points(obj, rvec, shift - rodrigues_to_matrix(rvec) @ obj.mean(0), K)
        if (xy > 20).all() and (xy[:, 0] < 1260).all() and (xy[:, 1] < 700).all():
            xys.append(xy)
    xy = torch.stack(xys)
    cols, rows = torch.arange(128.0), torch.arange(128.0)
    d2 = ((cols - xy[..., 0, None, None] * 0.1) ** 2
          + (rows[:, None] - xy[..., 1, None, None] * 128 / 720) ** 2)
    heat = 10.0 * torch.exp(-d2 / 4.5) - 5.0
    eye = torch.eye(3).expand(views, 3, 3)
    return tuple(t.contiguous().to(device) for t in (heat, pred, eye, K.expand(views, 3, 3), xy))


def clean_pose(xy, pred, bases, Ks, draws: PoseDraws, refine: bool) -> dict:
    """The pose step from the exact keypoints (no decode): solve_rig_pnp,
    then with refine the joint refinement, as recover_pose_batch runs them."""
    robot, conf = get_robot("fr3"), torch.full(xy.shape[:-1], 0.9, device=xy.device)
    out = solve_rig_pnp(xy, conf, pred, bases, Ks, robot, gumbel=draws.gumbel)
    if refine:
        out.update(refine_rig_pose_angles(xy, conf, pred, out["rvec"], out["tvec"], bases, Ks,
                                          robot, starts=draws.starts, regumbel=draws.regumbel))
    return out


def device_kernels(fn) -> tuple:
    """One call of fn under torch.profiler, fn already warm -> (what the
    device runs: kernels, copies, fills; the aten operator calls the host
    makes for them)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return (sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
            sum(1 for e in events if e.name.startswith("aten::")))


def phase_pose() -> dict:
    """The pose step (`recover_pose_batch`: peak decode, FK, RANSAC PnP with
    16 hypotheses a view, and with refine the joint refinement) on a clean
    fr3 rig at the serve shapes, V = 1 and 4, refine off and on, with one
    set of draws: on the card against the CPU route, equal success masks
    from the heatmaps, and from the exact keypoints rotations within 1e-3
    rad and translations within 1e-3 of |t| (from the heatmaps the argmax's
    quantization, up to 5 px, leaves FR3's RANSAC to pick among near-equal
    hypotheses, some of them DLT candidates from a null space of dimension
    > 1: FR3's coincident keypoints); 5 SVD launches a call without refine
    and 10 with it, never synchronizing with the host; timed as CUDA-graph
    replays (device time) and as eager calls (CUDA events, host-bound), its
    device work and the host's aten calls counted by the profiler."""
    robot = get_robot("fr3")
    out = {}
    for views in (1, 4):
        for refine in (False, True):
            label = f"V={views}, refine {'on' if refine else 'off'}"
            draws = PoseDraws.draw((), views, 8, 7, refine, torch.Generator().manual_seed(9))
            results = {}
            for dev in ("cpu", "cuda"):
                *args, xy = pose_rig(views, 60 + views, dev)
                d = PoseDraws(*(None if x is None else x.to(dev)
                                for x in dataclasses.astuple(draws)))
                step = functools.partial(recover_pose_batch, *args, robot, (720, 1280),
                                         draws=d, refine=refine)
                before = small_svd.launches
                results[dev] = {k: v.cpu() for k, v in step().items()}
                results[dev + "_clean"] = {k: v.cpu() for k, v in
                                           clean_pose(xy, *args[1:], d, refine).items()}
                if dev == "cuda":
                    torch.cuda.synchronize()
                    svds = small_svd.launches - before
                    check(svds == 2 * (10 if refine else 5), f"pose {label}: {svds} SVD launches")
                    _never_syncs(step)
                    cuda_step = step
            check(torch.equal(results["cpu"]["success"], results["cuda"]["success"])
                  and bool(results["cpu"]["success"].all()),
                  f"pose {label}: success {results['cuda']['success']} on the card, "
                  f"{results['cpu']['success']} on the CPU")
            cpu, card = results["cpu_clean"], results["cuda_clean"]
            check(torch.equal(cpu["success"], card["success"]),
                  f"pose {label}: exact keypoints' success differs, card vs CPU")
            R_gap = (rodrigues_to_matrix(card["rvec"].double())
                     * rodrigues_to_matrix(cpu["rvec"].double())).sum((-2, -1))
            rot = float(torch.arccos(((R_gap - 1) / 2).clamp(-1, 1)).max())
            trans = float(((card["tvec"] - cpu["tvec"]).norm(dim=-1)
                           / cpu["tvec"].norm(dim=-1)).max())
            check(rot <= 1e-3 and trans <= 1e-3, f"pose {label}: card vs CPU {rot} rad, {trans}")
            # With refine a call takes seconds of host time: fewer samples.
            replay = graph_ms(cuda_step, iters=1, samples=5 if refine else 20)
            eager = cuda_ms(cuda_step, 1, 3 if refine else 10, warm=0)  # already warm
            kernels, aten = device_kernels(cuda_step)
            out[label] = {"graph_ms": replay, "eager_ms": eager, "device_kernels": kernels,
                          "aten_calls": aten}
            print(f"pose step [{label}]: card vs CPU from the exact keypoints rotation {rot:.3g} "
                  f"rad, translation {trans:.3g} of |t|, success equal (also from the heatmaps); "
                  f"never synchronizes; CUDA-graph replay "
                  f"(device time) {replay:.3f} ms, eager {eager:.3f} ms (CUDA events), "
                  f"{kernels} device kernels a call ({10 if refine else 5} SVD launches) for "
                  f"{aten} host aten calls")
    return out


# The reference's FR3 training shape (bench_train.py:178-191): frozen ViT-B/16
# at 512 px (= FULL), 18 groups x 4 views, fr3 (J = 8, A = 7), 128x128 heatmaps.
TRAIN_GROUPS = 18
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 3, 10, 3
# The trainer run: scripts/torch_train_synthetic.py --mode multi at its
# defaults (fr5, 3 views, 128 px, batch 64, lr 1e-3), for TRAINER_STEPS steps.
TRAINER_STEPS = 300
TRAINER_EVAL_BATCHES = 4  # the script's default --eval-batches
TRAINER_LOSS_DROP = 0.7  # the last logged loss must be below this share of the first


def phase_train_step(device: dict) -> int:
    """The full-width multi-view train step on the card, its batches made by
    the port's `synthesize_multiview_batch` (image 512, heatmaps 128): a few
    warm steps, one step and one batch under the no-sync check, timed steps
    (CUDA events), a profiled window. Checks: finite losses, the backbone
    bit-identical, every head module and BatchNorm running statistic moved,
    two render launches per batch and no other kernel. -> render launches."""
    dev = torch.device("cuda")
    robot = get_robot("fr3")
    rig = rig_tuple(make_rig(n_views=4, image_hw=(512, 512)), dev)
    model = MultiViewPoseEstimator(FULL, device=dev)
    model.load_state_dict(flax_init_state(model, seed=1))
    state = create_train_state(model, TrainConfig())
    step = make_multi_view_train_step(state.cfg)
    data_gen = torch.Generator(dev).manual_seed(0)
    dropout_gen = torch.Generator(dev).manual_seed(1)
    batches = [0]

    def make_batch() -> dict:
        batches[0] += 1
        return synthesize_multiview_batch(robot, rig, data_gen, TRAIN_GROUPS,
                                          image_hw=(512, 512), heatmap_hw=(128, 128))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    _reset_launches()
    losses = [step(state, make_batch(), dropout_gen)["loss"] for _ in range(TRAIN_WARM)]
    made = {}
    _never_syncs(lambda: made.update(batch=make_batch()))
    _never_syncs(lambda: losses.append(step(state, made["batch"], dropout_gen)["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(TRAIN_TIMED)]
    t0 = time.perf_counter()
    for e in events:
        e[0].record()
        batch = make_batch()
        e[1].record()
        losses.append(step(state, batch, dropout_gen)["loss"])
        e[2].record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    render_ms = statistics.median(e[0].elapsed_time(e[1]) for e in events)
    step_ms = statistics.median(e[1].elapsed_time(e[2]) for e in events)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAIN_PROFILED):
            losses.append(step(state, make_batch(), dropout_gen)["loss"])
        torch.cuda.synchronize()
    launches = _read_launches()
    check(launches == {k: 2 * batches[0] if k == "heatmap_render" else 0 for k in KERNELS},
          f"train step: {batches[0]} batches launched {launches}, not 2 renders each")
    loss = torch.stack(losses).cpu()
    check(bool(torch.isfinite(loss).all()), f"train step: loss not finite: {loss.tolist()}")
    after = model.state_dict()
    moved = {k for k, v in after.items() if not torch.equal(v, before[k])}
    check(not any(k.startswith("backbone.") for k in moved), "train step: the frozen backbone moved")
    for name in KPT_MODULES + ANG_MODULES:
        check(any(k.startswith(name + ".") and "running_" not in k for k in moved),
              f"train step: no parameter of {name} moved")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    check(stats and all(k in moved for k in stats), "train step: a BatchNorm statistic did not move")
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / TRAIN_PROFILED
    print(f"train step [{device['nvidia_smi']}; frozen ViT-B/16 at 512 px, fr3, "
          f"{TRAIN_GROUPS} groups x 4 views, 128x128 heatmaps, bf16]: train step "
          f"{step_ms:.3f} ms (CUDA events, median of {TRAIN_TIMED}) = "
          f"{1e3 * TRAIN_GROUPS / step_ms:.2f} groups/s; batch render {render_ms:.3f} ms; "
          f"host wall {wall_ms:.3f} ms per batch + step; peak memory {peak_gib:.2f} GiB; device "
          f"busy {busy_ms:.3f} ms per batch + step over {len(device_events) / TRAIN_PROFILED:.0f} "
          f"device events (profiler), busy share {min(1.0, busy_ms / wall_ms):.3f}; no host-device "
          f"sync in the batch render or the step; losses {[round(v, 4) for v in loss.tolist()]}; "
          f"backbone bit-identical, {len(moved)} head tensors and all {len(stats)} BatchNorm "
          f"statistics moved; render launches {launches['heatmap_render']} for {batches[0]} batches")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
    return launches["heatmap_render"]


def trainer_evals(steps: int, every: int = 100) -> int:
    """The trainer's evaluations over the eval batches: at step 1, every
    `every` steps (its default --eval-every) and once at the end."""
    return len({1, *range(every, steps + 1, every)}) + 1


def phase_trainer() -> int:
    """`scripts/torch_train_synthetic.py --mode multi` at its defaults for
    TRAINER_STEPS steps: finite losses, the last logged loss below
    TRAINER_LOSS_DROP of the first, two render launches per batch made
    (the eval batches and one per step), and the SVD kernel's launches: the
    final pose evaluation's 5 per eval batch, with the predicted and with
    the true angles, and one per eval batch at each evaluation (the
    triangulated ADD). -> render launches."""
    trainer = _script("torch_train_synthetic")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        _reset_launches()
        final = trainer.main(["--mode", "multi", "--steps", str(TRAINER_STEPS), "--workdir", work])
        launches = _read_launches()
        log = [json.loads(line) for line in
               (Path(work) / "logs" / "metrics.jsonl").read_text().splitlines()]
    # The SVD kernel: the final pose evaluations' 5 a batch, with the
    # predicted and with the true angles, and each evaluation's triangulated
    # ADD, one a batch.
    want = {"heatmap_render": 2 * (TRAINER_STEPS + TRAINER_EVAL_BATCHES),
            "small_svd": (2 * 5 + trainer_evals(TRAINER_STEPS)) * TRAINER_EVAL_BATCHES}
    check(launches == {k: want.get(k, 0) for k in KERNELS},
          f"trainer: launched {launches}, want {want}")
    curve = [(int(r["step"]), r["loss"], r["pck5"]) for r in log]
    print(f"trainer ({TRAINER_STEPS} steps at its defaults): (step, loss, pck5) {curve}; "
          f"final pck5 {final['pck5']}, angle_mae {final['angle_mae']}, "
          f"{final['train_samples_per_sec']} samples/s; render launches "
          f"{launches['heatmap_render']}; pose success rate {final['pose_success_rate']}, "
          f"rotation error {final['pose_rot_err_deg']} deg ({final['pose_rot_err_deg_gt_angles']} "
          "with the true angles)")
    check(all(np.isfinite(r["loss"]) for r in log), "trainer: a logged loss is not finite")
    check(log[-1]["loss"] < TRAINER_LOSS_DROP * log[0]["loss"],
          f"trainer: loss {log[0]['loss']} -> {log[-1]['loss']}, not below "
          f"{TRAINER_LOSS_DROP} of the first")
    return launches["heatmap_render"]


# The calibrated rig of the new serve runs: 4 720p cameras with ZED-like
# intrinsics and distortion, named by fr3's views (each its base rotation).
CAL_KEYS = ("view1_leftcam", "view2_leftcam", "view3_leftcam", "view4_leftcam")
# label, kind, config, SVD launches a tick (the PnP's 5; geometric3d's DLT 1 more)
CALIBRATED_RUNS = [("single-view geometric, calibrated", "single_view", FULL_SV_GEO, 5),
                   ("multi-view geometric3d, calibrated", "multi_view", FULL_MV_GEO3D, 6)]


def write_rig(root: Path) -> tuple:
    """`cli calibrate intrinsics` files for CAL_KEYS (K around fx = fy = 528,
    the centre near (640, 360), k1 -0.05..-0.035, k2 0.02, p1 1e-3, p2 -1e-3)
    and an ArUco summary of a 4-camera ring 3 m from the robot, views 1 and 3
    in radians (fr3's unit, untagged), 2 and 4 in degrees with their unit
    tag -> (calib dir, summary path)."""
    _, rvecs, tvecs = rig_tuple(make_rig(n_views=4, image_hw=(720, 1280), distance_m=3.0))
    calib = root / "calib"
    calib.mkdir(parents=True)
    records = []
    for i, key in enumerate(CAL_KEYS):
        view, cam = key.split("_")
        f = 528.0 + 2 * i
        (calib / f"{view}_3000{i}_{cam}_calib.json").write_text(json.dumps({
            "camera_matrix": [[f, 0.0, 640.0 + i], [0.0, f, 360.0 - i], [0.0, 0.0, 1.0]],
            "distortion_coeffs": [-0.05 + 0.005 * i, 0.02, 1e-3, -1e-3, 0.0]}))
        rv = rvecs[i].double().numpy()
        rec = {"view": view, "cam": cam,
               **dict(zip(("tvec_x", "tvec_y", "tvec_z"), map(float, tvecs[i])))}
        if i % 2:
            rec.update(zip(("rvec_x", "rvec_y", "rvec_z"), map(float, np.degrees(rv))),
                       rvec_unit="deg")
        else:
            rec.update(zip(("rvec_x", "rvec_y", "rvec_z"), map(float, rv)))
        records.append(rec)
    summary = root / "aruco_pose_summary.json"
    summary.write_text(json.dumps(records, indent=2))
    return calib, summary


def _calibrated_model(kind: str, cfg: EstimatorConfig, flat: dict, device, f32: bool):
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  vit=dataclasses.replace(cfg.vit, dtype="float32"))
    model = KINDS[kind](cfg, device=device).eval()
    load_jax_params(model, flat)
    return model


def calibrated_step(label: str, kind: str, cfg: EstimatorConfig, flat: dict, calib_dir: Path,
                    summary: Path, device: dict) -> None:
    """The calibrated serve step alone (the device remap, preprocess, the
    model, the pose step with the cameras' K, base rotations and fallback
    poses) on 4 resident 720 x 1280 frames: its launches, no host sync, its
    device time by CUDA-graph replay with and without the remap (the
    difference is the remap's cost) and the remap's alone; and against the
    CPU route on the same weights and frames: the undistorted frames at most
    one level apart, the heatmaps (the card in bf16, the CPU in f32) within
    twice the card's own bf16-vs-f32 gap (the yardstick `phase_step`
    prints), the angle head on the same heatmaps within 1e-3, and the whole
    step's angles within 1e-2 where every decoded peak agrees."""
    hw, keys, single = (720, 1280), ",".join(CAL_KEYS), kind == "single_view"
    calib = read_calibration(calib_dir, keys, 4)
    read_fallback_poses(calib, summary, keys, get_robot("fr3"))
    frames = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, size=(4, *hw, 3), dtype=np.uint8))
    out = {}
    for name, where, f32 in (("card", "cuda", False), ("card_f32", "cuda", True),
                             ("cpu_f32", "cpu", True)):
        model = _calibrated_model(kind, cfg, flat, where, f32)
        remap = calib.remap(hw, where)
        proj = None if single else heatmap_projection_matrices(
            *(torch.from_numpy(a).to(where) for a in (calib.fb_rvec, calib.fb_tvec, calib.Ks)),
            hw, cfg.heatmap_size)[None]
        f, m = frames.to(where), torch.ones(4, dtype=torch.bool, device=where)
        with torch.inference_mode():
            und = remap(f)
            imgs = preprocess(und, 512)
            hm, ang = (model(imgs) if single else
                       model(imgs[None], torch.arange(4, device=where)[None], m[None],
                             proj_mats=proj))
            out[name] = {"und": und.cpu(), "hm": hm.reshape(4, cfg.num_joints, *hm.shape[-2:]),
                         "ang": ang.float(), "model": model, "proj": proj, "mask": m}
            if name != "card":
                continue
            pose = PoseStep(4, hw, where, cfg.num_angles, "fr3", calib=calib)
            step = functools.partial(serve_step, model, f, m, 512, hw, pose=pose, remap=remap,
                                     proj_mats=proj, single_view=single)
            bare = functools.partial(serve_step, model, und, m, 512, hw, pose=pose,
                                     proj_mats=proj, single_view=single)
            step()
            _reset_launches()
            step()
            torch.cuda.synchronize()
            got = _read_launches()
            per_tick = {"peak_decode": 1, "small_svd": 5 if single else 6}
            check(got == {k: per_tick.get(k, 0) for k in KERNELS},
                  f"{label} step launched {got}, not {per_tick}")
            _never_syncs(step)
            times = {"with remap": graph_ms(step, iters=1, samples=20),
                     "without remap": graph_ms(bare, iters=1, samples=20),
                     "remap alone": graph_ms(lambda: remap(f), iters=1, samples=20)}
    card, ref, yard = out["card"], out["cpu_f32"], out["card_f32"]
    off = (card["und"].int() - ref["und"].int()).abs()
    check(int(off.max()) <= 1 and float((off > 0).float().mean()) <= 1e-4,
          f"{label}: undistorted frames {int(off.max())} levels apart on "
          f"{float((off > 0).float().mean()):.3g} of the values, card vs CPU")
    hm_c, hm_r, hm_y = (o["hm"].float().cpu() for o in (card, ref, yard))
    gap, bf16_gap = float((hm_c - hm_r).abs().max()), float((hm_c - hm_y).abs().max())
    f32_gap = float((hm_y - hm_r).abs().max())
    check(gap <= 2 * bf16_gap and f32_gap <= 1e-3,
          f"{label}: heatmaps card bf16 vs CPU f32 {gap}, the card's bf16 vs f32 {bf16_gap}, "
          f"card f32 vs CPU f32 {f32_gap}")
    # The angle head alone on the CPU's heatmaps, on the card (its f32 MLP,
    # the DLT on the SVD kernel) and on the CPU.
    with torch.inference_mode():
        head = card["model"].angle_head
        hm_in = ref["hm"].to("cuda")
        head_ang = (head(hm_in) if single else
                    head(hm_in[None], card["mask"][None], card["proj"])).float().cpu()
    head_gap = float((head_ang - ref["ang"]).abs().max())
    check(head_gap <= 1e-3, f"{label}: the angle head on the same heatmaps {head_gap} apart")
    peaks = hm_c.flatten(2).argmax(-1) == hm_r.flatten(2).argmax(-1)
    ang_gap = float((card["ang"].cpu() - ref["ang"]).abs().max())
    agree = bool(peaks.all())
    check(not agree or ang_gap <= 1e-2, f"{label}: angles {ang_gap} apart with equal peaks")
    print(f"calibrated step [{label}; {device['nvidia_smi']}] (remap + preprocess + model + "
          f"decode + pose, 4x720x1280 u8 resident): CUDA-graph replay (device time) "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; the remap's cost {times['with remap'] - times['without remap']:.3f} ms; launches "
          f"a step {per_tick}; no host-device sync. Card vs CPU: undistorted frames "
          f"{int(off.max())} level(s) apart on {int((off > 0).sum())} of {off.numel()} values; "
          f"heatmaps bf16 card vs f32 CPU {gap:.4g} (the card's bf16 vs f32 {bf16_gap:.4g}, "
          f"f32 card vs CPU {f32_gap:.3g}); the angle head on the same heatmaps {head_gap:.3g}; "
          f"decoded peaks equal on {int(peaks.sum())}/{peaks.numel()} maps, whole-step angles "
          f"{ang_gap:.4g} apart" + ("" if agree else " (not compared: a peak differs)"))


def phase_calibrated(device: dict) -> dict:
    """`serve --params RUN --calib-dir --camera-keys --summary --recover-pose`
    for a single-view geometric and a multi-view geometric3d run directory
    (ViT-B/16 at 512 px, seed-0 weights exported with `export_jax_params`,
    bf16) on the calibrated rig of `write_rig`, under build/: the peak
    decode every tick and the SVD kernel 5 and 6 times a tick; then each
    step alone (`calibrated_step`). -> their launches."""
    launches, t0 = dict.fromkeys(KERNELS, 0), time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        calib_dir, summary = write_rig(Path(work))
        rig = ["--calib-dir", str(calib_dir), "--camera-keys", ",".join(CAL_KEYS), "--summary",
               str(summary), "--recover-pose"]
        for label, kind, cfg, per_tick in CALIBRATED_RUNS:
            run = Path(work) / kind
            flat = random_flat(KINDS[kind](cfg, device="meta"))
            write_run_dir(run, cfg, 512, flat, kind=kind)
            got = _serve(["--params", str(run / "best_params.npz"), *rig], label,
                         ["peak_decode", "small_svd"])
            check_pose_tick(label, got, per_tick)
            for name in ("peak_decode", "small_svd"):
                launches[name] += got[name]
            calibrated_step(label, kind, cfg, flat, calib_dir, summary, device)
            del flat
    print(f"calibrated serves and steps: {time.perf_counter() - t0:.1f} s")
    return launches


# The trainer's other modes on the card, a few steps each at its defaults
# otherwise (fr5, 128 px, batch 64): label, argv, views.
GEOMETRIC_TRAINER_RUNS = [
    ("single-view geometric + FK", ["--mode", "single", "--angle-head", "geometric",
                                    "--fk-loss-weight", "0.1"], 1),
    ("multi-view geometric3d", ["--mode", "multi", "--angle-head", "geometric3d"], 3),
]
GEOMETRIC_TRAINER_STEPS, GEOMETRIC_TRAINER_EVERY, GEOMETRIC_TRAINER_EVAL_BATCHES = 20, 10, 2


def phase_geometric_trainer() -> dict:
    """Each mode's train step on the card under the no-sync check (the
    trainer's own model and batch: the single-view step with the FK term,
    the multi-view step with the geometric3d head and its projection
    matrices), then `scripts/torch_train_synthetic.py` in that mode for a few
    steps: finite losses, two render launches a batch; the single-view
    run's SVD launches the pose evaluations' 5 a batch, the geometric3d
    run's more (its DLT in every forward). -> their launches."""
    trainer = _script("torch_train_synthetic")
    dev, robot = torch.device("cuda"), get_robot("fr5")
    launches, t0 = dict.fromkeys(KERNELS, 0), time.perf_counter()
    for label, argv, V in GEOMETRIC_TRAINER_RUNS:
        args = trainer.build_parser().parse_args(argv)
        single = args.mode == "single"
        model = trainer.build_model(args.mode, robot, 128, "bfloat16", V, False,
                                    args.angle_head, dev)
        model.load_state_dict(flax_init_state(model, seed=1))
        tcfg = TrainConfig(loss_weight_fk=args.fk_loss_weight, freeze_backbone=False)
        state = create_train_state(model, tcfg)
        step = (make_single_view_train_step(tcfg, robot=robot) if single
                else make_multi_view_train_step(tcfg))
        K, rv, tv = rig_tuple(make_rig(n_views=V, image_hw=(128, 128)), dev)
        batch = synthesize_multiview_batch(robot, (K, rv, tv), torch.Generator(dev).manual_seed(0),
                                           16, image_hw=(128, 128), heatmap_hw=(64, 64))
        if single:
            batch = single_view_batch(batch)
            batch.update(rvec=rv[0].expand(16, 3), tvec=tv[0].expand(16, 3),
                         K=K.expand(16, 3, 3), base_rotation=torch.eye(3, device=dev).expand(16, 3, 3))
        gen = torch.Generator(dev).manual_seed(1)
        losses = [step(state, batch, gen)]
        _never_syncs(lambda: losses.append(step(state, batch, gen)))
        check(all(bool(torch.isfinite(v).all()) for m in losses for v in m.values()),
              f"{label} train step: losses {losses}")
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            _reset_launches()
            final = trainer.main([*argv, "--steps", str(GEOMETRIC_TRAINER_STEPS), "--eval-every",
                                  str(GEOMETRIC_TRAINER_EVERY), "--eval-batches",
                                  str(GEOMETRIC_TRAINER_EVAL_BATCHES), "--workdir", work])
            got = _read_launches()
            log = [json.loads(line) for line in
                   (Path(work) / "logs" / "metrics.jsonl").read_text().splitlines()]
        batches = GEOMETRIC_TRAINER_STEPS + GEOMETRIC_TRAINER_EVAL_BATCHES
        check(got["heatmap_render"] == 2 * batches and got["small_svd"] > 0
              and (not single or got["small_svd"] == 2 * 5 * GEOMETRIC_TRAINER_EVAL_BATCHES)
              and all(v == 0 for k, v in got.items() if k not in ("heatmap_render", "small_svd")),
              f"{label} trainer: launched {got}")
        check(all(np.isfinite(r["loss"]) for r in log), f"{label} trainer: a loss is not finite")
        print(f"trainer [{label}] ({GEOMETRIC_TRAINER_STEPS} steps): the train step finite and "
              f"free of host syncs (losses {[round(float(m['loss']), 4) for m in losses]}); "
              f"(step, loss) {[(r['step'], round(r['loss'], 4)) for r in log]}; final pck5 "
              f"{final['pck5']}, angle_mae {final['angle_mae']}, "
              f"{final['train_samples_per_sec']} samples/s; launches {got}")
        for name in ("heatmap_render", "small_svd"):
            launches[name] += got[name]
    print(f"the trainer's single-view and geometric3d modes: {time.perf_counter() - t0:.1f} s")
    return launches


# `cli train` on a captured FR3 rig at full width: 4 serials x left and right
# cameras (max_views = 8), 1080x1920 frames, CLI_TRAIN_GROUPS groups of 8
# views; ViT-B/16 at 512 px (the query head), batch 2, the host loading in
# CLI_TRAIN_WORKERS worker processes (the reference's default).
CLI_TRAIN_HW = (1080, 1920)
CLI_TRAIN_GROUPS = 8
CLI_TRAIN_VAL_SPLIT = 0.25  # 6 train groups (3 steps an epoch) and 2 val groups
CLI_TRAIN_WORKERS = 4
CLI_TRAIN_ARGV = ["--robot", "fr3", "--image-hw", "1080", "1920", "--model-size", "512",
                  "--hidden-size", "768", "--num-layers", "12", "--batch-size", "2",
                  "--val-split", str(CLI_TRAIN_VAL_SPLIT), "--viz-every", "1", "--device", "cuda",
                  "--num-workers", str(CLI_TRAIN_WORKERS)]
# The timed turns of 0 and CLI_TRAIN_WORKERS workers: 3 steps an epoch are
# too few to time a warm stream (its first batch waits for the workers to
# start and decode), so these runs read 16 groups (12 train, 6 steps an
# epoch) over 2 epochs, whose stream stays warm across the epoch boundary.
CLI_TURN_GROUPS = 16
CLI_TURN_WORKERS = (0, CLI_TRAIN_WORKERS, CLI_TRAIN_WORKERS, 0)


def write_ring_calibration(root: Path) -> list:
    """The capture's calibration, as `cli calibrate` leaves it:
    `calib/{view}_{serial}_{cam}_calib.json` (ZED-like K, some distortion)
    and `pose1_aruco_pose_summary.json`, a ring of 8 cameras 2.2 m from the
    robot in radians (fr3's unit), composed with each view's base rotation
    so that the robot projects into every frame -> the summary's records."""
    robot = get_robot("fr3")
    rig = make_rig(n_views=8, image_hw=CLI_TRAIN_HW, distance_m=2.2)
    (root / "calib").mkdir(parents=True)
    records = []
    for i, serial in enumerate(FR3_SERIALS):
        view = FR3_SERIALS[serial]
        base = torch.from_numpy(robot.base_rotation(view)).double()
        for c, cam in enumerate(("leftcam", "rightcam")):
            v = 2 * i + c
            (root / "calib" / f"{view}_{serial}_{cam}_calib.json").write_text(json.dumps({
                "camera_matrix": rig.K.tolist(),
                "distortion_coeffs": [-0.04 + 0.005 * v, 0.015, 5e-4, -5e-4, 0.0]}))
            R = rodrigues_to_matrix(torch.from_numpy(rig.rvecs[v]).double()) @ base.T
            rvec = matrix_to_rodrigues(R).tolist()
            records.append({"view": view, "cam": cam,
                            **dict(zip(("rvec_x", "rvec_y", "rvec_z"), rvec)),
                            **dict(zip(("tvec_x", "tvec_y", "tvec_z"),
                                       map(float, rig.tvecs[v])))})
    (root / "pose1_aruco_pose_summary.json").write_text(json.dumps(records, indent=2))
    return records


def write_capture(root: Path, groups: int = CLI_TRAIN_GROUPS, seed: int = 0) -> dict:
    """A capture as `cli sync fr3` and `cli calibrate` leave one, written
    with the stdlib csv, cv2 and json: per group one joint record (radians)
    and 8 JPEGs pose1/zed_<serial>_<left|right>_<epoch>.jpg within 5 ms of
    it (so the group's rows tie on robot_timestamp), the sync CSV schema and
    the ring's calibration (`write_ring_calibration`) -> CLI argv pieces."""
    import cv2

    H, W = CLI_TRAIN_HW
    rng = np.random.default_rng(seed)
    (root / "pose1").mkdir(parents=True)
    write_ring_calibration(root)
    serials = list(FR3_SERIALS)
    summary = root / "pose1_aruco_pose_summary.json"
    joints = [f"position_fr3_joint{j}" for j in range(1, 8)]
    rows = []
    for g in range(groups):
        ts = 1700000000.0 + 0.5 * g + 0.123
        angles = rng.uniform(-0.6, 0.6, 7).tolist()
        for serial in serials:
            for side in ("left", "right"):
                t_img = ts - 0.0333 + rng.uniform(-0.005, 0.005)
                path = root / "pose1" / f"zed_{serial}_{side}_{t_img:.9f}.jpg"
                small = rng.integers(0, 256, (H // 16, W // 16, 3), dtype=np.uint8)
                check(cv2.imwrite(str(path), cv2.resize(small, (W, H))), f"cannot write {path}")
                rows.append([str(path), repr(t_img), repr(abs(t_img + 0.0333 - ts)), repr(ts),
                             *map(repr, angles)])
    csv_path = root / "fr3.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["image_path", "image_timestamp", "time_difference_s",
                         "robot_timestamp", *joints])
        writer.writerows(rows)
    return ["--csv", str(csv_path), "--calib-dir", str(root / "calib"), "--aruco-summary",
            str(summary)]


@contextlib.contextmanager
def _instrumented_train(log: dict):
    """Count and time what `cli train` does, through its own module: each
    preprocessed batch (its render launches must match; the first one's
    keypoints and heatmaps are kept), any call of the plain render (there
    must be none), each step's host and device (CUDA events) time, and the
    host time of each batch's load (decode, undistortion, padding): a train
    batch's under "train_load_s" (in-process, or the wait for the worker
    stream's next batch), a validation batch's under "val_load_s". The
    worker stream's first `log["keep"]` batches are kept with their
    indices, and its dataset."""
    real_pre, real_step = cli_main.make_device_preprocessor, cli_main.make_multi_view_train_step
    real_split, real_plain = cli_main.builders.train_val_split, heatmap_render.render_heatmaps_reference
    real_loader = cli_main.make_worker_loader

    def make_pre(*a, **kw):
        pre = real_pre(*a, **kw)

        def counted(images, cam_idx, keypoints, *rest, **kw2):
            out = pre(images, cam_idx, keypoints, *rest, **kw2)
            log["batches"] += 1
            if "first" not in log:
                log["first"] = (keypoints.clone(), out[1].clone())
            return out
        return counted

    def make_step(*a, **kw):
        step = real_step(*a, **kw)

        def timed(*args):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            out = []
            t0 = time.perf_counter()
            e[0].record()
            with torch.profiler.record_function("cli_train_step"):
                # The first step allocates the optimizer's state.
                if log["check_syncs"] and log["step_events"]:
                    _never_syncs(lambda: out.append(step(*args)))
                else:
                    out.append(step(*args))
            e[1].record()
            log["step_host_s"].append(time.perf_counter() - t0)
            log["step_events"].append(e)
            return out[0]
        return timed

    def split(ds, frac):
        parts = real_split(ds, frac)
        for part, key in zip(parts, ("train_load_s", "val_load_s")):
            batches = part.batches

            def timed_batches(*a, _batches=batches, _key=key, **kw):
                it = _batches(*a, **kw)
                while True:
                    t0 = time.perf_counter()
                    b = next(it, None)
                    if b is None:
                        return
                    log[_key].append(time.perf_counter() - t0)
                    yield b
            part.batches = timed_batches
        return parts

    class TimedStream:
        def __init__(self, stream):
            self.stream = stream

        def __next__(self):
            t0 = time.perf_counter()
            b = next(self.stream)
            log["train_load_s"].append(time.perf_counter() - t0)
            if len(log["stream_batches"]) < log["keep"]:
                log["stream_batches"].append(
                    (self.stream.indices.copy(), {k: v.clone() for k, v in b.items()}))
            return b

        def close(self):
            self.stream.close()

    def make_loader(ds, batch_size, **kw):
        log["stream"] = (ds, batch_size, kw)
        return TimedStream(real_loader(ds, batch_size, **kw))

    def plain(*a, **kw):
        log["plain_renders"] += 1
        return real_plain(*a, **kw)

    cli_main.make_device_preprocessor = make_pre
    cli_main.make_multi_view_train_step = make_step
    cli_main.builders.train_val_split = split
    cli_main.make_worker_loader = make_loader
    heatmap_render.render_heatmaps_reference = plain
    try:
        yield
    finally:
        cli_main.make_device_preprocessor = real_pre
        cli_main.make_multi_view_train_step = real_step
        cli_main.builders.train_val_split = real_split
        cli_main.make_worker_loader = real_loader
        heatmap_render.render_heatmaps_reference = real_plain


def _cli_train_run(argv: list, label: str, profiled: bool = False, keep: int = 0) -> tuple:
    """One `cli train` call through the CLI's parser -> (its launches, its
    log). `profiled` adds the device's busy time over the call, a train
    step's device time (`torch.profiler`) and the check that no step but the
    first synchronizes, all of which slow the host; `keep` keeps the worker
    stream's first batches."""
    log = {"batches": 0, "plain_renders": 0, "step_host_s": [], "step_events": [],
           "train_load_s": [], "val_load_s": [], "stream_batches": [], "keep": keep,
           "check_syncs": profiled}
    args = build_parser().parse_args(["train", *argv])
    _reset_launches()
    t0 = time.perf_counter()
    with _instrumented_train(log), (profile(activities=[ProfilerActivity.CPU,
                                                        ProfilerActivity.CUDA])
                                    if profiled else contextlib.nullcontext()) as prof:
        result = cli_main.train(args)
        torch.cuda.synchronize()
    log["wall_s"], log["result"] = time.perf_counter() - t0, result
    if profiled:
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
        log["busy_s"] = sum(e.time_range.elapsed_us() for e in device_events) / 1e6
        steps = [e for e in prof.key_averages() if e.key == "cli_train_step"]
        log["step_device_ms"] = (steps[0].device_time_total / steps[0].count / 1e3
                                 if steps else float("nan"))
    launches = _read_launches()
    check(launches == {k: log["batches"] if k == "heatmap_render" else 0 for k in KERNELS},
          f"cli train [{label}]: {log['batches']} preprocessed batches, launches {launches}")
    check(log["plain_renders"] == 0, f"cli train [{label}]: the plain render ran")
    return launches, log


def host_load_parts(capture: Path, n: int = 8) -> tuple:
    """(ms to decode one of the capture's frames, ms to undistort it by
    cv2.remap), medians of n, as a dataset's batch does per view."""
    import cv2

    path = str(sorted((capture / "pose1").glob("*.jpg"))[0])
    calib = json.loads(sorted((capture / "calib").glob("*_calib.json"))[0].read_text())
    grid = undistort_map(torch.tensor(calib["camera_matrix"]),
                         torch.tensor(calib["distortion_coeffs"]), *CLI_TRAIN_HW).numpy()
    mx, my = np.ascontiguousarray(grid[1]), np.ascontiguousarray(grid[0])
    decode, remap = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        t1 = time.perf_counter()
        cv2.remap(img, mx, my, cv2.INTER_LINEAR)
        decode.append(t1 - t0)
        remap.append(time.perf_counter() - t1)
    return 1e3 * statistics.median(decode), 1e3 * statistics.median(remap)


def check_stream_batches(log: dict, label: str) -> int:
    """The worker stream's kept batches against the in-process sample prep
    of the same groups (`batches()` of a dataset holding just them): every
    field bit-equal -> the batches checked."""
    ds, batch_size, _ = log["stream"]
    for idx, got in log["stream_batches"]:
        sub = copy.copy(ds)
        sub.groups = [ds.groups[i] for i in idx]
        # The class's batches: the instance's is the timed wrapper of the
        # whole split's.
        want = next(type(ds).batches(sub, batch_size))
        check(list(got) == list(want), f"{label}: stream keys {list(got)} vs {list(want)}")
        for k, v in want.items():
            check(np.array_equal(got[k].numpy(), v),
                  f"{label}: the worker batch of groups {idx.tolist()} differs at {k}")
    return len(log["stream_batches"])


def phase_cli_train(device: dict) -> dict:
    """`cli train` on a capture written under build/ (`write_capture`), one
    epoch, then the same run resumed to a second epoch, both loading in
    CLI_TRAIN_WORKERS worker processes: render launches equal to the
    preprocessed batches and no plain render in each run; the first
    epoch's worker batches bit-equal to the in-process sample prep of the
    same groups; the first batch's GT heatmaps equal to
    `render_heatmaps_reference` of its scaled keypoints (bound 1e-6, as
    phase 3's render check); finite losses; the resumed run's one record at
    epoch 2, a step count that goes on and a reseeded stream; the trained
    best_params.npz served by `serve --params`; `cli visualize` of the
    capture. Then `cli_train_turns`. -> launches."""
    launches = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        capture = write_capture(Path(work) / "capture")
        write_s = time.perf_counter() - t0
        run = Path(work) / "run"
        argv = [*CLI_TRAIN_ARGV, *capture, "--workdir", str(run)]
        steps = int(CLI_TRAIN_GROUPS * (1 - CLI_TRAIN_VAL_SPLIT)) // 2
        logs = []
        for epochs in (1, 2):
            got, log = _cli_train_run([*argv, "--epochs", str(epochs)], f"epochs {epochs}",
                                      profiled=epochs == 2, keep=steps if epochs == 1 else 0)
            logs.append(log)
            launches["heatmap_render"] += got["heatmap_render"]
        seeds = [log["stream"][2]["seed"] for log in logs]
        check(seeds == [0, 1000003] and all(log["stream"][2]["num_workers"] == CLI_TRAIN_WORKERS
                                            for log in logs),
              f"cli train: the worker streams' seeds {seeds}")
        kept = check_stream_batches(logs[0], "cli train, first epoch")
        check(kept == steps, f"cli train: {kept} worker batches checked, not {steps}")
        recs = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
                .splitlines()]
        check([r["epoch"] for r in recs] == [1, 2] and logs[1]["result"].epochs_run == 1,
              f"cli train: the resumed run did not start at epoch 2: {recs}")
        check(recs[1]["step"] == 2 * recs[0]["step"] == 2 * steps, f"cli train: steps {recs}")
        check(all(np.isfinite(r[k]) for r in recs for k in ("loss", "val_loss")),
              f"cli train: a loss is not finite: {recs}")
        kp, hms = logs[0]["first"]
        scale = torch.tensor([128 / CLI_TRAIN_HW[1], 128 / CLI_TRAIN_HW[0]], device="cuda")
        inv = torch.full((kp.numel() // 2, 1), 1.0 / (2.0 * 5.0 ** 2), device="cuda")
        want = heatmap_render.render_heatmaps_reference(
            torch.cat([(kp.float() * scale).reshape(-1, 2), inv], 1), 128, 128)
        err = float((hms.reshape(want.shape) - want).abs().max())
        check(err <= 1e-6 and float(hms.amax()) > 0.5,
              f"cli train: GT heatmaps against the plain render: {err}, peak {float(hms.amax())}")
        images = list((run / "logs" / "images").glob("val_predictions_step*.png"))
        check(len(images) == 2, f"cli train: panels {images}")
        load_parts = host_load_parts(Path(work) / "capture")
        panels = Path(work) / "panels"
        check(cli_main.main(["visualize", "--robot", "fr3", "--multi-view", *capture,
                             "--image-hw", *map(str, CLI_TRAIN_HW), "--out-dir", str(panels),
                             "--num-samples", "1"]) == 0,
              "cli visualize failed")
        shapes = {cv2_shape(f) for f in panels.glob("group*view_*.png")}
        check(shapes == {(CLI_TRAIN_HW[0], 8 * CLI_TRAIN_HW[1], 3)},
              f"cli visualize: panels of shapes {shapes}")
        served = _serve(["--params", str(run / "best_params.npz")], "trained FR3 checkpoint",
                        ["peak_decode"], 3.0)
        launches["peak_decode"] += served["peak_decode"]
        t_eval = time.perf_counter()
        _add_launches(launches, phase_cli_eval_capture(capture, run))
        eval_s = time.perf_counter() - t_eval
        cfg, size, kind = cli_main.read_model_config(run / "best_params.npz")
        check((kind, size, cfg.max_views, cfg.vit.hidden_size) == ("multi_view", 512, 8, 768),
              f"cli train: model_config.json {kind}, {size}, {cfg}")
    train_groups = int(CLI_TRAIN_GROUPS * (1 - CLI_TRAIN_VAL_SPLIT))
    for log, rec in zip(logs, recs):
        steps_ms = [e[0].elapsed_time(e[1]) for e in log["step_events"]]
        profiled = ("" if "busy_s" not in log else
                    f"; under the profiler: a train step's kernels {log['step_device_ms']:.3f} "
                    f"ms of device time, the device busy {log['busy_s']:.3f} s of the call's "
                    f"{log['wall_s']:.2f} s; no host-device sync in a step after the first")
        print(f"cli train [{device['nvidia_smi']}; FR3 capture, {CLI_TRAIN_GROUPS} groups x 8 "
              f"views of {CLI_TRAIN_HW[0]}x{CLI_TRAIN_HW[1]}, frozen ViT-B/16 at 512 px, bf16, "
              f"batch 2, {CLI_TRAIN_WORKERS} workers] epoch {int(rec['epoch'])}: "
              f"{log['wall_s']:.2f} s for the call ({rec['epoch_time_s']:.3f} s the epoch with "
              f"its validation: {train_groups / rec['epoch_time_s']:.3f} train groups/s); "
              f"waits for the worker stream {_ms_list(log['train_load_s'])} ms a batch, "
              f"in-process validation load {_ms_list(log['val_load_s'])} ms; train step "
              f"{statistics.median(steps_ms):.3f} ms between CUDA events (median of "
              f"{len(steps_ms)}), {1e3 * statistics.median(log['step_host_s']):.1f} ms on the "
              f"host{profiled}; {log['batches']} preprocessed batches, "
              f"{log['batches']} render launches, {log['plain_renders']} plain renders; loss "
              f"{rec['loss']:.4f}, val_loss {rec['val_loss']:.4f}, val_pck5 {rec['val_pck5']:.4f}")
    print(f"cli train: capture written in {write_s:.1f} s; a frame's host load: cv2 decode "
          f"{load_parts[0]:.2f} ms, cv2.remap {load_parts[1]:.2f} ms (medians of 8); first "
          f"batch's GT heatmaps within {err:.3g} of the plain render; {kept} worker batches "
          f"bit-equal to the in-process prep; phase {time.perf_counter() - t0:.1f} s (cli eval "
          f"of the run {eval_s:.1f} s)")
    _add_launches(launches, cli_train_turns(device))
    return launches


DISPLAY_EVERY = 5


def phase_serve_display() -> int:
    """`serve --display dir` at the serve defaults (4 synthetic 720x1280
    cameras, ViT-B/16 at 512 px, bf16) for a few seconds: one canvas each
    DISPLAY_EVERY ticks, named canvas_<n>.png from tick 1 (a tick is one
    peak-decode launch, and each is fetched and drawn), each the 2-over-2
    tiling of the frames scaled to fit 1800x950. -> peak-decode launches."""
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        launches = _serve(["--display", "dir", "--display-dir", d, "--display-every",
                           str(DISPLAY_EVERY)], "bf16 + display dir", ["peak_decode"], 4.0)
        ticks = launches["peak_decode"]
        files = sorted(p.name for p in Path(d).iterdir())
        want = [f"canvas_{n:06d}.png" for n in range(1, ticks + 1, DISPLAY_EVERY)]
        check(files == want, f"serve --display dir: {ticks} ticks, canvases {files}")
        w, h = 2 * 1280, 2 * 720
        scale = min(1800 / w, 950 / h)
        shapes = {cv2_shape(Path(d) / f) for f in files}
        check(shapes == {(int(h * scale), int(w * scale), 3)},
              f"serve --display dir: canvases of shapes {shapes}")
    print(f"serve --display dir: {len(files)} canvases of {shapes.pop()} for {ticks} ticks")
    return ticks


PROFILE_ITERS = 20


def phase_profile(device: dict) -> int:
    """`cli profile` at its defaults (ViT-B/16, 4 views, 512 px, bf16, zero
    weights): each stage's device ms between CUDA events, the peak decode's
    launches (one a decode stage and the warm-up's) and no other kernel.
    -> peak-decode launches."""
    args = build_parser().parse_args(["profile", "--iters", str(PROFILE_ITERS)])
    check((args.views, args.model_size, args.hidden_size, args.num_layers) == (4, 512, 768, 12),
          f"cli profile defaults {args}")
    _reset_launches()
    timer = cli_main.profile(args)
    report = timer.report()
    launches = _read_launches()
    check(launches == {k: PROFILE_ITERS + 1 if k == "peak_decode" else 0 for k in KERNELS},
          f"cli profile: launches {launches}")
    check(sorted(report) == ["backbone", "decode", "full_forward"]
          and all(r["count"] == PROFILE_ITERS and 0 < r["mean_s"] < 1 for r in report.values()),
          f"cli profile: {report}")
    rate = 1.0 / (report["full_forward"]["mean_s"] + report["decode"]["mean_s"])
    print(f"cli profile [{device['nvidia_smi']}; ViT-B/16, 4 views, 512 px, bf16, zero weights, "
          f"mean of {PROFILE_ITERS}, CUDA events]: "
          + ", ".join(f"{k} {1e3 * r['mean_s']:.3f} ms" for k, r in sorted(report.items()))
          + f"; estimated frame-sets/s (forward+decode): {rate:.2f}")
    print(timer.summary())
    return launches["peak_decode"]


ARUCO_MARKERS = {"3": (0.25, -0.1, 0.05), "7": (-0.2, 0.15, 0.0), "12": (0.05, 0.2, -0.1)}
ARUCO_SIZE_M = 0.2
EXTRINSICS_TOL = 2e-5  # m and rad: f32 quaternion means of equal detections
CORNERS_TOL = 1e-4  # m and rad: an f32 PnP + LM of each marker's 4 corners


def write_aruco_detections(root: Path, records: list) -> dict:
    """ArUco capture files for the ring's cameras (`write_ring_calibration`'s
    records): per camera 3 files `{view}_{serial}_{cam}_<i>.json` of 3
    markers placed so that marker pose + board offset is the camera's drawn
    pose (position t - R offset, rotation R), their corners projected
    through the camera's K and distortion; in file 1 marker 7 is 11 degrees
    off, an outlier. -> the calibrate arguments' files."""
    import cv2

    serial_of = {v: s for s, v in FR3_SERIALS.items()}
    (root / "aruco").mkdir(parents=True)
    obj = np.array([[0, 0, 0], [ARUCO_SIZE_M, 0, 0], [ARUCO_SIZE_M, ARUCO_SIZE_M, 0],
                    [0, ARUCO_SIZE_M, 0]], np.float64)
    for rec in records:
        view, cam = rec["view"], rec["cam"]
        serial = serial_of[view]
        calib = json.loads((root / "calib" / f"{view}_{serial}_{cam}_calib.json").read_text())
        K, dist = np.asarray(calib["camera_matrix"]), np.asarray(calib["distortion_coeffs"])
        rvec = np.array([rec[f"rvec_{c}"] for c in "xyz"])
        tvec = np.array([rec[f"tvec_{c}"] for c in "xyz"])
        R, _ = cv2.Rodrigues(rvec)
        for i in range(3):
            dets = {}
            for m, offset in ARUCO_MARKERS.items():
                r = rvec + (0.2 if (i, m) == (1, "7") else 0.0)
                t = tvec - R @ np.asarray(offset)
                px, _ = cv2.projectPoints(obj, r, t, K, dist)
                q = matrix_to_quat(torch.from_numpy(cv2.Rodrigues(r)[0])).tolist()
                dets[m] = {"position_m": dict(zip("xyz", map(float, t))),
                           "rotation_quat": dict(zip("xyzw", q)),
                           "corners_pixel": px[:, 0].tolist()}
            (root / "aruco" / f"{view}_{serial}_{cam}_{i:03d}.json").write_text(json.dumps(dets))
    (root / "offsets.json").write_text(json.dumps(
        {v: {m: list(o) for m, o in ARUCO_MARKERS.items()} for v in serial_of}))
    (root / "serials.json").write_text(json.dumps(serial_of))
    return {"aruco": root / "aruco", "offsets": root / "offsets.json",
            "serials": root / "serials.json", "calib": root / "calib"}


def phase_cli_calibrate() -> None:
    """`cli calibrate extrinsics` and `corners` on the ring's ArUco
    detections (`write_aruco_detections`), held to the poses the ring drew:
    within EXTRINSICS_TOL averaging the detections, CORNERS_TOL re-solving
    each marker from its corners; `python -m mvropose_torch --help`."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        root = Path(work)
        records = write_ring_calibration(root)
        files = write_aruco_detections(root, records)
        args = {"extrinsics": ["--offsets", str(files["offsets"])],
                "corners": ["--calib-dir", str(files["calib"]), "--serial-map",
                            str(files["serials"]), "--offsets", str(files["offsets"]),
                            "--marker-size", str(ARUCO_SIZE_M)]}
        errs = {}
        for cmd, tol in (("extrinsics", EXTRINSICS_TOL), ("corners", CORNERS_TOL)):
            out = root / f"{cmd}.json"
            check(cli_main.main(["calibrate", cmd, "--aruco-dir", str(files["aruco"]),
                                 *args[cmd], "--out", str(out)]) == 0, f"calibrate {cmd}")
            got = {(r["view"], r["cam"]): r for r in json.loads(out.read_text())}
            check(sorted(got) == sorted((r["view"], r["cam"]) for r in records)
                  and all(r["rvec_unit"] == "rad" for r in got.values()),
                  f"calibrate {cmd}: records {sorted(got)}")
            err = 0.0
            for rec in records:
                g = got[rec["view"], rec["cam"]]
                R = [rodrigues_to_matrix(torch.tensor([r[f"rvec_{c}"] for c in "xyz"],
                                                      dtype=torch.float64)) for r in (rec, g)]
                angle = float(matrix_to_rodrigues(R[0].T @ R[1]).norm())
                dt = max(abs(g[f"tvec_{c}"] - rec[f"tvec_{c}"]) for c in "xyz")
                err = max(err, angle, dt)
            check(err <= tol, f"calibrate {cmd}: {err:.3g} from the drawn poses (bound {tol})")
            errs[cmd] = err
    help_out = subprocess.run([sys.executable, "-m", "mvropose_torch", "--help"], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
    check(help_out.returncode == 0 and help_out.stdout.startswith("usage: mvropose_torch"),
          f"python -m mvropose_torch --help: {help_out.returncode} {help_out.stderr[-500:]}")
    print(f"cli calibrate on the ring's 8 cameras x 3 markers x 3 detections (one outlier a "
          f"camera): extrinsics within {errs['extrinsics']:.3g}, corners within "
          f"{errs['corners']:.3g} (m and rad) of the drawn poses; python -m mvropose_torch "
          f"runs; {time.perf_counter() - t0:.1f} s")


def cv2_shape(path: Path) -> tuple:
    import cv2

    return cv2.imread(str(path)).shape


def _ms_list(seconds: list) -> str:
    return "[" + ", ".join(f"{1e3 * s:.1f}" for s in seconds) + "]"


def cli_train_turns(device: dict) -> dict:
    """`cli train` on a capture of CLI_TURN_GROUPS groups, 2 epochs a run,
    in turns of CLI_TURN_WORKERS worker processes (0: in-process): each
    run's train-batch load (the in-process decode and undistortion, or the
    wait for the worker stream's next batch) a batch and in all an epoch,
    its train step's time and groups/s an epoch, beside os.cpu_count().
    -> launches."""
    launches = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    cpus = os.cpu_count()
    train_groups = int(CLI_TURN_GROUPS * (1 - CLI_TRAIN_VAL_SPLIT))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        capture = write_capture(Path(work) / "capture", groups=CLI_TURN_GROUPS, seed=1)
        for turn, workers in enumerate(CLI_TURN_WORKERS):
            run = Path(work) / f"run{turn}"
            got, log = _cli_train_run([*CLI_TRAIN_ARGV, *capture, "--workdir", str(run),
                                       "--epochs", "2", "--viz-every", "10", "--num-workers",
                                       str(workers)], f"turn {turn}, {workers} workers")
            _add_launches(launches, got)
            recs = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
                    .splitlines()]
            check(all(np.isfinite(r["loss"]) for r in recs) and len(recs) == 2,
                  f"cli train turn {turn}: {recs}")
            loads = log["train_load_s"]
            half = len(loads) // 2
            epoch_s = [r["epoch_time_s"] for r in recs]
            rates = [train_groups / t for t in epoch_s]
            steps_ms = [e[0].elapsed_time(e[1]) for e in log["step_events"]]
            print(f"cli train turn {turn} [{device['nvidia_smi']}; os.cpu_count() {cpus}; "
                  f"{CLI_TURN_GROUPS} groups x 8 views of {CLI_TRAIN_HW[0]}x{CLI_TRAIN_HW[1]}, "
                  f"ViT-B/16 at 512 px, batch 2, 2 epochs] {workers} workers: host load a "
                  f"train batch median {1e3 * statistics.median(loads):.1f} ms (first "
                  f"{1e3 * loads[0]:.1f}, then {_ms_list(loads[1:])}; in all "
                  f"{1e3 * sum(loads[:half]):.1f}, {1e3 * sum(loads[half:]):.1f} ms an epoch); "
                  f"train step median {statistics.median(steps_ms):.3f} ms between CUDA "
                  f"events, {1e3 * statistics.median(log['step_host_s']):.1f} ms on the host; "
                  f"groups/s a epoch "
                  f"{', '.join(f'{r:.3f}' for r in rates)} (the epoch with its validation "
                  f"{', '.join(f'{t:.3f}' for t in epoch_s)} s); "
                  f"{log['wall_s']:.2f} s for the call")
    print(f"cli train turns: {time.perf_counter() - t0:.1f} s")
    return launches


# cli eval's report keys in the reference's order (mvropose_tpu/cli/main.py:1429-1480):
# the first nine always, the others where the run has their data.
EVAL_KEYS = [
    "pck@5.0px", "kp_px_err_mean", "kp_px_err_rms", "angle_mae", "angle_mae_per_joint", "add_m",
    "add_auc@10cm", "samples", "occlusion_masks", "triangulated_add_m", "triangulated_obs_rate",
    "pose_success_rate", "pose_rot_err_deg", "pose_trans_err_m", "pnp_add_m_converged",
    "pnp_add_pass@10cm", "pnp_add_auc@10cm", "pose_rot_err_deg_gt_angles",
    "pose_trans_err_m_gt_angles", "pnp_add_m_converged_gt_angles", "pnp_add_pass@10cm_gt_angles",
    "pnp_add_auc@10cm_gt_angles", "pose_rot_err_deg_refined", "pose_trans_err_m_refined",
    "refined_angle_mae", "pnp_add_m_converged_refined", "pnp_add_pass@10cm_refined",
    "pnp_add_auc@10cm_refined",
]
_REFINED = EVAL_KEYS[22:25]
# Per configuration: (the keys the reference always reports, the keys it may report).
EVAL_KEY_SETS = {
    # FR3 multi-view (calibrated extrinsics, no camera-frame keypoints).
    "multi_view": (EVAL_KEYS[:9] + ["pose_success_rate"], EVAL_KEYS[:14]),
    # A single-view fr5 set (calibrated extrinsics): no triangulation.
    "single_view": (EVAL_KEYS[:9] + ["pose_success_rate"], EVAL_KEYS[:9] + EVAL_KEYS[11:14]),
    "multi_view_refine": (EVAL_KEYS[:9] + ["pose_success_rate", *_REFINED],
                          EVAL_KEYS[:14] + _REFINED),
    # DREAM (the GT pose by alignment, the _gt_angles variant) with --refine-pose.
    "dream_refine": ([*EVAL_KEYS[:9], "pose_success_rate", "pnp_add_pass@10cm",
                      "pnp_add_auc@10cm", "pnp_add_pass@10cm_gt_angles",
                      "pnp_add_auc@10cm_gt_angles", *_REFINED, *EVAL_KEYS[25:]],
                     EVAL_KEYS[:9] + EVAL_KEYS[11:]),
}
# An int8 eval forward's launches a transformer block: the attention and its
# values' quantization, q/k/v/out/fc1/fc2's GEMMs, and the row quantizations
# of q/k/v's shared input, out's, fc1's and fc2's.
INT8_EVAL_PER_BLOCK = {"int8_attention": 1, "int8_quantize_v": 1, "int8_matmul": 6,
                       "int8_quantize_rows": 4}
# The int8 receipt's model (runs/dream_synth_real_geom/model_config.json):
# a 192-wide, 4-layer ViT/16 at 128 px, 3 heads of 64.
TWIN_ARGV = ["--image-hw", "128", "128", "--model-size", "128", "--hidden-size", "192",
             "--num-layers", "4", "--device", "cuda"]


@contextlib.contextmanager
def _instrumented_eval(log: dict):
    """Count `cli eval`'s preprocessed batches and any call of the plain render."""
    real_pre, real_plain = cli_eval.make_device_preprocessor, heatmap_render.render_heatmaps_reference

    def make_pre(*a, **kw):
        pre = real_pre(*a, **kw)

        def counted(*args, **kw2):
            log["batches"] += 1
            return pre(*args, **kw2)
        return counted

    def plain(*a, **kw):
        log["plain_renders"] += 1
        return real_plain(*a, **kw)

    cli_eval.make_device_preprocessor = make_pre
    heatmap_render.render_heatmaps_reference = plain
    try:
        yield
    finally:
        cli_eval.make_device_preprocessor = real_pre
        heatmap_render.render_heatmaps_reference = real_plain


@contextlib.contextmanager
def _int8_shapes(seen: set):
    """Record the (B, T, H, d) of each int8 attention and the (M, Din, Dout)
    of each int8 product a `cli eval` forward runs."""
    real_attn, real_mm = vit_module.int8_prob_attention, quantize_module.int8_matmul

    def attention(q, k, v, key_mask=None):
        seen.add(("int8_attention", *q.shape))
        return real_attn(q, k, v, key_mask=key_mask)

    def matmul(x, kernel_q, scale, bias, out_dtype):
        x0 = x[0] if isinstance(x, tuple) else x
        seen.add(("int8_matmul", x0.numel() // x0.shape[-1], *kernel_q.shape))
        return real_mm(x, kernel_q, scale, bias, out_dtype)

    vit_module.int8_prob_attention, quantize_module.int8_matmul = attention, matmul
    try:
        yield
    finally:
        vit_module.int8_prob_attention, quantize_module.int8_matmul = real_attn, real_mm


def _finite(value) -> bool:
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    return not isinstance(value, float) or bool(np.isfinite(value))


def _cli_eval_run(argv: list, label: str, keys: str | None, layers: int = 0,
                  pose: bool = True) -> dict:
    """One `cli eval` call through the CLI's parser -> its launches. `keys`
    names the configuration's key sets (None: the mixed report); `layers`
    > 0 expects an int8 backbone of that depth, whose attentions and
    products run only at shapes that phase_int8_attention and
    phase_int8_matmul hold against the plain version (INT8_CASES,
    INT8_MM_CASES); `pose` expects SVD launches."""
    log = {"batches": 0, "plain_renders": 0}
    args = build_parser().parse_args(["eval", *argv])
    shapes: set = set()
    _reset_launches()
    t0 = time.perf_counter()
    with _instrumented_eval(log), _int8_shapes(shapes):
        report = cli_eval.evaluate(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    if keys is None:
        robots = args.robot.split(",")
        check(list(report) == ["robots", "samples", *robots] and report["robots"] == robots
              and all(list(report[r]) == ["pck@5.0px", "angle_mae_native", "angle_unit",
                                          "add_m", "samples"] for r in robots),
              f"cli eval [{label}]: report keys {report}")
    else:
        required, allowed = EVAL_KEY_SETS[keys]
        got = list(report)
        check(got == [k for k in EVAL_KEYS if k in report] and set(required) <= set(got)
              <= set(allowed), f"cli eval [{label}]: report keys {got}")
    check(_finite(report), f"cli eval [{label}]: a value is not finite: {report}")
    check(log["batches"] > 0 and launches["heatmap_render"] == log["batches"],
          f"cli eval [{label}]: {log['batches']} preprocessed batches, launches {launches}")
    check(log["plain_renders"] == 0, f"cli eval [{label}]: the plain render ran")
    check((launches["small_svd"] > 0) == pose, f"cli eval [{label}]: SVD launches {launches}")
    held = ({("int8_attention", B, T, H, d) for _, B, T, H, d, _, _ in INT8_CASES}
            | {("int8_matmul", M, din, dout) for _, M, din, dout in INT8_MM_CASES})
    check(bool(shapes) == (layers > 0) and shapes <= held,
          f"cli eval [{label}]: int8 shapes not held against the plain version: "
          f"{sorted(shapes - held)} (all: {sorted(shapes)})")
    int8 = {k: n * layers * log["batches"] for k, n in INT8_EVAL_PER_BLOCK.items()}
    check(all(launches[k] == int8.get(k, launches[k] if k in ("heatmap_render", "small_svd",
                                                              "peak_decode") else 0)
              for k in KERNELS), f"cli eval [{label}]: launches {launches}, int8 expected {int8}")
    print(f"cli eval [{label}]: {wall:.2f} s for the call, {log['batches']} batches; int8 "
          f"shapes {sorted(shapes)}, each held against the plain version; launches "
          f"{ {k: v for k, v in launches.items() if v} }; report {json.dumps(report)}")
    return launches


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_cli_eval_capture(capture_argv: list, run: Path) -> dict:
    """`cli eval` of phase_cli_train's run on its own capture (ViT-B/16 at
    512 px, 8 views of 1080x1920): float with --refine-pose
    --occlusion-masks 2, then --int8-backbone --int8-attention. -> launches."""
    argv = ["--robot", "fr3", *capture_argv, "--params",
            str(run / "best_params.npz"), "--image-hw", "1080", "1920", "--batch-size", "2",
            "--device", "cuda"]
    launches = {}
    _add_launches(launches, _cli_eval_run([*argv, "--refine-pose", "--occlusion-masks", "2"],
                                          "FR3 capture, float, refine, occlusion",
                                          "multi_view_refine"))
    _add_launches(launches, _cli_eval_run([*argv, "--int8-backbone", "--int8-attention"],
                                          "FR3 capture, int8 + int8 attention", "multi_view",
                                          layers=12))
    return launches


def phase_cli_eval_small(device: dict) -> dict:
    """A DREAM pass and a mixed pass on sets the port's generators write
    under build/: `cli sync dream`, `cli train` (2 epochs at the int8
    receipt's architecture; the three robots 1 epoch) and `cli eval`. -> launches."""
    launches = {}
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = Path(work)
        gen = _script("torch_make_dream_synthetic")
        for name, n, seed in (("dream_train", 96, 0), ("dream_eval", 32, 77)):
            check(gen.main(["--out-dir", str(work / name), "--n-samples", str(n), "--image-hw",
                            "128", "128", "--focal-scale", "0.96", "--seed", str(seed)]) == 0,
                  f"generator {name}")
            check(cli_main.main(["sync", "dream", "--base-dirs", str(work / name / "panda_synth"),
                                 "--out", str(work / f"{name}.csv"), "--strict"]) == 0,
                  f"cli sync dream {name}")
        check(_script("torch_make_mixed_synthetic").main(
            ["--out-dir", str(work / "mixed"), "--robots", "fr5", "fr3", "meca_insertion",
             "--n-samples", "8", "--image-hw", "128", "128"]) == 0, "mixed generator")
        gen_s = time.perf_counter() - t0
        dream = lambda name: ["--robot", "dream", "--single-view", "--csv",  # noqa: E731
                              str(work / f"{name}.csv"), "--dream-dirs",
                              str(work / name / "panda_synth")]
        run = work / "dream_run"
        got, _ = _cli_train_run([*dream("dream_train"), "--workdir", str(run), "--epochs", "2",
                                 "--batch-size", "32", "--num-workers", "0", *TWIN_ARGV],
                                "DREAM twin, 2 epochs")
        _add_launches(launches, got)
        eval_argv = [*dream("dream_eval"), "--params", str(run / "best_params.npz"),
                     "--batch-size", "16", "--refine-pose", *TWIN_ARGV]
        _add_launches(launches, _cli_eval_run(eval_argv, "DREAM twin, float", "dream_refine"))
        _add_launches(launches, _cli_eval_run([*eval_argv, "--int8-backbone", "--int8-attention"],
                                              "DREAM twin, int8 + int8 attention",
                                              "dream_refine", layers=4))
        mixed, robots = work / "mixed", ("fr5", "fr3", "meca_insertion")
        prefix = {"fr3": "pose1"}
        mixed_argv = ["--robot", ",".join(robots), "--csv",
                      *(str(mixed / f"{r}.csv") for r in robots), "--calib-dir",
                      str(mixed / "calib"), "--aruco-summary",
                      *(str(mixed / f"{prefix.get(r, r)}_aruco_pose_summary.json")
                        for r in robots)]
        got, _ = _cli_train_run([*mixed_argv, "--workdir", str(work / "mixed_run"), "--epochs",
                                 "1", "--batch-size", "8", "--num-workers", "0", *TWIN_ARGV],
                                "fr5 + fr3 + meca, 1 epoch")
        _add_launches(launches, got)
        _add_launches(launches, _cli_eval_run(
            [*mixed_argv, "--params", str(work / "mixed_run" / "best_params.npz"),
             "--batch-size", "8", *TWIN_ARGV], "fr5 + fr3 + meca", None, pose=False))
    print(f"cli eval [{device['nvidia_smi']}]: small passes {time.perf_counter() - t0:.1f} s "
          f"(data written in {gen_s:.1f} s)")
    return launches


# The DINO checkpoint's path at d = 48 (`phase_dino_d48`): the synthetic
# trainer's single-view fr5 model at 128 px (192 wide, 4 layers, 4 heads of
# 48, LayerScale) with runs/synth_sv_frozen/dino_192x4.npz grafted and frozen.
DINO_192X4 = ROOT / "runs" / "synth_sv_frozen" / "dino_192x4.npz"
DINO_STEPS = 20
DINO_SERVE_SECONDS = 4.0
DINO_LAYERS = 4
# A tick of the single-view fr5 run served on 4 cameras: keypoints,
# confidences and the cameras' mean angles.
DINO_SERVE_OUTPUTS = ((4, 7, 2), (4, 7), (1, 6))
DINO_SERVE_KERNELS = ["peak_decode", "int8_quantize_v", "int8_matmul", "int8_quantize_rows"]


def phase_dino_d48(device: dict) -> dict:
    """The int8 attention at d = 48 end to end, from the DINO checkpoint:
      * `scripts/torch_train_synthetic.py --freeze-backbone --backbone-ckpt
        runs/synth_sv_frozen/dino_192x4.npz` for DINO_STEPS steps on the card
        (bf16): finite losses, a frozen backbone's drift of exactly 0, the
        run directory it writes (best_params.npz from `export_jax_params`
        beside model_config.json, the reference's layouts) with 4 heads of 48;
      * `cli serve --params RUN/best_params.npz --int8-backbone
        --int8-attention` on that directory (bf16) and on a copy whose
        model_config.json says float32: per tick 4 launches of the fused int8
        attention at d = 48 ("fused", then "fused_f32": the width counters),
        its values' quantization, the int8 GEMMs and row quantizations;
      * `cli eval --single-view --int8-backbone --int8-attention` of the run
        on a small fr5 set of `scripts/torch_make_mixed_synthetic.py`: the
        report's keys, finite values, the int8 attention at d = 48 at shapes
        phase_int8_attention holds;
      * `cli train --backbone-ckpt` of the same file into `cli train`'s
        192-wide, 4-layer ViT (3 heads of 64, as the reference's CLI
        reshapes it) on that set: at least one step, finite losses.
    -> launches."""
    launches: dict = {}
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = Path(work)
        run = work / "dino_run"
        _reset_launches()
        final = _script("torch_train_synthetic").main(
            ["--freeze-backbone", "--backbone-ckpt", str(DINO_192X4), "--steps", str(DINO_STEPS),
             "--batch", "16", "--image-size", "128", "--eval-every", str(DINO_STEPS),
             "--eval-batches", "1", "--workdir", str(run)])
        trained = _read_launches()
        records = [json.loads(line) for line in
                   (run / "logs" / "metrics.jsonl").read_text().splitlines()]
        check(final["frozen_backbone_max_drift"] == 0.0 and final["backbone_ckpt"]
              == str(DINO_192X4) and all(np.isfinite(r["loss"]) for r in records),
              f"DINO trainer: {final}, {records}")
        # The render a batch; the SVD kernel in its closing pose evaluation.
        check(trained["heatmap_render"] > 0 and trained["small_svd"] > 0 and
              sum(trained.values()) == trained["heatmap_render"] + trained["small_svd"],
              f"DINO trainer: launches {trained}")
        _add_launches(launches, trained)
        cfg, size, kind = cli_main.read_model_config(run / "best_params.npz")
        check(kind == "single_view" and size == 128 and cfg.vit.num_heads == 4
              and cfg.vit.hidden_size == 192 and cfg.vit.layerscale_init == 1e-5,
              f"DINO run directory: {kind}, {size}, {cfg.vit}")
        print(f"DINO trainer: {DINO_STEPS} steps, graft of {DINO_192X4.name} frozen (drift "
              f"{final['frozen_backbone_max_drift']}), losses {[r['loss'] for r in records]}; "
              f"{trained['heatmap_render']} render launches; run directory {kind}, {cfg.vit}")
        run_f32 = work / "dino_run_f32"
        with np.load(run / "best_params.npz") as data:
            flat = {k: data[k] for k in data.files}
        write_run_dir(run_f32, dataclasses.replace(
            cfg, vit=dataclasses.replace(cfg.vit, dtype="float32")), size, flat, kind)
        for label, r, route, kname in (("bf16", run, "fused", "int8_attention"),
                                       ("f32", run_f32, "fused_f32", "int8_attention_f32")):
            got = _serve(["--params", str(r / "best_params.npz"), "--int8-backbone",
                          "--int8-attention"], f"DINO d = 48, int8 + int8 attention, {label}",
                         [*DINO_SERVE_KERNELS, kname], DINO_SERVE_SECONDS, DINO_SERVE_OUTPUTS)
            at48 = int8_attention.width_launches[route, 48]
            check(at48 == got[kname] == DINO_LAYERS * got["peak_decode"] > 0,
                  f"DINO serve {label}: {at48} {route} launches at d = 48 of {got[kname]}, "
                  f"{got['peak_decode']} ticks")
            print(f"DINO serve [{label}]: {at48} launches of {kname} at d = 48 in "
                  f"{got['peak_decode']} ticks ({DINO_LAYERS} a tick)")
            _add_launches(launches, got)
        fr5 = work / "fr5"
        check(_script("torch_make_mixed_synthetic").main(
            ["--out-dir", str(fr5), "--robots", "fr5", "--n-samples", "20", "--image-hw", "128",
             "128"]) == 0, "fr5 generator")
        data = ["--robot", "fr5", "--single-view", "--csv", str(fr5 / "fr5.csv"), "--calib-dir",
                str(fr5 / "calib"), "--aruco-summary", str(fr5 / "fr5_aruco_pose_summary.json"),
                "--image-hw", "128", "128", "--device", "cuda"]
        got = _cli_eval_run([*data, "--params", str(run / "best_params.npz"), "--batch-size",
                             "16", "--int8-backbone", "--int8-attention"],
                            "DINO d = 48, fr5, int8 + int8 attention", "single_view",
                            layers=DINO_LAYERS)
        at48 = int8_attention.width_launches["fused", 48]
        check(at48 == got["int8_attention"] > 0,
              f"DINO eval: {at48} launches at d = 48 of {got['int8_attention']}")
        _add_launches(launches, got)
        cli_run = work / "cli_run"
        got, _ = _cli_train_run([*data, "--workdir", str(cli_run), "--epochs", "1",
                                 "--num-workers", "0",
                                 "--batch-size", "8", "--model-size", "128", "--hidden-size",
                                 "192", "--num-layers", "4", "--backbone-ckpt", str(DINO_192X4)],
                                "cli train --backbone-ckpt, 3 heads of 64")
        records = [json.loads(line) for line in
                   (cli_run / "logs" / "metrics.jsonl").read_text().splitlines()]
        check(records and records[-1]["step"] >= 1 and np.isfinite(records[-1]["loss"]),
              f"cli train --backbone-ckpt: {records}")
        print(f"cli train --backbone-ckpt: {records[-1]['step']} steps, loss "
              f"{records[-1]['loss']:.4f}, val loss {records[-1]['val_loss']:.4f}")
        _add_launches(launches, got)
    print(f"DINO d = 48 path [{device['nvidia_smi']}]: {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    t0 = time.perf_counter()
    device = phase_device()
    phase_build()
    measured = {**phase_peak_decode(), **phase_layernorm(), **phase_layernorm_int8(),
                **phase_int8_attention(), **phase_int8_matmul(), **phase_heatmap_render(),
                **phase_small_svd(), **phase_flash()}
    for name, extra in phase_f32().items():
        measured[name].update(extra)
    for name, by_width in phase_flash_widths().items():
        measured[name]["widths"] = by_width
    for name, by_width in phase_flash_f16().items():
        measured[name]["f16_widths"] = by_width
    phase_counters()
    phase_replay()
    launches = {"peak_decode": _serve([], "bf16", ["peak_decode"])["peak_decode"]
                + phase_serve_display() + phase_profile(device)}
    phase_cli_calibrate()
    phase_pose()
    # Pose recovery on the tick: 5 SVD launches a tick, 10 with refine.
    pose_launches = _serve(["--recover-pose"], "bf16 + pose", ["peak_decode", "small_svd"])
    check_pose_tick("bf16 + pose", pose_launches, 5)
    calibrated = phase_calibrated(device)
    flat = seed0_flat()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as run:  # ~350 MB of weights
        write_run_dir(run, FULL_LN, 512, flat)
        int8_launches = _serve(
            ["--params", str(Path(run) / "best_params.npz"), "--int8-backbone",
             "--int8-attention"], "int8 + fused LN", SERVE_KERNELS,
        )
        ln_launches = _serve(["--params", str(Path(run) / "best_params.npz")], "fused LN, bf16",
                             FUSED_LN_KERNELS)
        refine_launches = _serve(
            ["--params", str(Path(run) / "best_params.npz"), "--int8-backbone",
             "--int8-attention", "--recover-pose", "--refine-pose"],
            "int8 + fused LN + pose + refine", [*SERVE_KERNELS, "small_svd"],
            REFINE_SERVE_SECONDS)
    check_int8_tick("int8 serve", int8_launches, "int8_attention")
    check_int8_tick("int8 serve with pose and refine", refine_launches, "int8_attention")
    check_pose_tick("int8 serve with pose and refine", refine_launches, 10)
    launches.update({k: v for k, v in int8_launches.items() if k != "peak_decode"})
    launches["small_svd"] = (pose_launches["small_svd"] + refine_launches["small_svd"]
                             + calibrated["small_svd"])
    launches["peak_decode"] += pose_launches["peak_decode"] + calibrated["peak_decode"]
    # The bf16 fused-LN tick: norm1 and the final norm, the residual norm2.
    for name, per_tick in (("layernorm", 13), ("residual_layernorm", 12)):
        check(ln_launches[name] == per_tick * ln_launches["peak_decode"],
              f"fused-LN bf16 serve: {ln_launches[name]} {name} launches for "
              f"{ln_launches['peak_decode']} ticks, not {per_tick} each")
        launches[name] += ln_launches[name]
    gap_512 = phase_step(flat)
    serve_768 = phase_serve_768()
    phase_step_768(gap_512)
    del flat
    serve_768_f32 = phase_serve_768_f32()
    phase_step_768(gap_512, FULL_768_F32)
    launches["int8_attention_f32"] = phase_serve_int8_f32()["int8_attention_f32"]
    phase_small_reference()
    launches["heatmap_render"] = phase_train_step(device) + phase_trainer()
    geometric = phase_geometric_trainer()
    launches["heatmap_render"] += geometric["heatmap_render"]
    launches["small_svd"] += geometric["small_svd"]
    captured = phase_cli_train(device)
    _add_launches(captured, phase_cli_eval_small(device))
    dino = phase_dino_d48(device)  # every int8 attention of it at d = 48
    _add_launches(captured, dino)
    for name in ("heatmap_render", "peak_decode", "small_svd", "int8_matmul",
                 "int8_quantize_rows", "int8_attention", "int8_attention_f32", "int8_quantize_v"):
        launches[name] += captured.get(name, 0)
    for name, widths in (("int8_attention", "widths"), ("int8_attention_f32", "f32_widths")):
        for d, entry in measured[name][widths].items():
            entry["launches"] = dino[name] if d == "48" else 0  # no main path runs the others
    train_768 = phase_train_768()
    train_768_f32 = phase_train_768(UNFROZEN_768_F32, TRAIN_768_F32_GROUPS)
    phase_fusion()
    for name in ("peak_decode", "heatmap_render", *FLASH_KERNELS):
        launches[name] = (launches.get(name, 0) + serve_768[name] + serve_768_f32[name]
                          + train_768[name] + train_768_f32[name])
    # The f32 kernels' own source, and their launches on their main paths:
    # the forward's on the f32 768-px serve run, dK/dV's and dQ's on the f32
    # train steps.
    for name, runs in (("flash_fwd", serve_768_f32), ("flash_bwd_dkv", train_768_f32),
                       ("flash_bwd_dq", train_768_f32)):
        measured[name].update(f32_source="mvropose_torch/csrc/flash_attention_tf32.cu",
                              f32_launches=runs[name])
    check(all(launches[name] > 0 for name in KERNELS),
          f"a kernel with no main-path launches in the JSON line: {launches}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], **measured[name],
    } for name, (_, _, source, replaces) in KERNELS.items()]}))
    print(device["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
