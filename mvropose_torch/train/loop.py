"""Epoch-level training orchestrator: port of `mvropose_tpu/train/loop.py:36` `fit`.

The epoch loop, validation, metric logging, best-model export and full-state
checkpoints. Resume restores the newest checkpoint and continues at its
epoch. Each epoch's dropout masks come from a generator seeded by (seed,
epoch), the reference's `fold_in(PRNGKey(seed), epoch)`, so a resumed run
draws what an uninterrupted one would. The step metrics stay device tensors
until the epoch's end, so no step waits for the device.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from mvropose_torch.geometry.heatmap import argmax_decode
from mvropose_torch.train.checkpoint import CheckpointManager, CheckpointMeta, save_params_npz
from mvropose_torch.train.metrics import pck_at_k
from mvropose_torch.train.state import TrainConfig, TrainState
from mvropose_torch.utils.metrics_writer import MetricWriter

VAL_KEYS = ("loss", "loss_kpt", "loss_ang")


@dataclasses.dataclass
class FitResult:
    best_val_loss: float
    epochs_run: int


def epoch_generator(seed: int, epoch: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` seeded by (seed, epoch, stream) alone: stream
    0 draws an epoch's dropout masks, 1 its augmentation."""
    key = int(np.random.SeedSequence([seed, epoch, stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device).manual_seed(key)


def val_pck5(out: dict, batch: dict) -> torch.Tensor:
    """PCK@5 heatmap pixels of the argmax decodes against the argmax of the
    GT maps, over the keypoints that count: a real view (multi-view
    `view_mask`) or a sample of weight > 0 (single-view `sample_weight`),
    and a GT map whose peak is above 0.1 (a zero map is a padded channel)."""
    pred_xy, _ = argmax_decode(out["pred_heatmaps"].float())
    gt_xy, _ = argmax_decode(batch["heatmaps"])
    valid = batch["heatmaps"].amax(dim=(-2, -1)) > 0.1
    if batch.get("view_mask") is not None:
        valid = valid & batch["view_mask"][..., None]
    elif batch.get("sample_weight") is not None:
        valid = valid & (batch["sample_weight"][:, None] > 0)
    return pck_at_k(pred_xy, gt_xy, k_px=5.0, valid=valid)


def _means(metrics: list[dict], keys) -> dict:
    """Per key the mean over the list, one host copy for all of them (f64)."""
    if not metrics:
        return {k: float("nan") for k in keys}
    table = torch.stack([torch.stack([m[k].float() for k in keys]) for m in metrics])
    return dict(zip(keys, table.cpu().double().mean(dim=0).tolist()))


def fit(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    train_batches: Callable[[int], Iterable],  # epoch -> iterable of device batches
    val_batches: Callable[[], Iterable],
    cfg: TrainConfig,
    workdir: str | Path,
    metric_writer: MetricWriter,
    seed: int = 0,
    on_epoch_end: Optional[Callable] = None,
) -> FitResult:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ckpt = CheckpointManager(workdir / "ckpt")
    device = next(state.model.parameters()).device

    meta = ckpt.restore(state)  # the whole state, the optimizer's included
    start_epoch, best_val = (0, float("inf")) if meta is None else (meta.epoch, meta.best_val_loss)
    epochs_run = 0
    try:
        for epoch in range(start_epoch, cfg.num_epochs):
            epochs_run += 1
            gen = epoch_generator(seed, epoch, device)
            t0 = time.time()
            train_metrics = [train_step(state, batch, gen) for batch in train_batches(epoch)]
            train_avg = _means(train_metrics, list(train_metrics[0]) if train_metrics else [])

            val_metrics, pcks = [], []
            for batch in val_batches():
                out = eval_step(state, batch)
                val_metrics.append({k: out[k] for k in VAL_KEYS})
                pcks.append({"pck5": val_pck5(out, batch)})
            val_avg = {f"val_{k}": v for k, v in _means(val_metrics, VAL_KEYS).items()}
            val_avg["val_pck5"] = _means(pcks, ["pck5"])["pck5"]

            record = {"epoch": epoch + 1, "epoch_time_s": time.time() - t0}
            record.update(train_avg)
            record.update(val_avg)
            metric_writer.write(state.step, record)

            val_loss = val_avg["val_loss"]
            if np.isfinite(val_loss) and val_loss < best_val:
                best_val = val_loss
                save_params_npz(workdir / "best_params.npz", state.model)
            ckpt.save(state.step, state, CheckpointMeta(epoch=epoch + 1, best_val_loss=best_val))

            if on_epoch_end is not None:
                on_epoch_end(epoch, state, record)
    finally:
        ckpt.wait()  # an interrupted run still leaves the checkpoint it started
    return FitResult(best_val_loss=best_val, epochs_run=epochs_run)
