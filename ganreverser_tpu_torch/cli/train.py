"""Adversarial G/D training CLI — train.lua, the counterpart of
ganreverser_tpu/cli/train.py, in its order and with its artifact names.

Resumes (``--network <ckpt>`` or ``latest``: the epoch after the saved one,
the same visualisation noise, the loss history continued, the
``--normalize`` statistics) or creates G3 + D2, warm-started from
``pretrained_<C>x<H>x<W>_nd<z>`` (G and D) or else from
``g_pretrained_...`` (G) unless ``--nopretraining``. Then per epoch:

  load N_epoch * batchSize / 2 * D_iterations fresh images (prefetched on a
  background thread and copied to the card while the previous epoch trains)
  -> <save>/images/{samples,best,worst}_<epoch>.png, D's sanity scores
     (G in evaluation; D's evaluation forward on kernel B6,
     models/fastpath.py::make_fast_discriminator)
  -> the epoch: per batch D_iterations D steps, G_iterations G steps
     (train/adversarial.py), losses and confusion counts kept on the card
     and read once at the end of the epoch
  -> losses + the confusion matrix printed, d_loss/g_loss/d_accuracy in
     <save>/events.jsonl, <save>/images/plot_loss.png
  -> the checkpoint <save>/adversarial every saveFreq epochs (and
     adversarial.step<E>, the newest --keep_history of them), with extra
     {"epoch", "plot_data", "normalize_mean", "normalize_std"}.

``epoch_time`` (mean seconds per epoch over 10) goes to the event file.
SIGTERM checkpoints at the end of the epoch and exits. On CUDA
(GANREVERSER_PLATFORM unset or gpu) kernel B6 runs; with
GANREVERSER_PLATFORM=cpu its plain version. ``--init`` picks the weight
init of fresh G and D (models/zoo.py); ``--profile_dir`` writes a
torch.profiler trace of epoch 2 there; ``--async_save`` writes the
checkpoints in a background thread (io/checkpoint.py); --prng is inert.

Several processes (``--coordinator_address/--num_processes/--process_id``
or torchrun) train one G/D pair on a ('data', 'model') mesh
(``--mesh_data``, ``--mesh_model``, parallel/): every rank loads the
epoch's images and draws the latents as one process would and trains on
its rows of each batch, the gradients averaged over 'data', so the run
equals the one-process run; a 'model' axis keeps each rank's slices of
the parameters and moments. Each checkpoint is gathered by every rank and
written by rank 0, which alone writes files; the per-epoch grids are
skipped in a multi-process run, as in the JAX package.

Usage: python -m ganreverser_tpu_torch.cli.train --dataset synthetic \\
           --height 64 --width 64 --noiseDim 100 --batchSize 256 \\
           --compute_dtype bfloat16 --epochs 3
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import parallel as par
from ..core.config import GanConfig
from ..core.prng import (PREVIEW_STAGE, noise_inputs, stage_generator,
                         trainer_generators)
from ..data.dataset import NORMALIZE_STATS, normalize_images
from ..data.prefetch import prefetch_to_device
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsWriter, StepTimer, profiler_trace
from ..io.preemption import PreemptionGuard
from ..models import bridge
from ..models.fastpath import make_fast_discriminator
from ..models.modules import set_dropout_generator
from ..train.adversarial import Confusion, make_epoch_program
from ..train.state import GanState, TrainState
from . import common


def visualize_progress(writer: MetricsWriter, rate, gs: GanState,
                       vis_noise: torch.Tensor, cfg, epoch: int,
                       train_data: torch.Tensor):
    """train.lua:268-319: grids of the 50 samples of the fixed noise, the
    50 best and 8 worst by D's score, and D's scores of a diagonal pattern
    and of the epoch's first real image. G runs in evaluation; D's two
    forwards run on ``rate`` (kernel B6)."""
    d_vars = bridge.module_variables(gs.d.module)
    with torch.no_grad():
        images = gs.g.module.eval()(vis_noise)
        if not bool(torch.isfinite(images).all()):
            print("<trainer> WARNING: generated images contain NaN/Inf "
                  "(train.lua:303-305 equivalent)")
        preds = rate(d_vars, images).reshape(-1).float().cpu().numpy()
        h, w, c = images.shape[1:]
        diag = torch.zeros((h, w, c), device=images.device)
        idx = torch.arange(min(h, w), device=images.device)
        diag[idx, idx] = 1.0
        sanity = torch.stack([diag, train_data[0].float()])
        sp = rate(d_vars, sanity).reshape(-1).float().cpu().numpy()
    order = np.argsort(-preds, kind="stable")
    rgb = common.to_nhwc_rgb(images, cfg.colorSpace)
    writer.image_grid("samples", rgb[:50], 5, 10, epoch)
    writer.image_grid("best", rgb[order[:50]], 5, 10, epoch)
    writer.image_grid("worst", rgb[order[::-1][:8]], 2, 4, epoch)
    writer.scalar("sanity_diag_pred", sp[0], step=epoch)
    writer.scalar("sanity_face_pred", sp[1], step=epoch)


def _warm_start(cfg, G, D, g_opt, d_opt, dims, device):
    """The pretrained G + D (train.lua:127-138), else fresh weights with the
    g_pretrained G (train.lua:148-157); only fresh weights with
    --nopretraining."""
    c, h, w = dims
    if not cfg.nopretraining:
        pt = ckpt.pretrained_name(cfg.save, c, h, w, cfg.noiseDim)
        if ckpt.exists(pt):
            tree = ckpt.load_checkpoint(pt)[0]
            print(f"<trainer> loaded pretrained G+D from {pt}")
            return GanState(
                g=TrainState.create(bridge.load_jax_variables(
                    G, tree["G"]).to(device), g_opt),
                d=TrainState.create(bridge.load_jax_variables(
                    D, tree["D"]).to(device), d_opt))
    gs = common.init_gan_state(cfg, G, D, device)
    if not cfg.nopretraining:
        gpt = ckpt.g_pretrained_name(cfg.G_pretrained_dir, c, h, w,
                                     cfg.noiseDim)
        if ckpt.exists(gpt):
            bridge.load_jax_variables(G, ckpt.load_checkpoint(gpt)[0])
            gs.g = TrainState.create(G, g_opt)
            print("<trainer> loading pretrained G...")
        else:
            print("<trainer> Note: Did not find pretrained G")
    return gs


def main(argv=None) -> dict:
    """Train G and D; returns the GAN state, the host records of this
    run's epochs (``epoch``, ``d_losses``, ``g_losses``, ``counts``), the
    loss history and the checkpoint path."""
    cfg = GanConfig.from_args(argv, "adversarial G/D training (train.lua)")
    started = common.maybe_distributed(cfg)
    try:
        return _train(cfg)
    finally:
        ckpt.wait_for_saves()  # join an in-flight async write before exit
        if started:
            par.shutdown_distributed()


def _train(cfg: GanConfig) -> dict:
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    print(f"<trainer> --prng {cfg.prng}: the port draws latents, dropouts "
          "and the visualisation noise from torch generators seeded by "
          "--seed, whatever --prng says")
    dataset = common.make_dataset(cfg)
    G, D, dims = common.build_gan_models(cfg, dtype)
    g_opt, d_opt = common.gan_optimizers(cfg)
    ckpt_path = ckpt.adversarial_name(cfg.save)

    if cfg.network == "latest":  # resume-from-latest convenience
        cfg.network = ckpt_path if ckpt.exists(ckpt_path) else ""
    epoch, vis_noise, plot_data, normalize_stats = 1, None, [], None
    if cfg.network:
        # resume (train.lua:110-125): the next epoch, the fixed vis noise
        path = (cfg.network if os.path.isdir(cfg.network)
                else os.path.join(cfg.save, cfg.network))
        tree, _, extra = ckpt.load_checkpoint(path)
        gs = common.gan_from_tree(tree, G, D, g_opt, d_opt, device)
        epoch = int(extra.get("epoch", 0)) + 1
        vis_noise = bridge.to_torch(tree["vis_noise_inputs"], device)
        # the loss history continues (the reference resets it on resume,
        # train.lua:203; the JAX package restores it)
        plot_data = list(extra.get("plot_data", []))
        if cfg.normalize and extra.get("normalize_mean") is not None:
            normalize_stats = (extra["normalize_mean"],
                               extra["normalize_std"])  # train.lua:117-119
        print(f"<trainer> reloaded network, continuing at epoch {epoch}")
    else:
        gs = _warm_start(cfg, G, D, g_opt, d_opt, dims, device)
    print(f"Number of free parameters in D: "
          f"{sum(p.numel() for p in gs.d.module.parameters())}")
    print(f"Number of free parameters in G: "
          f"{sum(p.numel() for p in gs.g.module.parameters())}")
    multi = par.mesh.world()[1] > 1
    mesh = None
    if common.wants_mesh(cfg):
        # dp: batches cut over 'data'; tp: big kernels over 'model'
        mesh = par.make_mesh(data=cfg.mesh_data, model=cfg.mesh_model)
        print(f"<trainer> mesh: {mesh.shape}")
        gs = common.place_gan_on_mesh(gs, mesh)

    if vis_noise is None:
        vis_noise = noise_inputs(stage_generator(cfg.seed, PREVIEW_STAGE,
                                                 device),
                                 100, cfg.noiseDim, cfg.noiseMethod,
                                 device=device)
    noise_gen, drop_gen = trainer_generators(cfg.seed, device)
    set_dropout_generator(gs.d.module, drop_gen)
    epoch_program = make_epoch_program(
        batch_size=cfg.batchSize, noise_dim=cfg.noiseDim,
        noise_method=cfg.noiseMethod, n_batches=cfg.N_epoch, dtype=dtype,
        d_iterations=cfg.D_iterations, g_iterations=cfg.G_iterations,
        d_l1=cfg.D_L1, d_l2=cfg.D_L2, g_l1=cfg.G_L1, g_l2=cfg.G_L2,
        d_clamp=cfg.D_clamp, g_clamp=cfg.G_clamp, d_optimizer=d_opt,
        g_optimizer=g_opt, mesh=mesh)
    rate = make_fast_discriminator(dims, dtype)

    writer = common.make_writer(cfg.save)
    timer = StepTimer(writer, log_every=10, tag="epoch_time")
    guard = PreemptionGuard()  # SIGTERM -> checkpoint + clean exit
    last_saved = None

    def save(completed_epoch):
        nonlocal last_saved
        last_saved = completed_epoch
        # every rank gathers (a collective with 'model' shards), then
        # only rank 0 writes
        tree = common.gan_to_tree(gs, {"vis_noise_inputs": vis_noise})
        if not par.is_main_process():
            return
        # train.lua:256's checkpoint: epoch, the loss history and the
        # normalisation statistics travel with the weights
        extra = {"epoch": completed_epoch, "plot_data": plot_data,
                 "normalize_mean": (normalize_stats[0] if normalize_stats
                                    else None),
                 "normalize_std": (normalize_stats[1] if normalize_stats
                                   else None)}
        saver = (ckpt.save_checkpoint_async if cfg.async_save
                 else ckpt.save_checkpoint)
        saver(ckpt_path, tree, config=cfg.to_dict(), extra=extra)
        if cfg.keep_history > 0:
            saver(f"{ckpt_path}.step{completed_epoch}", tree,
                  config=cfg.to_dict(), extra=extra, backup_old=False)
            ckpt.wait_for_saves()  # the step directory must exist first
            ckpt.retain(ckpt_path, cfg.keep_history)
        print(f"<trainer> saving network to {ckpt_path}")

    n_load = (cfg.N_epoch * cfg.batchSize // 2) * cfg.D_iterations

    def load(_):
        images = dataset.load_random_images(n_load)
        if cfg.normalize:
            # [0,1] -> [-1,1] (train.lua:217-218); kept quirk: G's sigmoid
            # output stays in [0, 1], as in the reference
            images = np.array(images, np.float32)
            normalize_images(images)
        return images

    data_iter = prefetch_to_device(load, -1, device=device)
    records = []
    try:
        while True:
            # the reference's inverted --epochs check stops at once
            # (train.lua:208); as in the JAX package it runs N epochs
            if 0 <= cfg.epochs < epoch:
                print("<trainer> Last epoch reached.")
                if last_saved != epoch - 1:
                    save(epoch - 1)
                break
            print(f"<trainer> Loading {n_load} new training images...")
            train_data = next(data_iter)
            if cfg.normalize:
                normalize_stats = NORMALIZE_STATS
            if not cfg.noplot and not multi:
                # a multi-process run renders no grids (JAX: they need
                # host fetches of global arrays); the sample CLI renders
                # rank 0's checkpoints
                visualize_progress(writer, rate, gs, vis_noise, cfg, epoch,
                                   train_data)

            confusion = Confusion.zero(device)
            with profiler_trace(cfg.profile_dir if epoch == 2 else None,
                                device):
                d_losses, g_losses = epoch_program(gs, confusion,
                                                   train_data, noise_gen)
            if mesh is not None:  # each rank counted its rows (summed in
                # f32, exact to 2^24, which every backend reduces)
                confusion.counts = par.psum(confusion.counts.float(),
                                            mesh).to(torch.int32)
            # the epoch's one host fetch
            host = torch.cat([
                d_losses, g_losses, d_losses.mean()[None],
                g_losses.mean()[None], confusion.total_valid[None],
                confusion.counts.reshape(-1).float()]).cpu()
            nd_, ng_ = d_losses.shape[0], g_losses.shape[0]
            d_mean, g_mean, acc = host[nd_ + ng_:nd_ + ng_ + 3].tolist()
            counts = host[-4:].to(torch.int32).reshape(2, 2)
            print(f"<trainer> Epoch #{epoch} [batchSize = {cfg.batchSize}] "
                  f"d_loss: {d_mean:.4f} g_loss: {g_mean:.4f}")
            print(Confusion(counts).render())  # adversarial.lua:199-203
            writer.scalar("d_loss", d_mean, step=epoch)
            writer.scalar("g_loss", g_mean, step=epoch)
            writer.scalar("d_accuracy", acc, step=epoch)
            plot_data.append([epoch, d_mean, g_mean, acc])
            if not cfg.noplot:
                writer.chart("plot_loss", plot_data,
                             ["epoch", "D loss", "G loss", "D acc"],
                             title="Adversarial training")
            timer.tick(epoch)
            records.append({"epoch": epoch,
                            "d_losses": host[:nd_].tolist(),
                            "g_losses": host[nd_:nd_ + ng_].tolist(),
                            "counts": counts.tolist()})

            if epoch % cfg.saveFreq == 0 or guard.should_stop:
                save(epoch)
            if guard.should_stop:
                break
            epoch += 1
    finally:
        data_iter.close()
        guard.restore()
        writer.close()
    return {"gs": gs, "epochs": records, "plot_data": plot_data,
            "checkpoint": ckpt_path, "vis_noise": vis_noise}


if __name__ == "__main__":
    main()
