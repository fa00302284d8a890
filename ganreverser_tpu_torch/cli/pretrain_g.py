"""Autoencoder pretraining CLI — pretrain_g.lua, the counterpart of
ganreverser_tpu/cli/pretrain_g.py, in its order and with its artifact
names.

Trains G_encoder then G3 (the decoder) as an autoencoder (MSE
reconstruction, adam or adagrad, the L1 -> L2 -> clamp penalties) on real
images and saves the decoder only as ``<save>/g_pretrained_<C>x<H>x<W>_nd<z>``
(pretrain_g.lua:85-89, 148-180, 191-202), with extra ``{"epoch",
"plot_data"}``; ``train`` warm-starts G from that file. Per epoch:

  load N_epoch * batchSize fresh images -> N_epoch steps
  -> "<trainer> last batch loss", ae_loss in <save>/events_pretrain_g.jsonl,
     <save>/images_pretrain_g/plot_g_loss.png and ae_recon_<epoch>.png
     (32 images over their reconstructions) unless --noplot
  -> the checkpoint every saveFreq epochs, and after the last epoch.

``--network`` resumes the decoder (and the loss history) from a
g_pretrained checkpoint of either package; the encoder starts fresh, since
the file holds the decoder only. ``--epochs`` counts epochs as the JAX
package does (the reference's inverted check is fixed). On CUDA
(GANREVERSER_PLATFORM unset or gpu) the run is on the card; with
GANREVERSER_PLATFORM=cpu on the CPU.

Usage: python -m ganreverser_tpu_torch.cli.pretrain_g --dataset synthetic \\
           --height 64 --width 64 --epochs 2 --compute_dtype bfloat16
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import PretrainGConfig
from ..core.prng import INIT_STAGE, stage_generator
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsWriter
from ..models import bridge, zoo
from ..models.modules import init_parameters
from ..optim import adagrad, adam
from ..train.pretrain_ae import (decoder_variables, make_ae_train_step,
                                 make_autoencoder)
from ..train.state import TrainState
from . import common


def main(argv=None) -> dict:
    """Pretrain; returns the autoencoder's train state, the last batch
    loss of each epoch, the loss history and the checkpoint path."""
    cfg = PretrainGConfig.from_args(argv, "autoencoder G pretraining "
                                          "(pretrain_g.lua)")
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    dataset = common.make_dataset(cfg)
    dims = cfg.img_dims()
    c, h, w = dims

    AE = make_autoencoder(zoo.create_G_encoder(dims, cfg.noiseDim, dtype),
                          zoo.create_G(dims, cfg.noiseDim, dtype))
    init_parameters(AE, stage_generator(cfg.seed, INIT_STAGE, "cpu"))
    resumed_plot_data: list = []
    if cfg.network:
        # the decoder and its loss history from a g_pretrained checkpoint
        # (the reference declares --network but never reads it,
        # pretrain_g.lua:16; the JAX package resumes the decoder)
        dec_tree, _, net_extra = ckpt.load_checkpoint(cfg.network)
        bridge.load_jax_variables(AE.l1, dec_tree)
        resumed_plot_data = list(net_extra.get("plot_data", []))
        print(f"<trainer> resumed decoder from {cfg.network} "
              "(fresh encoder)")
    opt = adagrad() if cfg.G_optmethod == "adagrad" else adam()
    ts = TrainState.create(AE.to(device), opt)
    print(f"Number of free parameters in G (total): "
          f"{sum(p.numel() for p in AE.parameters())}")

    step = make_ae_train_step(dtype=dtype, g_l1=cfg.G_L1, g_l2=cfg.G_L2,
                              g_clamp=cfg.G_clamp, opt=opt)
    writer = MetricsWriter(cfg.save, name="events_pretrain_g")
    ckpt_path = ckpt.g_pretrained_name(cfg.save, c, h, w, cfg.noiseDim)
    last_saved = None
    # [epoch, loss] rows (PLOT_DATA, pretrain_g.lua:239-244), continued
    # past the resumed tail (the epoch counter restarts at 1)
    plot_data = resumed_plot_data
    plot_base = int(plot_data[-1][0]) if plot_data else 0
    losses = []

    def save(epoch):
        nonlocal last_saved
        ckpt.save_checkpoint(ckpt_path, decoder_variables(AE),
                             config=cfg.to_dict(),
                             extra={"epoch": epoch + 1,
                                    "plot_data": plot_data})
        last_saved = epoch
        print(f"<trainer> saving network to {ckpt_path}")

    epoch = 1
    try:
        while True:
            if 0 <= cfg.epochs < epoch:  # the fixed inverted check
                print("<trainer> Last epoch reached.")
                break
            print(f"<trainer> Epoch {epoch}")
            data = dataset.load_random_images(cfg.N_epoch * cfg.batchSize)
            if data.shape[0] < cfg.batchSize:
                raise SystemExit(
                    f"Dataset holds only {data.shape[0]} images — need at "
                    f"least one full batch of {cfg.batchSize}")
            data = torch.from_numpy(np.ascontiguousarray(data)).to(device)
            loss = None
            for b in range(cfg.N_epoch):
                batch = data[b * cfg.batchSize:(b + 1) * cfg.batchSize]
                if batch.shape[0] < cfg.batchSize:
                    break
                loss = step(ts, batch)
            last = float(loss)  # the epoch's one host fetch of a loss
            losses.append(last)
            print(f"<trainer> last batch loss: {last:.4f}")
            writer.scalar("ae_loss", last, step=epoch)
            plot_data.append([plot_base + epoch, last])
            if not cfg.noplot:
                # pretrain_g.lua:244's 'G Loss' window, as a PNG
                writer.chart("plot_g_loss", plot_data, ["epoch", "G Loss"],
                             title="G Loss", subdir="images_pretrain_g")
                sample = data[:32]
                with torch.no_grad():
                    out = AE.eval()(sample)
                both = np.concatenate([
                    common.to_nhwc_rgb(sample, cfg.colorSpace),
                    common.to_nhwc_rgb(out, cfg.colorSpace)])
                writer.image_grid("ae_recon", both, 8, 8, epoch,
                                  subdir="images_pretrain_g")
            if epoch % cfg.saveFreq == 0:
                save(epoch)
            epoch += 1
        if last_saved != epoch - 1:
            save(epoch - 1)
    finally:
        writer.close()
    return {"ts": ts, "losses": losses, "plot_data": plot_data,
            "checkpoint": ckpt_path}


if __name__ == "__main__":
    main()
