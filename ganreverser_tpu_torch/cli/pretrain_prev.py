"""Net2net distillation pretraining CLI — pretrain_with_previous_net.lua,
the counterpart of ganreverser_tpu/cli/pretrain_prev.py, in its order and
with its artifact names.

Loads a previous {G, D} checkpoint (its noiseDim, noiseMethod, colorSpace,
height and width from the config saved with it) and trains a fresh G3 and
D2 at this run's geometry, noise dimension and colour space. Per batch:

  prev_z, new_z (shared leading components copied) from the noise stream
  -> G_prev's images (its fast evaluation forward: kernel U for stage 1,
     U's fused head for stage 2 and the output conv), to the host, into
     the new colour space and size -> the G step, MSE against them
  -> half real images, half G_prev's -> in D_prev's colour space and size
     -> D_prev's soft predictions (its fast evaluation forward, kernel B6)
     -> the D step, BCE against them
  -> every 10 batches "<batch i of N> loss G: .., loss D: .." and
     distill_g_loss / distill_d_loss in <save>/events_pretrain_prev.jsonl
  -> every saveFreq batches, and at the end, the checkpoint
     <save>/pretrained_<C>x<H>x<W>_nd<z> ({"G", "D"} train states, extra
     {"batches"}), which ``train`` warm-starts from.

The JAX CLI applies the module G_prev and D_prev in evaluation; the port
runs the fast forwards on the same weights (ROADMAP.md, queue C). The
colour-space and resize hop stays on the host, as in the JAX CLI. On CUDA
(GANREVERSER_PLATFORM unset or gpu) the kernels launch; with
GANREVERSER_PLATFORM=cpu their plain versions run.

Usage: python -m ganreverser_tpu_torch.cli.pretrain_prev --network \\
           logs/adversarial --dataset synthetic --height 64 --width 64 \\
           --colorSpace yuv --noiseDim 100 --N_batches 1000
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import PretrainPrevConfig
from ..core.prng import INIT_STAGE, stage_generator, trainer_generators
from ..data.colorspace import switch_colorspace
from ..data.dataset import resize_bilinear
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsWriter
from ..models import bridge, zoo
from ..models.fastpath import make_fast_discriminator, make_fast_generator
from ..models.modules import init_parameters, set_dropout_generator
from ..optim import adam
from ..train.pretrain_distill import (make_distill_d_step,
                                      make_distill_g_step, paired_noise)
from ..train.state import TrainState
from . import common


def _resize_batch(images: np.ndarray, h: int, w: int) -> np.ndarray:
    """NHWC f32 images resized bilinearly on the host when the geometry
    differs (f32 throughout: negative YUV chroma survives)."""
    if images.shape[1] == h and images.shape[2] == w:
        return images
    return resize_bilinear(np.ascontiguousarray(images, np.float32), h, w)


def main(argv=None) -> dict:
    """Distil; returns the host losses of every batch and the checkpoint
    path."""
    cfg = PretrainPrevConfig.from_args(
        argv, "net2net distillation pretraining "
              "(pretrain_with_previous_net.lua)")
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    dataset = common.make_dataset(cfg)
    dims = cfg.img_dims()
    c, h, w = dims

    # the previous nets and their geometry (pretrain_with_previous_net.lua:
    # 94-110)
    prev_tree, prev_cfg, _ = ckpt.load_checkpoint(cfg.network)
    prev_nd = prev_cfg["noiseDim"]
    prev_method = prev_cfg["noiseMethod"]
    prev_cs = prev_cfg["colorSpace"]
    prev_h, prev_w = prev_cfg["height"], prev_cfg["width"]
    prev_dims = (1 if prev_cs == "y" else 3, prev_h, prev_w)
    gp_vars = bridge.to_torch({"params": prev_tree["G"]["params"],
                               "state": prev_tree["G"]["state"]}, device)
    dp_vars = bridge.to_torch({"params": prev_tree["D"]["params"],
                               "state": prev_tree["D"]["state"]}, device)
    g_prev = make_fast_generator(prev_dims, prev_nd, dtype, fused_head=True)
    d_prev = make_fast_discriminator(prev_dims, dtype)

    gen = stage_generator(cfg.seed, INIT_STAGE, "cpu")  # G's weights, then D's
    G = init_parameters(zoo.create_G(dims, cfg.noiseDim, dtype), gen)
    D = init_parameters(zoo.create_D(dims, dtype), gen)
    g_ts = TrainState.create(G.to(device), adam())
    d_ts = TrainState.create(D.to(device), adam())
    noise_gen, drop_gen = trainer_generators(cfg.seed, device)
    set_dropout_generator(D, drop_gen)

    g_step = make_distill_g_step(dtype=dtype, g_l1=cfg.G_L1, g_l2=cfg.G_L2,
                                 g_clamp=cfg.G_clamp)
    d_step = make_distill_d_step(dtype=dtype, d_l1=cfg.D_L1, d_l2=cfg.D_L2,
                                 d_clamp=cfg.D_clamp)
    writer = MetricsWriter(cfg.save, name="events_pretrain_prev")
    ckpt_path = ckpt.pretrained_name(cfg.save, c, h, w, cfg.noiseDim)

    def save():
        tree = {"G": common.ts_to_tree(g_ts), "D": common.ts_to_tree(d_ts)}
        ckpt.save_checkpoint(ckpt_path, tree, config=cfg.to_dict(),
                             extra={"batches": g_ts.step})
        print(f"<trainer> saving network to {ckpt_path}")

    half = cfg.batchSize // 2
    g_losses, d_losses = [], []
    try:
        for i in range(1, cfg.N_batches + 1):
            prev_z, new_z = paired_noise(noise_gen, cfg.batchSize,
                                         cfg.noiseDim, cfg.noiseMethod,
                                         prev_nd, prev_method, device)
            # G_prev's images -> the new geometry and colour space (the
            # host hop of pretrain_with_previous_net.lua:167)
            with torch.no_grad():
                gp = g_prev(gp_vars, prev_z)
            gp_imgs = switch_colorspace(gp.float().cpu().numpy(), prev_cs,
                                        cfg.colorSpace)
            gp_imgs = _resize_batch(gp_imgs, h, w)
            g_losses.append(g_step(g_ts, new_z,
                                   torch.from_numpy(gp_imgs).to(device)))

            # D's batch: half real, half G_prev's (lua:161-183); D_prev
            # sees its own colour space and geometry (lua:182)
            real = dataset.load_random_images(half)
            d_inputs = np.concatenate([real, gp_imgs[:half]])
            d_prev_in = _resize_batch(
                switch_colorspace(d_inputs, cfg.colorSpace, prev_cs),
                prev_h, prev_w)
            with torch.no_grad():
                soft = d_prev(dp_vars, torch.from_numpy(
                    np.ascontiguousarray(d_prev_in)).to(device)).reshape(-1)
            d_losses.append(d_step(d_ts, torch.from_numpy(d_inputs).to(
                device), soft))

            if i % 10 == 0:
                gl, dl = float(g_losses[-1]), float(d_losses[-1])
                print(f"<batch {i} of {cfg.N_batches}> loss G: {gl:.4f}, "
                      f"loss D: {dl:.4f}")
                writer.scalar("distill_g_loss", gl, step=i)
                writer.scalar("distill_d_loss", dl, step=i)
            if i % cfg.saveFreq == 0:
                save()
        save()
    finally:
        writer.close()
    host = (torch.stack(g_losses + d_losses).cpu().tolist() if g_losses
            else [])
    n = len(g_losses)
    return {"g_losses": host[:n], "d_losses": host[n:],
            "checkpoint": ckpt_path}


if __name__ == "__main__":
    main()
