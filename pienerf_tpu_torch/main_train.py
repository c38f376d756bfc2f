"""Train a radiance field from posed images (port of main_train.py).

    python -m pienerf_tpu_torch.main_train --path data/lego -O \\
        --workspace model/lego --iters 30000

Reads a blender (``transforms_{train,val}.json`` and PNGs) or colmap
(``transforms.json``) dataset, trains with the reference's recipe (the
JAX trainer's flags; ``--backbone mlp`` trains the interactive Fourier
net through the hierarchical renderer, the default hashgrid through the
occupancy march), evaluates on the val split when there is one, and writes
checkpoints (``{workspace}/checkpoints/ngp_ep*.npz``, the JAX package's
format), ``point_cloud.ply`` (a 256^3 density grid, as the reference) and
``train_losses.npy`` (every step's loss). Runs on the card; ``--device
cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    from pienerf_tpu_torch.config import get_shared_opts
    cfg = get_shared_opts(parser, argv)
    ns, _ = parser.parse_known_args(argv)

    from pienerf_tpu_torch.data.provider import NeRFDataset
    from pienerf_tpu_torch.train.trainer import Trainer

    train_ds = NeRFDataset(cfg, type="train")
    try:
        valid_ds = NeRFDataset(cfg, type="val", downscale=1)
    except (FileNotFoundError, NotImplementedError):
        valid_ds = None

    trainer = Trainer("ngp", cfg, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt, device=ns.device)
    trainer.mark_untrained_grid(train_ds.poses, train_ds.intrinsics)
    trainer.train(train_ds, valid_ds, max_iters=cfg.iters)
    np.save(os.path.join(cfg.workspace, "train_losses.npy"),
            np.asarray(trainer.loss_history, np.float32))

    if valid_ds is not None:
        psnr = trainer.evaluate(valid_ds)
        trainer.log(f"[final eval] PSNR={psnr:.3f}")

    # a density point cloud next to the checkpoints (reference
    # main_train.py:101)
    trainer.save_point_cloud(
        os.path.join(cfg.workspace, "point_cloud.ply"), resolution=256)


if __name__ == "__main__":
    main()
