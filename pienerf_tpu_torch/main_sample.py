"""Sample a physics point cloud from a trained field (port of
main_sample.py).

    python -m pienerf_tpu_torch.main_sample --workspace model/lego \\
        --exp_name lego --sub_res 256 --density_threshold 0.05

Loads the workspace's field as the trainer picks it (``--ckpt``: ``latest``
the newest ``ngp_ep*.npz``, or a file), refuses a workspace with no
checkpoint, samples its EMA weights (``sample.AdaptiveUniformSampling``)
and writes ``model/<workspace basename>/<exp_name>.ply`` under the current
directory. Runs on the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    from pienerf_tpu_torch.config import get_shared_opts
    cfg = get_shared_opts(parser, argv)
    ns, _ = parser.parse_known_args(argv)

    from pienerf_tpu_torch.sample import AdaptiveUniformSampling
    from pienerf_tpu_torch.train.trainer import Trainer

    trainer = Trainer("ngp", cfg, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt, device=ns.device)
    if trainer.global_step == 0:
        raise SystemExit(f"no checkpoint found under {cfg.workspace}")

    out_dir = os.path.join("model",
                           os.path.basename(cfg.workspace.rstrip("/")))
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{cfg.exp_name}.ply")

    sampler = AdaptiveUniformSampling(cfg, trainer.state.ema_params,
                                      trainer.spec)
    res = sampler.sample(write_path=out)
    print(f"{res['points'].shape[0]} points -> {os.path.abspath(out)}")
    print("annotate pin/lam/mu/mass attributes before simulation "
          "(see README)")
    return out


if __name__ == "__main__":
    main()
