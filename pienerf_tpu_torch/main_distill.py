"""Distill a hashgrid checkpoint into the interactive mlp backbone (port
of main_distill.py).

    python -m pienerf_tpu_torch.main_distill --workspace model/chair \\
        --steps 4000 --student_width 128
    # then: python -m pienerf_tpu_torch.main_gui --workspace model/chair \\
    #     --backbone mlp ...

Loads the workspace's hashgrid field as the trainer does (``--ckpt``),
distills its EMA weights into an mlp student (``train/distill.py``), logs
the field-space agreement, and writes the student as the workspace's next
``ngp_ep*.npz``, so that ``main_gui --ckpt latest`` serves it. Runs on
the card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import copy


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--distill_lr", type=float, default=5e-3)
    parser.add_argument("--student_width", type=int, default=64,
                        choices=(64, 128),
                        help="student MLP width: 64, or 128 with 10 "
                             "Fourier frequencies (the wide student)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    from pienerf_tpu_torch.config import get_shared_opts
    cfg = get_shared_opts(parser, argv)
    ns, _ = parser.parse_known_args(argv)

    from pienerf_tpu_torch.train import distill
    from pienerf_tpu_torch.train.trainer import Trainer
    from pienerf_tpu_torch.weights import field_to_numpy

    teacher = Trainer("ngp", cfg, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt, device=ns.device)
    if teacher.spec.backbone != "hashgrid":
        raise SystemExit("--workspace must hold a hashgrid checkpoint "
                         "(the mlp backbone is already interactive)")

    student, s_spec, loss = distill.distill(
        teacher.state.ema_params, teacher.spec, steps=ns.steps,
        batch=ns.batch, lr=ns.distill_lr, log_fn=teacher.log,
        student_width=ns.student_width)
    diag = distill.field_agreement(teacher.state.ema_params, teacher.spec,
                                   student, s_spec)
    teacher.log(f"[distill] agreement: {diag}")

    # an mlp-backbone checkpoint the viewer loads; numbered after the
    # teacher's newest, so that --ckpt latest picks it and the teacher's
    # files stay
    cfg2 = copy.copy(cfg)
    cfg2.backbone = "mlp"
    out = Trainer("ngp", cfg2, spec=s_spec, workspace=cfg.workspace,
                  use_checkpoint="scratch", device=ns.device)
    tree = field_to_numpy(student)
    out._set_fields(tree, tree)
    out.global_step = teacher.global_step
    out.epoch = teacher.epoch
    path = out.save_checkpoint()
    print(f"[distill] wrote mlp checkpoint: {path}")


if __name__ == "__main__":
    main()
