"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(requested: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Return the device to run on.

    ``None`` or ``"cuda"`` means the card, and raises when CUDA is absent
    (nothing falls back to the CPU quietly). ``"cpu"`` is the only way onto
    the CPU; the tests use it.
    """
    dev = torch.device(requested if requested is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
