"""PiE-NeRF in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The twin of ``pienerf_tpu`` (JAX), which stays the reference: every ported
function is tested against its JAX original on the same numpy inputs.
This package imports neither JAX nor ``pienerf_tpu``.

Precision policy: float32 matmuls run in true f32, never TF32. The sim
contractions and the candidate fetch need it (a reduced-precision sim pass
diverges; a truncated candidate fetch smears the bend-reject boundary).
Only the field MLPs run in the spec's ``compute_dtype``, with f32
accumulation and a rounding back to that dtype after every layer.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
