"""CLIP text-guided training loss (port of
``pienerf_tpu.train.clip_guidance``; reference nerf/clip_utils.py, used by
the rand_pose mode, nerf/trainer.py:138-141,163-178).

The reference wraps OpenAI ``clip`` ViT-B/16 and minimises the negative
image-text cosine similarity of low-resolution frames rendered from random
orbit poses. The loss is defined by pretrained weights that are not
vendored here: the whole differentiable model (the vision ViT and the
text transformer, computed as Hugging Face's ``CLIPModel`` computes them,
so its checkpoints import directly) activates when a weight npz is at
``$PIENERF_CLIP_WEIGHTS`` or ``pienerf_tpu_torch/assets/clip_vit_b16.npz``.
Export the npz once from any machine with ``transformers``::

    import numpy as np
    from transformers import CLIPModel
    m = CLIPModel.from_pretrained("openai/clip-vit-base-patch16")
    np.savez("clip_vit_b16.npz",
             **{k: v.numpy() for k, v in m.state_dict().items()},
             __v_heads__=m.config.vision_config.num_attention_heads,
             __t_heads__=m.config.text_config.num_attention_heads)

Tokenising needs the CLIP vocabulary (not vendored either): pass
pre-tokenised ids to ``CLIPGuidance.prepare_text``, or a local tokenizer
directory for ``transformers.CLIPTokenizer`` (imported only then).

The matmuls and the attention are plain ``torch.matmul`` / ``einsum`` and
softmax in the JAX package's order (which computes them outside any Pallas
kernel); the patch embedding is ``F.conv2d``. ``resize_bilinear`` is
``jax.image.resize(..., "bilinear")``: JAX's triangle kernel, renormalised
at the borders and widened by the scale when it shrinks (antialias).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# CLIP preprocessing constants (reference nerf/clip_utils.py:24-27)
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "clip_vit_b16.npz")


def weights_path() -> Optional[str]:
    p = os.environ.get("PIENERF_CLIP_WEIGHTS", _DEFAULT_PATH)
    return p if os.path.exists(p) else None


def available() -> bool:
    return weights_path() is not None


# ---------------------------------------------------------------------------
# weight import (HF CLIPModel state-dict layout), numpy
# ---------------------------------------------------------------------------

def _layer(sd: Dict[str, np.ndarray], pre: str) -> Dict[str, np.ndarray]:
    def g(k):
        return np.asarray(sd[pre + k], np.float32)
    return {
        "ln1_g": g("layer_norm1.weight"), "ln1_b": g("layer_norm1.bias"),
        "q_w": g("self_attn.q_proj.weight"), "q_b": g("self_attn.q_proj.bias"),
        "k_w": g("self_attn.k_proj.weight"), "k_b": g("self_attn.k_proj.bias"),
        "v_w": g("self_attn.v_proj.weight"), "v_b": g("self_attn.v_proj.bias"),
        "o_w": g("self_attn.out_proj.weight"),
        "o_b": g("self_attn.out_proj.bias"),
        "ln2_g": g("layer_norm2.weight"), "ln2_b": g("layer_norm2.bias"),
        "fc1_w": g("mlp.fc1.weight"), "fc1_b": g("mlp.fc1.bias"),
        "fc2_w": g("mlp.fc2.weight"), "fc2_b": g("mlp.fc2.bias"),
    }


def import_hf_state_dict(sd: Dict[str, np.ndarray], v_heads: int,
                         t_heads: int) -> Dict:
    """Canonical params (numpy) from a ``transformers.CLIPModel`` state
    dict; ``weights.clip_to_torch`` puts them on a device."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def g(k):
        return np.asarray(sd[k], np.float32)

    n_v = len({k.split(".")[3] for k in sd
               if k.startswith("vision_model.encoder.layers.")})
    n_t = len({k.split(".")[3] for k in sd
               if k.startswith("text_model.encoder.layers.")})
    vision = {
        "class_emb": g("vision_model.embeddings.class_embedding"),
        "patch_w": g("vision_model.embeddings.patch_embedding.weight"),
        "pos_emb": g("vision_model.embeddings.position_embedding.weight"),
        # sic: the HF module is named `pre_layrnorm`
        "pre_ln_g": g("vision_model.pre_layrnorm.weight"),
        "pre_ln_b": g("vision_model.pre_layrnorm.bias"),
        "layers": [_layer(sd, f"vision_model.encoder.layers.{i}.")
                   for i in range(n_v)],
        "post_ln_g": g("vision_model.post_layernorm.weight"),
        "post_ln_b": g("vision_model.post_layernorm.bias"),
        "proj": g("visual_projection.weight"),
        "heads": v_heads,
    }
    text = {
        "tok_emb": g("text_model.embeddings.token_embedding.weight"),
        "pos_emb": g("text_model.embeddings.position_embedding.weight"),
        "layers": [_layer(sd, f"text_model.encoder.layers.{i}.")
                   for i in range(n_t)],
        "final_ln_g": g("text_model.final_layer_norm.weight"),
        "final_ln_b": g("text_model.final_layer_norm.bias"),
        "proj": g("text_projection.weight"),
        "heads": t_heads,
    }
    return {"vision": vision, "text": text}


def seeded_state_dict(seed: int, vision: Sequence[int],
                      text: Sequence[int], proj: int) -> Dict[str, np.ndarray]:
    """A ``transformers.CLIPModel`` state dict (numpy float32) drawn from a
    seed, for checks without the pretrained weights: ``vision`` = (layers,
    width, heads, mlp width, patch, image size), ``text`` = (layers, width,
    heads, mlp width, vocabulary, positions). Linear weights scale as
    width^-0.5, embeddings, biases and norm offsets as 0.1, so activations
    stay near unit size through any depth."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def r(*shape, sc=0.1):
        return rng.standard_normal(shape, np.float32) * np.float32(sc)

    def tower(pre, layers, h, inter):
        for i in range(layers):
            p = f"{pre}.encoder.layers.{i}."
            for nm in ("layer_norm1", "layer_norm2"):
                sd[p + nm + ".weight"] = 1 + r(h)
                sd[p + nm + ".bias"] = r(h)
            for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[p + "self_attn." + nm + ".weight"] = r(h, h, sc=h ** -0.5)
                sd[p + "self_attn." + nm + ".bias"] = r(h)
            sd[p + "mlp.fc1.weight"] = r(inter, h, sc=h ** -0.5)
            sd[p + "mlp.fc1.bias"] = r(inter)
            sd[p + "mlp.fc2.weight"] = r(h, inter, sc=inter ** -0.5)
            sd[p + "mlp.fc2.bias"] = r(h)

    vl, vh, _, vi, patch, img = vision
    tl, th, _, ti, vocab, npos = text
    v, t = "vision_model.", "text_model."
    sd[v + "embeddings.class_embedding"] = r(vh)
    sd[v + "embeddings.patch_embedding.weight"] = r(
        vh, 3, patch, patch, sc=(3 * patch * patch) ** -0.5)
    sd[v + "embeddings.position_embedding.weight"] = r(
        (img // patch) ** 2 + 1, vh)
    sd[v + "pre_layrnorm.weight"] = 1 + r(vh)
    sd[v + "pre_layrnorm.bias"] = r(vh)
    tower("vision_model", vl, vh, vi)
    sd[v + "post_layernorm.weight"] = 1 + r(vh)
    sd[v + "post_layernorm.bias"] = r(vh)
    sd["visual_projection.weight"] = r(proj, vh, sc=vh ** -0.5)
    sd[t + "embeddings.token_embedding.weight"] = r(vocab, th)
    sd[t + "embeddings.position_embedding.weight"] = r(npos, th)
    tower("text_model", tl, th, ti)
    sd[t + "final_layer_norm.weight"] = 1 + r(th)
    sd[t + "final_layer_norm.bias"] = r(th)
    sd["text_projection.weight"] = r(proj, th, sc=th ** -0.5)
    return sd


def load_weights(path: Optional[str] = None) -> Dict:
    """Canonical params (numpy) from an exported npz (the state dict and
    ``__v_heads__`` / ``__t_heads__``)."""
    path = path or weights_path()
    if path is None:
        raise FileNotFoundError(
            "CLIP weights not found; set $PIENERF_CLIP_WEIGHTS or place "
            "clip_vit_b16.npz under pienerf_tpu_torch/assets/ (export "
            "recipe in train/clip_guidance.py docstring)")
    with np.load(path) as z:
        sd = {k: z[k] for k in z.files if not k.startswith("__")}
        v_heads, t_heads = int(z["__v_heads__"]), int(z["__t_heads__"])
    return import_hf_state_dict(sd, v_heads, t_heads)


# ---------------------------------------------------------------------------
# forward (transformers.CLIPModel: pre-LN ViT, quick_gelu MLPs)
# ---------------------------------------------------------------------------

def _ln(x, g, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _attention(x, p, heads, causal=False):
    B, N, h = x.shape
    hd = h // heads
    scale = hd ** -0.5

    def proj(w, b):
        y = x @ w.T + b
        return y.reshape(B, N, heads, hd).transpose(1, 2)

    # HF CLIPAttention scales q before the product
    q = proj(p["q_w"], p["q_b"]) * scale
    k = proj(p["k_w"], p["k_b"])
    v = proj(p["v_w"], p["v_b"])
    att = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if causal:
        mask = torch.tril(torch.ones((N, N), dtype=torch.bool,
                                     device=x.device))
        att = torch.where(mask[None, None], att, float("-inf"))
    att = torch.softmax(att, dim=-1)
    y = torch.einsum("bhqk,bhkd->bhqd", att, v)
    y = y.transpose(1, 2).reshape(B, N, h)
    return y @ p["o_w"].T + p["o_b"]


def _encoder(x, layers, heads, causal=False):
    for p in layers:
        x = x + _attention(_ln(x, p["ln1_g"], p["ln1_b"]), p, heads,
                           causal=causal)
        h = _ln(x, p["ln2_g"], p["ln2_b"])
        h = _quick_gelu(h @ p["fc1_w"].T + p["fc1_b"])
        x = x + (h @ p["fc2_w"].T + p["fc2_b"])
    return x


def encode_image(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, S, S] preprocessed -> L2-normalised features [B, d]."""
    v = params["vision"]
    ps = v["patch_w"].shape[2]
    patches = F.conv2d(images, v["patch_w"], stride=ps)   # [B, h, g, g]
    B, h = patches.shape[:2]
    x = patches.reshape(B, h, -1).transpose(1, 2)          # [B, g*g, h]
    cls = v["class_emb"].expand(B, 1, h)
    x = torch.cat([cls, x], dim=1)
    x = x + v["pos_emb"][None]
    x = _ln(x, v["pre_ln_g"], v["pre_ln_b"])
    x = _encoder(x, v["layers"], v["heads"])
    pooled = _ln(x[:, 0], v["post_ln_g"], v["post_ln_b"])
    z = pooled @ v["proj"].T
    return z / torch.linalg.norm(z, dim=-1, keepdim=True)


def encode_text(params: Dict, ids: torch.Tensor,
                eos_token_id: Optional[int] = None) -> torch.Tensor:
    """ids [B, N] token ids -> L2-normalised features [B, d].

    The pooled token: with eos_token_id None, the argmax(ids) position
    (the EOT token has the largest id in the OpenAI CLIP vocabulary: the
    reference's ``clip`` package and HF checkpoints with the legacy
    eos_token_id=2 config); otherwise the first position equal to
    eos_token_id (transformers' later pooling)."""
    t = params["text"]
    ids = ids.long()
    x = t["tok_emb"][ids]
    x = x + t["pos_emb"][None, :x.shape[1]]
    x = _encoder(x, t["layers"], t["heads"], causal=True)
    x = _ln(x, t["final_ln_g"], t["final_ln_b"])
    if eos_token_id is None:
        pos = torch.argmax(ids, dim=-1)
    else:
        pos = torch.argmax((ids == eos_token_id).int(), dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), pos]
    z = pooled @ t["proj"].T
    return z / torch.linalg.norm(z, dim=-1, keepdim=True)


def resize_weights(in_size: int, out_size: int, device=None
                   ) -> torch.Tensor:
    """The [in, out] weight matrix of ``jax.image.resize``'s bilinear
    resize along one axis (jax/_src/image/scale.py ``compute_weight_mat``,
    antialiased, zero translation), in f32 as JAX computes it: the
    triangle kernel widened by in/out when shrinking, each column
    renormalised, columns whose sample lies outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    f32 = torch.float32
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * np.float32(inv_scale) - np.float32(0.0) - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32,
                                          device=device)[:, None]).abs()
    x = x / torch.tensor(kernel_scale, device=device)
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C] as ``jax.image.resize(...,
    "bilinear")``: separable weights along each axis whose size changes."""
    x = images
    if x.shape[1] != size:
        x = torch.einsum("bhwc,hi->biwc", x,
                         resize_weights(x.shape[1], size, x.device))
    if x.shape[2] != size:
        x = torch.einsum("bhwc,wj->bhjc", x,
                         resize_weights(x.shape[2], size, x.device))
    return x


def preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized, normalised [B, 3, S, S]
    (reference transform: Resize((224, 224)) + Normalize,
    clip_utils.py)."""
    x = resize_bilinear(images.float(), size)
    mean = torch.as_tensor(_MEAN, device=x.device)
    std = torch.as_tensor(_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def clip_loss(params: Dict, images: torch.Tensor, text_z: torch.Tensor,
              size: Optional[int] = None) -> torch.Tensor:
    """Negative mean image-text cosine similarity (reference
    nerf/clip_utils.py:41-58). images [B, H, W, 3] in [0, 1]; ``size``
    overrides the 224 input (the ViT is resolution-agnostic apart from
    its position embeddings, so tests use tiny towers)."""
    img_z = encode_image(params, preprocess(images, size or 224))
    return -(img_z * text_z).sum(dim=-1).mean()


class CLIPGuidance:
    """The reference's API (clip_utils.CLIPLoss): prepare_text once, then
    call with rendered images. Image-text mode only, as the reference's
    own __call__. ``params``: a numpy tree (``import_hf_state_dict``,
    ``load_weights``; default the weight file) or one of tensors; it goes
    onto ``device`` (default the card)."""

    def __init__(self, params: Optional[Dict] = None, device=None):
        from pienerf_tpu_torch.device import resolve_device
        from pienerf_tpu_torch.weights import clip_to_torch

        self.device = resolve_device(device)
        self.params = clip_to_torch(
            params if params is not None else load_weights(), self.device)
        self.text_z = None

    def prepare_text(self, texts: Optional[Sequence[str]] = None,
                     ids: Optional[np.ndarray] = None,
                     tokenizer_dir: Optional[str] = None) -> None:
        if ids is None:
            if tokenizer_dir is None:
                raise ValueError(
                    "pass pre-tokenized `ids` or a local `tokenizer_dir` "
                    "(the CLIP vocab is not vendored)")
            from transformers import CLIPTokenizer
            tok = CLIPTokenizer.from_pretrained(tokenizer_dir)
            ids = tok(list(texts), padding="max_length", max_length=77,
                      return_tensors="np")["input_ids"]
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        with torch.no_grad():
            self.text_z = encode_text(self.params, ids)

    def __call__(self, images: torch.Tensor,
                 size: Optional[int] = None) -> torch.Tensor:
        if self.text_z is None:
            raise RuntimeError("call prepare_text first")
        # with several prompts the reference picks one at random a call;
        # the mean keeps the loss deterministic
        return clip_loss(self.params, images, self.text_z, size=size)
