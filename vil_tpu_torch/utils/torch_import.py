"""Import reference PyTorch checkpoints into the port's MsViT.

Counterpart of ``vil_tpu/utils/torch_import.py``, which maps a reference
``.pth`` (``{"net": state_dict, "arch", "epoch", "best_acc", ...}``, with
module names like ``layer1.0.proj.weight``) onto the flax tree. The port's
parameter names are the flax paths joined by ``.`` with ``kernel`` and
``scale`` named ``weight`` (``utils/jax_import.py``), and its layouts are
PyTorch's, the reference's own. So the mapping is that of the module
prefixes alone:

  reference module                  port module
  layer{k}.0                        stage{k}_patch_embed
  layer{k}.{1+2i}                   stage{k}_block{i}_attn
  layer{k}.{2+2i}                   stage{k}_block{i}_mlp
  norm / head                       norm / head

and one leaf: the performer's projection buffer, ``attn.projection_matrix``
on the port's module, lives under the reference's FastAttention submodule
(``attn.fast_attention.projection_matrix``, its performer.py:133), as
``vil_tpu`` maps it into its ``buffers`` collection.

with the reference's fuzzy-loading behaviours (its checkpoint.py:10-131), as
``vil_tpu`` keeps them: ``module.`` prefix stripping, a unique-suffix match
for a missing key, linear resize of the 1-D x/y position embeddings and of
the 2-D relative-position table on a shape mismatch (the arithmetic of
``jax.image.resize(..., "linear")``, antialiased when it shrinks),
classifier-head truncation, and leniency: a parameter with no match keeps
its value, with a warning.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a reference ``.pth`` file into {reference name: numpy array}."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "net" in blob:
        state = blob["net"]
    elif isinstance(blob, dict) and "model" in blob:
        state = blob["model"]
    else:
        state = blob
    out = {}
    for k, v in state.items():
        # strip DataParallel/DDP prefix (checkpoint.py:10-17)
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
    return out


# ---------------------------------------------------------------------------
# shape adaptation (checkpoint.py:20-41, applied at :98-117)
# ---------------------------------------------------------------------------
def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s linear method
    along one axis: a triangle kernel at half-pixel centres, widened by the
    shrink factor when shrinking (antialiasing), each column normalised."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize_pos_embed_1d(posemb: np.ndarray, shape_new: tuple) -> np.ndarray:
    """Linear resize of a (1, N, C) positional embedding along N."""
    w = _linear_weights(posemb.shape[1], shape_new[1])
    return np.einsum("bnc,nm->bmc", posemb.astype(np.float32), w)


def resize_pos_embed_2d(posemb: np.ndarray, shape_new: tuple) -> np.ndarray:
    """Linear resize of a flattened 2-D bias table (gs_old², nH) → (gs_new², nH)."""
    gs_old = int(np.sqrt(posemb.shape[0]))
    gs_new = int(np.sqrt(shape_new[0]))
    grid = posemb.astype(np.float32).reshape(gs_old, gs_old, -1)
    w = _linear_weights(gs_old, gs_new)
    out = np.einsum("yxh,yv,xu->vuh", grid, w, w)
    return out.reshape(gs_new * gs_new, -1)


def _adapt(name: str, value: np.ndarray, target_shape: tuple) -> Optional[np.ndarray]:
    """Reconcile a checkpoint tensor with the model's expected shape: resize
    position embeddings and relative-position tables, truncate the
    classifier head, otherwise skip (return None)."""
    if tuple(value.shape) == tuple(target_shape):
        return value
    if "x_pos_embed" in name or "y_pos_embed" in name:
        return resize_pos_embed_1d(value, target_shape)
    if "local_relative_position_bias_table" in name:
        return resize_pos_embed_2d(value, target_shape)
    if name.startswith("head.") and value.shape[0] > target_shape[0]:
        logger.warning("Truncating %s: %s -> %s", name, value.shape, target_shape)
        return value[: target_shape[0]]
    logger.warning("Skipping %s: ckpt %s vs model %s", name, value.shape, target_shape)
    return None


# ---------------------------------------------------------------------------
# structural key mapping
# ---------------------------------------------------------------------------
def reference_key(name: str) -> Optional[str]:
    """The reference state-dict name of the port's parameter ``name``, or
    None for a name outside the four module families."""
    top, _, rest = name.partition(".")
    m = re.match(r"stage(\d+)_patch_embed$", top)
    if m:
        prefix = f"layer{m.group(1)}.0"
    else:
        m = re.match(r"stage(\d+)_block(\d+)_(attn|mlp)$", top)
        if m:
            k, i, kind = int(m.group(1)), int(m.group(2)), m.group(3)
            prefix = f"layer{k}.{1 + 2 * i if kind == 'attn' else 2 + 2 * i}"
        elif top in ("norm", "head"):
            prefix = top
        else:
            return None
    if rest.rpartition(".")[2] == "projection_matrix":
        rest = rest[:-len("projection_matrix")] + "fast_attention.projection_matrix"
    return f"{prefix}.{rest}" if rest else prefix


@torch.no_grad()
def import_torch_checkpoint(state: Dict[str, np.ndarray], model: nn.Module) -> nn.Module:
    """Fill ``model``'s parameters and buffers (the performer's projections)
    in place from a reference state dict, casting to each
    one's dtype and device. Those with no match keep their values (with a
    warning), as the reference loads leniently."""
    used = set()
    missing = []
    for name, param in [*model.named_parameters(), *model.named_buffers()]:
        key = reference_key(name)
        if key is None:
            continue
        if key not in state:
            # fuzzy fallback: unique ckpt key with matching suffix
            # (align_and_update_state_dicts, checkpoint.py:44-131)
            cands = [k for k in state if k.endswith(key)]
            if len(cands) == 1:
                key = cands[0]
            else:
                missing.append(key)
                continue
        adapted = _adapt(key, state[key], tuple(param.shape))
        if adapted is None:
            continue
        param.copy_(torch.from_numpy(np.array(adapted, dtype=np.float32, order="C")))
        used.add(key)

    if missing:
        logger.warning("%d params not found in checkpoint: %s...", len(missing), missing[:8])
    unused = [k for k in state if k not in used and "relative_position_index" not in k
              and "calls_since_last_redraw" not in k]
    if unused:
        logger.info("%d checkpoint tensors unused: %s...", len(unused), unused[:8])
    return model


def load_into_model(path: str, model: nn.Module) -> nn.Module:
    """Convenience: .pth file → ``model`` filled in place."""
    return import_torch_checkpoint(load_torch_state_dict(path), model)
