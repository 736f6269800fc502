"""SigLIP2 NaFlex vision tower: native aspect ratio, variable resolution.

The reference serves only the fixed-resolution checkpoint
(image_database.py:193); the SigLIP2 family also ships NaFlex variants
(`google/siglip2-*-patch16-naflex`) that keep each image's aspect ratio by
patchifying at a per-image (h, w) grid with h*w <= max_num_patches. HF's
``Siglip2VisionModel`` is the oracle (tests/test_naflex.py).

Static-shape discipline (one compiled program per batch shape): a batch is
  patches        (B, L, P*P*C)  L = max_num_patches, zero-padded
  pixel_mask     (B, L)         1 = real patch
  spatial_shapes (B, 2)         per-image (h, w) patch grid, h*w <= L
and variable resolution is expressed entirely through masks and dynamic
*values* (never dynamic shapes), so one compiled program serves every
aspect ratio — no per-shape recompilation, unlike a naive port of HF's
per-image ``F.interpolate`` loop.

Position embeddings: the checkpoint stores a square S x S grid
(S = sqrt(L)); each image needs it resized to its (h, w) with bilinear
antialiasing (HF: ``F.interpolate(..., mode="bilinear", antialias=True,
align_corners=False)``). Because the source grid is tiny (S = 16), we
compute the FULL S-tap antialiased triangle-filter weights for every output
slot with traced arithmetic and contract them against the grid — exact to
fp32 and free of data-dependent control flow.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from tpuclip.models.configs import SiglipConfig, VisionConfig
from tpuclip.models.siglip import (
    Params,
    dense,
    encoder,
    layer_norm,
    map_head,
)


def _axis_weights(src: int, dst: jnp.ndarray, out_idx: jnp.ndarray) -> jnp.ndarray:
    """Antialiased bilinear weights for resizing a length-``src`` axis to a
    (dynamic) length ``dst``, evaluated at integer output positions
    ``out_idx``. Returns (len(out_idx), src), rows summing to 1.

    Matches torch ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=True)`` / PIL: source center = (o + 0.5) * scale - 0.5 with a
    triangle kernel stretched by max(scale, 1).
    """
    scale = src / dst.astype(jnp.float32)
    center = (out_idx.astype(jnp.float32) + 0.5) * scale - 0.5
    support = jnp.maximum(scale, 1.0)
    i = jnp.arange(src, dtype=jnp.float32)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(i[None, :] - center[:, None]) / support)
    return w / jnp.sum(w, axis=-1, keepdims=True)


def resize_position_embeddings(
    pos_grid: jnp.ndarray, spatial_shapes: jnp.ndarray, max_length: int
) -> jnp.ndarray:
    """(S, S, D) grid -> (B, max_length, D), per-image (h, w) resize.

    Slot p of image b holds the (p // w, p % w) cell of the grid resized to
    (h, w); slots past h*w repeat slot 0 (HF Siglip2VisionEmbeddings
    semantics — those positions are attention-masked anyway). fp32 math, as
    HF upcasts for antialiased interpolation.
    """
    s = pos_grid.shape[0]
    grid = pos_grid.astype(jnp.float32)

    def one(shape):
        h, w = shape[0], shape[1]
        p = jnp.arange(max_length, dtype=jnp.int32)
        p_eff = jnp.where(p < h * w, p, 0)
        r = p_eff // w
        c = p_eff % w
        rw = _axis_weights(s, h, r)  # (L, S)
        cw = _axis_weights(s, w, c)  # (L, S)
        # HIGHEST: default-precision f32 contractions may run in reduced
        # precision on an accelerator (TF32 on the GPU, ~3 decimal digits,
        # vs HF's fp32 interpolate); this runs once per grid shape, so the
        # true-f32 product costs nothing measurable.
        return jnp.einsum(
            "pi,pj,ijd->pd", rw, cw, grid, precision=jax.lax.Precision.HIGHEST
        )

    return jax.vmap(one)(spatial_shapes.astype(jnp.int32))


def normalize_patches(patches: jnp.ndarray, compute_dtype: jnp.dtype) -> jnp.ndarray:
    """uint8 patch pixels -> SigLIP normalization (x/127.5 - 1); float passes
    through (same contract as siglip.normalize_pixels)."""
    if patches.dtype == jnp.uint8:
        x = patches.astype(compute_dtype)
        return x * jnp.asarray(1.0 / 127.5, compute_dtype) - jnp.asarray(1.0, compute_dtype)
    return patches.astype(compute_dtype)


def vision_forward_naflex(
    params: Params,
    patches: jnp.ndarray,
    pixel_mask: jnp.ndarray,
    spatial_shapes: jnp.ndarray,
    cfg: VisionConfig,
    compute_dtype: jnp.dtype = jnp.float32,
    return_hidden: bool = False,
):
    """NaFlex vision tower -> pooled features (B, D), pre-normalization.

    Mirrors HF Siglip2VisionTransformer: linear patch embed + per-image
    resized position embeddings, mask-attended encoder, post-LN, MAP head
    attending only to real patches.
    """
    x = normalize_patches(patches, compute_dtype)
    x = dense(x, params["embeddings"]["patch_kernel"], params["embeddings"]["patch_bias"])

    s = int(round(cfg.max_num_patches ** 0.5))
    pos_grid = params["embeddings"]["pos_embed"].reshape(s, s, -1)
    pos = resize_position_embeddings(pos_grid, spatial_shapes, cfg.max_num_patches)
    x = x + pos.astype(x.dtype)

    keep = pixel_mask.astype(jnp.float32)
    mask4d = ((1.0 - keep) * jnp.finfo(jnp.float32).min)[:, None, None, :]

    x = encoder(x, params["encoder"], cfg.num_heads, cfg.layer_norm_eps, mask=mask4d)
    hidden = layer_norm(
        x, params["post_ln"]["scale"], params["post_ln"]["bias"], cfg.layer_norm_eps
    )
    pooled = map_head(hidden, params["head"], cfg, mask=mask4d)
    if return_hidden:
        return pooled, hidden
    return pooled


@partial(jax.jit, static_argnames=("cfg", "compute_dtype"))
def get_image_features_naflex(
    params: Params,
    patches: jnp.ndarray,
    pixel_mask: jnp.ndarray,
    spatial_shapes: jnp.ndarray,
    cfg: SiglipConfig,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """L2-normalized NaFlex image embeddings (B, embedding_dim), fp32."""
    pooled = vision_forward_naflex(
        params["vision"], patches, pixel_mask, spatial_shapes, cfg.vision, compute_dtype
    ).astype(jnp.float32)
    pooled = jax.lax.optimization_barrier(pooled)  # see siglip.get_image_features
    norm = jnp.linalg.norm(pooled, axis=-1, keepdims=True)
    return pooled / jnp.maximum(norm, 1e-12)
