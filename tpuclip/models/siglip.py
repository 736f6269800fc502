"""SigLIP vision+text towers in pure JAX.

From-scratch JAX implementation of the architecture the reference drives
through HF/PyTorch (``SiglipModel.get_image_features`` /
``get_text_features``, image_database.py:455, :491, :536). Design notes:

- **Stacked layers + ``lax.scan``**: all encoder layers' weights carry a
  leading layer axis, and the encoder is a single scanned step. A 27-layer
  SO400M tower traces and compiles as one layer, keeping jit compile times
  in seconds rather than minutes.
- **Patch embedding as one big GEMM**: the stride-14 conv is algebraically a
  reshape into (batch, patches, patch_pixels) followed by a matmul — a
  plain GEMM for the tensor cores. No conv primitive is used.
- **uint8-native input**: ``pixel_values`` may be uint8 NHWC straight from the
  decoder; rescale (1/255) and normalization (mean=std=0.5 →
  ``x/127.5 - 1``) fuse into the first device op, quartering host→device
  transfer bytes versus shipping float32.
- **Mixed precision**: matmuls run in ``compute_dtype`` (bf16 on the GPU) with
  fp32 accumulation via ``preferred_element_type``; LayerNorm statistics and
  softmax are computed in fp32. With fp32 everywhere outputs match the HF
  reference to ~1e-6 (see tests/test_parity.py).
- **Attention stays einsum**: at SigLIP's fixed small sequences (256
  patches, 64 tokens) XLA's fused attention is the plain route; whether
  cuDNN's fused attention beats it on the GPU is not measured yet.

Weight layout convention: every dense kernel is stored as (in_features,
out_features) so forward is ``x @ W + b``, i.e. the transpose of PyTorch's
``nn.Linear.weight``. See tpuclip/models/convert.py for the mapping.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpuclip.models.configs import SiglipConfig, TextConfig, VisionConfig

Params = Dict[str, Any]


# =============================================================================
# Primitive blocks
# =============================================================================


def layer_norm(x: jnp.ndarray, scale: jnp.ndarray, bias: jnp.ndarray, eps: float) -> jnp.ndarray:
    """LayerNorm with fp32 statistics regardless of compute dtype."""
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    y = y * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    return y.astype(orig_dtype)


def dense(x: jnp.ndarray, kernel: jnp.ndarray, bias: Optional[jnp.ndarray]) -> jnp.ndarray:
    y = jnp.dot(x, kernel.astype(x.dtype), preferred_element_type=jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def _gelu_tanh(x: jnp.ndarray) -> jnp.ndarray:
    # HF `gelu_pytorch_tanh`; fp32 internally for parity across dtypes.
    x32 = x.astype(jnp.float32)
    return jax.nn.gelu(x32, approximate=True).astype(x.dtype)


def _split_heads(x: jnp.ndarray, num_heads: int) -> jnp.ndarray:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads)


def _merge_heads(x: jnp.ndarray) -> jnp.ndarray:
    b, s, h, hd = x.shape
    return x.reshape(b, s, h * hd)


def mha(
    q_in: jnp.ndarray,
    kv_in: jnp.ndarray,
    p: Params,
    num_heads: int,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Multi-head attention. q_in (B,Sq,D), kv_in (B,Sk,D).

    Equivalent to HF SiglipAttention (modeling_siglip eager path): scale
    1/sqrt(head_dim), softmax in fp32.

    Plain einsum for XLA to fuse: flash-style attention pays at long
    sequences, which this workload (256 patches / 64 tokens) never has.
    """
    q = _split_heads(dense(q_in, p["q_kernel"], p["q_bias"]), num_heads)
    k = _split_heads(dense(kv_in, p["k_kernel"], p["k_bias"]), num_heads)
    v = _split_heads(dense(kv_in, p["v_kernel"], p["v_bias"]), num_heads)

    scale = 1.0 / math.sqrt(q.shape[-1])
    # (B, H, Sq, Sk) logits in fp32
    logits = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    if mask is not None:
        logits = logits + mask.astype(jnp.float32)
    weights = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    out = jnp.einsum(
        "bhqk,bkhd->bqhd", weights, v, preferred_element_type=jnp.float32
    ).astype(q.dtype)

    return dense(_merge_heads(out), p["o_kernel"], p["o_bias"])


def mlp(x: jnp.ndarray, p: Params) -> jnp.ndarray:
    h = dense(x, p["fc1_kernel"], p["fc1_bias"])
    h = _gelu_tanh(h)
    return dense(h, p["fc2_kernel"], p["fc2_bias"])


# Trace-time rematerialization switch. Training wraps its jitted step in
# remat_scope() (parallel/training.py): the scanned layer body is then
# jax.checkpoint'ed, so the backward pass re-computes per-layer
# activations from the 27 carried layer inputs instead of stashing every
# intermediate — the SO400M fwd+bwd stash (incl. 27x(B,256,4304) MLP
# intermediates) is otherwise most of the step's device memory. Inference
# paths trace outside the scope and are unaffected.
_ENCODER_REMAT = False


@contextlib.contextmanager
def remat_scope():
    global _ENCODER_REMAT
    prev = _ENCODER_REMAT
    _ENCODER_REMAT = True
    try:
        yield
    finally:
        _ENCODER_REMAT = prev


def encoder(
    x: jnp.ndarray,
    layers: Params,
    num_heads: int,
    eps: float,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Pre-LN transformer encoder, scanned over the stacked layer axis.

    Matches SiglipEncoderLayer: x += attn(LN1(x)); x += mlp(LN2(x)).
    """

    def step(h, layer):
        residual = h
        y = layer_norm(h, layer["ln1_scale"], layer["ln1_bias"], eps)
        y = mha(y, y, layer, num_heads, mask=mask)
        h = residual + y
        residual = h
        y = layer_norm(h, layer["ln2_scale"], layer["ln2_bias"], eps)
        y = mlp(y, layer)
        h = residual + y
        return h, None

    out, _ = jax.lax.scan(
        jax.checkpoint(step) if _ENCODER_REMAT else step, x, layers
    )
    return out


# =============================================================================
# Vision tower
# =============================================================================


def normalize_pixels(pixel_values: jnp.ndarray, compute_dtype: jnp.dtype) -> jnp.ndarray:
    """uint8 [0,255] NHWC → normalized float; float inputs pass through.

    SigLIP preprocessing is rescale 1/255 then (x-0.5)/0.5, i.e. x/127.5 - 1.
    """
    if pixel_values.dtype == jnp.uint8:
        x = pixel_values.astype(compute_dtype)
        return x * jnp.asarray(1.0 / 127.5, compute_dtype) - jnp.asarray(1.0, compute_dtype)
    return pixel_values.astype(compute_dtype)


def patch_embed(pixel_values: jnp.ndarray, p: Params, cfg: VisionConfig) -> jnp.ndarray:
    """Non-overlapping conv patch embedding as reshape + GEMM.

    Input NHWC (B, H, W, C); kernel (P*P*C, D) flattened in (ph, pw, c) order
    to match the torch Conv2d weight layout after transpose (see convert.py).
    Output (B, num_patches, D), patches in row-major (i, j) grid order —
    identical to HF's ``patch_embeds.flatten(2).transpose(1, 2)``.
    """
    b, h, w, c = pixel_values.shape
    ps = cfg.patch_size
    hp, wp = h // ps, w // ps
    x = pixel_values.reshape(b, hp, ps, wp, ps, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)  # (B, hp, wp, ps, ps, C)
    x = x.reshape(b, hp * wp, ps * ps * c)
    return dense(x, p["patch_kernel"], p["patch_bias"])


def map_head(
    hidden: jnp.ndarray,
    p: Params,
    cfg: VisionConfig,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Multihead attention pooling (SiglipMultiheadAttentionPoolingHead):
    learned probe cross-attends over patch tokens, then LN + residual MLP,
    returning token 0. ``mask``: additive (B, 1, 1, S) over padded patch
    keys (NaFlex variable-resolution batches)."""
    b = hidden.shape[0]
    probe = jnp.broadcast_to(p["probe"].astype(hidden.dtype), (b, 1, hidden.shape[-1]))
    attn_out = mha(probe, hidden, p, cfg.num_heads, mask=mask)
    residual = attn_out
    y = layer_norm(attn_out, p["ln_scale"], p["ln_bias"], cfg.layer_norm_eps)
    y = residual + mlp(y, p)
    return y[:, 0]


def vision_forward(
    params: Params,
    pixel_values: jnp.ndarray,
    cfg: VisionConfig,
    compute_dtype: jnp.dtype = jnp.float32,
    return_hidden: bool = False,
) -> jnp.ndarray:
    """Full vision tower → pooled features (B, D) (pre-normalization), the
    equivalent of HF ``get_image_features`` (image_database.py:491).

    ``pixel_values``: (B, H, W, C) uint8 or pre-normalized float, NHWC.
    """
    x = normalize_pixels(pixel_values, compute_dtype)
    x = patch_embed(x, params["embeddings"], cfg)
    x = x + params["embeddings"]["pos_embed"].astype(x.dtype)
    x = encoder(
        x,
        params["encoder"],
        cfg.num_heads,
        cfg.layer_norm_eps,
    )
    hidden = layer_norm(
        x, params["post_ln"]["scale"], params["post_ln"]["bias"], cfg.layer_norm_eps
    )
    pooled = map_head(hidden, params["head"], cfg)
    if return_hidden:
        return pooled, hidden
    return pooled


# =============================================================================
# Text tower
# =============================================================================


def text_forward(
    params: Params,
    input_ids: jnp.ndarray,
    cfg: TextConfig,
    compute_dtype: jnp.dtype = jnp.float32,
    return_hidden: bool = False,
    attention_mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Text tower → projected features (B, proj) (pre-normalization).

    SigLIP text contract (image_database.py:509-543): inputs are padded to
    exactly ``cfg.max_length`` tokens, pooling takes the LAST position's
    hidden state (which may be a pad token), then the linear head projects
    it. ``attention_mask`` (B, S) of 1/0 masks padded keys — the reference
    passes the processor's mask into ``get_text_features``
    (image_database.py:524-536 via HF `_prepare_4d_attention_mask`), so
    embedding compatibility requires honoring it.
    """
    ids = input_ids.astype(jnp.int32)
    tok = jnp.take(params["token_embedding"], ids, axis=0).astype(compute_dtype)
    seq = ids.shape[-1]
    pos = params["pos_embed"][:seq].astype(compute_dtype)
    x = tok + pos[None, :, :]
    mask4d = None
    if attention_mask is not None:
        # (B, S) keep-mask → additive (B, 1, 1, S): 0 keep, -inf drop.
        keep = attention_mask.astype(jnp.float32)
        mask4d = ((1.0 - keep) * jnp.finfo(jnp.float32).min)[:, None, None, :]
    x = encoder(
        x,
        params["encoder"],
        cfg.num_heads,
        cfg.layer_norm_eps,
        mask=mask4d,
    )
    hidden = layer_norm(
        x, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.layer_norm_eps
    )
    pooled = hidden[:, -1, :]
    pooled = dense(pooled, params["head"]["kernel"], params["head"]["bias"])
    if return_hidden:
        return pooled, hidden
    return pooled


# =============================================================================
# Top-level feature fns (jit-friendly)
# =============================================================================


@partial(jax.jit, static_argnames=("cfg", "compute_dtype"))
def get_image_features(
    params: Params,
    pixel_values: jnp.ndarray,
    cfg: SiglipConfig,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """L2-normalized image embeddings (B, embedding_dim), fp32.

    Normalization matches the reference's F.normalize(p=2, dim=1)
    (image_database.py:457, :493).
    """
    pooled = vision_forward(
        params["vision"], pixel_values, cfg.vision, compute_dtype
    ).astype(jnp.float32)
    # Barrier: without it XLA may duplicate the pooled computation into the
    # norm fusion and the divide fusion with different tilings, whose bf16
    # accumulation orders differ — the output would then be ~5e-4 off unit
    # norm. That duplication is XLA's choice on any backend; one
    # materialization keeps norms exact.
    pooled = jax.lax.optimization_barrier(pooled)
    norm = jnp.linalg.norm(pooled, axis=-1, keepdims=True)
    return pooled / jnp.maximum(norm, 1e-12)


@partial(jax.jit, static_argnames=("cfg", "compute_dtype"))
def get_text_features(
    params: Params,
    input_ids: jnp.ndarray,
    cfg: SiglipConfig,
    compute_dtype: jnp.dtype = jnp.float32,
    attention_mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """L2-normalized text embeddings (B, embedding_dim), fp32 (eps 1e-12,
    image_database.py:540)."""
    pooled = text_forward(
        params["text"], input_ids, cfg.text, compute_dtype,
        attention_mask=attention_mask,
    ).astype(jnp.float32)
    pooled = jax.lax.optimization_barrier(pooled)  # see get_image_features
    norm = jnp.linalg.norm(pooled, axis=-1, keepdims=True)
    return pooled / (norm + 1e-12)


# =============================================================================
# Initialization (offline/random weights; checkpoints come via convert.py)
# =============================================================================


def _dense_init(key, fan_in: int, fan_out: int, dtype) -> Dict[str, jnp.ndarray]:
    k1, _ = jax.random.split(key)
    std = 1.0 / math.sqrt(fan_in)
    return {
        "kernel": jax.random.normal(k1, (fan_in, fan_out), dtype) * std,
        "bias": jnp.zeros((fan_out,), dtype),
    }


def _layer_stack(key, cfg, dtype) -> Params:
    """Random-init stacked encoder layer params with leading layer axis."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    keys = jax.random.split(key, 6)

    def stack_dense(k, fan_in, fan_out):
        ks = jax.random.split(k, n)
        kernels = jnp.stack(
            [jax.random.normal(ki, (fan_in, fan_out), dtype) / math.sqrt(fan_in) for ki in ks]
        )
        return kernels, jnp.zeros((n, fan_out), dtype)

    qk, qb = stack_dense(keys[0], d, d)
    kk, kb = stack_dense(keys[1], d, d)
    vk, vb = stack_dense(keys[2], d, d)
    ok, ob = stack_dense(keys[3], d, d)
    f1k, f1b = stack_dense(keys[4], d, f)
    f2k, f2b = stack_dense(keys[5], f, d)
    # NOTE: each leaf gets its own array — aliased buffers break donation
    # (donate_argnums would hand the same buffer to XLA twice).
    return {
        "ln1_scale": jnp.ones((n, d), dtype), "ln1_bias": jnp.zeros((n, d), dtype),
        "q_kernel": qk, "q_bias": qb,
        "k_kernel": kk, "k_bias": kb,
        "v_kernel": vk, "v_bias": vb,
        "o_kernel": ok, "o_bias": ob,
        "ln2_scale": jnp.ones((n, d), dtype), "ln2_bias": jnp.zeros((n, d), dtype),
        "fc1_kernel": f1k, "fc1_bias": f1b,
        "fc2_kernel": f2k, "fc2_bias": f2b,
    }


def init_params(
    key: jax.Array, cfg: SiglipConfig, dtype: jnp.dtype = jnp.float32
) -> Params:
    """Deterministic random init with the full parameter tree structure."""
    kv, kt, kh, kp, ke, kth = jax.random.split(key, 6)
    v, t = cfg.vision, cfg.text
    patch_in = v.patch_size * v.patch_size * v.num_channels

    pe = _dense_init(kp, patch_in, v.hidden_size, dtype)
    vision = {
        "embeddings": {
            "patch_kernel": pe["kernel"],
            "patch_bias": pe["bias"],
            "pos_embed": jax.random.normal(ke, (v.num_patches, v.hidden_size), dtype) * 0.02,
        },
        "encoder": _layer_stack(kv, v, dtype),
        "post_ln": {"scale": jnp.ones((v.hidden_size,), dtype), "bias": jnp.zeros((v.hidden_size,), dtype)},
        "head": _map_head_init(kh, v, dtype),
    }

    keys = jax.random.split(kt, 4)
    head = _dense_init(keys[2], t.hidden_size, t.projection_size, dtype)
    text = {
        "token_embedding": jax.random.normal(keys[0], (t.vocab_size, t.hidden_size), dtype) * 0.02,
        "pos_embed": jax.random.normal(keys[1], (t.max_length, t.hidden_size), dtype) * 0.02,
        "encoder": _layer_stack(kth, t, dtype),
        "final_ln": {"scale": jnp.ones((t.hidden_size,), dtype), "bias": jnp.zeros((t.hidden_size,), dtype)},
        "head": head,
    }

    # logit scale/bias initialized to SigLIP paper values (used by training).
    return {
        "vision": vision,
        "text": text,
        "logit_scale": jnp.asarray(math.log(10.0), dtype),
        "logit_bias": jnp.asarray(-10.0, dtype),
    }


def _map_head_init(key, v: VisionConfig, dtype) -> Params:
    d, f = v.hidden_size, v.intermediate_size
    keys = jax.random.split(key, 7)
    out = {
        "probe": jax.random.normal(keys[0], (1, d), dtype),
        "ln_scale": jnp.ones((d,), dtype),
        "ln_bias": jnp.zeros((d,), dtype),
    }
    for name, k, fi, fo in (
        ("q", keys[1], d, d),
        ("k", keys[2], d, d),
        ("v", keys[3], d, d),
        ("o", keys[4], d, d),
        ("fc1", keys[5], d, f),
        ("fc2", keys[6], f, d),
    ):
        init = _dense_init(k, fi, fo, dtype)
        out[f"{name}_kernel"] = init["kernel"]
        out[f"{name}_bias"] = init["bias"]
    return out


def param_count(params: Params) -> int:
    return int(sum(np.prod(p.shape) for p in jax.tree.leaves(params)))


def cast_params(params: Params, dtype: jnp.dtype) -> Params:
    """Cast floating-point leaves to dtype (e.g. bf16 for device residency)."""
    def cast(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, params)
