"""SigLIP sigmoid-contrastive training.

The reference is inference-only; a complete framework also fine-tunes the
towers it serves. This implements the SigLIP loss (pairwise sigmoid, not
softmax: Zhai et al. 2023) with a jit-compiled, mesh-sharded train step:

- batch sharded over ``data`` (DP), params optionally TP-sharded over
  ``model`` via tpuclip.parallel.sharding — XLA inserts the grad psums and
  TP collectives from the sharding annotations alone.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from tpuclip.models.configs import SiglipConfig
from tpuclip.models.siglip import text_forward, vision_forward
from tpuclip.parallel.mesh import DATA_AXIS

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def sigmoid_contrastive_loss(
    params: Any,
    images: jnp.ndarray,
    input_ids: jnp.ndarray,
    cfg: SiglipConfig,
    compute_dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """SigLIP loss: -mean_i Σ_j log σ(z_ij · (scale·sim_ij + bias)),
    z = 2I - 1."""
    img = vision_forward(params["vision"], images, cfg.vision, compute_dtype).astype(jnp.float32)
    txt = text_forward(params["text"], input_ids, cfg.text, compute_dtype).astype(jnp.float32)
    img = img / jnp.maximum(jnp.linalg.norm(img, axis=-1, keepdims=True), 1e-12)
    txt = txt / jnp.maximum(jnp.linalg.norm(txt, axis=-1, keepdims=True), 1e-12)
    logits = txt @ img.T
    logits = logits * jnp.exp(params["logit_scale"].astype(jnp.float32))
    logits = logits + params["logit_bias"].astype(jnp.float32)
    n = logits.shape[0]
    z = 2.0 * jnp.eye(n, dtype=jnp.float32) - 1.0
    loglik = jax.nn.log_sigmoid(z * logits)
    return -jnp.mean(jnp.sum(loglik, axis=-1))


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def make_optimizer(
    learning_rate: float = 1e-5,
    weight_decay: float = 1e-4,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    grad_clip_norm: Optional[float] = 1.0,
    factored: bool = False,
):
    """AdamW with optional global-norm clipping and warmup(+cosine) schedule —
    the standard contrastive fine-tuning recipe.

    Weight decay applies only to matrix-shaped params (kernels/embeddings):
    biases, layer-norm scales, and SigLIP's logit_scale/logit_bias
    calibration scalars are excluded — decaying logit_bias (initialized
    near -10) toward 0 would steadily mis-calibrate the sigmoid loss.

    ``factored=True`` selects Adafactor (factored second moment, no first
    moment) instead of AdamW — for a single device whose memory cannot hold
    AdamW's two fp32 moment trees beside params and grads (the trainer
    decides from the device's memory, pipelines/train.py), while
    Adafactor's state is ~KBs of row/column statistics per matrix. Meshes
    shard the AdamW state instead (parallel/sharding.py) and don't need
    this.
    """
    if warmup_steps > 0 or total_steps is not None:
        if total_steps is not None and total_steps > warmup_steps:
            schedule = optax.warmup_cosine_decay_schedule(
                init_value=0.0,
                peak_value=learning_rate,
                warmup_steps=max(1, warmup_steps),
                decay_steps=total_steps,
            )
        else:
            schedule = optax.linear_schedule(0.0, learning_rate, max(1, warmup_steps))
    else:
        schedule = learning_rate
    def decay_mask(params):
        return jax.tree.map(lambda p: jnp.ndim(p) >= 2, params)

    parts = []
    if grad_clip_norm is not None:
        parts.append(optax.clip_by_global_norm(grad_clip_norm))
    if factored:
        parts.append(
            optax.adafactor(
                learning_rate=schedule,
                multiply_by_parameter_scale=False,
                weight_decay_rate=weight_decay or None,
                weight_decay_mask=decay_mask,
            )
        )
    else:
        parts.append(
            optax.adamw(schedule, weight_decay=weight_decay, mask=decay_mask)
        )
    return optax.chain(*parts)


def make_train_step(
    cfg: SiglipConfig,
    optimizer,
    mesh: Optional[Mesh] = None,
    compute_dtype=jnp.bfloat16,
):
    """Build a jitted (state, images, input_ids) → (state, loss) step.

    With a mesh: batch inputs sharded over ``data``, params/opt-state sharded
    by tpuclip.parallel.sharding rules (replicated where not TP).
    """

    from tpuclip.models.siglip import remat_scope

    def step(state: TrainState, images, input_ids):
        loss, grads = jax.value_and_grad(sigmoid_contrastive_loss)(
            state.params, images, input_ids, cfg, compute_dtype
        )
        updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        return TrainState(new_params, new_opt, state.step + 1), loss

    # The remat_scope wrapper flips the encoder's trace-time checkpoint
    # flag: the scan body is jax.checkpoint'ed only in programs traced
    # here, so the backward pass recomputes per-layer activations instead
    # of stashing them (at SO400M the stash — incl. 27x(B,256,4304) MLP
    # intermediates — is most of the fwd+bwd memory). Inference
    # programs trace outside the scope and keep the stash-free forward.
    jit_step = jax.jit(step, donate_argnums=(0,))

    if mesh is None:

        def local_step(state: TrainState, images, input_ids):
            with remat_scope():
                return jit_step(state, images, input_ids)

        return local_step

    # State shardings are carried by the arrays themselves: callers build the
    # TrainState from shard_params(...)'d params, and optimizer.init's
    # zeros_like moments inherit those shardings. jit then infers everything
    # from the committed args; only the batch needs explicit placement.
    img_sharding = NamedSharding(mesh, P(DATA_AXIS))
    ids_sharding = NamedSharding(mesh, P(DATA_AXIS, None))

    def sharded_step(state: TrainState, images, input_ids):
        images = jax.device_put(images, img_sharding)
        input_ids = jax.device_put(input_ids, ids_sharding)
        with remat_scope():
            return jit_step(state, images, input_ids)

    return sharded_step


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))


@functools.partial(jax.jit, static_argnames=("cfg", "compute_dtype"))
def eval_retrieval_at_1(params, images, input_ids, cfg, compute_dtype=jnp.bfloat16):
    """Text→image retrieval@1 on a batch (sanity metric for fine-tuning)."""
    img = vision_forward(params["vision"], images, cfg.vision, compute_dtype).astype(jnp.float32)
    txt = text_forward(params["text"], input_ids, cfg.text, compute_dtype).astype(jnp.float32)
    img = img / jnp.maximum(jnp.linalg.norm(img, axis=-1, keepdims=True), 1e-12)
    txt = txt / jnp.maximum(jnp.linalg.norm(txt, axis=-1, keepdims=True), 1e-12)
    pred = jnp.argmax(txt @ img.T, axis=-1)
    n = pred.shape[0]
    return jnp.mean((pred == jnp.arange(n)).astype(jnp.float32))
