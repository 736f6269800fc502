"""Contrastive fine-tuning pipeline.

The reference is inference-only; a complete framework also adapts the towers
it serves. Dataset convention: a directory of images with sidecar captions —
``photo.jpg`` + ``photo.txt`` (one caption). Pairs feed the SigLIP sigmoid
loss (tpuclip.parallel.training) through the same threaded decode
prefetcher as scan; the batch is DP-sharded over the mesh and params
optionally TP-sharded.

Checkpoints: tpuclip-format model params (tpuclip.models.checkpoint) plus an
orbax TrainState for exact resume.
"""

from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tpuclip.io.walker import census
from tpuclip.utils.logging import banner, log


def find_pairs(data_dir: str) -> List[Tuple[str, str]]:
    """(image_path, caption) pairs from sidecar .txt files."""
    images, _ = census(data_dir)
    pairs = []
    for img in sorted(images):
        sidecar = img.with_suffix(".txt")
        if sidecar.exists():
            caption = sidecar.read_text(encoding="utf-8").strip()
            if caption:
                pairs.append((str(img), caption))
    return pairs


def _batches(
    pairs: List[Tuple[str, str]],
    batch_size: int,
    image_size: int,
    tokenizer,
    steps: int,
    seed: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite shuffled epochs → (images uint8 (B,S,S,3), ids (B,64))."""
    from tpuclip.io.prefetch import prefetch_batches

    rng = random.Random(seed)

    def path_stream():
        epoch = list(pairs)
        while True:
            rng.shuffle(epoch)
            for p, _ in epoch:
                yield p, 0.0

    caption_of = dict(pairs)
    produced = 0
    consecutive_skips = 0
    # A bad image only poisons the batches it lands in, so skipping works —
    # but if every batch fails to decode this would spin forever on the
    # infinite path stream. Bail after roughly two epochs of pure failures.
    max_consecutive_skips = max(10, 2 * (len(pairs) // batch_size + 1))
    for batch in prefetch_batches(
        path_stream(), batch_size, image_size, with_hash=False
    ):
        if not batch.valid.all():
            consecutive_skips += 1
            if consecutive_skips >= max_consecutive_skips:
                raise RuntimeError(
                    f"{consecutive_skips} consecutive batches contained decode "
                    "failures; check the dataset for corrupt/unreadable images"
                )
            continue  # skip batches with decode failures (pairs must align)
        consecutive_skips = 0
        ids = tokenizer.encode_batch(
            [caption_of[item.path].lower() for item in batch.items]
        )
        yield batch.pixels, ids
        produced += 1
        if produced >= steps:
            return


def train(
    data_dir: str,
    model_name: str,
    model_cache_dir: Optional[str],
    output_dir: str,
    steps: int = 100,
    batch_size: int = 16,
    learning_rate: float = 1e-5,
    resume: Optional[str] = None,
    seed: int = 0,
    log_every: int = 10,
    optimizer: str = "auto",
) -> List[float]:
    """Fine-tune for ``steps`` steps and save the model and train state
    under ``output_dir``; returns the per-step losses (empty when the run
    could not start)."""
    import jax
    import jax.numpy as jnp

    from tpuclip import platform
    from tpuclip.models.checkpoint import save_checkpoint
    from tpuclip.models.loader import find_local_checkpoint, load_model
    from tpuclip.parallel.checkpoint import restore_train_state, save_train_state
    from tpuclip.parallel.mesh import make_mesh
    from tpuclip.parallel.sharding import shard_params
    from tpuclip.parallel.training import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )
    from tpuclip.text.tokenizer import load_tokenizer

    banner("Contrastive fine-tuning")
    pairs = find_pairs(data_dir)
    if len(pairs) < batch_size:
        log(f"[X] Need at least {batch_size} (image, caption) pairs; found {len(pairs)}")
        return []
    log(f"Dataset: {len(pairs)} image/caption pairs from {data_dir}")

    cfg, params = load_model(model_name, model_cache_dir)
    if cfg.vision.naflex:
        # The square-pixel prefetcher + vision_forward train step do not
        # match NaFlex's patchified input contract (models/naflex.py).
        log(f"[X] {model_name} is a NaFlex model; training does not support NaFlex yet")
        return []
    ckpt_dir = find_local_checkpoint(model_name, model_cache_dir)
    tokenizer = load_tokenizer(
        model_name, str(ckpt_dir) if ckpt_dir else None, vocab_size=cfg.text.vocab_size
    )

    # DP requires the batch to divide over the data axis; use the largest
    # device count that divides the batch.
    n_dev = len(jax.devices())
    usable = next((d for d in range(min(n_dev, batch_size), 0, -1) if batch_size % d == 0), 1)
    mesh = make_mesh(jax.devices()[:usable]) if usable > 1 else None
    compute_dtype = platform.compute_dtype()
    if mesh is not None:
        params = shard_params(params, mesh)
        log(f"Mesh: {dict(mesh.shape)}")

    # Optimizer memory: AdamW keeps two fp32 moment trees beside the fp32
    # params and grads. "auto" picks Adafactor (factored second moment,
    # ~KBs of state) when those four trees would not fit the device's
    # memory (platform.fits) and no mesh shards them.
    if optimizer == "auto":
        param_bytes = sum(
            int(np.prod(p.shape)) * 4 for p in jax.tree_util.tree_leaves(params)
        )
        factored = mesh is None and not platform.fits(4 * param_bytes)
    else:
        factored = optimizer == "adafactor"
    if factored:
        log("Optimizer: adafactor (AdamW state would exceed the device's memory)"
            if optimizer == "auto" else "Optimizer: adafactor")
    opt = make_optimizer(
        learning_rate=learning_rate,
        warmup_steps=min(100, max(1, steps // 10)),
        total_steps=steps,
        factored=factored,
    )
    state = init_train_state(params, opt)
    if resume:
        state = restore_train_state(resume, template=state)
        log(f"Resumed from {resume} at step {int(state.step)}")
    step_fn = make_train_step(cfg, opt, mesh=mesh, compute_dtype=compute_dtype)

    t0 = time.time()
    losses = []
    for i, (images, ids) in enumerate(
        _batches(pairs, batch_size, cfg.vision.image_size, tokenizer, steps, seed)
    ):
        state, loss = step_fn(state, jnp.asarray(images), jnp.asarray(ids))
        losses.append(float(loss))
        if (i + 1) % log_every == 0 or i == 0:
            rate = batch_size * (i + 1) / (time.time() - t0)
            log(
                f"  step {int(state.step):5d}  loss {np.mean(losses[-log_every:]):.4f}  "
                f"{rate:.1f} img/s"
            )

    out = Path(output_dir)
    save_checkpoint(str(out / "model"), jax.device_get(state.params), cfg)
    log(f"\nSaved fine-tuned model to {out / 'model'} (tpuclip format)")
    try:
        save_train_state(str(out / "train_state"), state)
    except ImportError:
        log("[WARNING] Train state not saved: resuming needs orbax "
            "(pip install 'tpuclip[train]')")
    else:
        log(f"Saved train state to {out / 'train_state'} (orbax)")
    banner("Training complete")
    return losses
