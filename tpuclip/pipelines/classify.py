"""Zero-shot classification.

Beyond the reference's retrieval surface: SigLIP is a classifier by
construction — per-label sigmoid probabilities from
``logit_scale * cos(image, text) + logit_bias`` (the training objective), plus
a softmax view for forced-choice ranking. Uses the same prompt template and
preprocessing contracts as search, no database required.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from tpuclip.utils.logging import log


def classify_image(
    image_path: str,
    labels: List[str],
    model_name: str,
    model_cache_dir: Optional[str] = None,
) -> List[Tuple[str, float, float]]:
    """Returns [(label, sigmoid_prob, softmax_prob)] sorted descending."""
    import jax
    import jax.numpy as jnp

    from tpuclip.io.prefetch import decode_single
    from tpuclip.models.loader import find_local_checkpoint, load_model
    from tpuclip.models.siglip import cast_params, get_image_features, get_text_features
    from tpuclip.text.tokenizer import build_prompt, load_tokenizer

    cfg, params = load_model(model_name, model_cache_dir)
    if cfg.vision.naflex:
        # The square-resize decode + vision_forward path below does not match
        # NaFlex's patchified input contract (models/naflex.py); feeding it
        # square pixels would crash in the position-embedding add.
        raise ValueError(
            f"{model_name} is a NaFlex model, which classify does not support yet; "
            "use a fixed-resolution preset"
        )
    from tpuclip import platform

    compute_dtype = platform.compute_dtype()
    params = jax.device_put(cast_params(params, compute_dtype))
    ckpt = find_local_checkpoint(model_name, model_cache_dir)
    tokenizer = load_tokenizer(
        model_name, str(ckpt) if ckpt else None, vocab_size=cfg.text.vocab_size
    )

    pixels = decode_single(image_path, cfg.vision.image_size)
    if pixels is None:
        raise ValueError(f"Could not decode image: {image_path}")
    img = np.asarray(
        get_image_features(params, jnp.asarray(pixels[None]), cfg, compute_dtype)
    )[0]

    ids, mask = tokenizer.encode_batch_with_mask([build_prompt(t) for t in labels])
    txt = np.asarray(
        get_text_features(
            params, jnp.asarray(ids), cfg, compute_dtype,
            attention_mask=jnp.asarray(mask),
        )
    )

    return score_labels(labels, txt, img, params)


def score_labels(
    labels: List[str], txt: np.ndarray, img: np.ndarray, params
) -> List[Tuple[str, float, float]]:
    """SigLIP head over unit-norm embeddings: per-label sigmoid probability
    (`logit_scale * cos + logit_bias`, the training objective) plus a
    softmax view for forced choice. Returns [(label, sigmoid, softmax)]
    sorted by sigmoid descending."""
    cos = txt @ img
    scale = float(np.exp(np.asarray(params.get("logit_scale", math.log(10.0)), np.float32)))
    bias = float(np.asarray(params.get("logit_bias", -10.0), np.float32))
    logits = scale * cos + bias
    sigmoid = 1.0 / (1.0 + np.exp(-logits))
    z = logits - logits.max()
    softmax = np.exp(z) / np.exp(z).sum()

    ranked = sorted(
        zip(labels, sigmoid, softmax), key=lambda x: x[1], reverse=True
    )
    return [(l, float(p), float(sm)) for l, p, sm in ranked]


def classify_pil(engine, img, labels: List[str]) -> List[Tuple[str, float, float]]:
    """Zero-shot classification against a RESIDENT engine (the serve
    /classify path): reuses the loaded towers and the text-embedding LRU,
    no model load per call. NaFlex-capable — the engine's embed path owns
    the patchified input contract classify_image can't drive itself."""
    img_emb = engine._embed_pil(img)
    txt = engine.embed_texts_cached(list(labels))
    return score_labels(list(labels), txt, img_emb, engine.params)


def run_classify(image_path: str, labels: List[str], model_name: str, model_cache_dir) -> None:
    results = classify_image(image_path, labels, model_name, model_cache_dir)
    log(f"\nZero-shot classification of {image_path}:")
    for label, prob, sm in results:
        log(f"  {prob * 100:6.2f}%  (rel {sm * 100:5.1f}%)  {label}")
