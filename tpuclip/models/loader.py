"""Checkpoint discovery and loading.

Keeps the reference's cold-start contract (image_database.py:186-232):
local model-cache directory probed first, hub layout second, clear error
otherwise. Zero-egress environments can opt into deterministic random
initialization (for tests/smoke runs) via ``TPUCLIP_INIT=random`` or
``allow_random=True`` — the reference has no such mode, it simply fails.

Accepted on-disk layouts under ``model_cache_dir``:
  1. ``<cache>/google--siglip2-so400m-patch14-224/``   (reference convention,
     image_database.py:192)
  2. ``<cache>/models--google--siglip2-so400m-patch14-224/snapshots/<rev>/``
     (HF hub cache convention)
  3. ``<cache>/<name with '/' kept>/``                  (plain directory)
Each must contain an HF-style config.json + weights (safetensors preferred).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax

from tpuclip.models import convert
from tpuclip.models.configs import (
    DEFAULT_MODEL,
    PRESETS,
    SiglipConfig,
    config_from_hf_dict,
    get_config,
)
from tpuclip.models.siglip import init_params
from tpuclip.utils.logging import log

Params = Dict[str, Any]


def find_local_checkpoint(model_name: str, model_cache_dir: Optional[str]) -> Optional[Path]:
    """Locate a local checkpoint directory for model_name, or None."""
    if not model_cache_dir:
        return None
    cache = Path(model_cache_dir)
    flat = model_name.replace("/", "--")
    candidates = [cache / flat, cache / model_name]
    hub = cache / f"models--{flat}" / "snapshots"
    if hub.is_dir():
        snapshots = sorted(hub.iterdir(), key=lambda p: p.stat().st_mtime, reverse=True)
        candidates.extend(snapshots)
    for c in candidates:
        if c.is_dir() and ((c / "config.json").exists() or (c / "tpuclip.json").exists()):
            return c
    return None


def load_checkpoint_dir(model_dir: str, model_name: Optional[str] = None) -> Tuple[SiglipConfig, Params]:
    """Load (config, params) from a tpuclip-native or HF-layout directory."""
    from tpuclip.models.checkpoint import is_tpuclip_checkpoint, load_checkpoint

    if is_tpuclip_checkpoint(model_dir):
        return load_checkpoint(model_dir)
    with open(Path(model_dir) / "config.json", "r", encoding="utf-8") as f:
        hf_cfg = json.load(f)
    name = model_name or hf_cfg.get("_name_or_path") or str(model_dir)
    cfg = config_from_hf_dict(name, hf_cfg)
    sd = convert.read_checkpoint_dir(model_dir)
    params = convert.params_from_state_dict(sd, cfg)
    return cfg, params


def load_model(
    model_name: str = DEFAULT_MODEL,
    model_cache_dir: Optional[str] = None,
    allow_random: Optional[bool] = None,
    seed: int = 0,
) -> Tuple[SiglipConfig, Params]:
    """Resolve and load a model: local cache first, then error (or random).

    Checkpoint loads return fp32 params on host; the random-init path
    returns fp32 params already on the default device (see below). Callers
    cast/shard for device residency either way.
    """
    local = find_local_checkpoint(model_name, model_cache_dir)
    if local is not None:
        log(f"  Loading from local cache: {local}")
        cfg, params = load_checkpoint_dir(str(local), model_name)
        log("  [OK] Model weights loaded")
        return cfg, params

    if allow_random is None:
        allow_random = os.environ.get("TPUCLIP_INIT", "") == "random"
    if allow_random:
        log(
            f"  [WARNING] No local checkpoint for {model_name}; using deterministic "
            "random initialization (TPUCLIP_INIT=random). Embeddings will NOT match "
            "the pretrained model."
        )
        cfg = get_config(model_name) if model_name in PRESETS else get_config(DEFAULT_MODEL)
        # ONE jitted device program: eager init dispatches hundreds of tiny
        # RNG ops and a host pull-back of the full tree (1.6 GB for SO400M)
        # that the engine would immediately re-upload. Callers
        # cast/device_put the returned device arrays; both are on-device
        # no-copy ops.
        params = jax.jit(lambda k: init_params(k, cfg))(jax.random.PRNGKey(seed))
        return cfg, params

    raise FileNotFoundError(
        f"No local checkpoint found for {model_name!r} under "
        f"{model_cache_dir!r}, and network download is not available in this "
        "build. Place the HF checkpoint (config.json + model.safetensors) at "
        f"<model_cache>/{model_name.replace('/', '--')}/ or set "
        "TPUCLIP_INIT=random for a random-weight smoke mode."
    )
