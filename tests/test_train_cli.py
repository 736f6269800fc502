"""CLI train + convert subcommands end-to-end on the tiny model."""

import numpy as np
import pytest
from PIL import Image

from tpuclip.cli import main
from tpuclip.pipelines.train import find_pairs


@pytest.fixture()
def caption_dataset(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    colors = {"red": (220, 30, 30), "green": (30, 200, 30), "blue": (30, 30, 220)}
    for name, c in colors.items():
        for i in range(4):
            Image.new("RGB", (60, 60), c).save(d / f"{name}_{i}.jpg")
            (d / f"{name}_{i}.txt").write_text(f"a solid {name} square")
    (d / "nocaption.jpg").touch()  # ignored (no sidecar)
    return d


def test_find_pairs(caption_dataset):
    pairs = find_pairs(str(caption_dataset))
    assert len(pairs) == 12
    assert all(c.startswith("a solid") for _, c in pairs)


def test_train_cli_end_to_end(caption_dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUCLIP_MODEL", "tpuclip/test-tiny")
    out = tmp_path / "finetuned"
    main([
        "train", str(caption_dataset),
        "--output", str(out),
        "--model", "tpuclip/test-tiny",
        "--model-cache", str(tmp_path / "models"),
        "--steps", "3",
        "--batch-size", "4",
        "--lr", "1e-3",
    ])
    assert (out / "model" / "tpuclip.json").exists()
    assert (out / "model" / "model.safetensors").exists()
    assert (out / "train_state").exists()

    # fine-tuned checkpoint loads and produces valid embeddings
    from tpuclip.models.checkpoint import load_checkpoint
    from tpuclip.models.siglip import get_image_features

    import jax.numpy as jnp

    cfg, params = load_checkpoint(str(out / "model"))
    pix = np.random.default_rng(0).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    emb = np.asarray(get_image_features(params, jnp.asarray(pix), cfg))
    assert np.isfinite(emb).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


def test_convert_cli(tmp_path):
    """HF-layout dir → tpuclip format via the CLI."""
    import torch
    import transformers
    from transformers import SiglipConfig, SiglipModel

    hf_cfg = SiglipConfig.from_text_vision_configs(
        transformers.SiglipTextConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
        ),
        transformers.SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=28, patch_size=14,
        ),
    )
    torch.manual_seed(0)
    model = SiglipModel(hf_cfg)
    src = tmp_path / "hf"
    model.save_pretrained(str(src))

    dst = tmp_path / "native"
    main(["convert", str(src), str(dst)])

    from tpuclip.models.checkpoint import load_checkpoint

    cfg, params = load_checkpoint(str(dst))
    assert cfg.vision.hidden_size == 32
    assert params["text"]["token_embedding"].shape == (128, 32)
