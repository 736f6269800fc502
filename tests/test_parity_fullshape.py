"""Full-SO400M-shape parity + converter gate (opt-in: TPUCLIP_FULL_PARITY=1).

The fast suite proves architecture parity at tiny dims; shape-dependent bugs
(head_dim 72 at 16 heads, 27-layer stacks, the 1152-d MAP pooling head,
256k-row token embedding) would slip through it. This gate builds the HF
``SiglipModel`` at the exact ``google/siglip2-so400m-patch14-224`` config
(random init — the pretrained checkpoint is not downloadable here), converts
its state dict through ``params_from_state_dict``, and asserts both towers
match, masked text included. It then round-trips the full-shape checkpoint
through the ``convert`` CLI (HF layout → tpuclip-native) and re-checks.

Reference analog: the real-weight load at image_database.py:193-235.
Runtime: ~4-6 min on one CPU core, ~15 GB RAM. Run with:

    TPUCLIP_FULL_PARITY=1 python -m pytest tests/test_parity_fullshape.py -v
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from tpuclip.models import siglip  # noqa: E402
from tpuclip.models.configs import get_config  # noqa: E402
from tpuclip.models.convert import params_from_state_dict  # noqa: E402

pytestmark = [
    pytest.mark.skipif(
        os.environ.get("TPUCLIP_FULL_PARITY") != "1",
        reason="full-SO400M-shape gate; opt in with TPUCLIP_FULL_PARITY=1",
    ),
]

MODEL = "google/siglip2-so400m-patch14-224"

VISION_KW = dict(
    hidden_size=1152,
    intermediate_size=4304,
    num_hidden_layers=27,
    num_attention_heads=16,
    image_size=224,
    patch_size=14,
)
TEXT_KW = dict(
    vocab_size=256000,
    hidden_size=1152,
    intermediate_size=4304,
    num_hidden_layers=27,
    num_attention_heads=16,
    max_position_embeddings=64,
    projection_size=1152,
)


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """(hf_model, cfg, params, state_dict) at full SO400M shape."""
    from transformers import SiglipConfig, SiglipModel, SiglipTextConfig, SiglipVisionConfig

    hf_cfg = SiglipConfig.from_text_vision_configs(
        SiglipTextConfig(**TEXT_KW), SiglipVisionConfig(**VISION_KW)
    )
    torch.manual_seed(0)
    hf = SiglipModel(hf_cfg).eval()
    cfg = get_config(MODEL)
    # Sanity: the preset must match the HF config we constructed.
    assert cfg.vision.num_layers == VISION_KW["num_hidden_layers"]
    assert cfg.vision.head_dim == 1152 // 16  # 72 — the shape the tiny suite can't see
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    params = params_from_state_dict(sd, cfg)
    return hf, cfg, params, sd


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(
        np.min(np.sum(a * b, -1) / (np.linalg.norm(a, -1) * np.linalg.norm(b, -1) + 1e-30))
    )


def test_vision_parity_full_shape(full):
    hf, cfg, params, _ = full
    rng = np.random.default_rng(1)
    pix = rng.standard_normal((2, 3, 224, 224), dtype=np.float32)
    with torch.no_grad():
        ref = hf.get_image_features(pixel_values=torch.from_numpy(pix)).numpy()
    ours = np.asarray(
        siglip.vision_forward(params["vision"], jnp.asarray(pix.transpose(0, 2, 3, 1)), cfg.vision)
    )
    assert ours.shape == ref.shape == (2, 1152)
    assert _cos(ours, ref) > 0.999  # BASELINE.md gate
    assert _cos(ours, ref) > 0.99999  # what fp32 actually achieves
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


def test_text_parity_full_shape_masked(full):
    hf, cfg, params, _ = full
    rng = np.random.default_rng(2)
    ids = rng.integers(2, TEXT_KW["vocab_size"], size=(3, 64))
    mask = np.ones((3, 64), np.int64)
    mask[0, 7:] = 0
    mask[1, 33:] = 0
    ids[0, 7:] = 1
    ids[1, 33:] = 1
    with torch.no_grad():
        ref = hf.get_text_features(
            input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)
        ).numpy()
    ours = np.asarray(
        siglip.text_forward(
            params["text"], jnp.asarray(ids), cfg.text, attention_mask=jnp.asarray(mask)
        )
    )
    assert ours.shape == ref.shape == (3, 1152)
    assert _cos(ours, ref) > 0.999
    assert _cos(ours, ref) > 0.99999
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


def test_convert_cli_roundtrip_full_shape(full, tmp_path):
    """HF-layout dir → `tpuclip convert` → tpuclip-native dir → identical params."""
    import jax

    from tpuclip.cli import main as cli_main
    from tpuclip.models.checkpoint import write_safetensors
    from tpuclip.models.loader import load_checkpoint_dir

    _, cfg, params, sd = full
    src = tmp_path / "hf_layout"
    src.mkdir()
    hf_config = {
        "model_type": "siglip",
        "_name_or_path": MODEL,
        "vision_config": dict(VISION_KW),
        "text_config": dict(TEXT_KW),
    }
    (src / "config.json").write_text(json.dumps(hf_config))
    write_safetensors(str(src / "model.safetensors"), dict(sd))

    dst = tmp_path / "native"
    cli_main(["convert", str(src), str(dst)])

    cfg2, params2 = load_checkpoint_dir(str(dst))
    assert cfg2.vision.num_layers == cfg.vision.num_layers
    assert cfg2.embedding_dim == cfg.embedding_dim
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat2 = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params2)}
    assert len(flat) == len(flat2)
    for key, v in flat:
        ks = jax.tree_util.keystr(key)
        np.testing.assert_array_equal(np.asarray(v), np.asarray(flat2[ks]), err_msg=ks)
