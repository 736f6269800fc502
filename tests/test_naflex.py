"""NaFlex (SigLIP2 variable aspect/resolution) parity vs HF Siglip2Model.

Oracle: random-init ``Siglip2VisionModel``/``Siglip2Model`` from config +
``Siglip2ImageProcessor`` (the real preprocessing), same zero-egress strategy
as tests/test_parity.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
pytest.importorskip("transformers.models.siglip2")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tpuclip.io.preprocess import naflex_target_size, preprocess_naflex  # noqa: E402
from tpuclip.models import configs as C  # noqa: E402
from tpuclip.models import naflex  # noqa: E402
from tpuclip.models.convert import params_from_state_dict  # noqa: E402

VISION_KW = dict(
    hidden_size=96,
    intermediate_size=192,
    num_hidden_layers=3,
    num_attention_heads=4,
    patch_size=8,
    num_patches=64,  # 8x8 position grid
)
TEXT_KW = dict(
    vocab_size=200,
    hidden_size=96,
    intermediate_size=192,
    num_hidden_layers=3,
    num_attention_heads=4,
    max_position_embeddings=64,
    projection_size=96,
)


def _tpuclip_cfg():
    return C.SiglipConfig(
        name="naflex-tiny",
        vision=C.VisionConfig(
            hidden_size=96, intermediate_size=192, num_layers=3, num_heads=4,
            patch_size=8, naflex=True, max_num_patches=64,
        ),
        text=C.TextConfig(
            vocab_size=200, hidden_size=96, intermediate_size=192, num_layers=3,
            num_heads=4, projection_size=96,
        ),
    )


@pytest.fixture(scope="module")
def models():
    from transformers import Siglip2Config, Siglip2Model, Siglip2TextConfig, Siglip2VisionConfig

    cfg_hf = Siglip2Config(
        text_config=Siglip2TextConfig(**TEXT_KW).to_dict(),
        vision_config=Siglip2VisionConfig(**VISION_KW).to_dict(),
    )
    torch.manual_seed(0)
    hf = Siglip2Model(cfg_hf).eval()
    cfg = _tpuclip_cfg()
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    params = params_from_state_dict(sd, cfg)
    return hf, cfg, params


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(
        np.min(np.sum(a * b, -1) / (np.linalg.norm(a, -1) * np.linalg.norm(b, -1) + 1e-30))
    )


def _hf_processor_inputs(images):
    from transformers import Siglip2ImageProcessor

    proc = Siglip2ImageProcessor(
        patch_size=VISION_KW["patch_size"], max_num_patches=VISION_KW["num_patches"]
    )
    return proc(images=images, return_tensors="pt")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    sizes = [(40, 72), (96, 24), (64, 64)]  # landscape, portrait, square
    return [
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
        for h, w in sizes
    ]


def test_naflex_vision_parity_hf_processor_inputs(models, images):
    """Feed HF's own processor outputs to both towers: isolates the model."""
    hf, cfg, params = models
    inputs = _hf_processor_inputs(images)
    with torch.no_grad():
        ref = hf.get_image_features(
            pixel_values=inputs["pixel_values"],
            pixel_attention_mask=inputs["pixel_attention_mask"],
            spatial_shapes=inputs["spatial_shapes"],
        ).numpy()
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    ours = np.asarray(
        naflex.get_image_features_naflex(
            params,
            jnp.asarray(inputs["pixel_values"].numpy()),
            jnp.asarray(inputs["pixel_attention_mask"].numpy()),
            jnp.asarray(inputs["spatial_shapes"].numpy()),
            cfg,
        )
    )
    assert ours.shape == ref.shape
    assert _cos(ours, ref) > 0.99999
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def test_naflex_position_resize_matches_torch_interpolate(models):
    """The traced antialiased-bilinear weights must equal
    F.interpolate(..., bilinear, align_corners=False, antialias=True)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(7)
    s, d = 8, 16
    grid = rng.standard_normal((s, s, d)).astype(np.float32)
    for h, w in [(3, 12), (12, 3), (8, 8), (1, 16), (5, 7)]:
        ref = (
            F.interpolate(
                torch.from_numpy(grid).permute(2, 0, 1).unsqueeze(0),
                size=(h, w), mode="bilinear", align_corners=False, antialias=True,
            )
            .reshape(d, h * w).T.numpy()
        )
        out = np.asarray(
            naflex.resize_position_embeddings(
                jnp.asarray(grid), jnp.asarray([[h, w]]), max_length=64
            )
        )[0]
        tol = 3e-5
        np.testing.assert_allclose(out[: h * w], ref, rtol=tol, atol=tol, err_msg=f"{h}x{w}")
        # padded slots repeat slot 0 (HF semantics)
        np.testing.assert_allclose(out[h * w :], np.broadcast_to(out[0], (64 - h * w, d)), rtol=1e-6)


def test_naflex_own_preprocessing_matches_hf(images):
    """tpuclip's host patchify == Siglip2ImageProcessor (uint8 → normalized)."""
    inputs = _hf_processor_inputs(images)
    for i, img in enumerate(images):
        patches, mask, (h, w) = preprocess_naflex(img, VISION_KW["patch_size"], VISION_KW["num_patches"])
        assert (h, w) == tuple(inputs["spatial_shapes"][i].tolist())
        np.testing.assert_array_equal(mask, inputs["pixel_attention_mask"][i].numpy())
        ours_norm = patches.astype(np.float32) / 127.5 - 1.0
        ref = inputs["pixel_values"][i].numpy()
        # Padded slots differ by convention (HF pads 0.0 in normalized space,
        # ours are uint8 zeros → -1) — they are attention-masked either way,
        # so only real patches must match.
        real = mask.astype(bool)
        np.testing.assert_allclose(ours_norm[real], ref[real], atol=1e-6)


def test_naflex_target_size_properties():
    for hgt, wid in [(37, 1000), (1000, 37), (8, 8), (513, 511)]:
        th, tw = naflex_target_size(hgt, wid, 8, 64)
        assert th % 8 == 0 and tw % 8 == 0
        assert (th // 8) * (tw // 8) <= 64
        assert th >= 8 and tw >= 8


def test_naflex_batch_mixed_aspects_invariant_to_padding_rows(models, images):
    """An image's embedding must not depend on other images in the batch.
    (fp32-exact property on the CPU; on an accelerator, different batch
    sizes compile different programs whose matmuls differ in low bits.)"""
    hf, cfg, params = models
    inputs = _hf_processor_inputs(images)
    full = np.asarray(
        naflex.get_image_features_naflex(
            params,
            jnp.asarray(inputs["pixel_values"].numpy()),
            jnp.asarray(inputs["pixel_attention_mask"].numpy()),
            jnp.asarray(inputs["spatial_shapes"].numpy()),
            cfg,
        )
    )
    for i in range(len(images)):
        solo = np.asarray(
            naflex.get_image_features_naflex(
                params,
                jnp.asarray(inputs["pixel_values"][i : i + 1].numpy()),
                jnp.asarray(inputs["pixel_attention_mask"][i : i + 1].numpy()),
                jnp.asarray(inputs["spatial_shapes"][i : i + 1].numpy()),
                cfg,
            )
        )
        np.testing.assert_allclose(full[i], solo[0], rtol=1e-5, atol=1e-5)


def test_naflex_end_to_end_own_pipeline_matches_hf(models, images):
    """Full tpuclip path (own patchify, uint8 transfer, device normalize) vs
    full HF path (processor + model): padded-slot conventions differ but are
    masked, so embeddings must still match."""
    hf, cfg, params = models
    inputs = _hf_processor_inputs(images)
    with torch.no_grad():
        ref = hf.get_image_features(
            pixel_values=inputs["pixel_values"],
            pixel_attention_mask=inputs["pixel_attention_mask"],
            spatial_shapes=inputs["spatial_shapes"],
        ).numpy()
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)

    ours_in = [preprocess_naflex(img, 8, 64) for img in images]
    patches = np.stack([p for p, _, _ in ours_in])  # uint8
    masks = np.stack([m for _, m, _ in ours_in])
    shapes = np.array([s for _, _, s in ours_in], np.int64)
    ours = np.asarray(
        naflex.get_image_features_naflex(
            params, jnp.asarray(patches), jnp.asarray(masks), jnp.asarray(shapes), cfg
        )
    )
    assert _cos(ours, ref) > 0.99999
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def test_naflex_engine_scan_and_search(tmp_path, monkeypatch):
    """Full stack with a NaFlex model: scan a mixed-aspect tree, text search,
    image search — through the same engine surface as the fixed-res model."""
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path))
    from tpuclip.engine import ImageDatabase

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(9)
    for name, size in [("wide.jpg", (30, 90)), ("tall.png", (80, 20)), ("sq.webp", (48, 48))]:
        h, w = size
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(imgs / name)

    eng = ImageDatabase(
        db_path=str(tmp_path / "n.db"),
        model_cache_dir=str(tmp_path / "models"),
        model_name="tpuclip/test-tiny-naflex",
        inference_batch_size=2,  # 3 images -> one full + one padded batch
    )
    assert eng.is_naflex
    eng.scan_directory(str(imgs), inference_batch_size=2)
    assert eng.store.count_images() == 3

    results = eng.search("a wide photo", k=3)
    assert len(results) == 3
    sims = [s for _, s in results]
    assert sims == sorted(sims, reverse=True)

    # image query round-trips and ranks itself (near-)first (bf16-safe
    # threshold: scan-time and query-time programs may differ in low bits)
    results = eng.search(str(imgs / "wide.jpg"), k=3, is_image_path=True)
    assert results[0][0].endswith("wide.jpg")
    assert results[0][1] > 0.99

    # embeddings must match the single-image path (batch invariance incl.
    # the padded final batch; tolerance covers bf16 backends)
    solo = eng._get_image_embedding(str(imgs / "tall.png"))
    batch = eng._get_image_embeddings_batch([str(imgs / "tall.png"), str(imgs / "sq.webp")])
    np.testing.assert_allclose(solo, batch[0], rtol=5e-3, atol=5e-3)
