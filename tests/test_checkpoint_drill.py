"""End-to-end synthetic real-format checkpoint drill (VERDICT r2 item 3).

The pretrained SO400M checkpoint cannot be downloaded here (zero egress), so
this drill exercises the EXACT on-disk artifact path with synthetic content:

  1. an HF-layout checkpoint directory written by the REAL HF stack
     (``SiglipModel.save_pretrained`` → config.json + model.safetensors via
     the genuine safetensors writer, optionally sharded with an index), with
     the real tensor names the reference loads (image_database.py:203/:224);
  2. a real-format ``tokenizer.model`` — a sentencepiece ModelProto with
     Gemma id conventions (pad=0, eos=1, bos=2, unk=3) and a darts-clone
     ``precompiled_charsmap`` — placed beside the weights as the hub does;
  3. ``tpuclip convert`` (the CLI), ``load_model`` cache discovery (both the
     reference's flat layout and the HF hub snapshot layout,
     image_database.py:192-210), tokenizer golden ids, and forward parity of
     the loaded params against the HF model that wrote the artifacts.

After this drill the only step never executed with real weights is the
network download itself.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from tpuclip.models import configs as C  # noqa: E402
from tpuclip.models import siglip  # noqa: E402
from tpuclip.models.loader import find_local_checkpoint, load_model  # noqa: E402
from tpuclip.text import sentencepiece as sp  # noqa: E402
from tpuclip.text.tokenizer import build_prompt, load_tokenizer  # noqa: E402

MODEL_NAME = "google/siglip2-test-drill-patch14-56"

VISION_KW = dict(
    hidden_size=96,
    intermediate_size=192,
    num_hidden_layers=3,
    num_attention_heads=4,
    image_size=56,
    patch_size=14,
)
TEXT_KW = dict(
    vocab_size=64,
    hidden_size=96,
    intermediate_size=192,
    num_hidden_layers=3,
    num_attention_heads=4,
    max_position_embeddings=64,
)


def _gemma_style_tokenizer_model() -> sp.SentencePieceModel:
    """Real-format unigram model with Gemma's id conventions and a
    precompiled_charsmap. Vocab built so the golden segmentations below are
    forced by construction (word pieces score far above letter fallback)."""
    pieces = ["<pad>", "<eos>", "<bos>", "<unk>"]
    types = [sp._CONTROL, sp._CONTROL, sp._CONTROL, sp._UNKNOWN]
    scores = [0.0, 0.0, 0.0, 0.0]
    words = ["▁this", "▁is", "▁a", "▁photo", "▁of", "▁cat", "▁dog", "▁fine", "▁fi"]
    for w in words:
        pieces.append(w)
        types.append(sp._NORMAL)
        scores.append(-1.0)
    # letter fallback so any text stays encodable
    for ch in "abcdefghijklmnopqrstuvwxyz▁":
        pieces.append(ch)
        types.append(sp._NORMAL)
        scores.append(-10.0)
    m = sp.SentencePieceModel(
        pieces=pieces,
        scores=scores,
        types=types,
        model_type=sp.UNIGRAM,
        unk_id=3,
        bos_id=2,
        eos_id=1,
        pad_id=0,
        add_dummy_prefix=True,
        remove_extra_whitespaces=True,
        escape_whitespaces=True,
        precompiled_charsmap=sp.build_precompiled_charsmap({"ﬁ": "fi"}),
    )
    return m.finalize()


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """Synthetic HF checkpoint directory, written by the real HF stack."""
    from transformers import SiglipConfig, SiglipModel

    d = tmp_path_factory.mktemp("hf_ckpt")
    cfg = SiglipConfig.from_text_vision_configs(
        transformers.SiglipTextConfig(**TEXT_KW),
        transformers.SiglipVisionConfig(**VISION_KW),
    )
    torch.manual_seed(7)
    model = SiglipModel(cfg).eval()
    # Shard at a tiny size so the model.safetensors.index.json path is the
    # one exercised (the real SO400M ships one file; sharding is a superset).
    model.save_pretrained(str(d), safe_serialization=True, max_shard_size="200KB")
    (d / "tokenizer.model").write_bytes(
        sp.serialize_model(_gemma_style_tokenizer_model())
    )
    return d, model


def _tpuclip_cfg():
    vision = C.VisionConfig(
        hidden_size=VISION_KW["hidden_size"],
        intermediate_size=VISION_KW["intermediate_size"],
        num_layers=VISION_KW["num_hidden_layers"],
        num_heads=VISION_KW["num_attention_heads"],
        image_size=VISION_KW["image_size"],
        patch_size=VISION_KW["patch_size"],
    )
    text = C.TextConfig(
        vocab_size=TEXT_KW["vocab_size"],
        hidden_size=TEXT_KW["hidden_size"],
        intermediate_size=TEXT_KW["intermediate_size"],
        num_layers=TEXT_KW["num_hidden_layers"],
        num_heads=TEXT_KW["num_attention_heads"],
        projection_size=TEXT_KW["hidden_size"],
    )
    return C.SiglipConfig(name=MODEL_NAME, vision=vision, text=text)


def test_artifact_dir_is_sharded(hf_dir):
    d, _ = hf_dir
    assert (d / "model.safetensors.index.json").exists()
    with open(d / "model.safetensors.index.json") as f:
        weight_map = json.load(f)["weight_map"]
    assert len(set(weight_map.values())) > 1, "fixture should exercise shards"
    # real reference-loaded names present (image_database.py:203)
    assert any(k.startswith("vision_model.encoder.layers.0.") for k in weight_map)
    assert any(k.startswith("text_model.embeddings.") for k in weight_map)


def test_convert_cli_then_forward_parity(hf_dir, tmp_path):
    """tpuclip convert <hf_dir> <dst> → load → forwards match the HF model
    that wrote the artifacts (the full converter path over real files)."""
    from tpuclip.cli import main
    from tpuclip.models.loader import load_checkpoint_dir

    d, hf_model = hf_dir
    dst = tmp_path / "converted"
    main(["convert", str(d), str(dst)])
    assert (dst / "tpuclip.json").exists()

    cfg, params = load_checkpoint_dir(str(dst))
    assert cfg.vision.num_layers == VISION_KW["num_hidden_layers"]

    rng = np.random.default_rng(8)
    pixels = rng.random((2, 56, 56, 3), dtype=np.float32) * 2 - 1
    ids = rng.integers(0, TEXT_KW["vocab_size"], size=(2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)

    ours_img = np.asarray(
        siglip.get_image_features(params, jnp.asarray(pixels), cfg)
    )
    ours_txt = np.asarray(
        siglip.get_text_features(
            params, jnp.asarray(ids), cfg, attention_mask=jnp.asarray(mask)
        )
    )
    with torch.no_grad():
        hf_img = hf_model.get_image_features(
            pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2)
        ).numpy()
        hf_txt = hf_model.get_text_features(
            input_ids=torch.from_numpy(ids.astype(np.int64)),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
        ).numpy()

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for ours, ref in ((ours_img, hf_img), (ours_txt, hf_txt)):
        cos = np.sum(norm(ours) * norm(ref), axis=-1)
        assert np.all(cos >= 0.9999), cos


def test_load_model_reference_flat_cache_layout(hf_dir, tmp_path):
    """load_model probes <cache>/google--<name>/ first — the reference's own
    local layout (image_database.py:192-195)."""
    import shutil

    d, _ = hf_dir
    cache = tmp_path / "cache"
    flat = cache / MODEL_NAME.replace("/", "--")
    shutil.copytree(d, flat)
    cfg, params = load_model(MODEL_NAME, model_cache_dir=str(cache))
    assert cfg.text.vocab_size == TEXT_KW["vocab_size"]
    assert params["vision"]["encoder"]["q_kernel"].shape[0] == VISION_KW["num_hidden_layers"]


def test_load_model_hub_snapshot_layout(hf_dir, tmp_path):
    """load_model also resolves the HF hub cache convention
    (models--org--name/snapshots/<rev>/) the hub download produces."""
    import shutil

    d, _ = hf_dir
    cache = tmp_path / "cache"
    snap = cache / f"models--{MODEL_NAME.replace('/', '--')}" / "snapshots" / "abc123"
    shutil.copytree(d, snap)
    assert find_local_checkpoint(MODEL_NAME, str(cache)) == snap
    cfg, _ = load_model(MODEL_NAME, model_cache_dir=str(cache))
    assert cfg.vision.patch_size == 14


def test_tokenizer_golden_ids(hf_dir):
    """The real-format tokenizer.model beside the weights loads through the
    SentencePiece backend and produces the exact golden ids (forced by vocab
    construction), with Gemma conventions: BOS prepended, pad=0, no EOS."""
    d, _ = hf_dir
    tok = load_tokenizer(MODEL_NAME, checkpoint_dir=str(d))
    assert type(tok).__name__ == "SentencePieceBackend"
    m = _gemma_style_tokenizer_model()
    pid = {p: i for i, p in enumerate(m.pieces)}

    prompt = build_prompt("Cat")  # "this is a photo of cat"
    ids, mask = tok.encode_with_mask(prompt)
    golden = [
        2,  # <bos>
        pid["▁this"], pid["▁is"], pid["▁a"], pid["▁photo"], pid["▁of"], pid["▁cat"],
    ]
    assert ids[: len(golden)].tolist() == golden
    assert ids[len(golden) :].tolist() == [0] * (64 - len(golden))  # pad=0
    assert mask[: len(golden)].tolist() == [1] * len(golden)
    assert int(mask.sum()) == len(golden)


def test_tokenizer_charsmap_normalization(hf_dir):
    """The precompiled_charsmap inside tokenizer.model is interpreted: the
    ligature 'ﬁ' normalizes to 'fi' BEFORE segmentation, so '▁fine' matches."""
    d, _ = hf_dir
    tok = load_tokenizer(MODEL_NAME, checkpoint_dir=str(d))
    m = _gemma_style_tokenizer_model()
    pid = {p: i for i, p in enumerate(m.pieces)}
    ids, _ = tok.encode_with_mask("ﬁne")
    assert ids[0] == 2 and ids[1] == pid["▁fine"]


def test_full_shape_drill(tmp_path):
    """Opt-in (TPUCLIP_FULL_CHECKPOINT_DRILL=1): the same drill at the REAL
    SO400M tensor shapes — config.json with the real dims, safetensors with
    the real names/shapes, convert + load + one forward. ~5 min on this host.
    """
    if os.environ.get("TPUCLIP_FULL_CHECKPOINT_DRILL") != "1":
        pytest.skip("set TPUCLIP_FULL_CHECKPOINT_DRILL=1 for the full-shape drill")
    from transformers import SiglipConfig, SiglipModel

    from tpuclip.cli import main
    from tpuclip.models.configs import get_config
    from tpuclip.models.loader import load_checkpoint_dir

    name = "google/siglip2-so400m-patch14-224"
    cfg = get_config(name)
    hf_cfg = SiglipConfig.from_text_vision_configs(
        transformers.SiglipTextConfig(
            vocab_size=cfg.text.vocab_size,
            hidden_size=cfg.text.hidden_size,
            intermediate_size=cfg.text.intermediate_size,
            num_hidden_layers=cfg.text.num_layers,
            num_attention_heads=cfg.text.num_heads,
            max_position_embeddings=64,
        ),
        transformers.SiglipVisionConfig(
            hidden_size=cfg.vision.hidden_size,
            intermediate_size=cfg.vision.intermediate_size,
            num_hidden_layers=cfg.vision.num_layers,
            num_attention_heads=cfg.vision.num_heads,
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
        ),
    )
    torch.manual_seed(0)
    model = SiglipModel(hf_cfg).eval()
    src = tmp_path / "so400m_hf"
    model.save_pretrained(str(src), safe_serialization=True)
    (src / "tokenizer.model").write_bytes(
        sp.serialize_model(_gemma_style_tokenizer_model())
    )
    dst = tmp_path / "so400m_tpuclip"
    main(["convert", str(src), str(dst)])
    loaded_cfg, params = load_checkpoint_dir(str(dst))
    assert loaded_cfg.vision.hidden_size == cfg.vision.hidden_size
    assert params["text"]["token_embedding"].shape == (
        cfg.text.vocab_size, cfg.text.hidden_size,
    )
    ids = np.zeros((1, 64), np.int32)
    mask = np.ones((1, 64), np.int32)
    ours = np.asarray(
        siglip.get_text_features(
            params, jnp.asarray(ids), loaded_cfg, attention_mask=jnp.asarray(mask)
        )
    )
    with torch.no_grad():
        ref = model.get_text_features(
            input_ids=torch.zeros((1, 64), dtype=torch.int64),
            attention_mask=torch.ones((1, 64), dtype=torch.int64),
        ).numpy()
    cos = float(
        np.sum(ours * ref) / (np.linalg.norm(ours) * np.linalg.norm(ref))
    )
    assert cos >= 0.999, cos
