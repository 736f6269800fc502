"""The resident engine: model + database + device index.

Device-resident counterpart of the reference's ``ImageDatabase`` class
(image_database.py:145-243). One instance holds:

- the SigLIP params resident on device (bf16 on the GPU, fp32 on CPU — the
  analog of the reference's fp16-on-CUDA/fp32-on-CPU split,
  image_database.py:174-175; ``tpuclip.platform.compute_dtype``),
- jit-compiled image/text feature functions with *fixed* batch shapes
  (batches are zero-padded to ``inference_batch_size`` so exactly one
  program is compiled per tower),
- the SQLite metadata store (tpuclip.index.store) and the HBM-resident
  search index (tpuclip.index.search),
- the tokenizer and the thumbnailer.

The private-method surface mirrors the reference so downstream pipelines and
tests translate 1:1: ``_get_image_embedding``, ``_get_image_embeddings_batch``,
``_get_text_embedding`` (image_database.py:443, :465, :509).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpuclip import platform
from tpuclip.config import default_paths
from tpuclip.index.search import DeviceIndex
from tpuclip.index.store import MetadataStore
from tpuclip.io.preprocess import preprocess_batch
from tpuclip.io.thumbnails import Thumbnailer
from tpuclip.models.configs import DEFAULT_MODEL
from tpuclip.models.loader import find_local_checkpoint, load_model
from tpuclip.models.siglip import cast_params, get_image_features, get_text_features
from tpuclip.text.tokenizer import build_prompt, load_tokenizer
from tpuclip.utils.logging import banner, log, safe_print_path


from tpuclip.utils.bucketing import batch_bucket as _batch_bucket


class ImageDatabase:
    """Searchable image database: SigLIP embeddings + on-device retrieval."""

    def __init__(
        self,
        db_path: Optional[str] = None,
        model_cache_dir: Optional[str] = None,
        model_name: str = DEFAULT_MODEL,
        inference_batch_size: int = 16,
        compute_dtype=None,
    ):
        banner("Initializing Image Database")
        from tpuclip.utils.compile_cache import enable_compilation_cache

        enable_compilation_cache()
        paths = default_paths()
        self.db_path = db_path or paths.db_path
        self.model_cache_dir = model_cache_dir if model_cache_dir is not None else paths.model_cache_dir
        self.thumbnails_dir = paths.thumbnails_dir
        self.results_dir = paths.results_dir
        log(f"Database path: {self.db_path}")
        log(f"Model cache directory: {self.model_cache_dir}")

        self.device = jax.devices()[0]
        if compute_dtype is None:
            compute_dtype = platform.compute_dtype(self.device)
        self.compute_dtype = compute_dtype
        log(f"\nCompute device: {platform.platform_of(self.device)} ({self.device})")
        log(f"  [OK] Data type: {jnp.dtype(self.compute_dtype).name}")

        log(f"\nLoading SigLIP 2 model...\n  Model: {model_name}")
        self.model_name = model_name
        self.config, host_params = load_model(model_name, self.model_cache_dir)
        # Params live on device in compute dtype (so400m bf16 ≈ 1.8 GB).
        self.params = jax.device_put(
            cast_params(host_params, self.compute_dtype), self.device
        )
        self.embedding_dim = self.config.embedding_dim
        self.image_size = self.config.vision.image_size
        self.inference_batch_size = int(inference_batch_size)
        log(f"  Embedding dimension: {self.embedding_dim}")

        ckpt_dir = find_local_checkpoint(model_name, self.model_cache_dir)
        self.tokenizer = load_tokenizer(
            model_name,
            str(ckpt_dir) if ckpt_dir else None,
            vocab_size=self.config.text.vocab_size,
        )

        self._text_cache: dict = {}

        log("\nInitializing database...")
        self.store = MetadataStore(self.db_path, embedding_dim=self.embedding_dim)
        self.store.init_schema()
        # meta's embedding_dim is INSERT OR IGNORE — the first writer's dim
        # is the database's truth. A different model against an existing DB
        # would otherwise fail silently at query time (shape error contained
        # to an empty result).
        stored_dim = self.store.stored_embedding_dim()
        if stored_dim and stored_dim != self.embedding_dim:
            log(
                f"  [WARNING] Database was built with {stored_dim}-d embeddings "
                f"but model '{model_name}' produces {self.embedding_dim}-d — "
                "searches will return no results. Use the model the database "
                "was scanned with (or a new --db)."
            )
        self.index = DeviceIndex(self.store, device=self.device)
        self.thumbnailer = Thumbnailer(self.thumbnails_dir)
        banner("Initialization complete!")

    # ------------------------------------------------------------- embeddings

    def embed_images_uint8(self, batch_uint8: np.ndarray) -> np.ndarray:
        """uint8 (B, S, S, 3) → L2-normalized fp32 (B, D).

        Shapes are bucketed to keep compilation bounded: single images (query
        time) run at batch 1; everything else pads to the configured
        inference batch size — exactly two compiled programs per tower.
        """
        b = batch_uint8.shape[0]
        if b > self.inference_batch_size:
            # Chunk oversized batches so only the two fixed shapes compile.
            step = self.inference_batch_size
            return np.concatenate(
                [self.embed_images_uint8(batch_uint8[i : i + step]) for i in range(0, b, step)]
            )
        target = 1 if b == 1 else self.inference_batch_size
        pad = target - b
        if pad > 0:
            batch_uint8 = np.concatenate(
                [batch_uint8, np.zeros((pad,) + batch_uint8.shape[1:], np.uint8)]
            )
        out = get_image_features(
            self.params,
            jnp.asarray(batch_uint8),
            self.config,
            compute_dtype=self.compute_dtype,
        )
        # slice on the host: a device-side slice compiles a program per shape
        return np.asarray(out, dtype=np.float32)[:b]

    def embed_patches_naflex(
        self, patches: np.ndarray, masks: np.ndarray, shapes: np.ndarray
    ) -> np.ndarray:
        """NaFlex path: uint8 patches (B, L, P*P*C) + masks (B, L) + patch
        grids (B, 2) → L2-normalized fp32 (B, D). Same two-bucket shape
        policy as embed_images_uint8."""
        from tpuclip.models.naflex import get_image_features_naflex

        b = patches.shape[0]
        if b > self.inference_batch_size:
            step = self.inference_batch_size
            return np.concatenate(
                [
                    self.embed_patches_naflex(
                        patches[i : i + step], masks[i : i + step], shapes[i : i + step]
                    )
                    for i in range(0, b, step)
                ]
            )
        target = 1 if b == 1 else self.inference_batch_size
        pad = target - b
        if pad > 0:
            patches = np.concatenate([patches, np.zeros((pad,) + patches.shape[1:], patches.dtype)])
            pad_mask = np.zeros((pad, masks.shape[1]), masks.dtype)
            pad_mask[:, 0] = 1  # all-masked rows would NaN the softmax
            masks = np.concatenate([masks, pad_mask])
            shapes = np.concatenate([shapes, np.ones((pad, 2), shapes.dtype)])
        out = get_image_features_naflex(
            self.params,
            jnp.asarray(patches),
            jnp.asarray(masks),
            jnp.asarray(shapes),
            self.config,
            compute_dtype=self.compute_dtype,
        )
        # slice on the host: a device-side slice compiles a program per shape
        return np.asarray(out, dtype=np.float32)[:b]

    def _tokenize_bucketed(self, texts: List[str]):
        """Prompt + tokenize, padded to the ladder batch size so arbitrary
        request sizes reuse a handful of compiled programs instead of
        compiling per length. Returns (ids, mask); pad rows are all-zero
        (masked out) and must be sliced off by the caller."""
        b = len(texts)
        ids, mask = self.tokenizer.encode_batch_with_mask(
            [build_prompt(t) for t in texts]
        )
        bucket = _batch_bucket(b)
        if bucket > b:
            pad = bucket - b
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), mask.dtype)])
        return ids, mask

    def embed_texts(self, texts: List[str]) -> np.ndarray:
        """Prompted, tokenized, L2-normalized text embeddings (fp32).

        Batch dims are bucketed to powers of two (pad rows masked out and
        sliced off) so arbitrary request sizes reuse a handful of compiled
        programs instead of compiling per length.
        """
        b = len(texts)
        if b == 0:
            return np.zeros((0, self.embedding_dim), np.float32)
        ids, mask = self._tokenize_bucketed(texts)
        out = get_text_features(
            self.params,
            jnp.asarray(ids),
            self.config,
            compute_dtype=self.compute_dtype,
            attention_mask=jnp.asarray(mask),
        )
        # slice on the host: a device-side slice compiles a program per shape
        return np.asarray(out, dtype=np.float32)[:b]

    def search_texts(
        self, texts: List[str], k: int, filter_folders=None
    ) -> List[List[tuple]]:
        """Batch text search, fusing tokenize→tower→scan→rescore into ONE
        device program when the index is eligible (int8 + resident device
        rerank copy, no folder filter) — a single host↔device round trip
        per request group. Falls back to embed + search_batch otherwise."""
        if not texts:
            return []
        if self.index.can_fuse_text_search(k, filter_folders):
            return self._search_texts_fused(texts, k)
        vecs = self.embed_texts_cached(texts)
        return self.index.search_batch(vecs, k, filter_folders=filter_folders)

    def _search_texts_fused(self, texts: List[str], k: int) -> List[List[tuple]]:
        """Fused-path body of :meth:`search_texts`: caller has already
        checked ``can_fuse_text_search`` (the gate runs a DB fingerprint
        scan — the serve micro-batcher decides it once per group and must
        not pay it again per call)."""
        ids, mask = self._tokenize_bucketed(texts)
        return self.index.search_texts_fused(
            self.params, ids, mask, self.config, k, self.compute_dtype, len(texts)
        )

    def _search_mixed_fused(self, texts: List[str], images: List, k: int):
        """Mixed text+image fused search: both towers + ONE shared int8
        scan in a single device program (separate text and image passes
        would pay the scan's matrix read twice). Caller has already checked
        ``can_fuse_text_search``; returns (text_results, image_results)
        aligned to the inputs. NaFlex models route through the
        patchified-variant program."""
        ids, mask = self._tokenize_bucketed(texts)
        nb = len(images)
        # Same ladder bucketing as the text rows: a mixed program compiles
        # per (text-bucket, image-bucket) pair, so arbitrary window
        # compositions reuse a small fixed set of compiled programs.
        ib = _batch_bucket(nb)
        if self.is_naflex:
            from tpuclip.io.preprocess import preprocess_naflex

            v = self.config.vision
            trip = [preprocess_naflex(img, v.patch_size, v.max_num_patches)
                    for img in images]
            patches = np.stack([p for p, _, _ in trip])
            masks = np.stack([m for _, m, _ in trip])
            shapes = np.asarray([s for _, _, s in trip], np.int32)
            if ib > nb:
                pad = ib - nb
                patches = np.concatenate(
                    [patches, np.zeros((pad,) + patches.shape[1:], patches.dtype)]
                )
                pad_mask = np.zeros((pad, masks.shape[1]), masks.dtype)
                pad_mask[:, 0] = 1  # all-masked rows would NaN the softmax
                masks = np.concatenate([masks, pad_mask])
                shapes = np.concatenate([shapes, np.ones((pad, 2), np.int32)])
            res = self.index.search_mixed_fused_naflex(
                self.params, ids, mask, patches, masks, shapes,
                self.config, k, self.compute_dtype,
                n_texts=len(texts), n_images=nb,
            )
        else:
            from tpuclip.io.preprocess import resize_to_uint8

            pixels = np.stack(
                [resize_to_uint8(img, self.image_size) for img in images]
            )
            if ib > nb:
                pixels = np.concatenate(
                    [pixels, np.zeros((ib - nb,) + pixels.shape[1:], np.uint8)]
                )
            res = self.index.search_mixed_fused(
                self.params, ids, mask, pixels, self.config, k, self.compute_dtype,
                n_texts=len(texts), n_images=nb,
            )
        # The index drops pad rows and returns real queries texts-first.
        return res[: len(texts)], res[len(texts):]

    def search_image_pil(
        self, img, k: int, filter_folders=None
    ) -> List[tuple]:
        """Single decoded-image search, fusing preprocess→vision-tower→scan→
        rescore into ONE device program when the index is eligible (the
        image analog of :meth:`search_texts`; the reference runs tower and
        scan as separate stages, image_database.py:443-507 then :1564).
        NaFlex models fuse through their own tower entry point. Falls back
        to embed + index.search otherwise."""
        if self.index.can_fuse_image_search(k, filter_folders):
            return self._search_image_fused(img, k)
        emb = self._embed_pil(img)
        return self.index.search(emb, k, filter_folders=filter_folders)

    def _search_image_fused(self, img, k: int) -> List[tuple]:
        """Fused-path body of :meth:`search_image_pil`: caller has already
        checked ``can_fuse_image_search`` (the gate runs a DB fingerprint
        scan — don't pay it twice on one request)."""
        if self.is_naflex:
            from tpuclip.io.preprocess import preprocess_naflex

            v = self.config.vision
            patches, mask, shape = preprocess_naflex(
                img, v.patch_size, v.max_num_patches
            )
            return self.index.search_images_fused_naflex(
                self.params, patches[None], mask[None],
                np.asarray([shape], np.int32), self.config, k,
                self.compute_dtype, 1,
            )[0]
        from tpuclip.io.preprocess import resize_to_uint8

        pixels = resize_to_uint8(img, self.image_size)[None]
        return self.index.search_images_fused(
            self.params, pixels, self.config, k, self.compute_dtype, 1
        )[0]

    def embed_texts_cached(self, texts: List[str]) -> np.ndarray:
        """Batch text embedding through the session LRU: cache hits skip the
        tower; misses embed in ONE pass and populate the cache (the HTTP
        micro-batcher repeats query terms constantly, same as the REPL)."""
        out = np.empty((len(texts), self.embedding_dim), np.float32)
        misses = []
        for i, t in enumerate(texts):
            cached = self._text_cache.get(t)
            if cached is not None:
                out[i] = cached
                self._text_cache[t] = self._text_cache.pop(t)  # refresh recency
            else:
                misses.append(i)
        if misses:
            fresh = self.embed_texts([texts[i] for i in misses])
            for j, i in enumerate(misses):
                out[i] = fresh[j]
                if len(self._text_cache) >= 256:
                    self._text_cache.pop(next(iter(self._text_cache)))
                self._text_cache[texts[i]] = fresh[j].copy()
        return out

    # Reference-surface methods (image_database.py:443-543) -------------------

    @property
    def is_naflex(self) -> bool:
        return self.config.vision.naflex

    def _embed_pil(self, img) -> np.ndarray:
        """Decoded PIL image → L2-normalized embedding (naflex-aware); the
        single embed path shared by path- and bytes-based image queries."""
        if self.is_naflex:
            from tpuclip.io.preprocess import preprocess_naflex

            v = self.config.vision
            patches, mask, shape = preprocess_naflex(img, v.patch_size, v.max_num_patches)
            return self.embed_patches_naflex(
                patches[None], mask[None], np.asarray([shape], np.int32)
            )[0].flatten()
        from tpuclip.io.preprocess import resize_to_uint8

        pixels = resize_to_uint8(img, self.image_size)
        return self.embed_images_uint8(pixels[None])[0].flatten()

    def _get_image_embedding(self, image_path: str) -> Optional[np.ndarray]:
        try:
            from tpuclip.io.decode import load_image

            img = load_image(image_path)
            if img is None:
                return None
            return self._embed_pil(img)
        except Exception as e:  # noqa: BLE001 - containment
            safe_print_path("Error processing ", image_path, e)
            return None

    def embed_pils(self, images) -> np.ndarray:
        """L2-normalized embeddings for a list of decoded PIL images (all
        valid — callers own decode containment). One batched tower pass
        (naflex-aware); the serve micro-batcher's image-group path."""
        if self.is_naflex:
            from tpuclip.io.preprocess import preprocess_naflex

            v = self.config.vision
            L = v.max_num_patches
            patches = np.zeros((len(images), L, v.patch_size**2 * 3), np.uint8)
            masks = np.zeros((len(images), L), np.int32)
            shapes = np.ones((len(images), 2), np.int32)
            for i, img in enumerate(images):
                patches[i], masks[i], shapes[i] = preprocess_naflex(
                    img, v.patch_size, L
                )
            return self.embed_patches_naflex(patches, masks, shapes)
        pixels = preprocess_batch(images, self.image_size)
        return self.embed_images_uint8(pixels)

    def _get_image_embeddings_batch(
        self, image_paths: List[str]
    ) -> List[Optional[np.ndarray]]:
        from tpuclip.io.decode import load_image

        images = [load_image(p) for p in image_paths]
        valid = [i for i, img in enumerate(images) if img is not None]
        if not valid:
            return [None] * len(image_paths)
        try:
            embeddings = self.embed_pils([images[i] for i in valid])
            out: List[Optional[np.ndarray]] = [None] * len(image_paths)
            for j, i in enumerate(valid):
                out[i] = embeddings[j].flatten()
            return out
        except Exception as e:  # noqa: BLE001
            log(f"Error processing batch: {e}")
            return [None] * len(image_paths)

    def _get_text_embedding(self, text: str) -> np.ndarray:
        """Lowercase + template + 64-token pad contract (image_database.py:509-543).

        Session-scoped LRU: interactive sessions and the HTTP server repeat
        query terms constantly (negatives especially); embedding text is pure
        so caching is free accuracy-wise.
        """
        return self.embed_texts_cached([text])[0]

    # ------------------------------------------------------------- pipelines

    def scan_directory(self, root_dir: str, **kwargs):
        from tpuclip.pipelines.scan import scan_directory

        return scan_directory(self, root_dir, **kwargs)

    def search(self, query: str, **kwargs):
        from tpuclip.pipelines.search import search

        return search(self, query, **kwargs)

    def search_by_embedding(self, embedding: np.ndarray, k: int = 10, **kwargs):
        from tpuclip.pipelines.search import search_by_embedding

        return search_by_embedding(self, embedding, k, **kwargs)

    def embed_image_bytes(self, data: bytes) -> Optional[np.ndarray]:
        """L2-normalized embedding for in-memory raster bytes (serve's
        base64 image queries; same containment as path decodes → None)."""
        try:
            from tpuclip.io.decode import load_image_bytes

            img = load_image_bytes(data, "<bytes>")
            if img is None:
                return None
            return self._embed_pil(img)
        except Exception as e:  # noqa: BLE001 - containment
            safe_print_path("Error processing ", "<image bytes>", e)
            return None

    def search_image_bytes(
        self,
        data: bytes,
        k: int = 10,
        filter_folders=None,
        show_duplicates: bool = False,
    ):
        """serve's base64 image-query hot path: decode, then ONE fused
        vision-tower→scan→rescore device program when the index is eligible
        (otherwise embed + search as two stages). Returns None when the
        bytes don't decode to an image."""
        from tpuclip.io.decode import load_image_bytes

        img = load_image_bytes(data, "<bytes>")
        if img is None:
            return None
        if self.index.can_fuse_image_search(k, filter_folders):
            results = self._search_image_fused(img, k)
            if not show_duplicates and results:
                from tpuclip.index.dedup import filter_duplicates

                results = filter_duplicates(self.store, results)
            return results
        emb = self._embed_pil(img)
        return self.search_by_embedding(
            emb, k, filter_folders=filter_folders, show_duplicates=show_duplicates
        )

    def generate_html_gallery(self, results, output_file="results.html", query=None):
        from tpuclip.gallery.html import generate_html_gallery

        generate_html_gallery(
            results, output_file, query=query, thumbnailer=self.thumbnailer
        )

    # Back-compat private names used by pipelines/tests --------------------

    def _needs_thumbnail(self, file_path: str) -> bool:
        from tpuclip.io.thumbnails import needs_thumbnail

        return needs_thumbnail(file_path)
