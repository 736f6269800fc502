"""Seeded synthetic data for the benchmark and the GPU smoke run.

- :func:`build_synthetic_db` bulk-writes an n-row database of unit vectors
  (fp16 vector blobs + unpacked sign-bit blobs — readers detect the dtype of
  each row by blob size). executemany keeps a 1M-row build to seconds; the
  per-row commit path is the scan pipeline's job, measured separately.
- :func:`make_jpeg_tree` writes a photo-like JPEG tree for scan runs.

Both are pure functions of their seed; nothing is downloaded.
"""

from __future__ import annotations

import os
import shutil
import sqlite3

import numpy as np


def unit_vectors(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """(n, d) float32 rows drawn from N(0, 1) and L2-normalized."""
    v = rng.standard_normal((n, d), dtype=np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def build_synthetic_db(db_path: str, n: int, d: int, seed: int,
                       folders: int = 1) -> np.ndarray:
    """Write ``n`` seeded unit vectors through ``MetadataStore``'s schema.

    Row ``i`` (0-based) gets image id ``i + 1`` and the path
    ``/synthetic/f{i % folders}/img_{i:08d}.jpg``. Returns the stored
    vectors as float32 (the fp16 blob values, which is what every reader of
    the database sees), row-aligned with the ids."""
    from tpuclip.index.store import MetadataStore

    rng = np.random.default_rng(seed)
    store = MetadataStore(db_path, embedding_dim=d)
    store.init_schema(verbose=False)
    stored = np.empty((n, d), np.float32)
    conn = sqlite3.connect(db_path)
    try:
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=OFF")
        bs = 20000
        for start in range(0, n, bs):
            m = min(bs, n - start)
            v16 = unit_vectors(rng, m, d).astype(np.float16)
            bits = (v16 >= 0).view(np.uint8)  # reference sign-bit blobs
            stored[start:start + m] = v16
            ids = range(start + 1, start + m + 1)
            conn.executemany(
                "INSERT INTO images (id, file_path, last_modified, file_hash)"
                " VALUES (?, ?, ?, ?)",
                [(i, f"/synthetic/f{(i - 1) % folders}/img_{i - 1:08d}.jpg",
                  0.0, f"h{i:08x}") for i in ids],
            )
            conn.executemany(
                "INSERT INTO embeddings (image_id, vector) VALUES (?, ?)",
                [(start + j + 1, v16[j].tobytes()) for j in range(m)],
            )
            conn.executemany(
                "INSERT INTO binary_embeddings (image_id, embedding) VALUES (?, ?)",
                [(start + j + 1, bits[j].tobytes()) for j in range(m)],
            )
            conn.commit()
    finally:
        conn.close()
    return stored


def make_jpeg_tree(root: str, n_images: int, seed: int = 7, width: int = 1024,
                   height: int = 768, uniques: int = 48) -> str:
    """Synthetic photo library: ``n_images`` JPEGs at width x height in
    eight folders.

    Encoding thousands of multi-MP JPEGs would dominate the run, so
    ``uniques`` distinct images are encoded and the rest are byte copies
    with a unique trailer (PIL decodes past EOI fine; sha256 and decode
    cost stay real per file). Needs Pillow."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    unique_paths = []
    for u in range(min(uniques, n_images)):
        # Photo-like content: smooth low-frequency structure + mild sensor
        # noise compresses like a real photo (raw noise JPEGs are
        # entropy-decode-bound, an unrepresentative decode penalty).
        low = rng.integers(0, 256, size=(height // 8, width // 8, 3), dtype=np.uint8)
        arr = np.asarray(Image.fromarray(low).resize((width, height), Image.BILINEAR))
        arr = (arr.astype(np.int16) + rng.integers(-10, 10, size=arr.shape)).clip(0, 255).astype(np.uint8)
        sub = os.path.join(root, f"folder_{u % 8}")
        os.makedirs(sub, exist_ok=True)
        p = os.path.join(sub, f"img_{u:05d}.jpg")
        Image.fromarray(arr).save(p, "JPEG", quality=85)
        unique_paths.append(p)
    for i in range(len(unique_paths), n_images):
        src = unique_paths[i % len(unique_paths)]
        dst = os.path.join(os.path.dirname(src), f"img_{i:05d}.jpg")
        shutil.copyfile(src, dst)
        with open(dst, "ab") as f:
            f.write(b"\x00tpuclip-synthetic-%d" % i)
    return root
