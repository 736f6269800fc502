"""tpuclip — an image-embedding & retrieval framework on NVIDIA GPUs.

A from-scratch rebuild of the capabilities of droon/CLIP-database
(reference: image_database.py) in JAX:

- SigLIP/SigLIP2 vision+text towers implemented in pure JAX (jit/pjit);
  the int8 scan behind every default query is a Pallas kernel compiled
  through Triton.
- A batched, prefetching host-side decode/preprocess pipeline feeding
  the device, instead of serial per-image PIL work.
- Brute-force cosine search as an on-device fused matmul+top-k over an
  device-resident (optionally mesh-sharded) embedding matrix, instead of
  sqlite-vec's C extension scan.
- SQLite retained for metadata only (same `images` table contract as the
  reference, image_database.py:275-283), embeddings in packed arrays.

Public surface mirrors the reference CLI (scan / search / interactive).
"""

__version__ = "0.1.0"

from tpuclip.config import (  # noqa: F401
    load_config,
    resolve_path,
    resolve_db_dir,
    resolve_db_path,
    list_db_files,
    get_paths,
)

__all__ = [
    "load_config",
    "resolve_path",
    "resolve_db_dir",
    "resolve_db_path",
    "list_db_files",
    "get_paths",
    "__version__",
]
