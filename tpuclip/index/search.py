"""Device-resident search engine.

Replaces the reference's per-query SQL scan (image_database.py:1559-1629):
the packed embedding matrix is uploaded to device memory once per session (or
after index growth) and every query is a fused matmul+top-k. The binary path
(binary-only databases) keeps sign bits PACKED on device (1 bit/dim — 144
bytes/row at 1152-d) and scores with AND+popcount — exact integer parity
with the reference's ``dot(query_bits, cand_bits) / dim``.

What depends on the device (dtypes, default precision, whether the
full-precision rows stay resident, capacity) is decided in
``tpuclip.platform``.

Folder filters become additive score masks built from SQLite LIKE-prefix id
sets (image_database.py:1513-1529 semantics); masks are cached per filter
tuple.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuclip import platform
from tpuclip.index.cache import MatrixCache
from tpuclip.index.store import MetadataStore
from tpuclip.ops.topk import cosine_topk, pad_matrix_t
from tpuclip.utils.logging import log


class DeviceIndex:
    """Device-resident brute-force index over one database."""

    def __init__(
        self,
        store: MetadataStore,
        matrix_dtype=None,
        device=None,
        precision: Optional[str] = None,
        mesh=None,
    ):
        import os

        self.store = store
        self.cache = MatrixCache(store)
        self.matrix_dtype = matrix_dtype or platform.matrix_dtype(device)
        self.device = device
        # Mesh-sharded index: the matrices shard over the 'data' axis and
        # every search is a distributed top-k (one all_gather candidate
        # merge).
        # Opt-in via mesh= or TPUCLIP_SHARDED_INDEX=1 (auto-mesh over all
        # devices); single-device behavior is unchanged.
        if mesh is None and os.environ.get("TPUCLIP_SHARDED_INDEX") == "1":
            import jax as _jax

            if len(_jax.devices()) > 1:
                from tpuclip.parallel.mesh import make_mesh

                mesh = make_mesh()
        self.mesh = mesh
        # "int8" (the GPU default) = per-vector symmetric quantized scan —
        # half the bytes of the bf16 scan — with results exact-ified by an
        # exact rescore of the device shortlist: fused on-device against
        # the resident full-precision copy when it fits device memory, else
        # a host re-rank from the memmapped cache. "bf16" = plain
        # exact-within-bf16 full scan (the CPU default: CPU int8 matmuls
        # win nothing).
        self.precision = precision or os.environ.get(
            "TPUCLIP_SEARCH_PRECISION", platform.default_precision(device)
        )
        self.rerank = os.environ.get("TPUCLIP_SEARCH_RERANK", "1") != "0"
        # Device-side exact re-rank (int8 mode): keep a row-major full-
        # precision copy resident so scan + shortlist + exact rescore run as
        # ONE device program (ops/topk_int8.topk_int8_rerank_fused) instead
        # of a host-memmap gather per query. "auto" enables it on the GPU
        # when int8 + full copies fit device memory (platform.fits; a
        # TPUCLIP_DEVICE_RERANK_MAX_GB cap applies on top when set); force
        # with TPUCLIP_DEVICE_RERANK=1/0.
        # Exactness contract: the device rescore reproduces THE DEFAULT
        # FULL-PRECISION PATH's results (bf16 storage on the GPU). The =0
        # host re-rank instead orders by true-fp32 scores from the memmap,
        # which can flip sub-1e-3 near-ties relative to any bf16 path.
        self.device_rerank = os.environ.get("TPUCLIP_DEVICE_RERANK", "auto")
        # "exact" (default) scans every row; "ivf" probes balanced k-means
        # buckets + an always-scanned overflow block (index/ivf.py) — ~10-30x
        # smaller scan at >=0.95 measured recall, exact scores via the same
        # device rescore. Requires int8 + device-rerank copy. With a mesh the
        # cluster-sharded variant serves (parallel/sharded_ivf.py).
        # "cascade" = packed-binary device prefilter (1 bit/dim on device) +
        # exact rescore of the shortlist from the host memmap. No flat
        # int8/bf16 matrix is uploaded at all, so the device holds N/8
        # bytes/row (~1.4 GB at 10M x 1152) — the single-device mode for
        # indexes whose
        # int8+full copies exceed the budget. Recall is data-dependent
        # (sign-bit prefilter); depth via TPUCLIP_CASCADE_DEPTH.
        # Matrices: int8 is row-major (N_padded, D); bf16/f32 is
        # feature-major (D, N_padded); packed binary words are row-major
        # (N, W), row-sharded under a mesh.
        self.search_mode = os.environ.get("TPUCLIP_SEARCH_MODE", "exact")
        self._cascade = False
        self._ivf = None
        self._ivf_sharded = None  # mesh analog (parallel/sharded_ivf.py)
        self._rows_device = None  # (N_rows, D) bf16/f32 row-major, int8 mode
        self._host_vectors = None  # fp32 memmap, row-aligned with _ids
        self._scales: Optional[jnp.ndarray] = None
        self._ids: Optional[np.ndarray] = None  # row -> image_id
        self._matrix: Optional[jnp.ndarray] = None  # see the layout note above
        self._n_valid: Optional[jnp.ndarray] = None
        self._bin_ids: Optional[np.ndarray] = None
        self._bin_matrix: Optional[jnp.ndarray] = None  # (N, W) packed words
        self._bin_n_valid: Optional[jnp.ndarray] = None
        self._fingerprint: Optional[Tuple[int, int, int, int, int, int]] = None
        self._mask_cache: Dict[Tuple[str, ...], jnp.ndarray] = {}
        # Verified-shortlist observability: how many single-query fused
        # searches ran the proof-checked program, and how many missed into
        # the resident-scores fallback (surfaced at serve /stats).
        self.shortlist_stats = {"verified_queries": 0, "shortlist_fallbacks": 0}

    # ---------------------------------------------------------------- loading

    def _current_fingerprint(self) -> Tuple[int, int, int, int, int, int]:
        """(count, max_id, sum_id) of the embeddings table followed by the
        same triple for binary_embeddings — refresh() slices [:3]/[3:]
        apart again for MatrixCache.refresh, so the 3+3 layout is
        load-bearing."""
        return self.store.embeddings_fingerprint() + self.store.binary_fingerprint()

    def refresh(self, force: bool = False) -> None:
        fp = self._current_fingerprint()
        if not force and fp == self._fingerprint:
            return
        # One cache refresh with the fingerprints we just computed, then
        # refresh-free loads: letting load()/load_binary() each re-refresh
        # would re-run the full-table aggregate scans two more times.
        self.cache.refresh(full_fp=fp[:3], bin_fp=fp[3:])
        ids, vectors = self.cache.load(refresh=False)
        self._ids = ids
        self._host_vectors = vectors if len(ids) else None
        # Drop the previous device arrays first: the capacity gates below
        # read the device's free memory.
        self._rows_device = None
        self._matrix = None
        self._scales = None
        self._bin_matrix = None
        # Invalidate the IVF index up front (not just on the branch that
        # rebuilds it): any path that leaves this method must never keep an
        # IVF referencing the previous matrix's row numbering. The previous
        # index is kept locally so a rebuild can reuse its centroids.
        prev_ivf, self._ivf = self._ivf, None
        prev_sharded, self._ivf_sharded = self._ivf_sharded, None
        # Load binary rows ONCE for both the cascade gate and the binary
        # matrix build further down (a second load_binary re-reads the whole
        # ids sidecar — ~80 MB at 10M rows).
        bin_ids, packed = self.cache.load_binary(refresh=False)
        # Cascade gate: single device, full rows on host, and the binary
        # rows EXACTLY aligned with the full rows (both caches are
        # image_id-ordered, so set equality means index equality). When it
        # holds, skip the flat device matrix entirely — that's the mode's
        # whole point.
        self._cascade = False
        if self.search_mode == "cascade" and len(ids):
            if len(bin_ids) == len(ids) and np.array_equal(bin_ids, ids):
                # Mesh or single device: the packed prefilter shards
                # row-wise, so each device holds N/(8*ndev) bytes/row.
                self._cascade = True
            else:
                log(
                    "  [WARNING] cascade search mode needs binary rows aligned "
                    "with full rows; falling back to the exact scan"
                )
        if len(ids) and self._cascade:
            self._matrix = None
            self._scales = None
            self._rows_device = None
            self._n_valid = None
        elif len(ids):
            # Pre-padded to the scan tile so the per-query path never copies
            # the matrix.
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                from tpuclip.parallel.mesh import DATA_AXIS
                from tpuclip.parallel.sharded_search import shard_matrix

                ndev = self.mesh.shape[DATA_AXIS]
                if self.precision == "int8":
                    from tpuclip.ops.topk_int8 import (
                        INT8_TILE_N,
                        pad_rows,
                        quantize_rows,
                    )

                    # pad to a multiple of both the scan tile and the mesh
                    padded, n_valid = pad_rows(
                        np.asarray(vectors, np.float32), tile_n=INT8_TILE_N * ndev
                    )
                    q, scales = quantize_rows(padded)
                    del padded
                    self._matrix = jax.device_put(
                        jnp.asarray(q), NamedSharding(self.mesh, P(DATA_AXIS, None))
                    )
                    self._scales = jax.device_put(
                        jnp.asarray(scales), NamedSharding(self.mesh, P(DATA_AXIS))
                    )
                    if self.rerank and self._want_device_rerank(len(ids)):
                        # Row-sharded full-precision copy, padded to the same
                        # row count as the sharded int8 matrix, for the
                        # per-shard exact rescore (sharded_topk_int8_rerank).
                        # Convert to the storage dtype BEFORE padding: a
                        # fp32 pad copy of a 10M-row index would double the
                        # host peak for bytes that are immediately downcast.
                        rows = np.asarray(vectors).astype(
                            jnp.dtype(self.matrix_dtype), copy=False
                        )
                        row_pad = q.shape[0] - rows.shape[0]
                        if row_pad:
                            rows = np.pad(rows, ((0, row_pad), (0, 0)))
                        self._rows_device = jax.device_put(
                            jnp.asarray(rows),
                            NamedSharding(self.mesh, P(DATA_AXIS, None)),
                        )
                        if self.search_mode == "ivf" and len(ids) >= 64:
                            # Mesh IVF: host build (the unsharded rows may
                            # not fit ONE device of the mesh), then the
                            # cluster-sharded placement with embedded
                            # storage-dtype rows (parallel/sharded_ivf.py).
                            # `rows` stays host numpy end-to-end: shard_ivf
                            # gathers on host and device_puts per sharding —
                            # an unsharded jnp.asarray here would commit the
                            # whole padded matrix to ONE device first, the
                            # exact thing the host build avoids. Centroids
                            # reuse the previous build's under the same
                            # growth threshold as the single-device path
                            # (k-means retrain under the serving lock).
                            from tpuclip.index.ivf import build_ivf
                            from tpuclip.parallel.sharded_ivf import shard_ivf

                            prev_cent = None
                            trained_n = getattr(
                                self, "_ivf_sharded_trained_n", 0
                            )
                            prev_sh = prev_sharded
                            if (
                                prev_sh is not None
                                and trained_n
                                and len(ids) >= trained_n
                                and (len(ids) - trained_n) / trained_n
                                < self._IVF_RETRAIN_GROWTH
                            ):
                                # Growth measured against the last TRAINING,
                                # not the last reuse build (see
                                # _build_ivf_resident).
                                prev_cent = np.asarray(
                                    prev_sh.centroids, np.float32
                                )[: prev_sh.k_real]
                            ivf_host = build_ivf(
                                np.asarray(vectors, np.float32),
                                centroids=prev_cent,
                            )
                            self._ivf_sharded = shard_ivf(
                                ivf_host, rows, self.mesh
                            )
                            if prev_cent is None:
                                self._ivf_sharded_trained_n = len(ids)
                            log(
                                "  sharded IVF index built: "
                                f"{ivf_host.centroids.shape[0]} buckets over "
                                f"{self.mesh.shape[DATA_AXIS]} devices, "
                                f"nprobe {ivf_host.nprobe}"
                            )
                else:
                    # Feature-major (D, N), padded to the mesh multiple.
                    mt, n_valid = pad_matrix_t(
                        np.ascontiguousarray(np.asarray(vectors).T),
                        tile_n=2048 * ndev,
                    )
                    self._matrix = shard_matrix(
                        jnp.asarray(mt, dtype=self.matrix_dtype), self.mesh
                    )
                    self._scales = None
            elif not self._flat_matrix_fits(len(ids)):
                # Graceful degradation instead of an opaque device OOM: a
                # single-device index whose FLAT matrix alone exceeds the memory
                # cap skips the upload; searches serve from the packed
                # binary index (the reference's own fallback tier) until
                # the user picks a big-index mode.
                fallback = (
                    "serving from the binary index"
                    if fp[3]  # binary_embeddings row count
                    else "NO binary rows exist either — searches will "
                         "return nothing"
                )
                log(
                    f"  [WARNING] index too large for the device's memory "
                    f"({len(ids):,} x {self.store.embedding_dim} "
                    f"{'int8' if self.precision == 'int8' else 'bf16'} does not "
                    f"fit) — {fallback}. "
                    f"Use TPUCLIP_SEARCH_MODE=cascade (exact-rescored, "
                    f"~N/8 bytes resident) or TPUCLIP_SHARDED_INDEX=1 on a "
                    f"mesh. (IVF would not help: its resident footprint "
                    f"exceeds the flat matrix's.)"
                )
                self._matrix = None
                self._scales = None
                self._rows_device = None
                n_valid = 0
            elif self.precision == "int8":
                from tpuclip.ops.topk_int8 import (
                    INT8_TILE_N,
                    derive_int8_matrix_device,
                    pad_rows,
                    quantize_rows,
                )

                self._rows_device = None
                if self.rerank and self._want_device_rerank(len(ids)):
                    # Production configuration: upload the full-precision
                    # rows ONCE and derive the int8 matrix + scales on
                    # device — no host quantization passes and no
                    # second transfer (derive_int8_matrix_device).
                    n_valid = len(ids)
                    n_pad = -(-n_valid // INT8_TILE_N) * INT8_TILE_N
                    self._rows_device = jax.device_put(
                        jnp.asarray(np.asarray(vectors), dtype=self.matrix_dtype),
                        self.device,
                    )
                    self._matrix, self._scales = derive_int8_matrix_device(
                        self._rows_device, n_pad
                    )
                else:
                    padded, n_valid = pad_rows(
                        np.asarray(vectors, np.float32), tile_n=INT8_TILE_N
                    )
                    q, scales = quantize_rows(padded)
                    self._matrix = jax.device_put(jnp.asarray(q), self.device)
                    self._scales = jax.device_put(jnp.asarray(scales), self.device)
                if self._rows_device is not None:
                    if self.search_mode == "ivf" and len(ids) >= 64:
                        self._ivf = self._build_ivf_resident(prev_ivf, len(ids))
                        log(
                            f"  IVF index built: {self._ivf.centroids.shape[0]} "
                            f"buckets, nprobe {self._ivf.nprobe}, overflow "
                            f"{int((np.asarray(self._ivf.over_rows) >= 0).sum()):,} rows"
                        )
            else:
                mt, n_valid = pad_matrix_t(np.ascontiguousarray(np.asarray(vectors).T))
                self._matrix = jax.device_put(
                    jnp.asarray(mt, dtype=self.matrix_dtype), self.device
                )
                self._scales = None
            self._n_valid = jnp.asarray(n_valid, jnp.int32)
        else:
            self._matrix = None
            self._scales = None
            self._n_valid = None

        self._bin_ids = bin_ids  # loaded once above, shared with the gate
        if len(bin_ids):
            # Packed words stay packed on device: 1 bit/dim; scoring is
            # AND+popcount (tpuclip.ops.hamming.binary_topk_packed).
            words = np.asarray(packed)
            pad = (-words.shape[-1]) % 4
            if pad:
                words = np.pad(words, ((0, 0), (0, pad)))
            words = words.view(np.uint32)
            self._bin_n_valid = jnp.asarray(words.shape[0], jnp.int32)
            if self.mesh is not None:
                # Row-shard the packed words over the data axis (zero rows
                # pad to the mesh multiple; masked out via _bin_n_valid).
                from jax.sharding import NamedSharding, PartitionSpec as P

                from tpuclip.parallel.mesh import DATA_AXIS

                ndev = self.mesh.shape[DATA_AXIS]
                row_pad = (-words.shape[0]) % ndev
                if row_pad:
                    words = np.pad(words, ((0, row_pad), (0, 0)))
                self._bin_matrix = jax.device_put(
                    jnp.asarray(words), NamedSharding(self.mesh, P(DATA_AXIS, None))
                )
            else:
                self._bin_matrix = jax.device_put(jnp.asarray(words), self.device)
        else:
            self._bin_matrix = None
            self._bin_n_valid = None
        self._fingerprint = fp
        self._mask_cache.clear()
        if len(ids) or len(bin_ids):
            log(
                f"  Index resident on {platform.platform_of(self.device)}: "
                f"{len(ids):,} full vectors, {len(bin_ids):,} binary rows"
            )

    # IVF centroids are retrained only when the index grew by more than this
    # fraction since the last build; below it the previous centroids are
    # reused and the rebuild is a single assignment pass (the appended rows
    # barely move the distribution). Keeps incremental-scan refreshes from
    # stalling queries behind a full k-means retrain.
    _IVF_RETRAIN_GROWTH = 0.2

    def _build_ivf_resident(self, prev_ivf, n_rows: int):
        """Build/refresh the IVF index from the device-resident rows.

        Runs entirely on device (index/ivf.py:build_ivf_device) — seconds of
        device time instead of minutes of host numpy at 1M rows, which
        matters because refresh() runs under the serving lock. When the
        index grew < _IVF_RETRAIN_GROWTH since the LAST TRAINING (not the
        last build — re-basing every reuse would let steady sub-threshold
        growth compound forever on the original centroids; review r3), the
        old centroids are reused and only assignment/quantize/scatter
        re-run.
        """
        from tpuclip.index.ivf import build_ivf_device

        centroids = None
        trained_n = getattr(self, "_ivf_trained_n", 0)
        if (
            prev_ivf is not None
            and trained_n
            and n_rows >= trained_n
            and (n_rows - trained_n) / trained_n < self._IVF_RETRAIN_GROWTH
        ):
            centroids = prev_ivf.centroids
        k_clusters = centroids.shape[0] if centroids is not None else None
        ivf = build_ivf_device(
            self._rows_device, k_clusters=k_clusters, centroids=centroids
        )
        if centroids is None:
            self._ivf_trained_n = n_rows
        return ivf

    @staticmethod
    def _ivf_footprint_bytes(n_rows: int, d: int, capacity_factor: float = 1.5) -> int:
        """Estimated resident HBM for an IVF build at n_rows (index/ivf.py
        layout): balanced int8 buckets are ~capacity_factor x the flat int8
        matrix, plus per-slot scales (f32) + row ids (i32), centroids, and
        the overflow block (small, bounded by the bucket estimate)."""
        slots = int(n_rows * capacity_factor)
        k_clusters = max(8, min(2 * int(np.sqrt(max(n_rows, 1))), n_rows // 8 or 8))
        return slots * d + slots * 8 + k_clusters * d * 4

    def _flat_matrix_fits(self, n_rows: int) -> bool:
        """Capacity gate for the single-device FLAT matrix upload: without
        it an oversized index dies inside device_put with an opaque OOM.
        The gate covers only the scan matrix itself (the int8+full-copy
        pair has its own in _want_device_rerank). Sized from the device's
        memory (platform.fits); TPUCLIP_INDEX_HBM_GB sets an explicit cap
        instead (which also applies where the device reports no memory,
        e.g. in CPU tests)."""
        import os

        d = self.store.embedding_dim
        if self.precision == "int8":
            flat = n_rows * d  # int8 bytes; scales are negligible
        else:
            flat = n_rows * d * jnp.dtype(self.matrix_dtype).itemsize
        env = os.environ.get("TPUCLIP_INDEX_HBM_GB")
        if env is not None:
            try:
                return flat / 1e9 <= float(env)
            except ValueError:
                # Malformed knob must not take down every search — same
                # fall-back-to-default policy as the other env parsers.
                log(f"  [WARNING] ignoring malformed TPUCLIP_INDEX_HBM_GB={env!r}")
        return platform.fits(flat, self.device)

    def _want_device_rerank(self, n_rows: int) -> bool:
        """Device re-rank gate: forced by TPUCLIP_DEVICE_RERANK=1/0, else auto
        (platform.device_rerank_default, and the int8 matrix plus the full
        copy — plus the IVF blocks when TPUCLIP_SEARCH_MODE=ivf — fit the
        device's memory; TPUCLIP_DEVICE_RERANK_MAX_GB caps it further)."""
        import os

        if self.device_rerank == "0":
            return False
        if self.device_rerank == "1":
            return True
        if not platform.device_rerank_default(self.device):
            return False
        d = self.store.embedding_dim
        itemsize = jnp.dtype(self.matrix_dtype).itemsize
        ndev = 1
        if self.mesh is not None:
            from tpuclip.parallel.mesh import DATA_AXIS

            ndev = self.mesh.shape[DATA_AXIS]
        # per-device bytes: both the int8 matrix and the full copy shard
        total_bytes = n_rows * d * (1 + itemsize) / ndev
        if self.search_mode == "ivf":
            # IVF blocks live alongside the flat int8 matrix and the rerank
            # copy, so they count against the same budget (unaccounted, a
            # large index passes the gate then OOMs during build — exactly
            # the large-N regime IVF targets). The mesh variant additionally
            # embeds a storage-dtype row per bucket slot
            # (parallel/sharded_ivf.py), all sharded over the mesh.
            extra = self._ivf_footprint_bytes(n_rows, d)
            if self.mesh is not None:
                extra += int(n_rows * 1.5) * d * itemsize
            total_bytes += extra / ndev
        cap = os.environ.get("TPUCLIP_DEVICE_RERANK_MAX_GB")
        if cap is not None and total_bytes / 1e9 > float(cap):
            return False
        return platform.fits(total_bytes, self.device)

    def _padded_n(self) -> int:
        """Padded row count of the resident flat matrix (int8 is row-major,
        the float matrix feature-major)."""
        if self.precision == "int8":
            return self._matrix.shape[0]
        return self._matrix.shape[1]

    @property
    def num_full(self) -> int:
        return 0 if self._ids is None else len(self._ids)

    @property
    def num_binary(self) -> int:
        return 0 if self._bin_ids is None else len(self._bin_ids)

    # ----------------------------------------------------------------- masks

    def _folder_mask(
        self, filter_folders: Sequence[str], row_ids: np.ndarray, padded_n: int
    ) -> jnp.ndarray:
        """Additive -inf/0 mask over the padded column width."""
        key = tuple(sorted(filter_folders)) + (len(row_ids), padded_n)
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        allowed = self.store.folder_filter_ids(filter_folders)
        allowed_arr = np.fromiter(allowed, dtype=np.int64, count=len(allowed))
        keep = np.zeros((padded_n,), bool)
        keep[: len(row_ids)] = np.isin(row_ids, allowed_arr)
        mask = jnp.asarray(np.where(keep, 0.0, -np.inf), dtype=jnp.float32)
        mask = jax.device_put(mask, self.device)
        self._mask_cache[key] = mask
        return mask

    # ---------------------------------------------------------------- search

    def search(
        self,
        query: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[Tuple[str, float]]:
        """Top-k over the index. Returns [(file_path, similarity)] descending.

        Full-precision path when float vectors exist; binary fallback
        otherwise (same preference order as image_database.py:1532-1556).
        """
        self.refresh()
        if self._cascade_ready():
            out = self._search_cascade(
                np.asarray(query, np.float32).reshape(1, -1), k, filter_folders
            )
            return out[0] if out else []
        if self._matrix is not None:
            return self._search_full(query, k, filter_folders)
        if self._bin_matrix is not None:
            return self._search_binary(query, k, filter_folders)
        return []

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_folders: Optional[Sequence[str]] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Top-k for Q queries in ONE device pass (the matrix is read once for
        the whole batch — amortizes the scan across concurrent queries)."""
        self.refresh()
        if len(queries) == 0:
            # atleast_2d would turn an empty list into one zero-length query
            # row and return a spurious result list for zero queries.
            return []
        if self._cascade_ready():
            return self._search_cascade(
                np.asarray(queries, np.float32).reshape(len(queries), -1),
                k, filter_folders,
            )
        if self._matrix is None:
            return [self.search(q, k, filter_folders) for q in np.atleast_2d(queries)]
        # Ladder-bucket the query count: the device paths below compile per
        # Q shape, and serve windows arrive at arbitrary sizes (r5 load
        # bench). Zero pad rows score 0 everywhere and are sliced off
        # before result mapping.
        from tpuclip.utils.bucketing import batch_bucket

        q_real = len(queries)
        q_host = np.asarray(queries, np.float32).reshape(q_real, -1)
        bucket = batch_bucket(q_real)
        if bucket > q_real:
            q_host = np.concatenate(
                [q_host, np.zeros((bucket - q_real, q_host.shape[1]), np.float32)]
            )
        q = jnp.asarray(q_host)
        mask = (
            self._folder_mask(filter_folders, self._ids, self._padded_n())
            if filter_folders
            else None
        )
        if (
            self.precision == "int8"
            and mask is None
            and self._ivf_sharded is not None
            and k <= 128
        ):
            from tpuclip.parallel.sharded_ivf import sharded_ivf_search

            scores, rows = sharded_ivf_search(self._ivf_sharded, q, k)
            scores, rows = np.asarray(scores), np.asarray(rows)
        elif (
            self.precision == "int8"
            and mask is None
            and self._rows_device is not None
            and self.mesh is not None
            and k <= 128
        ):
            from tpuclip.parallel.sharded_search import sharded_topk_int8_rerank

            scores, rows = sharded_topk_int8_rerank(
                q, self._matrix, self._scales, self._rows_device, k,
                self.mesh, self._n_valid,
            )
            scores, rows = np.asarray(scores), np.asarray(rows)
        elif (
            self.precision == "int8"
            and mask is None
            and self._ivf is not None
            and k <= 128
        ):
            from tpuclip.index.ivf import ivf_search

            scores, rows = ivf_search(self._ivf, self._rows_device, np.asarray(q), k)
            scores, rows = np.asarray(scores), np.asarray(rows)
        elif (
            self.precision == "int8"
            and mask is None
            and self._rows_device is not None
            and k <= 128
        ):
            from tpuclip.ops.topk_int8 import topk_int8_rerank_fused_auto

            scores, rows = topk_int8_rerank_fused_auto(
                q, self._matrix, self._scales, self._rows_device, k,
                n_valid=self._n_valid, stats=self.shortlist_stats,
            )
            scores, rows = np.asarray(scores), np.asarray(rows)
        elif self.precision == "int8":
            from tpuclip.ops.topk_int8 import topk_int8_batch

            # quantize + scan + scale fold in ONE device program (no
            # per-request host numpy — serve micro-batches hit this path);
            # same exact fp32 re-rank contract as the single-query path.
            do_rerank = self.rerank and self._host_vectors is not None
            k_short = max(4 * k, 64) if do_rerank else k
            scores, rows = topk_int8_batch(
                q, self._matrix, self._scales, k_short, n_valid=self._n_valid, mask=mask
            )
            if do_rerank:
                scores, rows = self._exact_rerank_batch(
                    np.asarray(q, np.float32), np.asarray(scores), np.asarray(rows), k
                )
            else:
                scores = np.asarray(scores)
        else:
            scores, rows = cosine_topk(q, self._matrix, k, mask=mask, n_valid=self._n_valid)
            scores = np.asarray(scores)
        rows = np.asarray(rows)
        # Drop the bucket pad rows: _map_batch_results does a per-row path
        # lookup, which pad rows must not pay.
        return self._map_batch_results(scores[:q_real], rows[:q_real], q_real)

    def _map_batch_results(self, scores, rows, q_count):
        """(Q, k) host scores/rows → per-query [(path, similarity)] lists."""
        out = []
        for qi_row in range(q_count):
            valid = np.isfinite(scores[qi_row]) & (rows[qi_row] < len(self._ids))
            image_ids = self._ids[rows[qi_row][valid]]
            paths = self.store.fetch_paths_for_ids(image_ids)
            out.append(
                [
                    (paths[int(i)], float(s))
                    for i, s in zip(image_ids, scores[qi_row][valid])
                    if int(i) in paths
                ]
            )
        return out

    def can_fuse_text_search(self, k: int, filter_folders,
                             assume_fresh: bool = False) -> bool:
        """True when the token-ids → text-tower → int8 scan → exact rescore
        pipeline can run as ONE device program for this index state.

        ``assume_fresh=True`` skips the implicit refresh — for callers that
        just called :meth:`refresh` under the same lock (the serve
        micro-batcher): each refresh is a pair of full-index-aggregate
        SQLite scans, and a redundant one costs a window real time."""
        if not assume_fresh:
            self.refresh()
        return (
            not filter_folders
            and self.precision == "int8"
            and self._matrix is not None
            and self._rows_device is not None
            and self.mesh is None
            and k <= 128
        )

    # The image-query fusability gate is the text gate verbatim: fusion is a
    # property of the index state (resident int8 matrix + full-precision
    # copy, single device, no folder mask), not of which tower feeds it.
    can_fuse_image_search = can_fuse_text_search

    def _run_fused(self, run_fused, k: int, q_count: int, row_sel=None):
        """Shared tail of the fused tower→scan→rescore paths.

        ``run_fused(method, keep_scores)`` executes the jitted program
        (text or vision tower + int8 scan) and returns its raw outputs.
        Handles the shortlist policy (resolve_shortlist_method): the
        verified program with the resident-scores proof-miss fallback when
        selected, the plain program otherwise.
        ``row_sel`` selects the REAL output rows when the program's query
        block holds interior padding (the mixed text+image layout pads
        each span to its bucket) — without it every pad row would pay a
        per-row SQLite path lookup in ``_map_batch_results``."""
        from tpuclip.ops.topk_int8 import (
            fallback_shortlist_depth,
            resolve_shortlist_method,
            topk_exact_from_scores,
        )

        method = resolve_shortlist_method()
        if method == "verified":
            scores, rows, ok, scores_res, emb = run_fused("verified", True)
            self.shortlist_stats["verified_queries"] += 1
            if not bool(np.asarray(ok)):
                # Rare approx-shortlist shortfall: exact top_k over the
                # score matrix the fused program kept resident — neither
                # the tower nor the scan re-runs (host-side decision). ok
                # can only be False when the scores path ran, so
                # scores_res is always non-empty here.
                self.shortlist_stats["shortlist_fallbacks"] += 1
                n = scores_res.shape[1]
                m = fallback_shortlist_depth(k, n)
                scores, rows = topk_exact_from_scores(
                    scores_res, emb, self._rows_device, k, m
                )
        if method != "verified":
            scores, rows = run_fused(method, False)
        scores = np.asarray(scores)
        rows = np.asarray(rows)
        if row_sel is not None:
            scores, rows = scores[row_sel], rows[row_sel]
            q_count = len(row_sel)
        else:
            scores, rows = scores[:q_count], rows[:q_count]
        return self._map_batch_results(scores, rows, q_count)

    def search_texts_fused(self, params, ids, mask, config, k, compute_dtype, q_count):
        """Tokenized text queries → ranked results in ONE device round trip.

        Fuses the text tower with the int8 scan + exact rescore
        (ops/topk_int8.text_topk_fused): no intermediate embedding ever
        returns to the host, which removes one full host↔device round trip
        per request group. Caller must have checked
        ``can_fuse_text_search``."""
        from tpuclip.ops.topk_int8 import text_topk_fused

        ids_d, mask_d = jnp.asarray(ids), jnp.asarray(mask)

        def run(method, keep_scores):
            return text_topk_fused(
                params, ids_d, mask_d, self._matrix,
                self._scales, self._rows_device, config, k,
                n_valid=self._n_valid, compute_dtype=compute_dtype,
                shortlist_method=method,
                keep_scores=keep_scores,
            )

        return self._run_fused(run, k, q_count)

    def search_images_fused(self, params, pixels, config, k, compute_dtype, q_count):
        """uint8 query pixels → ranked results in ONE device round trip —
        the image analog of :meth:`search_texts_fused` (vision tower + int8
        scan + exact rescore fused; ops/topk_int8.image_topk_fused). Caller
        must have checked ``can_fuse_image_search``."""
        from tpuclip.ops.topk_int8 import image_topk_fused

        pixels_d = jnp.asarray(pixels)

        def run(method, keep_scores):
            return image_topk_fused(
                params, pixels_d, self._matrix,
                self._scales, self._rows_device, config, k,
                n_valid=self._n_valid, compute_dtype=compute_dtype,
                shortlist_method=method,
                keep_scores=keep_scores,
            )

        return self._run_fused(run, k, q_count)

    def search_mixed_fused(
        self, params, ids, mask, pixels, config, k, compute_dtype,
        n_texts: int, n_images: int,
    ):
        """Mixed text+image query block through ONE device program (text
        tower + vision tower + one shared int8 scan + exact rescore;
        ops/topk_int8.mixed_topk_fused — the scan's matrix read is ~flat
        in query count, so separate text/image passes of a mixed serve
        window would pay it twice). Returns results for the REAL queries only, texts first
        then images (the padded block's layout is texts at [0, Tb),
        images at [Tb, Tb+Ib); pad rows are dropped before the per-row
        path mapping). Caller must have checked ``can_fuse_text_search``."""
        from tpuclip.ops.topk_int8 import mixed_topk_fused

        ids_d, mask_d = jnp.asarray(ids), jnp.asarray(mask)
        pixels_d = jnp.asarray(pixels)
        tb = int(ids.shape[0])
        total = tb + int(pixels.shape[0])
        row_sel = list(range(n_texts)) + list(range(tb, tb + n_images))

        def run(method, keep_scores):
            return mixed_topk_fused(
                params, ids_d, mask_d, pixels_d, self._matrix,
                self._scales, self._rows_device, config, k,
                n_valid=self._n_valid, compute_dtype=compute_dtype,
                shortlist_method=method,
                keep_scores=keep_scores,
            )

        return self._run_fused(run, k, total, row_sel=row_sel)

    def search_mixed_fused_naflex(
        self, params, ids, mask, patches, pixel_mask, shapes, config, k,
        compute_dtype, n_texts: int, n_images: int,
    ):
        """:meth:`search_mixed_fused` for NaFlex inputs (text tower +
        NaFlex vision tower + one shared scan; same texts-first real-rows
        output contract). Caller must have checked ``can_fuse_text_search``."""
        from tpuclip.ops.topk_int8 import mixed_naflex_topk_fused

        ids_d, mask_d = jnp.asarray(ids), jnp.asarray(mask)
        patches_d = jnp.asarray(patches)
        pmask_d = jnp.asarray(pixel_mask)
        shapes_d = jnp.asarray(shapes)
        tb = int(ids.shape[0])
        total = tb + int(patches.shape[0])
        row_sel = list(range(n_texts)) + list(range(tb, tb + n_images))

        def run(method, keep_scores):
            return mixed_naflex_topk_fused(
                params, ids_d, mask_d, patches_d, pmask_d, shapes_d,
                self._matrix, self._scales, self._rows_device, config, k,
                n_valid=self._n_valid, compute_dtype=compute_dtype,
                shortlist_method=method,
                keep_scores=keep_scores,
            )

        return self._run_fused(run, k, total, row_sel=row_sel)

    def search_images_fused_naflex(
        self, params, patches, mask, shapes, config, k, compute_dtype, q_count
    ):
        """:meth:`search_images_fused` for NaFlex (variable-aspect) inputs:
        uint8 patches + mask + grid through ops/topk_int8.
        naflex_image_topk_fused. Caller must have checked
        ``can_fuse_image_search``."""
        from tpuclip.ops.topk_int8 import naflex_image_topk_fused

        patches_d = jnp.asarray(patches)
        mask_d = jnp.asarray(mask)
        shapes_d = jnp.asarray(shapes)

        def run(method, keep_scores):
            return naflex_image_topk_fused(
                params, patches_d, mask_d, shapes_d, self._matrix,
                self._scales, self._rows_device, config, k,
                n_valid=self._n_valid, compute_dtype=compute_dtype,
                shortlist_method=method,
                keep_scores=keep_scores,
            )

        return self._run_fused(run, k, q_count)

    def _search_full(self, query, k, filter_folders):
        mask = (
            self._folder_mask(filter_folders, self._ids, self._padded_n())
            if filter_folders
            else None
        )
        if self.mesh is not None:
            if self.precision == "int8":
                if mask is None and self._ivf_sharded is not None and k <= 128:
                    # Mesh IVF: per-shard local probe + embedded-row exact
                    # rescore, one all_gather merge (parallel/sharded_ivf.py).
                    from tpuclip.parallel.sharded_ivf import sharded_ivf_search

                    scores, rows = sharded_ivf_search(
                        self._ivf_sharded,
                        np.asarray(query, np.float32).reshape(1, -1), k,
                    )
                elif mask is None and self._rows_device is not None and k <= 128:
                    # Distributed fused path: per-shard int8 scan + exact
                    # rescore against the row-sharded full-precision copy,
                    # one all_gather candidate merge — no host re-rank.
                    from tpuclip.parallel.sharded_search import (
                        sharded_topk_int8_rerank,
                    )

                    scores, rows = sharded_topk_int8_rerank(
                        jnp.asarray(np.asarray(query, np.float32).reshape(1, -1)),
                        self._matrix, self._scales, self._rows_device, k,
                        self.mesh, self._n_valid,
                    )
                else:
                    from tpuclip.ops.topk_int8 import quantize_query
                    from tpuclip.parallel.sharded_search import sharded_topk_int8

                    do_rerank = self.rerank and self._host_vectors is not None
                    k_short = max(4 * k, 64) if do_rerank else k
                    qi, qs = quantize_query(
                        np.asarray(query, np.float32).reshape(1, -1)
                    )
                    scores, rows = sharded_topk_int8(
                        jnp.asarray(qi), self._matrix, self._scales,
                        jnp.asarray(qs, jnp.float32), k_short, self.mesh,
                        self._n_valid, mask=mask,
                    )
                    if do_rerank:
                        scores, rows = self._exact_rerank(query, scores, rows, k)
            else:
                from tpuclip.parallel.sharded_search import sharded_topk

                q = jnp.asarray(
                    np.asarray(query, np.float32).reshape(1, -1), self._matrix.dtype
                )
                scores, rows = sharded_topk(
                    q, self._matrix, k, self.mesh, self._n_valid, mask=mask
                )
        elif self.precision == "int8":
            from tpuclip.ops.topk_int8 import (
                quantize_query,
                topk_int8_rerank_fused_auto,
                topk_int8_scan,
            )

            q2d = np.asarray(query, np.float32).reshape(1, -1)
            if mask is None and self._ivf is not None and k <= 128:
                from tpuclip.index.ivf import ivf_search

                scores, rows = ivf_search(self._ivf, self._rows_device, q2d, k)
            elif mask is None and self._rows_device is not None and k <= 128:
                # ONE device program: int8 scan -> shortlist -> exact rescore
                # against the resident full-precision rows.
                scores, rows = topk_int8_rerank_fused_auto(
                    jnp.asarray(q2d), self._matrix, self._scales,
                    self._rows_device, k, n_valid=self._n_valid,
                    stats=self.shortlist_stats,
                )
            else:
                # With re-ranking (default), pull a deeper shortlist from the
                # quantized scan; exact fp32 ordering from the host memmap.
                do_rerank = self.rerank and self._host_vectors is not None
                k_short = max(4 * k, 64) if do_rerank else k
                qi, qs = quantize_query(q2d)
                scores, rows = topk_int8_scan(
                    jnp.asarray(qi), self._matrix, self._scales,
                    jnp.asarray(qs, jnp.float32), k_short,
                    n_valid=self._n_valid, mask=mask,
                )
                if do_rerank:
                    scores, rows = self._exact_rerank(query, scores, rows, k)
        else:
            q = jnp.asarray(np.asarray(query, np.float32).reshape(1, -1))
            scores, rows = cosine_topk(q, self._matrix, k, mask=mask, n_valid=self._n_valid)
        scores = np.asarray(scores[0])
        rows = np.asarray(rows[0])
        valid = np.isfinite(scores) & (rows < len(self._ids))
        scores, rows = scores[valid], rows[valid]
        image_ids = self._ids[rows]
        paths = self.store.fetch_paths_for_ids(image_ids)
        return [
            (paths[int(i)], float(s))
            for i, s in zip(image_ids, scores)
            if int(i) in paths
        ]

    def _exact_rerank(self, query, scores, rows, k):
        """Exact fp32 rescoring of a quantized shortlist.

        Gathers the shortlisted rows from the memmapped fp32 matrix
        (~k_short x D x 4 bytes of page-cached reads) and re-sorts by true
        dot product — quantized modes return exact rankings at shortlist
        recall (~1.0 at 4x depth).
        """
        srows = np.asarray(rows[0])
        sscores = np.asarray(scores[0])
        valid = np.isfinite(sscores) & (srows >= 0) & (srows < len(self._ids))
        srows = srows[valid]
        if len(srows) == 0:
            return scores, rows
        q = np.asarray(query, np.float32).reshape(-1)
        exact = np.asarray(self._host_vectors[srows], np.float32) @ q
        order = np.lexsort((srows, -exact))[:k]
        out_s = exact[order][None, :]
        out_r = srows[order][None, :]
        return out_s, out_r

    def _exact_rerank_batch(self, qn, scores, rows, k):
        """Batched exact fp32 rescoring of quantized shortlists.

        One stacked memmap gather + einsum for the whole batch instead of a
        per-query Python loop (the masked/over-budget ``search_batch`` path —
        e.g. a folder-filtered batch — hits this under the engine lock, so
        per-row numpy there serialized concurrent requests). Invalid slots
        come back as (-inf, len(self._ids)) so downstream filtering drops
        them.
        """
        n_ids = len(self._ids)
        valid = np.isfinite(scores) & (rows >= 0) & (rows < n_ids)
        safe = np.where(valid, rows, 0)
        gathered = np.asarray(self._host_vectors[safe], np.float32)  # (Q, Ks, D)
        exact = np.einsum("qkd,qd->qk", gathered, qn)
        exact = np.where(valid, exact, -np.inf)
        # Sentinel must survive the result dtype: rows is int32, and under
        # NumPy 2 `np.where(valid, rows, int64_max)` KEEPS int32, wrapping
        # the sentinel to -1 (review r3). n_ids is > every valid row and
        # representable, and doubles as the drop marker downstream.
        sort_rows = np.where(valid, rows, n_ids)
        order = np.lexsort((sort_rows, -exact), axis=-1)[:, :k]
        out_s = np.take_along_axis(exact, order, axis=1)
        out_r = np.take_along_axis(sort_rows, order, axis=1)
        out_r = np.where(np.isfinite(out_s), out_r, n_ids)
        return out_s, out_r

    def _binary_topk_raw(self, qwords, k, mask):
        """Packed-binary top-k for (Q, W) packed queries; returns (matches,
        rows) device arrays (shared by the binary search and the cascade
        prefilter)."""
        if self.mesh is not None:
            from tpuclip.parallel.sharded_search import sharded_binary_topk

            return sharded_binary_topk(
                jnp.asarray(qwords), self._bin_matrix, k, self.mesh,
                self._bin_n_valid, mask=mask,
            )
        from tpuclip.ops.hamming import binary_topk_packed

        return binary_topk_packed(jnp.asarray(qwords), self._bin_matrix, k, mask=mask)

    def _binary_query_and_mask(self, queries_2d: np.ndarray, filter_folders):
        """Shared preamble for the binary search and the cascade prefilter:
        sign-pack the queries and build the (optional) folder mask over the
        binary layout's padded width."""
        from tpuclip.ops.hamming import pack_bits_to_words

        qn = np.asarray(queries_2d, np.float32)
        qwords = pack_bits_to_words((qn >= 0).astype(np.uint8))
        mask = (
            self._folder_mask(filter_folders, self._bin_ids, self._bin_matrix.shape[0])
            if filter_folders
            else None
        )
        return qn, qwords, mask

    # --------------------------------------------------------------- cascade

    def _cascade_ready(self) -> bool:
        return (
            self._cascade
            and self._bin_matrix is not None
            and self._host_vectors is not None
        )

    def _cascade_depth(self, k: int) -> int:
        import os

        env = os.environ.get("TPUCLIP_CASCADE_DEPTH")
        depth = 0
        if env:
            # Parse defensively: this runs on the QUERY path, where an
            # uncaught ValueError from a malformed env would 500 every
            # request (and "0" would silently degrade recall to nothing).
            try:
                depth = int(env)
            except ValueError:
                log(
                    f"  [WARNING] invalid TPUCLIP_CASCADE_DEPTH={env!r}; "
                    "using the default"
                )
        if depth <= 0:
            depth = max(32 * k, 512)
        return max(k, min(depth, len(self._ids)))

    def _cascade_prefilter(self, qwords, depth: int, mask):
        """Device prefilter: exact packed-binary top-``depth``, as
        (matches (Q, m) f32 with -inf invalid, rows (Q, m) i32)."""
        matches, rows = self._binary_topk_raw(qwords, depth, mask)
        matches = np.asarray(matches).astype(np.float32)
        # binary sentinels are int32-min; translate to the -inf/row-overflow
        # convention _exact_rerank_batch expects
        matches[matches <= np.iinfo(np.int32).min + 1] = -np.inf
        return matches, np.asarray(rows)

    def _search_cascade(self, queries_2d: np.ndarray, k: int, filter_folders):
        """Packed-binary prefilter + exact host rescore, (Q, k) results.

        The binary shortlist ranks by sign-bit matches (data-dependent
        recall, deeper shortlist = higher recall); the rescore orders the
        survivors by true fp32 dot product."""
        qn, qwords, mask = self._binary_query_and_mask(queries_2d, filter_folders)
        depth = self._cascade_depth(k)
        matches, rows = self._cascade_prefilter(qwords, depth, mask)
        scores, out_rows = self._exact_rerank_batch(qn, matches, rows, k)
        return self._map_batch_results(scores, out_rows, len(qn))

    def _search_binary(self, query, k, filter_folders):
        _, qwords, mask = self._binary_query_and_mask(
            np.asarray(query, np.float32).reshape(1, -1), filter_folders
        )
        matches, rows = self._binary_topk_raw(qwords, k, mask)
        matches = np.asarray(matches[0])
        rows = np.asarray(rows[0])
        valid = matches > np.iinfo(np.int32).min
        matches, rows = matches[valid], rows[valid]
        image_ids = self._bin_ids[rows]
        paths = self.store.fetch_paths_for_ids(image_ids)
        dim = self.store.embedding_dim
        return [
            (paths[int(i)], float(m) / dim)
            for i, m in zip(image_ids, matches)
            if int(i) in paths
        ]
