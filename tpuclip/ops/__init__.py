from tpuclip.ops.topk import cosine_topk, pad_matrix_t, topk_xla  # noqa: F401
from tpuclip.ops.topk_int8 import int8_scores, topk_int8_scan  # noqa: F401
from tpuclip.ops.hamming import binary_topk, binary_topk_packed  # noqa: F401
