"""Parameter sharding rules (DP + optional TP).

Pick a mesh, annotate shardings, let XLA insert the collectives — the
scaling-book recipe. The towers are small enough that TP is optional on one
GPU, but the rules are real: attention heads and MLP hidden shard over
``model``, everything contracts back with an XLA-inserted reduce.

Encoder leaves carry a leading layer axis (lax.scan stacking), so specs have
a leading None.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuclip.parallel.mesh import MODEL_AXIS

# kernel name → PartitionSpec for the trailing dims (layer axis prepended
# automatically for encoder leaves).
_ENCODER_RULES: Dict[str, P] = {
    "q_kernel": P(None, MODEL_AXIS),   # (D, D) out dim = heads sharded
    "k_kernel": P(None, MODEL_AXIS),
    "v_kernel": P(None, MODEL_AXIS),
    "q_bias": P(MODEL_AXIS),
    "k_bias": P(MODEL_AXIS),
    "v_bias": P(MODEL_AXIS),
    "o_kernel": P(MODEL_AXIS, None),   # contract sharded-in → replicated out
    "o_bias": P(None),
    "fc1_kernel": P(None, MODEL_AXIS),  # (D, F): hidden sharded
    "fc1_bias": P(MODEL_AXIS),
    "fc2_kernel": P(MODEL_AXIS, None),  # (F, D)
    "fc2_bias": P(None),
    "ln1_scale": P(None), "ln1_bias": P(None),
    "ln2_scale": P(None), "ln2_bias": P(None),
}


def _spec_for(path: str, leaf) -> P:
    parts = path.split("/")
    name = parts[-1]
    in_encoder = "encoder" in parts
    if name in _ENCODER_RULES and (in_encoder or "head" in parts):
        base = _ENCODER_RULES[name]
        if in_encoder:  # leading layer axis from lax.scan stacking
            return P(None, *base)
        return base
    # embeddings, layernorms, probe, text head, logit scale/bias: replicated
    return P(*([None] * getattr(leaf, "ndim", 0))) if getattr(leaf, "ndim", 0) else P()


def param_shardings(params: Any, mesh: Mesh):
    """Pytree of NamedShardings matching ``params``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)

    def path_str(kp):
        out = []
        for k in kp:
            if hasattr(k, "key"):
                out.append(str(k.key))
            elif hasattr(k, "idx"):
                out.append(str(k.idx))
        return "/".join(out)

    shardings = [NamedSharding(mesh, _spec_for(path_str(kp), leaf)) for kp, leaf in flat]
    return jax.tree_util.tree_unflatten(treedef, shardings)


def shard_params(params: Any, mesh: Mesh):
    return jax.device_put(params, param_shardings(params, mesh))
