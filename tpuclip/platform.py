"""The one place that knows what the device is.

Every choice that depends on the machine goes through here, and each is one
of three questions:

- **Accelerator or host?** :func:`on_accelerator` is True on a GPU and False
  on the CPU. The GPU runs the design the program has for its accelerator:
  bf16 towers and matrices, the int8 scan with the fused device rescore as
  the default precision, and the one-program text/image/mixed queries. The
  CPU keeps f32 everywhere and the bf16 flat scan.
- **Which kernel scores the int8 scan?** :func:`int8_scan_route` names it:
  ``"triton"`` (a Pallas kernel compiled through Triton) on the GPU,
  ``"xla"`` on the CPU.
- **Does it fit?** :func:`fits` sizes every capacity gate from the device's
  own ``memory_stats()``. Where the device reports none (the CPU), nothing is
  gated.

A platform or GPU kind this module does not know is an error, never a
default: its answers would be guesses.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# Device kinds the accelerator policy was measured on (substring match on
# ``device.device_kind``, e.g. "NVIDIA H100 80GB HBM3").
KNOWN_GPU_KINDS = ("H100", "H200")

# Workspace margin: a resident or transient array set "fits" when it leaves
# this fraction of the device's memory limit free beyond what is already in
# use. The margin holds compiled programs' temporaries (tower activations,
# score matrices, rescore gathers) that no gate accounts for one by one.
WORKSPACE_FRACTION = 0.125


def _device(device=None):
    return device if device is not None else jax.devices()[0]


def platform_of(device=None) -> str:
    """``"gpu"`` or ``"cpu"`` for ``device`` (default: the first device);
    raises on any other platform or an unknown GPU kind."""
    d = _device(device)
    if d.platform == "cpu":
        return "cpu"
    if d.platform == "gpu":
        if not any(kind in d.device_kind for kind in KNOWN_GPU_KINDS):
            raise RuntimeError(
                f"unknown GPU kind {d.device_kind!r}: tpuclip's device policy "
                f"is defined for {', '.join(KNOWN_GPU_KINDS)}"
            )
        return "gpu"
    raise RuntimeError(f"unsupported JAX platform {d.platform!r}")


def on_accelerator(device=None) -> bool:
    return platform_of(device) == "gpu"


def compute_dtype(device=None):
    """Tower compute dtype (and the params' device dtype)."""
    return jnp.bfloat16 if on_accelerator(device) else jnp.float32


def matrix_dtype(device=None):
    """Storage dtype of the resident float matrix and the rescore rows."""
    return jnp.bfloat16 if on_accelerator(device) else jnp.float32


def default_precision(device=None) -> str:
    """Default search precision: the int8 scan + exact rescore on the
    accelerator; the plain flat scan on the CPU, where int8 wins nothing."""
    return "int8" if on_accelerator(device) else "bf16"


def device_rerank_default(device=None) -> bool:
    """Whether ``TPUCLIP_DEVICE_RERANK=auto`` keeps the full-precision rows
    on the device (still subject to :func:`fits`). It is what enables the
    fused one-program queries."""
    return on_accelerator(device)


def int8_scan_route(device=None) -> str:
    return "triton" if on_accelerator(device) else "xla"


def free_bytes(device=None) -> Optional[int]:
    """Bytes a new allocation may take while leaving the workspace margin:
    ``bytes_limit - bytes_in_use - WORKSPACE_FRACTION * bytes_limit``.
    None where the device reports no memory statistics."""
    stats = _device(device).memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    limit = int(stats["bytes_limit"])
    in_use = int(stats.get("bytes_in_use", 0))
    return limit - in_use - int(limit * WORKSPACE_FRACTION)


def fits(nbytes: float, device=None) -> bool:
    """True when ``nbytes`` more on ``device`` keeps the workspace margin
    free (always True where the device reports no memory statistics)."""
    free = free_bytes(device)
    return free is None or nbytes <= free
