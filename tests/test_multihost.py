"""True multi-process (cross-host) validation on CPU: two OS processes, 4 virtual
devices each, jax.distributed over a localhost coordinator — the closest
offline stand-in for a multi-host deployment. Exercises
``maybe_distributed_init`` (explicit-coordinator path), global-sharding
placement across non-addressable devices, and the cross-process all_gather
merge inside the sharded int8+exact-rescore search."""

import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import os, sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["TPUCLIP_MULTIHOST"] = "1"
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = "2"
    os.environ["JAX_PROCESS_ID"] = str(pid)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tpuclip.parallel.mesh import maybe_distributed_init, make_mesh, DATA_AXIS
    maybe_distributed_init()
    assert jax.process_count() == 2, jax.process_count()
    import numpy as np, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpuclip.ops.topk_int8 import pad_rows, quantize_rows
    from tpuclip.parallel.sharded_search import sharded_topk_int8_rerank

    mesh = make_mesh()
    ndev = mesh.shape[DATA_AXIS]
    assert ndev == 8, ndev  # 2 processes x 4 local devices
    rng = np.random.default_rng(0)
    N, D, k = 4096, 64, 5
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows_pad, n_valid = pad_rows(rows, tile_n=2048 * ndev)
    q8, scales = quantize_rows(rows_pad)
    matrix = jax.device_put(jnp.asarray(q8), NamedSharding(mesh, P(DATA_AXIS, None)))
    scales_d = jax.device_put(jnp.asarray(scales), NamedSharding(mesh, P(DATA_AXIS)))
    rows_d = jax.device_put(jnp.asarray(rows_pad), NamedSharding(mesh, P(DATA_AXIS, None)))
    queries = rng.standard_normal((2, D)).astype(np.float32)
    scores, ridx = sharded_topk_int8_rerank(
        jnp.asarray(queries), matrix, scales_d, rows_d, k, mesh,
        jnp.asarray(n_valid, jnp.int32),
    )
    scores, ridx = np.asarray(scores), np.asarray(ridx)
    exact = queries @ rows.T
    for qi in range(2):
        want = np.lexsort((np.arange(N), -exact[qi]))[:k]
        assert list(ridx[qi]) == list(want), (qi, ridx[qi], want)
        np.testing.assert_allclose(scores[qi], exact[qi][want], rtol=1e-5)

    # DP training step across the two processes: batch data-sharded over the
    # global mesh, gradients psum across the processes; loss must match the unsharded
    # local computation and decrease when memorizing one batch.
    from tpuclip.models import get_config, init_params
    from tpuclip.parallel import shard_params
    from tpuclip.parallel.training import (
        init_train_state, make_optimizer, make_train_step,
        sigmoid_contrastive_loss,
    )

    cfg = get_config("tpuclip/test-tiny")
    params = init_params(jax.random.PRNGKey(0), cfg)
    sharded = shard_params(params, mesh)
    opt = make_optimizer(learning_rate=1e-3)
    state = init_train_state(sharded, opt)
    step = make_train_step(cfg, opt, mesh=mesh, compute_dtype=jnp.float32)
    rng2 = np.random.default_rng(4)
    images_h = rng2.integers(0, 256, size=(16, cfg.vision.image_size, cfg.vision.image_size, 3), dtype=np.uint8)
    ids_h = rng2.integers(0, cfg.text.vocab_size, size=(16, 64))
    first = float(sigmoid_contrastive_loss(params, jnp.asarray(images_h), jnp.asarray(ids_h), cfg, jnp.float32))
    images_g = jax.device_put(images_h, NamedSharding(mesh, P(DATA_AXIS)))
    ids_g = jax.device_put(ids_h, NamedSharding(mesh, P(DATA_AXIS)))
    losses = []
    for _ in range(3):
        state, loss = step(state, images_g, ids_g)
        losses.append(float(loss))
    assert abs(losses[0] - first) < 1e-3 * max(1.0, abs(first)), (losses[0], first)
    assert losses[-1] < losses[0], losses
    print(f"MULTIHOST-OK {pid}", flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_sharded_search(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        # the workers pin their own backend; drop harness platform forcing
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")
    }
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} rc={p.returncode}\n{out[-3000:]}"
        assert f"MULTIHOST-OK {i}" in out, out[-3000:]
