"""2-process `jax.distributed` CPU integration test.

Launches two real OS processes, each owning 2 virtual CPU devices, that
bootstrap the multi-host runtime (parallel/multihost.py), assemble a
globally-sharded batch from process-local rows, and run data-parallel VB +
SVI steps (tests/_multihost_worker.py). The results must match the
IDENTICAL program run single-process on 4 virtual devices — the only
pod-free way to catch process-major-ordering and un-psummed-stats bugs
(SURVEY.md §2.4 collectives row, §5 distributed backend).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env() -> dict:
    # Workers must run CPU-only, one process each on its own virtual
    # devices: strip the parent harness's JAX pins and set JAX_PLATFORMS in
    # the env BEFORE the interpreter starts.
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith("JAX") and k != "XLA_FLAGS"
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_process_dp_matches_single_process(tmp_path):
    out_path = str(tmp_path / "multihost_result.npz")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                WORKER,
                str(i),
                "2",
                f"localhost:{port}",
                out_path,
                "2",  # local virtual CPU devices per process
            ],
            env=_clean_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outputs[i]}"
    assert os.path.exists(out_path), outputs[0]

    # --- single-process reference on the same 4-device (cpu) mesh ---
    import jax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel.data_parallel import (
        make_dp_minibatch_svi_step,
        make_dp_vb_step,
        make_mesh,
        shard_batch,
    )
    from pysvihmm_tpu.utils import checkpoint

    K, D, N, T = 3, 2, 8, 24
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, N, T)
    mesh = make_mesh(4, devices=jax.devices("cpu"))
    gobs = shard_batch(obs, mesh)
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)

    vb_step = make_dp_vb_step(GaussianNIW, mesh, method="scan")
    p1, elbo = vb_step(p0, prior, gobs)

    cfg = svi.SVIConfig(batch_size=4, subchain_len=T, buffer=0, tau=1.0, kappa=0.6)
    svi_step = make_dp_minibatch_svi_step(GaussianNIW, cfg, N, mesh, method="scan")
    st = svi.init_state(p0, jax.random.PRNGKey(2))
    for _ in range(3):
        st, _ = svi_step(st, prior, gobs)

    expect = {"vb": p1, "elbo": elbo, "svi": st.params}
    expect_np = jax.tree.map(np.asarray, jax.device_get(expect))
    got = checkpoint.restore(out_path, expect_np)

    # same math, different process topology: psum reduction order differs
    # (gloo ring vs single-process), f32 => observed ~4e-5 relative on NIW
    # scale leaves after 3 SVI steps; tolerance sits ~5x above that
    for a, b in zip(jax.tree.leaves(expect_np), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-4, atol=1e-5)


TRAINER_WORKER = os.path.join(REPO, "tests", "_multihost_trainer_worker.py")


def _run_trainer_phase(out_path, corpus_path, ckpt_dir, mode, num_steps):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable, TRAINER_WORKER, str(i), "2",
                f"localhost:{port}", out_path, "2", corpus_path, ckpt_dir,
                mode, str(num_steps),
            ],
            env=_clean_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"{mode} worker {i} failed:\n{outputs[i]}"


def test_two_process_trainer_resume(tmp_path):
    """Trainer kill-resume UNDER `jax.distributed`:
    a 2-process run checkpointed by host 0, restarted with fresh state
    objects in both processes, must land bit-exactly on the uninterrupted
    2-process run — covering restore-after-initialize ordering, replicated
    state recommitment, and per-process loader shard re-derivation."""
    import numpy as np

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset

    import jax

    obs, _, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(20), 3, 2, 16, 24, mean_scale=6.0, cov_scale=0.3
    )
    corpus_path = str(tmp_path / "corpus.npy")
    np.save(corpus_path, np.asarray(obs, np.float32))
    ckpt_dir = str(tmp_path / "ckpt")
    ref_path = str(tmp_path / "ref.npz")
    got_path = str(tmp_path / "got.npz")

    # uninterrupted 2-process reference: 10 steps
    _run_trainer_phase(ref_path, corpus_path, ckpt_dir, "ref", 10)
    # "preempted" 2-process run: 6 steps with checkpoints (every 4 + final)
    _run_trainer_phase(got_path, corpus_path, ckpt_dir, "ckpt", 6)
    # restart both processes with fresh state; must restore and continue
    _run_trainer_phase(got_path, corpus_path, ckpt_dir, "resume", 10)

    from pysvihmm_tpu.utils import checkpoint

    ref_leaves = checkpoint.load_leaves(ref_path)
    got_leaves = checkpoint.load_leaves(got_path)
    assert len(ref_leaves) == len(got_leaves) > 0
    for a, b in zip(ref_leaves, got_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_initialize_distributed_fails_loudly():
    """An explicit multi-process request that cannot bootstrap must raise,
    not proceed single-process with un-psummed stats."""
    script = (
        "from pysvihmm_tpu.parallel.multihost import initialize_distributed\n"
        "import sys\n"
        "try:\n"
        # process 1 dialing an unroutable coordinator: must not proceed.
        # jax may raise a catchable error OR hard-terminate the process
        # (absl FATAL on coordinator deadline) — both are 'loud'; the one
        # forbidden outcome is returning successfully.
        "    initialize_distributed('localhost:1', 2, 1, initialization_timeout=5)\n"
        "except Exception:\n"
        "    sys.exit(42)\n"
        "print('PROCEEDED-SILENTLY')\n"
        "sys.exit(3)\n"
    )
    p = subprocess.run(
        [sys.executable, "-c", script],
        env=_clean_env(),
        capture_output=True,
        timeout=300,
    )
    assert p.returncode != 0 and p.returncode != 3, (p.returncode, p.stdout, p.stderr)
    assert b"PROCEEDED-SILENTLY" not in p.stdout
