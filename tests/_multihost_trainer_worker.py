"""Worker process for the 2-process trainer kill-resume integration test.

Launched by tests/test_multihost.py::test_two_process_trainer_resume with
argv = (process_id, num_processes, coordinator_address, out_path,
local_devices, corpus_path, ckpt_dir, mode, num_steps). Each process owns
its shard of a shared .npy corpus (ShardedSequenceLoader re-derives the
shard bounds from process_index at construction), runs the fault-tolerant
streamed trainer over data-parallel SVI steps, and (process 0) serializes
the final state. Modes:

  ref    — uninterrupted run to num_steps, no checkpointing.
  ckpt   — run to num_steps WITH checkpointing (the "preempted" run: its
           latest checkpoint is what a killed job would leave behind).
  resume — fresh state object, same checkpoint dir, higher num_steps:
           every process must restore host-0's checkpoint and continue.

The parent asserts resume == ref bit-exactly: checkpoint restore ordering
vs `jax.distributed.initialize`, replicated-state recommitment, and loader
shard re-derivation are all on the line (engines/trainer.py multi-host
contract).
"""

import os
import sys


def main() -> None:
    proc_id = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    out_path = sys.argv[4]
    local_devices = int(sys.argv[5])
    corpus_path = sys.argv[6]
    ckpt_dir = sys.argv[7]
    mode = sys.argv[8]
    num_steps = int(sys.argv[9])

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}"
    )

    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from pysvihmm_tpu.parallel import multihost

    multihost.initialize_distributed(coord, nproc, proc_id)

    from pysvihmm_tpu.data.loader import ShardedSequenceLoader
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi, trainer
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel import make_dp_streamed_svi_step
    from pysvihmm_tpu.utils import checkpoint

    import numpy as np

    corpus = np.load(corpus_path, mmap_mode="r")
    N, T, D = corpus.shape
    K, B = 3, 2  # B per host -> global batch nproc * B

    mesh = multihost.global_data_mesh()
    loader = ShardedSequenceLoader.from_npy(
        corpus_path, mesh, batch_per_host=B, seed=3
    )
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    import jax.numpy as jnp

    p0 = init_params(
        jax.random.PRNGKey(21), prior, GaussianNIW, jnp.asarray(corpus[:4])
    )
    cfg = svi.SVIConfig(batch_size=nproc * B, tau=5.0, kappa=0.6, adaptive=True)
    step = make_dp_streamed_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)
    state = svi.init_state(p0, jax.random.PRNGKey(22), adaptive=True)

    state = trainer.train_streamed(
        step, state, prior, loader, num_steps,
        checkpoint_dir=None if mode == "ref" else ckpt_dir,
        checkpoint_every=4,
    )
    assert int(np.asarray(jax.device_get(state.step))) == num_steps

    if proc_id == 0 and mode in ("ref", "resume"):
        checkpoint.save(out_path, jax.device_get(state))


if __name__ == "__main__":
    main()
