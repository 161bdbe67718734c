"""Worker process for the 2-process `jax.distributed` integration test.

Launched by tests/test_multihost.py with argv =
(process_id, num_processes, coordinator_address, out_path, local_devices).
Each process owns `local_devices` virtual CPU devices; together they form a
(num_processes * local_devices)-device global data mesh. The worker:

  1. bootstraps the multi-host runtime (parallel/multihost.py),
  2. assembles a globally-sharded batch from its process-local rows
     (host_local_batch_to_global — process-major ordering),
  3. runs one data-parallel batch-VB step and three data-parallel
     minibatch-SVI steps (parallel/data_parallel.py), and
  4. (process 0) checkpoints the resulting replicated params.

The parent test runs the identical program single-process on the same
number of virtual devices and asserts the results agree — the only way to
catch process-major-ordering / un-psummed-stats bugs without a pod
(SURVEY.md §2.4 distributed backend row).
"""

import os
import sys


def main() -> None:
    proc_id = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    out_path = sys.argv[4]
    local_devices = int(sys.argv[5])

    # must be set before jax initializes the backend
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}"
    )

    import jax

    # cross-process collectives on the CPU backend need a real transport
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np

    from pysvihmm_tpu.parallel import multihost

    multihost.initialize_distributed(coord, nproc, proc_id)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == nproc * local_devices

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW
    from pysvihmm_tpu.engines import svi
    from pysvihmm_tpu.models.hmm import init_params, make_prior
    from pysvihmm_tpu.parallel.data_parallel import (
        make_dp_minibatch_svi_step,
        make_dp_vb_step,
    )
    from pysvihmm_tpu.utils import checkpoint

    K, D, N, T = 3, 2, 8, 24
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, N, T)
    obs_np = np.asarray(obs)

    mesh = multihost.global_data_mesh()
    rows_per_proc = N // nproc
    local_rows = obs_np[proc_id * rows_per_proc : (proc_id + 1) * rows_per_proc]
    gobs = multihost.host_local_batch_to_global(local_rows, mesh)

    prior = make_prior(K, GaussianNIW, obs_dim=D)
    p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)

    vb_step = make_dp_vb_step(GaussianNIW, mesh, method="scan")
    p1, elbo = vb_step(p0, prior, gobs)

    cfg = svi.SVIConfig(batch_size=4, subchain_len=T, buffer=0, tau=1.0, kappa=0.6)
    svi_step = make_dp_minibatch_svi_step(GaussianNIW, cfg, N, mesh, method="scan")
    st = svi.init_state(p0, jax.random.PRNGKey(2))
    for _ in range(3):
        st, _ = svi_step(st, prior, gobs)

    if proc_id == 0:
        checkpoint.save(out_path, {"vb": p1, "elbo": elbo, "svi": st.params})


if __name__ == "__main__":
    main()
