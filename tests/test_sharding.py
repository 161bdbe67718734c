"""Multi-device tests on the 8-device virtual CPU mesh (SNIPPETS.md [3]
pattern): sharded paths must agree with single-device paths bit-for-bit
(up to float reduction order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu.distributions import GaussianNIW
from pysvihmm_tpu.engines import batch_vb, metaobs, svi
from pysvihmm_tpu.engines.base import batch_local_step, decode
from pysvihmm_tpu.eval.metrics import hamming_error
from pysvihmm_tpu.models.hmm import init_params, make_prior
from pysvihmm_tpu.parallel import (
    make_dp_metaobs_step,
    make_dp_minibatch_svi_step,
    make_dp_vb_step,
    make_mesh,
    shard_batch,
    sharded_local_step,
)


@pytest.fixture(scope="module")
def mesh(request):
    cpus = jax.devices("cpu")
    assert len(cpus) >= 8, "conftest must provide 8 virtual CPU devices"
    return make_mesh(8, devices=cpus)


@pytest.fixture(scope="module")
def gaussian_problem():
    K, D, B, T = 4, 2, 16, 100
    obs, z_true, _ = gen_gaussian_dataset(
        jax.random.PRNGKey(0), K, D, B, T, mean_scale=6.0, cov_scale=0.3
    )
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, obs)
    return obs, z_true, prior, params


class TestShardedLocalStep:
    def test_matches_single_device(self, mesh, gaussian_problem):
        obs, _, prior, params = gaussian_problem
        single, _ = batch_local_step(params, GaussianNIW, obs)
        obs_sharded = shard_batch(obs, mesh)
        sharded = jax.jit(
            lambda p, o: sharded_local_step(p, GaussianNIW, o, mesh)
        )(params, obs_sharded)
        for a, b in zip(jax.tree.leaves(single), jax.tree.leaves(sharded)):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=2e-4, atol=1e-4)

    def test_pallas_inside_shard_map(self, mesh):
        """The GPU default (the forward-backward kernel inside shard_map,
        each shard padding its LOCAL batch to whole blocks) matches the
        single-device scan path — run in the Pallas interpreter on the CPU
        mesh (B_local = 2 per device, padded to a 16-row block)."""
        K, D, B, T = 4, 2, 16, 96
        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(3), K, D, B, T)
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params = init_params(jax.random.PRNGKey(4), prior, GaussianNIW, obs)

        single, _ = batch_local_step(params, GaussianNIW, obs, "scan")
        obs_sharded = shard_batch(obs, mesh)
        sharded = jax.jit(
            lambda p, o: sharded_local_step(
                p, GaussianNIW, o, mesh, "pallas", interpret=True
            )
        )(params, obs_sharded)
        for a, b in zip(jax.tree.leaves(single), jax.tree.leaves(sharded)):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=2e-4, atol=1e-4)


class TestDPBatchVB:
    def test_elbo_trajectory_matches(self, mesh, gaussian_problem):
        obs, z_true, prior, params = gaussian_problem
        step1 = batch_vb.make_step(GaussianNIW)
        stepN = make_dp_vb_step(GaussianNIW, mesh)
        obs_sharded = shard_batch(obs, mesh)
        p1, pN = params, params
        for _ in range(5):
            p1, e1 = step1(p1, prior, obs)
            pN, eN = stepN(pN, prior, obs_sharded)
            np.testing.assert_allclose(float(e1), float(eN), rtol=2e-5)
        for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(pN)):
            np.testing.assert_allclose(np.array(a), np.array(b), rtol=2e-3, atol=2e-3)


class TestDPSVI:
    def test_dp_minibatch_svi_converges(self, mesh):
        K, D, N, T = 4, 2, 64, 100
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(3), K, D, N, T, mean_scale=6.0, cov_scale=0.3
        )
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(4), prior, GaussianNIW, obs)
        cfg = svi.SVIConfig(batch_size=16, tau=5.0, kappa=0.6)
        step = make_dp_minibatch_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)
        obs_sharded = shard_batch(obs, mesh)
        state = svi.init_state(params0, jax.random.PRNGKey(5))

        @jax.jit
        def run(s):
            def body(st, _):
                st2, _m = step(st, prior, obs_sharded)
                return st2, None
            out, _ = jax.lax.scan(body, s, None, length=120)
            return out

        state = run(state)
        zs = decode(state.params, GaussianNIW, obs)
        err = hamming_error(np.array(zs), np.array(z_true), K)
        assert err < 0.05, f"hamming {err}"

    def test_batch_size_validation(self, mesh):
        cfg = svi.SVIConfig(batch_size=10)
        with pytest.raises(ValueError, match="divisible"):
            make_dp_minibatch_svi_step(GaussianNIW, cfg, num_seqs=100, mesh=mesh)


class TestDPMetaObs:
    def test_dp_metaobs_converges(self, mesh):
        K, D, T = 4, 2, 3200
        obs, z_true, _ = gen_gaussian_dataset(
            jax.random.PRNGKey(6), K, D, 1, T, mean_scale=6.0, cov_scale=0.3
        )
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D)
        params0 = init_params(jax.random.PRNGKey(7), prior, GaussianNIW, chain)
        cfg = metaobs.MetaObsConfig(minibatch=8, block_len=100, buffer=10, tau=10.0, kappa=0.6)
        step = make_dp_metaobs_step(GaussianNIW, cfg, chain_len=T, mesh=mesh)
        state = svi.init_state(params0, jax.random.PRNGKey(8))

        @jax.jit
        def run(s):
            def body(st, _):
                st2, _m = step(st, prior, chain)
                return st2, None
            out, _ = jax.lax.scan(body, s, None, length=150)
            return out

        state = run(state)
        zs = decode(state.params, GaussianNIW, chain[None])
        err = hamming_error(np.array(zs), np.array(z_true), K)
        assert err < 0.05, f"hamming {err}"


class TestShardedLoader:
    def test_loader_single_process_epoch(self, cpu_devices):
        """ShardedSequenceLoader yields globally-sharded minibatches that
        tile the local shard exactly once per epoch (single-process case)."""
        import numpy as np
        from pysvihmm_tpu.data.loader import ShardedSequenceLoader, process_shard_bounds
        from pysvihmm_tpu.parallel import make_mesh

        mesh = make_mesh(8, devices=cpu_devices)
        corpus = np.arange(64 * 6, dtype=np.float32).reshape(64, 3, 2)
        loader = ShardedSequenceLoader(
            lambda s, e: corpus[s:e], total=64, mesh=mesh, batch_per_host=16
        )
        seen = []
        for batch in loader:
            assert batch.shape == (16, 3, 2)
            assert batch.sharding.spec == loader.sharding.spec
            seen.append(np.asarray(batch))
        assert len(seen) == 4
        got = np.sort(np.concatenate(seen).reshape(64, -1)[:, 0])
        np.testing.assert_array_equal(got, np.sort(corpus.reshape(64, -1)[:, 0]))

    def test_shard_bounds_cover(self):
        from pysvihmm_tpu.data.loader import process_shard_bounds

        spans = [process_shard_bounds(103, 4, p) for p in range(4)]
        assert spans[0][0] == 0 and spans[-1][1] == 103
        for (a, b), (c, d) in zip(spans, spans[1:]):
            assert b == c and b > a

    def test_from_npy_memmap_epoch(self, cpu_devices, tmp_path):
        """from_npy streams a memory-mapped corpus: the loader's local shard
        stays a memmap (no full materialization) and an epoch still tiles
        the corpus exactly."""
        import numpy as np
        from pysvihmm_tpu.data.loader import ShardedSequenceLoader
        from pysvihmm_tpu.parallel import make_mesh

        mesh = make_mesh(8, devices=cpu_devices)
        corpus = np.arange(48 * 4, dtype=np.float32).reshape(48, 2, 2)
        path = tmp_path / "corpus.npy"
        np.save(path, corpus)
        loader = ShardedSequenceLoader.from_npy(
            str(path), mesh=mesh, batch_per_host=8
        )
        assert isinstance(loader.local.base, np.memmap) or isinstance(
            loader.local, np.memmap
        )
        seen = [np.asarray(b) for b in loader]
        assert len(seen) == 6
        got = np.sort(np.concatenate(seen).reshape(48, -1)[:, 0])
        np.testing.assert_array_equal(got, np.sort(corpus.reshape(48, -1)[:, 0]))

    def test_prefetch_matches_sync_epoch(self, cpu_devices):
        """prefetch() yields exactly the batches __iter__ would (same seed,
        same shuffle stream), sharded identically — only pipelined."""
        import numpy as np
        from pysvihmm_tpu.data.loader import ShardedSequenceLoader
        from pysvihmm_tpu.parallel import make_mesh

        mesh = make_mesh(8, devices=cpu_devices)
        corpus = np.arange(64 * 6, dtype=np.float32).reshape(64, 3, 2)

        def make():
            return ShardedSequenceLoader(
                lambda s, e: corpus[s:e], total=64, mesh=mesh,
                batch_per_host=16, seed=7,
            )

        sync = [np.asarray(b) for b in make()]
        pre_loader = make()
        pre = []
        for b in pre_loader.prefetch(depth=2):
            assert b.sharding.spec == pre_loader.sharding.spec
            pre.append(np.asarray(b))
        assert len(pre) == len(sync) == 4
        for a, b in zip(sync, pre):
            np.testing.assert_array_equal(a, b)

    def test_prefetch_propagates_errors(self, cpu_devices):
        """An exception in the loader thread surfaces in the consumer."""
        import numpy as np
        import pytest
        from pysvihmm_tpu.data.loader import ShardedSequenceLoader
        from pysvihmm_tpu.parallel import make_mesh

        mesh = make_mesh(8, devices=cpu_devices)
        loader = ShardedSequenceLoader(
            lambda s, e: np.zeros((e - s, 2, 2), np.float32),
            total=32, mesh=mesh, batch_per_host=8,
        )

        class FlakyShard:
            """Indexable stand-in for loader.local: second row-gather dies."""

            def __init__(self, arr):
                self.arr, self.calls = arr, 0

            def __len__(self):
                return len(self.arr)

            def __getitem__(self, idx):
                self.calls += 1
                if self.calls > 1:
                    raise RuntimeError("disk gone")
                return self.arr[idx]

        loader.local = FlakyShard(np.asarray(loader.local))
        it = loader.prefetch(depth=1)
        next(it)  # first batch fine
        with pytest.raises(RuntimeError, match="disk gone"):
            list(it)
