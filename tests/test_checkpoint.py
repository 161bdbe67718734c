"""Checkpoint/resume tests (SURVEY.md §5): training state round-trips exactly
and SVI resumes its (t + tau)^(-kappa) schedule from the restored step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu.distributions import GaussianNIW
from pysvihmm_tpu.engines import svi
from pysvihmm_tpu.models.hmm import init_params, make_prior
from pysvihmm_tpu.utils import checkpoint


def _setup():
    K, D, T = 3, 2, 500
    obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), K, D, 1, T)
    chain = obs[0]
    prior = make_prior(K, GaussianNIW, obs_dim=D)
    params = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, chain)
    return chain, prior, params


class TestCheckpoint:
    def test_roundtrip_exact(self, tmp_path):
        chain, prior, params = _setup()
        state = svi.init_state(params, jax.random.PRNGKey(2))
        cfg = svi.SVIConfig(batch_size=4, subchain_len=50, buffer=5)
        state, _ = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=10)

        path = str(tmp_path / "ckpt.npz")
        checkpoint.save(path, state)
        fresh = svi.init_state(params, jax.random.PRNGKey(99))
        restored = checkpoint.restore(path, fresh)

        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(restored.step) == 10

    def test_resume_equals_uninterrupted(self, tmp_path):
        """10 steps == 5 steps -> checkpoint -> restore -> 5 steps, exactly."""
        chain, prior, params = _setup()
        cfg = svi.SVIConfig(batch_size=4, subchain_len=50, buffer=5)

        s_full = svi.init_state(params, jax.random.PRNGKey(3))
        s_full, _ = svi.fit(s_full, prior, chain, GaussianNIW, cfg, num_steps=10)

        s_half = svi.init_state(params, jax.random.PRNGKey(3))
        s_half, _ = svi.fit(s_half, prior, chain, GaussianNIW, cfg, num_steps=5)
        path = str(tmp_path / "ckpt.npz")
        checkpoint.save(path, s_half)
        restored = checkpoint.restore(path, svi.init_state(params, jax.random.PRNGKey(0)))
        resumed, _ = svi.fit(restored, prior, chain, GaussianNIW, cfg, num_steps=5)

        for a, b in zip(jax.tree.leaves(s_full.params), jax.tree.leaves(resumed.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
        assert int(resumed.step) == int(s_full.step)

    def test_save_step_prune_and_latest(self, tmp_path):
        chain, prior, params = _setup()
        state = svi.init_state(params, jax.random.PRNGKey(4))
        d = str(tmp_path / "ckpts")
        for s in (1, 2, 3, 4, 5):
            checkpoint.save_step(d, s, state, keep=3)
        names = sorted(os.listdir(d))
        assert names == ["ckpt_3.npz", "ckpt_4.npz", "ckpt_5.npz"]
        assert checkpoint.latest_step_path(d).endswith("ckpt_5.npz")

    def test_atomic_no_torn_file(self, tmp_path):
        chain, prior, params = _setup()
        state = svi.init_state(params, jax.random.PRNGKey(5))
        path = str(tmp_path / "c.npz")
        checkpoint.save(path, state)
        assert not os.path.exists(path + ".tmp")


class TestNpzFormat:
    """The numpy format holds any pytree of arrays bit-exactly, with no
    serialization library beyond numpy."""

    @pytest.mark.parametrize(
        "state",
        [
            {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.int32(7)},
            (np.array([1.5, -0.0, np.inf], np.float64), [np.uint32(3), np.zeros((0, 2))]),
            {"bf16": jnp.asarray([1.0, 2.5, -3.0], jnp.bfloat16), "key": jax.random.PRNGKey(5)},
            svi.SVIState,
        ],
        ids=["dict", "nested_seq", "bf16_and_key", "svi_state"],
    )
    def test_roundtrip_bit_exact(self, tmp_path, state):
        if state is svi.SVIState:
            _, _, params = _setup()
            state = svi.init_state(params, jax.random.PRNGKey(6))
        path = str(tmp_path / "s.npz")
        checkpoint.save(path, state)
        zeros = jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), state)
        restored = checkpoint.restore(path, zeros)
        assert jax.tree.structure(restored) == jax.tree.structure(zeros)
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()

    def test_restore_rejects_other_structure(self, tmp_path):
        path = str(tmp_path / "s.npz")
        checkpoint.save(path, {"a": np.ones(3), "b": np.ones(2)})
        with pytest.raises(ValueError):
            checkpoint.restore(path, {"a": np.ones(3)})
        with pytest.raises(ValueError):
            checkpoint.restore(path, {"a": np.ones(3), "b": np.ones(4)})


class TestOrbaxCheckpointer:
    def test_roundtrip_and_retention(self, tmp_path):
        """Orbax tier: save/restore is resume-exact and retention prunes."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
        from pysvihmm_tpu.distributions import GaussianNIW
        from pysvihmm_tpu.engines import svi
        from pysvihmm_tpu.models.hmm import init_params, make_prior
        from pysvihmm_tpu.utils.checkpoint import OrbaxCheckpointer

        obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(0), 3, 2, 1, 400)
        chain = obs[0]
        prior = make_prior(3, GaussianNIW, obs_dim=2)
        p0 = init_params(jax.random.PRNGKey(1), prior, GaussianNIW, chain)
        state = svi.init_state(p0, jax.random.PRNGKey(2))
        cfg = svi.SVIConfig(batch_size=4, subchain_len=30, buffer=5)
        state, _ = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=7)

        ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"), keep=2)
        for s in (1, 2, 3):
            ckpt.save(s, state if s == 3 else jax.tree.map(jnp.zeros_like, state))
        ckpt.close()
        assert ckpt.latest_step() == 3

        fresh = svi.init_state(p0, jax.random.PRNGKey(9))
        restored = OrbaxCheckpointer(str(tmp_path / "orbax")).restore(fresh)
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # resume-exactness: continuing from the restored state reproduces
        # the continuation from the live state bit-for-bit
        c1, _ = svi.fit(restored, prior, chain, GaussianNIW, cfg, num_steps=5)
        c2, _ = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=5)
        for a, b in zip(jax.tree.leaves(c1.params), jax.tree.leaves(c2.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # retention: only the last two steps remain
        mngr_steps = OrbaxCheckpointer(str(tmp_path / "orbax"))._mngr.all_steps()
        assert sorted(mngr_steps) == [2, 3]
