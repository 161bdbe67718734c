"""Checkpoint / resume of training state (SURVEY.md §5).

The reference keeps variational parameters only in memory (no persistence);
for elastic training we checkpoint the full device-side state pytree —
global variational params, the SVI step counter (so the (t + tau)^(-kappa)
schedule resumes correctly — BASELINE config 5), the PRNG key, and any
adaptive-step-size state — as its flattened leaves in one numpy ``.npz``
file (``leaf_0``, ``leaf_1``, ... in `jax.tree.leaves` order; the structure
comes from the restore target). numpy stores every leaf's dtype and bytes
as they are, so resume is bit-exact. Writes are atomic (tmp + rename) so a
preempted host never leaves a torn checkpoint. Orbax (lazily imported,
optional) is the tier for larger deployments.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np

SUFFIX = ".npz"


def save(path: str, state: Any) -> None:
    """Atomically write a pytree checkpoint (host-local)."""
    leaves = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state))]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    os.replace(tmp, path)


def load_leaves(path: str) -> list[np.ndarray]:
    """The checkpoint's leaves in `jax.tree.leaves` order."""
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def restore(path: str, target: Any) -> Any:
    """Load a checkpoint into the structure of ``target`` (same pytree)."""
    ref, treedef = jax.tree.flatten(target)
    leaves = load_leaves(path)
    if len(leaves) != len(ref):
        raise ValueError(
            f"checkpoint {path} holds {len(leaves)} leaves, target has {len(ref)}"
        )
    out = []
    for got, want in zip(leaves, ref):
        if got.shape != np.shape(want):
            raise ValueError(f"checkpoint leaf {got.shape} != target {np.shape(want)}")
        dtype = np.dtype(getattr(want, "dtype", np.asarray(want).dtype))
        # numpy writes dtypes it does not know (bfloat16) as raw bytes
        out.append(got.view(dtype) if got.dtype.kind == "V" else got)
    return jax.tree.unflatten(treedef, out)


def _steps(directory: str, prefix: str) -> dict[int, str]:
    """{step: path} of the ``{prefix}{step}.npz`` checkpoints in directory."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(SUFFIX):
            try:
                out[int(name[len(prefix) : -len(SUFFIX)])] = os.path.join(directory, name)
            except ValueError:
                continue
    return out


def latest_step_path(directory: str, prefix: str = "ckpt_") -> str | None:
    """Find the highest-step checkpoint file ``{prefix}{step}.npz``."""
    steps = _steps(directory, prefix)
    return steps[max(steps)] if steps else None


def save_step(directory: str, step: int, state: Any, prefix: str = "ckpt_", keep: int = 3) -> str:
    """Save ``state`` as the step-numbered checkpoint and prune old ones."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}{step}{SUFFIX}")
    save(path, state)
    steps = _steps(directory, prefix)
    for s in sorted(steps)[:-keep]:
        os.remove(steps[s])
    return path


class OrbaxCheckpointer:
    """Orbax-backed step-numbered checkpointing (production/multi-host tier).

    Same role as :func:`save_step` / :func:`latest_step_path` / :func:`restore`
    but via ``orbax.checkpoint.CheckpointManager``: async writes, atomic
    finalization, retention, and multi-host coordination (every process
    participates in the save; Orbax elects the writers) — use this tier for
    multi-host jobs, the npz tier for single-host runs and tests.

        ckpt = OrbaxCheckpointer(directory, keep=3)
        ckpt.save(step, state)            # non-blocking
        state = ckpt.restore(state_like)  # latest step
        ckpt.close()                      # drain async writes
    """

    def __init__(self, directory: str, keep: int = 3):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self._mngr = ocp.CheckpointManager(
            os.path.abspath(directory),
            options=ocp.CheckpointManagerOptions(max_to_keep=keep, create=True),
        )

    def save(self, step: int, state: Any) -> None:
        self._mngr.save(step, args=self._ocp.args.StandardSave(state))

    def latest_step(self) -> int | None:
        return self._mngr.latest_step()

    def restore(self, target: Any, step: int | None = None) -> Any:
        """Restore into the STRUCTURE of ``target`` (a matching pytree of
        arrays, e.g. a freshly-initialized state). Defaults to latest step."""
        if step is None:
            step = self._mngr.latest_step()
        if step is None:
            raise FileNotFoundError("no orbax checkpoint found")
        return self._mngr.restore(
            step, args=self._ocp.args.StandardRestore(target)
        )

    def close(self) -> None:
        self._mngr.wait_until_finished()
        self._mngr.close()
