"""Checkpoint / resume as pickled NumPy pytrees.

The reference has torch.save checkpointing wired only into the legacy
trainer (``/root/reference/src/flows/training.py:694-712``), with no
automatic periodic saving.  This rebuild makes stage resume real
(SURVEY.md §5): (params, optimizer states, accumulated basis, PRNG key,
history) are converted to NumPy and pickled at stage boundaries.  A
checkpoint is only ever read back by this program, which wrote it.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]


def _to_numpy_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Serialize a training/pipeline state dict as a pickled NumPy tree.
    Returns the checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.pkl"), "wb") as f:
        pickle.dump(_to_numpy_tree(dict(state)), f)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "state.pkl"), "rb") as f:
        return pickle.load(f)


class CheckpointManager:
    """Stage-boundary checkpointing for the pipeline."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path_for(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def save_stage(self, tag: str, state: Dict[str, Any]) -> str:
        return save_checkpoint(self.path_for(tag), state)

    def load_stage(self, tag: str) -> Optional[Dict[str, Any]]:
        p = self.path_for(tag)
        if not os.path.exists(p):
            return None
        return load_checkpoint(p)

    def has_stage(self, tag: str) -> bool:
        return os.path.exists(self.path_for(tag))

    def save_trainer(self, tag: str, trainer) -> str:
        """Checkpoint a PhysicsGuidedFlowTrainer (params, opts, basis, key,
        history)."""
        state = {
            "flow_params": trainer.flow_params,
            "nqs_params": trainer.nqs_params,
            "flow_opt_state": trainer.flow_opt_state,
            "nqs_opt_state": trainer.nqs_opt_state,
            "accumulated_basis": trainer.accumulated_basis,
            "acc_keys": trainer._acc_keys,
            "rng_key": trainer.key,
            "history": {k: np.asarray(v) for k, v in trainer.history.items()
                        if len(v)},
            "energy_ema": trainer.energy_ema,
        }
        return self.save_stage(tag, state)

    def restore_trainer(self, tag: str, trainer) -> bool:
        state = self.load_stage(tag)
        if state is None:
            return False
        import jax

        def restore_like(template, saved):
            # serialization canonicalizes tuples to lists, so the saved
            # treedef never equals the live one — flatten the saved leaves
            # back into the template's structure instead
            t_leaves, treedef = jax.tree_util.tree_flatten(template)
            s_leaves = jax.tree_util.tree_leaves(saved)
            if len(s_leaves) != len(t_leaves):
                raise ValueError(
                    f"checkpoint state has {len(s_leaves)} leaves, "
                    f"trainer expects {len(t_leaves)}")
            new = [np.asarray(s).astype(np.asarray(t).dtype)
                   if hasattr(t, "dtype") else s
                   for t, s in zip(t_leaves, s_leaves)]
            return jax.tree_util.tree_unflatten(treedef, new)

        trainer.flow_params = restore_like(trainer.flow_params,
                                           state["flow_params"])
        trainer.nqs_params = restore_like(trainer.nqs_params,
                                          state["nqs_params"])
        trainer.flow_opt_state = restore_like(trainer.flow_opt_state,
                                              state["flow_opt_state"])
        trainer.nqs_opt_state = restore_like(trainer.nqs_opt_state,
                                             state["nqs_opt_state"])
        trainer.accumulated_basis = (
            np.asarray(state["accumulated_basis"], np.uint32)
            if state["accumulated_basis"] is not None else None)
        # _acc_keys is a derived read-only @property on
        # PhysicsGuidedFlowTrainer (recomputed by the accumulated_basis
        # setter above); only restore it where it is a plain attribute.
        if not isinstance(getattr(type(trainer), "_acc_keys", None),
                          property):
            trainer._acc_keys = (np.asarray(state["acc_keys"], np.uint64)
                                 if state.get("acc_keys") is not None
                                 else None)
        trainer.key = np.asarray(state["rng_key"], dtype=np.uint32)
        if state.get("energy_ema") is not None:
            trainer.energy_ema = float(state["energy_ema"])
        for k, v in state.get("history", {}).items():
            trainer.history[k] = list(np.asarray(v))
        return True
