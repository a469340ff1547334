"""Recording: bake and replay world state trajectories.

Counterpart of nimblephysics_tpu/simulation/recording.py. Reference
parity: dart/simulation/Recording.hpp:57 + World::bake
(World.hpp:608-612). A recording is a stack of states; this class keeps
the familiar API. Checkpoints of any tree of tensors (training state,
plans, recordings) are a `torch.save` of a dict of tensors keyed by their
path in the tree, read back with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.utils._pytree as pytree

from nimblephysics_tpu_torch.simulation.world import World


class Recording:
    def __init__(self, world: World):
        self.world = world
        self._frames: List[np.ndarray] = []

    def bake(self, state) -> None:
        """Append one world state (reference: World::bake)."""
        if torch.is_tensor(state):
            state = state.detach().cpu().numpy()
        self._frames.append(np.asarray(state).copy())

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    def get_state(self, frame: int) -> np.ndarray:
        return self._frames[frame]

    def as_array(self) -> np.ndarray:
        return (
            np.stack(self._frames)
            if self._frames
            else np.zeros((0, self.world.state_size))
        )

    def clear(self) -> None:
        self._frames.clear()

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        np.save(path, self.as_array())

    @staticmethod
    def load(world: World, path: str) -> "Recording":
        rec = Recording(world)
        arr = np.load(path)
        rec._frames = [a for a in arr]
        return rec


def _leaves(tree):
    """[(path, leaf)] of a tree of tensors, arrays and numbers."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(path), leaf) for path, leaf in flat]


def save_checkpoint(path: str, tree) -> None:
    """Checkpoint a tree (dicts, lists, tuples, named tuples) of tensors,
    numpy arrays and numbers as {path in the tree: tensor}."""
    torch.save({k: torch.as_tensor(x).detach().cpu() for k, x in _leaves(tree)}, path)


def load_checkpoint(path: str, template):
    """The template tree with each leaf replaced by the checkpoint's tensor
    of its path, on the template leaf's device (numpy leaves come back as
    numpy, numbers as numbers)."""
    saved = torch.load(path, weights_only=True)
    flat, spec = pytree.tree_flatten_with_path(template)
    missing = [pytree.keystr(p) for p, _ in flat if pytree.keystr(p) not in saved]
    if missing:
        raise KeyError(f"checkpoint {path} has no entries for {missing}")
    out = []
    for p, leaf in flat:
        x = saved[pytree.keystr(p)]
        if torch.is_tensor(leaf):
            x = x.to(leaf.device)
        elif isinstance(leaf, np.ndarray):
            x = x.numpy()
        elif isinstance(leaf, (int, float, bool)):
            x = type(leaf)(x.item())
        out.append(x)
    return pytree.tree_unflatten(out, spec)
