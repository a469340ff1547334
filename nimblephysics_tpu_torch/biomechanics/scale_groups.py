"""Body-scale groups: one scale vector shared by symmetric bodies.

Counterpart of nimblephysics_tpu/biomechanics/scale_groups.py (reference:
Skeleton scale groups, dart/dynamics/Skeleton.hpp:993-1031, the
GROUP_SCALES fitting variable). A group shares one (3,) scale across its
member bodies (left/right symmetry), which cuts the fitting dimension and
holds the symmetry exactly.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from nimblephysics_tpu_torch.dynamics.skeleton import Skeleton


class ScaleGroups:
    """Static mapping group -> member bodies."""

    def __init__(self, skel: Skeleton,
                 groups: Optional[Sequence[Sequence[Union[int, str]]]] = None):
        self.skel = skel
        nb = skel.num_bodies
        member_of = np.full(nb, -1, dtype=np.int64)
        gid = 0
        for grp in groups or []:
            for b in (b if isinstance(b, int) else skel.body_index(b) for b in grp):
                if member_of[b] != -1:
                    raise ValueError(f"body {b} in two scale groups")
                member_of[b] = gid
            gid += 1
        for b in range(nb):
            if member_of[b] == -1:
                member_of[b] = gid
                gid += 1
        self.member_of = member_of  # (nb,) group index per body
        self.n_groups = gid

    def expand(self, group_scales: torch.Tensor) -> torch.Tensor:
        """(n_groups, 3) group scales -> (nb, 3) per-body scales; autograd
        sums the member bodies' gradients onto their group."""
        return group_scales[torch.as_tensor(self.member_of, device=group_scales.device)]

    def identity(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """All-ones group scales, on the card unless device="cpu"."""
        from nimblephysics_tpu_torch.batched.engine import _resolve_device

        return torch.ones((self.n_groups, 3), dtype=dtype, device=_resolve_device(device))

    @staticmethod
    def from_symmetry(skel: Skeleton) -> "ScaleGroups":
        """Pair left/right bodies by name (OpenSim `_l`/`_r` suffixes and
        `l_`/`r_` or `left`/`right` affixes) into shared groups."""
        names = [b.name for b in skel.bodies]
        idx = {n: i for i, n in enumerate(names)}
        pairs: List[List[int]] = []
        used = set()
        subs = [
            (re.compile(r"_l$"), "_r"),
            (re.compile(r"^l_"), "r_"),
            (re.compile(r"_left$"), "_right"),
            (re.compile(r"^left_"), "right_"),
        ]
        for n in names:
            if idx[n] in used:
                continue
            for pat, rep in subs:
                if pat.search(n):
                    other = pat.sub(rep, n)
                    if other in idx and idx[other] not in used:
                        pairs.append([idx[n], idx[other]])
                        used.add(idx[n])
                        used.add(idx[other])
                    break
        return ScaleGroups(skel, pairs)
