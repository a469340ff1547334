"""Differentiable-physics policy-gradient training step, one device.

Counterpart of nimblephysics_tpu/parallel/mesh.py's
sharded_train_step_batched on one device: the policy's parameters and the
batch-minor world states live on the engine's device, each of `horizon`
steps runs the policy and BatchedEngine.remat_step, and the gradient of
the rollout loss updates the parameters by plain SGD. Sharding worlds
over several GPUs is later work (ROADMAP queue 1 item 15).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from nimblephysics_tpu_torch.batched.engine import BatchedEngine, _resolve_device


class MlpPolicy(nn.Module):
    """tanh MLP on batch-minor states, (2nv, B) -> (na, B):
    a = w2 tanh(w1 s + b1) + b2 (bench.py's and dryrun_multichip's policy).

    Weights 0.1 N(0, 1) from a torch.Generator seeded with `seed`, biases
    zero. The device rule is the engine's: the card unless the caller asks
    for the CPU.
    """

    def __init__(self, state_size: int, action_size: int, hidden: int = 64,
                 seed: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dev = _resolve_device(device)

        def param(*shape, scale):
            x = scale * torch.randn(*shape, generator=gen, dtype=dtype)
            return nn.Parameter(x.to(dev))

        self.w1 = param(hidden, state_size, scale=0.1)
        self.b1 = param(hidden, 1, scale=0.0)
        self.w2 = param(action_size, hidden, scale=0.1)
        self.b2 = param(action_size, 1, scale=0.0)

    def forward(self, states):
        return self.w2 @ torch.tanh(self.w1 @ states + self.b1) + self.b2


class TrainStepResult(NamedTuple):
    states: torch.Tensor  # (2nv, B) after the rollout, detached
    loss: torch.Tensor  # () before the update, detached


def train_step_batched(
    engine: BatchedEngine,
    policy: nn.Module,
    horizon: int = 8,
    learning_rate: float = 1e-3,
) -> Callable[[torch.Tensor], TrainStepResult]:
    """Policy-gradient training step for the batched engine.

    Returns train(states) for (2nv, B) states on the engine's device. It
    rolls `horizon` steps of a = policy(s), s' = state_step(s, a) (a cold
    LCP start each step, as the JAX package's state_step), with the reward
    r = s'[nv] - 1e-3 sum(a^2) (the root's forward velocity minus an effort
    penalty), takes loss = -mean over worlds of the summed reward,
    backpropagates through every step (each one remat'd:
    BatchedEngine.remat_step) and updates every parameter by
    p -= learning_rate * p.grad. The gradients stay in p.grad.
    """
    nv = engine.world.num_dofs
    params = list(policy.parameters())
    for p in params:
        if p.device != engine.device or p.dtype != engine.dtype:
            raise ValueError(
                f"policy parameters are {p.dtype} on {p.device}; the engine "
                f"takes {engine.dtype} on {engine.device}"
            )

    def train(states: torch.Tensor) -> TrainStepResult:
        for p in params:
            p.grad = None
        s = states
        total = 0.0
        for _ in range(horizon):
            a = policy(s)
            r = engine.remat_step(s[:nv], s[nv:], engine.action_to_forces(a))
            s = torch.cat([r.q, r.v])
            total = total + (s[nv] - 1e-3 * torch.sum(a * a, dim=0))
        loss = -torch.mean(total)
        loss.backward()
        with torch.no_grad():
            for p in params:
                p -= learning_rate * p.grad
        return TrainStepResult(s.detach(), loss.detach())

    return train
