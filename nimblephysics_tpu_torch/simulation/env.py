"""BatchedEnv: a gym-style wrapper over the batched differentiable step.

Counterpart of nimblephysics_tpu/simulation/env.py. The reference exposes
an RL state/action API on World (World.hpp:471-523) consumed by torch
training loops; here a batch of worlds steps through the port's
BatchedEngine (`state_step`, one LCP solve for the whole batch: on the
card, one launch of the seed kernel a step under the default config),
and the whole transition (step, reward, auto-reset) stays on the engine's
device with no host sync. The public layout is the JAX package's: states
(B, 2nv), actions (B, na), steps (B,) int32; the engine's (2nv, B)
layout is used inside.

The JAX key becomes a torch.Generator on the engine's device, held in
EnvState; fresh states for the worlds that finish are drawn every step
and taken by a device-side `where`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from nimblephysics_tpu_torch.simulation.world import World


class EnvState(NamedTuple):
    state: torch.Tensor  # (B, 2nv)
    steps: torch.Tensor  # (B,) int32 steps since reset
    generator: torch.Generator  # draws the reset states, on the device


class StepOutput(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class BatchedEnv:
    """A batch of worlds on the engine's device (the card unless the caller
    passes device="cpu"; float32 unless dtype says otherwise).

    reward_fn(state, action, next_state) -> scalar, for one world
    done_fn(next_state, steps) -> bool, for one world (default: the
        horizon, steps >= horizon)
    reset_sampler(generator, n) -> (n, 2nv) initial states (default:
        0.01 N(0, 1) from the generator)

    reward_fn and done_fn keep their one-world signatures and are batched
    with torch.func.vmap. States carry autograd: the gradient of a reward
    flows back through the env's steps to actions and start states.
    """

    def __init__(
        self,
        world: World,
        reward_fn: Callable,
        reset_sampler: Optional[Callable] = None,
        done_fn: Optional[Callable] = None,
        horizon: int = 1000,
        batch_size: int = 1024,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        from nimblephysics_tpu_torch.batched.engine import BatchedEngine

        self.world = world
        self.engine = BatchedEngine(world, device=device, dtype=dtype)
        self.batch_size = batch_size
        nv = world.num_dofs
        t = dict(dtype=dtype, device=self.engine.device)

        if reset_sampler is None:
            def reset_sampler(gen, n):
                return 0.01 * torch.randn(n, 2 * nv, generator=gen, **t)
        if done_fn is None:
            def done_fn(s, steps):
                return steps >= horizon
        self._reset_sampler = reset_sampler
        self._reward = torch.func.vmap(reward_fn)
        self._done = torch.func.vmap(done_fn)

    def reset(self, seed: Union[int, torch.Generator] = 0) -> EnvState:
        """Fresh states for every world, from a seed or a generator on the
        engine's device."""
        dev = self.engine.device
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        states = self._reset_sampler(gen, self.batch_size)
        steps = torch.zeros(self.batch_size, dtype=torch.int32, device=dev)
        return EnvState(states, steps, gen)

    def step(self, env_state: EnvState, actions: torch.Tensor) -> StepOutput:
        """One step of every world under actions (B, na); a world that is
        done takes a fresh state and restarts its step count."""
        s = env_state.state
        nxt = self.engine.state_step(s.T.contiguous(), actions.T.contiguous()).T
        r = self._reward(s, actions, nxt)
        steps = env_state.steps + 1
        d = self._done(nxt, steps)
        fresh = self._reset_sampler(env_state.generator, self.batch_size)
        nxt = torch.where(d[:, None], fresh, nxt)
        steps = torch.where(d, torch.zeros_like(steps), steps)
        return StepOutput(EnvState(nxt, steps, env_state.generator), nxt, r, d)

    @property
    def observation_size(self) -> int:
        return 2 * self.world.num_dofs

    @property
    def action_size(self) -> int:
        return self.world.action_size
