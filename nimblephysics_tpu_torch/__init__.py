"""PyTorch port of nimblephysics_tpu for NVIDIA GPUs.

Mirrors the JAX package's module paths. It covers the differentiable
step of one world, nimble.timestep's counterpart:

    import nimblephysics_tpu_torch as nt
    state = torch.cat([q, v]).cuda()  # float64 by default
    next_state = nt.timestep(world, state, action)  # on state's device
    eng = nt.neural.Engine(world)  # on the GPU; device="cpu" to ask for it
    res = eng.step(q, v, control, z_warm=z)  # StepResult

and the batched step of many worlds and the policy-gradient training
step through it:

    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.parallel import MlpPolicy, train_step_batched
    world, q0, v0 = half_cheetah()
    engine = BatchedEngine(world)  # on the GPU; device="cpu" to ask for it
    res = engine.step(q, v, control, z_warm=z)  # (nv, B) / (n, B) tensors
    train = train_step_batched(engine, MlpPolicy(18, 6), horizon=100)

and the Jacobians of one step (neural.forward_pass, a BackpropSnapshot):

    snap = nt.forward_pass(world, state, action)  # state's device and dtype
    J = snap.get_state_jacobian()  # (2 nv, 2 nv), d[q'; v'] / d[q; v]
    g_state, g_action, _ = snap.backprop_state(g)  # one reverse pass

and the layers on top of the step (trajectory optimisation, MPC and
system identification on one world, the batched RL environment):

    from nimblephysics_tpu_torch.trajectory import MultiShot, GaussNewtonOptimizer
    from nimblephysics_tpu_torch.realtime import MPCLocal, SSID
    env = nt.BatchedEnv(world, reward_fn, batch_size=4096)  # BatchedEngine inside

Imports torch and numpy, never jax or the JAX package.
"""


def __getattr__(name):
    """`timestep`, `forward_pass` (`forwardPass`), `map_to_pos`,
    `map_to_vel`, `BatchedEnv` and the subpackages, imported at first use
    (as the JAX package's root has them)."""
    import importlib

    if name == "timestep":
        from nimblephysics_tpu_torch.neural.timestep import timestep

        return timestep
    if name == "forward_pass" or name == "forwardPass":
        from nimblephysics_tpu_torch.neural.backprop_snapshot import forward_pass

        return forward_pass
    if name == "map_to_pos":
        from nimblephysics_tpu_torch.neural.mappings import map_to_pos

        return map_to_pos
    if name == "map_to_vel":
        from nimblephysics_tpu_torch.neural.mappings import map_to_vel

        return map_to_vel
    if name == "BatchedEnv":
        from nimblephysics_tpu_torch.simulation.env import BatchedEnv

        return BatchedEnv
    if name in ("batched", "collision", "constraint", "dynamics", "math", "models",
                "neural", "parallel", "proto", "realtime", "simulation", "trajectory"):
        return importlib.import_module(f"nimblephysics_tpu_torch.{name}")
    raise AttributeError(f"module 'nimblephysics_tpu_torch' has no attribute {name!r}")
