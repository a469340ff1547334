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

Imports torch and numpy, never jax or the JAX package.
"""


def __getattr__(name):
    """`timestep` and the subpackages, imported at first use (as the JAX
    package's nimblephysics_tpu.timestep)."""
    import importlib

    if name == "timestep":
        from nimblephysics_tpu_torch.neural.timestep import timestep

        return timestep
    if name in ("batched", "collision", "constraint", "dynamics", "math", "models",
                "neural", "parallel", "simulation"):
        return importlib.import_module(f"nimblephysics_tpu_torch.{name}")
    raise AttributeError(f"module 'nimblephysics_tpu_torch' has no attribute {name!r}")
