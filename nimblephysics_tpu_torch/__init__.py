"""PyTorch port of nimblephysics_tpu for NVIDIA GPUs.

Mirrors the JAX package's module paths. It covers the batched,
differentiable step of the half-cheetah benchmark world and the
policy-gradient training step through it:

    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.parallel import MlpPolicy, train_step_batched
    world, q0, v0 = half_cheetah()
    engine = BatchedEngine(world)  # on the GPU; device="cpu" to ask for it
    res = engine.step(q, v, control, z_warm=z)  # (nv, B) / (n, B) tensors
    train = train_step_batched(engine, MlpPolicy(18, 6), horizon=100)

Imports torch and numpy, never jax or the JAX package.
"""
