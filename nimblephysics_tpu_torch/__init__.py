"""PyTorch port of nimblephysics_tpu for NVIDIA GPUs.

Mirrors the JAX package's module paths. Slice 1 covers the batched
forward step of the half-cheetah benchmark world:

    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    world, q0, v0 = half_cheetah()
    engine = BatchedEngine(world)  # on the GPU; device="cpu" to ask for it
    res = engine.step(q, v, control, z_warm=z)  # (nv, B) / (n, B) tensors

Imports torch and numpy, never jax or the JAX package.
"""
