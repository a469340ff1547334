"""Batched engine, world batch in the trailing axis.

Public surface: BatchedEngine(world, device, dtype).step(q, v, control,
z_warm) with (nv, B) tensors, held against the JAX package's
BatchedEngine.step in tests/test_torch_engine.py; remat_step, the same
step with a checkpointed backward.

Imported lazily, so that the single-world modules can use batched/linalg.py
and batched/articulated.py without importing the engine.
"""


def __getattr__(name):
    if name in ("BatchedEngine", "BatchedStepResult"):
        from nimblephysics_tpu_torch.batched import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
