"""Batched engine, world batch in the trailing axis.

Public surface: BatchedEngine(world, device, dtype).step(q, v, control,
z_warm) with (nv, B) tensors, held against the JAX package's
BatchedEngine.step in tests/test_torch_engine.py; remat_step, the same
step with a checkpointed backward.
"""

from nimblephysics_tpu_torch.batched.engine import BatchedEngine, BatchedStepResult
