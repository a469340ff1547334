"""Boundary rules of nimblephysics_tpu_torch.

* The port (and its scripts chip_smoke.py, profile_torch_step.py and
  compare_seed_kernel.py) never imports jax or the JAX package
  nimblephysics_tpu, checked statically per file and by importing every
  module in a fresh interpreter. The name test is exact: the port's own
  name starts with "nimblephysics_tpu".
* Entry points run on the card unless the caller asks for the CPU.
* The kernel module imports, and its CPU path runs, with no nvcc and no
  GPU; nothing is compiled at import.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nimblephysics_tpu_torch"
FILES = sorted(
    str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
) + ["chip_smoke.py", "profile_torch_step.py", "compare_seed_kernel.py"]


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "nimblephysics_tpu"


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _is_forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_forbidden_name_rule_is_exact():
    assert _is_forbidden("nimblephysics_tpu")
    assert _is_forbidden("nimblephysics_tpu.batched.lcp")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("nimblephysics_tpu_torch.batched.lcp")


def test_importing_the_port_loads_no_jax():
    modules = [
        "nimblephysics_tpu_torch." + str(p.relative_to(PORT).with_suffix(""))
        .replace(os.sep, ".").replace(".__init__", "")
        for p in PORT.rglob("*.py")
    ]
    code = (
        "import sys, importlib\n"
        f"for m in {sorted(modules)!r}: importlib.import_module(m)\n"
        "import chip_smoke, profile_torch_step, compare_seed_kernel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nimblephysics_tpu')]\n"
        "from nimblephysics_tpu_torch.batched import lcp_cuda\n"
        "assert lcp_cuda._library.cache_info().currsize == 0\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_engine_defaults_to_the_card():
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, _, _ = half_cheetah()
    world.solver = SolverConfig.throughput()
    if torch.cuda.is_available():
        assert BatchedEngine(world).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedEngine(world)
    eng = BatchedEngine(world, device="cpu", dtype=torch.float64)
    assert eng.device.type == "cpu" and eng.dtype == torch.float64


def test_kernel_wrapper_refuses_cpu_tensors_without_launching():
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    meta = LcpMeta(findex=np.array([-1, 0, 0], np.int32),
                   is_friction=np.array([False, True, True]), iterations=4)
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="must lie on"):
        lcp_cuda.apgd_cuda(meta, torch.zeros(3, 1, 2), x, x, x)
    assert lcp_cuda.apgd_seed.launches == 0


@pytest.mark.parametrize(
    "what", ["joint_type", "pair_kind", "body_params", "max_contacts"]
)
def test_off_slice_options_raise(what):
    """What the port does not take yet raises, naming its ROADMAP item:
    the spline-driven joint types (an ellipsoid joint); mesh, heightmap
    and multisphere pairs (a mesh against the ground); body_params; and
    World.max_contacts below the slot count."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.dynamics import PRISMATIC, ShapeSpec, Skeleton
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, _, _ = half_cheetah()
    world.solver = SolverConfig.throughput()
    kw = dict(device="cpu", dtype=torch.float64)
    if what == "joint_type":
        arm = Skeleton("arm")
        arm.add_joint_and_body("ellipsoid")
        world.add_skeleton(arm)
    elif what == "pair_kind":
        rock = Skeleton("rock")
        rock.add_joint_and_body(PRISMATIC, axis=[0, 1, 0], shapes=(
            ShapeSpec("mesh", np.zeros((4, 3))),))
        world.add_skeleton(rock)
    elif what == "max_contacts":
        world.max_contacts = 4  # of the cheetah's 16 slots
    if what == "body_params":
        eng = BatchedEngine(world, **kw)
        q = torch.zeros(9, 2, dtype=torch.float64)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.step(q, q, q, body_params={"masses": np.ones(11)})
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedEngine(world, **kw)
