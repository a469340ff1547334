"""Boundary rules of nimblephysics_tpu_torch.

* The port (and its scripts chip_smoke.py, profile_torch_step.py and
  compare_seed_kernel.py) never imports jax or the JAX package
  nimblephysics_tpu, checked statically per file and by importing every
  module in a fresh interpreter. The name test is exact: the port's own
  name starts with "nimblephysics_tpu".
* Entry points run on the card unless the caller asks for the CPU
  (BatchedEngine, the single-world Engine, get_engine, forward_pass,
  mapped_forward_pass, and the layers above them: BatchedEnv, SingleShot,
  MultiShot, MPCLocal and SSID), and timestep and a snapshot step on their
  state's device, refusing inputs on another.
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


@pytest.mark.parametrize("entry", ["Engine", "get_engine", "forward_pass",
                                   "mapped_forward_pass"])
def test_single_world_engine_defaults_to_the_card(entry):
    """The single-world Engine, get_engine, forward_pass and
    mapped_forward_pass take the card unless asked for the CPU, and step
    there when asked; a snapshot refuses an action on another device (the
    "meta" device stands in for a second one)."""
    from nimblephysics_tpu_torch import neural
    from nimblephysics_tpu_torch.models import cartpole

    world, q0, _ = cartpole()
    make = getattr(neural, entry)
    if entry == "mapped_forward_pass":
        def make(w, state=None, action=None, **kw):
            return neural.mapped_forward_pass(w, state, action,
                                              {"id": neural.IdentityMapping(w)}, **kw)
    if torch.cuda.is_available():
        made = make(world)
        assert (made.device if entry in ("Engine", "get_engine") else made.q.device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(world)
    x = torch.as_tensor(q0, dtype=torch.float64)
    if entry in ("Engine", "get_engine"):
        eng = make(world, device="cpu")
        assert eng.device.type == "cpu" and eng.dtype == torch.float64
        assert torch.isfinite(eng.step(x, torch.zeros_like(x), torch.zeros_like(x)).v).all()
        if entry == "get_engine":
            assert neural.get_engine(world, device="cpu") is eng
        return
    snap = make(world, device="cpu")
    assert snap.q.device.type == "cpu" and snap.q.dtype == torch.float64
    assert torch.isfinite(snap.get_state_jacobian()).all()
    state = torch.cat([x, torch.zeros_like(x)])
    assert make(world, state).engine is neural.get_engine(world, device="cpu")
    meta = torch.zeros(world.action_size, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="copies nothing"):
        make(world, state, meta)


@pytest.mark.parametrize("entry", ["BatchedEnv", "SingleShot", "MultiShot", "MPCLocal",
                                   "SSID"])
def test_upper_layers_default_to_the_card(entry):
    """The env, the trajectory problems, MPC and SSID build their engine on
    the card unless asked for the CPU, and keep their tensors there."""
    from nimblephysics_tpu_torch.models import cartpole
    from nimblephysics_tpu_torch.realtime import SSID, MPCLocal
    from nimblephysics_tpu_torch.simulation import BatchedEnv
    from nimblephysics_tpu_torch.trajectory import MultiShot, SingleShot

    world, _, _ = cartpole()
    world.set_action_space([0])
    make = {
        "BatchedEnv": lambda **kw: BatchedEnv(world, lambda s, a, s2: s2[0], batch_size=2, **kw),
        "SingleShot": lambda **kw: SingleShot(world, lambda ro: ro.poses.sum(), 2, **kw),
        "MultiShot": lambda **kw: MultiShot(world, lambda ro: ro.poses.sum(), 4, 2, **kw),
        "MPCLocal": lambda **kw: MPCLocal(world, lambda p, v, f: p.sum(), horizon_steps=2,
                                          **kw),
        "SSID": lambda **kw: SSID(world, **kw),
    }[entry]
    if torch.cuda.is_available():
        assert make().engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    made = make(device="cpu")
    assert made.engine.device.type == "cpu"
    if entry == "BatchedEnv":
        assert made.reset(0).state.device.type == "cpu"
    elif entry in ("SingleShot", "MultiShot"):
        assert made.start_state.device.type == "cpu"
        assert made.initial_guess(np.zeros(4)).device.type == "cpu"
    elif entry == "SSID":
        assert made.masses.device.type == "cpu" and made.masses.dtype == torch.float64


def test_timestep_refuses_mixed_devices():
    """timestep steps on its state's device and copies nothing: an action
    (or masses) on another device raises, as a state on the card would
    here (the "meta" device stands in for a second one)."""
    import nimblephysics_tpu_torch as nt
    from nimblephysics_tpu_torch.models import cartpole

    world, _, _ = cartpole()
    state = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="copies nothing"):
        nt.timestep(world, state, torch.zeros(2, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="copies nothing"):
        nt.timestep(world, state, torch.zeros(2, dtype=torch.float64),
                    masses=torch.ones(2, dtype=torch.float64, device="meta"))
    eng = nt.neural.Engine(world, device="cpu")
    with pytest.raises(ValueError, match="this engine takes"):
        eng.step(state[:2].float(), state[2:].float(), state[2:].float())
    assert nt.timestep(world, state, torch.zeros(2, dtype=torch.float64)).shape == (4,)


def test_kernel_wrapper_refuses_cpu_tensors_without_launching():
    from nimblephysics_tpu_torch.batched import lcp_cuda
    from nimblephysics_tpu_torch.constraint.lcp import LcpMeta

    meta = LcpMeta(findex=np.array([-1, 0, 0], np.int32),
                   is_friction=np.array([False, True, True]), iterations=4)
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="must lie on"):
        lcp_cuda.apgd_cuda(meta, torch.zeros(3, 1, 2), x, x, x)
    assert lcp_cuda.apgd_seed.launches == 0


def _cheetah_with(what):
    """The half-cheetah (throughput()) with one more skeleton: an
    ellipsoid joint ("joint_type"), a mesh with no vertices
    ("pair_kind", which collides with nothing, as in the JAX package) or
    a one-sphere set ("multisphere_pair") on a vertical slider over the
    ground; or with World.max_contacts below its 16 slots."""
    from nimblephysics_tpu_torch.dynamics import PRISMATIC, ShapeSpec, Skeleton
    from nimblephysics_tpu_torch.models import half_cheetah
    from nimblephysics_tpu_torch.simulation import SolverConfig

    world, _, _ = half_cheetah()
    world.solver = SolverConfig.throughput()
    if what == "joint_type":
        arm = Skeleton("arm")
        arm.add_joint_and_body("ellipsoid")
        world.add_skeleton(arm)
    elif what in ("pair_kind", "multisphere_pair"):
        kind, size = (("mesh", np.zeros((4, 3))) if what == "pair_kind"
                      else ("multisphere", np.array([[0.0, 0.0, 0.0, 0.1]])))
        spheres = size if kind == "multisphere" else None
        rock = Skeleton("rock")
        rock.add_joint_and_body(PRISMATIC, axis=[0, 1, 0],
                                shapes=(ShapeSpec(kind, size, spheres=spheres),))
        world.add_skeleton(rock)
    elif what == "max_contacts":
        world.max_contacts = 4  # of the cheetah's 16 slots
    return world


@pytest.mark.parametrize("what", ["joint_type", "pair_kind", "multisphere_pair"])
def test_new_slice_worlds_build_and_step(what):
    """The worlds that raised before the spline joints, meshes and sphere
    sets came build and step in both engines: a finite step."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.neural import Engine

    world = _cheetah_with(what)
    nv = world.num_dofs
    x = torch.zeros(nv, 2, dtype=torch.float64)
    r = BatchedEngine(world, device="cpu", dtype=torch.float64).step(x, x, x)
    assert torch.isfinite(r.q).all() and torch.isfinite(r.v).all()
    s = Engine(world, device="cpu").step(x[:, 0], x[:, 0], x[:, 0])
    assert torch.isfinite(s.v).all()
    torch.testing.assert_close(s.v, r.v[:, 0], atol=1e-12, rtol=0)


@pytest.mark.parametrize("what", ["max_contacts"])
def test_off_slice_options_raise(what):
    """What the port does not take yet raises, naming its ROADMAP item:
    World.max_contacts below the slot count."""
    from nimblephysics_tpu_torch.batched import BatchedEngine
    from nimblephysics_tpu_torch.neural import Engine

    world = _cheetah_with(what)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedEngine(world, device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng = Engine(world, device="cpu")
        x = torch.zeros(world.num_dofs, dtype=torch.float64)
        eng.step(x, x, x)
