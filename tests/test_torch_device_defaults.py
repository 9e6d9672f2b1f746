"""The port's state constructors run on the card unless the caller asks for
the CPU: `empty_state`, `empty_physics_state`, `build_physics_state` and
`empty_pool` called with no device resolve it through
`device.resolve_device`, which raises where PyTorch sees no card, and give
card tensors where it does. Called with `device="cpu"` they give CPU tensors
equal to the JAX package's constructors."""

import functools

import jax
import numpy as np
import pytest
import torch

from oxylus_tpu.physics import build as jbuild
from oxylus_tpu.physics import state as jphys
from oxylus_tpu.scene import particles as jparticles
from oxylus_tpu.scene import state as jstate
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import build as tbuild
from oxylus_tpu_torch.physics import state as tphys
from oxylus_tpu_torch.scene import particles as tparticles
from oxylus_tpu_torch.scene import state as tstate
from oxylus_tpu_torch.scene.scene import Scene as _TScene

torch.set_num_threads(1)
TScene = functools.partial(_TScene, device="cpu")
SPEC = dict(max_entities=32, max_bodies=64, max_particles=16)


def _bodies(Scene, SceneSpec):
    s = Scene("bodies", spec=SceneSpec(**SPEC))
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(20.0, 1.0, 20.0), friction=0.6)
    for i in range(3):
        e = s.create_entity(f"box{i}")
        e.add("TransformComponent", position=(0.5 * i, 1.0 + i, 0.0))
        e.add("BoxColliderComponent", size=(0.3, 0.4, 0.5))
        e.add("RigidBodyComponent", mass=1.0 + i)
    ball = s.create_entity("ball")
    ball.add("TransformComponent", position=(2.0, 3.0, 0.0))
    ball.add("SphereColliderComponent", radius=0.35)
    ball.add("RigidBodyComponent", mass=2.0)
    return s


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, name))


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None and not isinstance(v, bool):
            out[prefix + k] = np.asarray(v)
    return out


CONSTRUCTORS = {
    "empty_state": (lambda **kw: tstate.empty_state(tstate.SceneSpec(**SPEC), **kw),
                    lambda: bridge.scene_state_to_numpy(bridge.scene_state_from_numpy(
                        jax.device_get(jstate.empty_state(jstate.SceneSpec(**SPEC))))),
                    bridge.scene_state_to_numpy),
    "empty_physics_state": (lambda **kw: tphys.empty_physics_state(SPEC["max_bodies"], **kw),
                            lambda: bridge.physics_state_to_numpy(bridge.physics_state_from_numpy(
                                jax.device_get(jphys.empty_physics_state(SPEC["max_bodies"])))),
                            bridge.physics_state_to_numpy),
    "build_physics_state": (lambda **kw: tbuild.build_physics_state(_bodies(TScene, tstate.SceneSpec), **kw),
                            lambda: bridge.physics_state_to_numpy(bridge.physics_state_from_numpy(
                                jax.device_get(jbuild.build_physics_state(_bodies(JScene, jstate.SceneSpec))))),
                            bridge.physics_state_to_numpy),
    "empty_pool": (lambda **kw: tparticles.empty_pool(tstate.SceneSpec(**SPEC), **kw),
                   lambda: {k: np.asarray(v) for k, v in vars(jax.device_get(
                       jparticles.empty_pool(jstate.SceneSpec(**SPEC)))).items()},
                   lambda pool: {k: v.numpy() for k, v in vars(pool).items()}),
}


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_no_device_means_the_card(name):
    make = CONSTRUCTORS[name][0]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _tensors(make()))
    else:
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            make()


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_cpu_when_asked_equals_the_reference(name):
    make, reference, to_numpy = CONSTRUCTORS[name]
    got = make(device="cpu")
    tensors = list(_tensors(got))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    got, want = _flat(to_numpy(got)), _flat(reference())
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
