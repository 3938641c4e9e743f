"""Production and host meshes, as torch ``DeviceMesh``es.

Single pod: (16, 16) over ("data", "model"): 256 devices. Multi-pod:
(2, 16, 16) over ("pod", "data", "model"): 512 devices; the "pod" axis
is pure data parallelism, and gradient compression
(``parallel/compress.py``) targets exactly that axis.

The counterpart of ``repro.launch.mesh``. Both builders are functions,
so importing this module touches no process group or device; they run
on the default process group, which the caller (the train launcher, or
``torchrun``'s environment through it) has initialized, one rank per
device. On the production mesh the models run tensor-parallel over
"model" (``parallel/sharding.py``); the host mesh's "model" axis has one
rank.
"""
from __future__ import annotations

import math

import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over the default process group. Raises
    ``ValueError`` naming the device count it needs when the world size
    differs."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {'multi-pod ' if multi_pod else ''}production "
                         f"mesh {shape} over {axes} needs {need} devices "
                         f"(one rank each); this world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """(world size, 1) over ("data", "model") on the default process
    group: pure data parallelism over whatever ranks exist."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise ValueError("make_host_mesh needs an initialized default "
                         "process group")
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
