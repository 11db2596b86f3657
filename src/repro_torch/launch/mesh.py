"""Production meshes (``repro/launch/mesh.py``) as torch ``DeviceMesh``es.

Single-pod: (16, 16) = ("data", "model"), 256 ranks. Multi-pod: (2, 16,
16) = ("pod", "data", "model"), 512 ranks; the "pod" axis only ever
carries batch (pure data parallelism across pods: the slowest links carry
one gradient all-reduce a step). The shapes and names are the
reference's, so its rule tests and dry-run records line up with the
port's. On H100s a (16, 16) mesh is 32 hosts of 8 cards: a "model" group
of 16 spans two hosts' NVLink domains, and "data" crosses hosts over
InfiniBand (``launch/roofline.py`` states each link's rate).

Every builder is a function over ``init_device_mesh``: importing this
module touches no device and no process group. They need an initialised
``torch.distributed`` process group whose world size is the mesh's device
count, and raise without one: no builder starts a world.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import MeshConfig

SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


def _world(n: int) -> None:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n} ranks needs an initialised process group "
            "(torch.distributed.init_process_group); none is running")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} ranks needs a world of {n}, "
                           f"got {dist.get_world_size()}")


def make_mesh(config: MeshConfig, device_type: str = "cuda"):
    """A DeviceMesh of ``config``'s shape and axis names."""
    from torch.distributed.device_mesh import init_device_mesh

    _world(config.num_devices)
    return init_device_mesh(device_type, tuple(config.shape),
                            mesh_dim_names=tuple(config.axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD, device_type)


def make_host_mesh(model_axis: Optional[int] = None,
                   device_type: str = "cuda"):
    """A (world / model, model) ("data", "model") mesh over the ranks of
    the running world, one a visible card (tests and local runs)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        _world(torch.cuda.device_count())
    n = dist.get_world_size()
    model = model_axis or 1
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {n}")
    return make_mesh(MeshConfig((n // model, model), ("data", "model")),
                     device_type)
