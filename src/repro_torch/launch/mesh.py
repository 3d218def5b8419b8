"""Production mesh construction of the port, from ``repro.launch.mesh``.

FUNCTIONS (never module-level constants), so importing this module
touches no device and no process group.  Each builds a DeviceMesh over
the current default process group, whose world size must equal the
mesh's: single pod 16 x 16 = 256 devices ("data", "model"); multi-pod
2 x 16 x 16 = 512 with a leading "pod" axis.  The dry run builds them
over a fake process group of that size (``launch.dryrun``); a host run
over a real group of one (``make_host_mesh``).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Degenerate 1 x 1 mesh for single-device runs (world size 1)."""
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
