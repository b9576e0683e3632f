"""Production mesh definitions (single-pod 16x16, multi-pod 2x16x16).

PyTorch counterpart of ``repro.launch.mesh`` on ``init_device_mesh`` with
the reference's axis names. The meshes are built by FUNCTIONS, so that
importing this module touches no process group: the caller initialises
one of the mesh's size first (``torch.distributed.init_process_group``:
NCCL across cards, or the ``fake`` backend, which stands 256 or 512 ranks
in one process for a dry run of the placements).
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ``data`` x ``model`` mesh over the first ranks of the
    caller's process group (CPU tests pass ``device_type="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_data_axes(mesh) -> tuple:
    """Mesh axes that together form the logical batch/FSDP axis."""
    return (("pod", "data") if "pod" in mesh.mesh_dim_names
            else ("data",))
