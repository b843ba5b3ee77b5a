"""Meshes — port of ``repro/launch/mesh.py``.

``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the initialized process group (one rank a card; ``torch.distributed
.run`` starts them), named ``("data", "model")``, or ``("pod", "data",
"model")`` with ``pods > 1``.  The production meshes of the JAX package are
TPU pods (16 x 16 chips, two pods over DCN); ``make_production_mesh``
gives their shape alone, which a ``ShardingPlan`` resolves specs against
without devices.  Functions, not module-level constants, so importing
touches no device or process group.
"""
from __future__ import annotations

from typing import Dict, Optional


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialized)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """{axis: size} of JAX's production mesh (shape only)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_mesh(dp: int, tp: int, pods: int = 1, device_type: Optional[str] = None):
    """Any (pods, dp, tp) factorization of the live ranks; ``device_type``
    defaults to ``cuda`` on an NCCL group and ``cpu`` otherwise."""
    n = world_size()
    want = pods * dp * tp
    if want != n:
        raise ValueError(f"mesh {pods}x{dp}x{tp}={want} needs {want} ranks; the "
                         f"process group has {n}")
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(start the ranks with torch.distributed.run)")
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if pods > 1:
        return init_device_mesh(device_type, (pods, dp, tp),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("data", "model"))


def largest_feasible_mesh(tp: int = 16, pods: int = 1,
                          device_type: Optional[str] = None):
    """Elastic downscale: keep TP fixed (the model must fit), take the
    largest DP the live ranks support.  The mesh must cover every rank of
    the group, so a rank count that ``tp · pods`` does not divide raises
    (``make_mesh``)."""
    dp = max(1, world_size() // (tp * pods))
    return make_mesh(dp, tp, pods, device_type)
