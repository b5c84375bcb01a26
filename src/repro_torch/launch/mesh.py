"""Mesh definitions and the card's hardware model.

Counterpart of ``repro.launch.mesh``. Each function builds a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group (:func:`repro_torch.configs.setup_devices` joins it) with the
reference's axis names; importing this module touches no device.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs.devices import make_serving_mesh, mesh_device_type


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 256 ranks as (data=16, model=16). Multi-pod: 2 pods of
    256 as (pod=2, data=16, model=16); 'pod' is the slow cross-host
    axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Small (data, model) mesh over the ranks that exist."""
    return make_serving_mesh(data, model)


# NVIDIA H100 SXM5 80GB, per card, dense rates (no sparsity) at the full
# 700 W power limit. Source: NVIDIA H100 Tensor Core GPU datasheet
# (nvidia.com, "H100 SXM" column). A card set below 700 W runs slower.
HW = {
    "peak_bf16_flops": 989e12,     # FLOP/s, BF16 Tensor Core (datasheet)
    "peak_fp32_flops": 67e12,      # FLOP/s, FP32 outside tensor cores
    "hbm_bandwidth": 3.35e12,      # B/s, GPU memory bandwidth (datasheet)
    "hbm_bytes": 80 * 10**9,       # GPU memory, 80 GB (datasheet)
    "nvlink_bandwidth": 900e9,     # B/s per card, NVLink (datasheet)
}
