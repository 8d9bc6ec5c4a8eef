"""The device plugin's enumeration backend for NVIDIA cards.

Counterpart of ``tpushare/deviceplugin/enumerator.py``: the reference's
``DevicePlugin`` takes any enumerator with ``mesh`` and ``enumerate()``,
and :class:`~tpushare_torch.deviceplugin.enumerator.NvmlEnumerator` is
that for a GPU node, through NVML (the reference's own gpushare
ancestor asks NVML for the device count and memory).
"""

from tpushare_torch.deviceplugin.enumerator import (
    ChipRecord, FakeEnumerator, MeshTopology, NvmlEnumerator,
    detect_enumerator)

__all__ = ["ChipRecord", "FakeEnumerator", "MeshTopology", "NvmlEnumerator",
           "detect_enumerator"]
