"""Card enumeration for the device plugin on an NVIDIA host.

The port of ``tpushare/deviceplugin/enumerator.py``. The reference counts
``/dev/accel*`` through a C++ probe; a GPU host answers through NVML,
``libnvidia-ml.so.1``, which every NVIDIA host has (``nvidia-smi`` reads
the cards through it) and which is loaded here with ``ctypes`` (nothing
to build):

- :class:`NvmlEnumerator` asks NVML for the cards, each card's minor
  number (its ``/dev/nvidia<minor>`` node) and its memory. A card's id is
  its minor number, not its position in the scan (the reference's
  ``_idx_from_path`` rule): when a card vanishes the survivors keep their
  ids, so the plugin's health check marks the right one. HBM is NVML's
  total unless ``TPUSHARE_HBM_MIB`` is set. The mesh is 1-D; NVLink and
  NVSwitch topology are not scored.
- :class:`FakeEnumerator`, a synthetic host for tests.
- :func:`detect_enumerator`: the NVML backend when it finds cards, else
  None, as the reference's.

Both backends expose what the reference's ``DevicePlugin`` reads:
``enumerate()`` -> :class:`ChipRecord` list, and ``mesh`` (a
:class:`MeshTopology`: ``shape``, ``num_chips``, ``coords``,
``label``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

NVML_LIBRARY = "libnvidia-ml.so.1"


@dataclass(frozen=True)
class MeshTopology:
    """An axis-aligned mesh of cards, row-major (the last axis varies
    fastest): the port's copy of the part of the reference's
    ``tpushare.core.topology.MeshTopology`` the device plugin reads."""

    shape: tuple[int, ...]

    def __post_init__(self) -> None:
        if not self.shape or any(d <= 0 for d in self.shape):
            raise ValueError(f"invalid mesh shape {self.shape!r}")

    @property
    def num_chips(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def coords(self, idx: int) -> tuple[int, ...]:
        if not 0 <= idx < self.num_chips:
            raise IndexError(f"chip {idx} outside mesh {self.shape}")
        out = []
        for d in reversed(self.shape):
            out.append(idx % d)
            idx //= d
        return tuple(reversed(out))

    def label(self) -> str:
        return "x".join(str(d) for d in self.shape)

    @classmethod
    def from_label(cls, label: str) -> "MeshTopology":
        """Parse a mesh label such as ``"4"`` or ``"2x2"``."""
        try:
            dims = tuple(int(p) for p in label.lower().split("x"))
        except ValueError:
            raise ValueError(f"bad mesh label {label!r}") from None
        return cls(dims)

    @classmethod
    def for_chip_count(cls, count: int) -> "MeshTopology":
        """The most-square 2-D factorisation of ``count``; 1-D for
        primes (the reference's default for a host without a label)."""
        if count <= 0:
            raise ValueError("count must be positive")
        best = (1, count)
        for a in range(2, int(count ** 0.5) + 1):
            if count % a == 0:
                best = (a, count // a)
        return cls(best if best[0] > 1 else (count,))


@dataclass(frozen=True)
class ChipRecord:
    idx: int
    coords: tuple[int, ...]
    hbm_mib: int
    device_path: str  # what the container needs mounted (informational)


class FakeEnumerator:
    """Hermetic backend: a synthetic host (tests)."""

    def __init__(self, chips: int, hbm_mib: int = 80 * 1024,
                 mesh: str | None = None) -> None:
        self._topo = (MeshTopology.from_label(mesh) if mesh
                      else MeshTopology.for_chip_count(chips))
        if self._topo.num_chips != chips:
            raise ValueError(f"mesh {mesh} != {chips} chips")
        self._chips = chips
        self._hbm = hbm_mib

    def enumerate(self) -> list[ChipRecord]:
        return [ChipRecord(i, self._topo.coords(i), self._hbm,
                           f"/dev/nvidia{i}")
                for i in range(self._chips)]

    @property
    def mesh(self) -> MeshTopology:
        return self._topo


class _Memory(ctypes.Structure):
    """``nvmlMemory_t``."""
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


def _load_nvml():
    """``libnvidia-ml.so.1``, initialised, with the calls used here
    typed; None when it does not load or does not initialise."""
    try:
        lib = ctypes.CDLL(NVML_LIBRARY)
    except OSError:
        return None
    uint_p, handle_p = (ctypes.POINTER(ctypes.c_uint),
                        ctypes.POINTER(ctypes.c_void_p))
    for name, args in (("nvmlInit_v2", []),
                       ("nvmlDeviceGetCount_v2", [uint_p]),
                       ("nvmlDeviceGetHandleByIndex_v2",
                        [ctypes.c_uint, handle_p]),
                       ("nvmlDeviceGetMinorNumber",
                        [ctypes.c_void_p, uint_p]),
                       ("nvmlDeviceGetMemoryInfo",
                        [ctypes.c_void_p, ctypes.POINTER(_Memory)])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    lib.nvmlErrorString.restype = ctypes.c_char_p
    return lib if lib.nvmlInit_v2() == 0 else None


def _hbm_from_env() -> int | None:
    raw = os.environ.get("TPUSHARE_HBM_MIB")
    return int(raw) if raw and raw.isdigit() else None


class NvmlEnumerator:
    """The host's NVIDIA cards through NVML (the counterpart of the
    reference's ``NativeEnumerator``). ``lib`` is NVML: by default
    ``libnvidia-ml.so.1``, loaded and initialised once; a test passes an
    object with the same calls."""

    _lock = threading.Lock()

    def __init__(self, lib=None) -> None:
        self._lib = _load_nvml() if lib is None else lib

    def available(self) -> bool:
        return self._lib is not None

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"NVML {name} failed ({rc}): "
                               f"{self._lib.nvmlErrorString(rc)!r}")

    def _count(self) -> int:
        count = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.pointer(count))
        return count.value

    def enumerate(self) -> list[ChipRecord]:
        """A fresh scan (the plugin's health check relies on it): one
        record per card, its id its minor number."""
        if self._lib is None:
            return []
        with self._lock:
            count = self._count()
            topo = MeshTopology((max(count, 1),))
            override = _hbm_from_env()
            out = []
            for i in range(count):
                handle = ctypes.c_void_p()
                self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(i),
                           ctypes.pointer(handle))
                minor, mem = ctypes.c_uint(), _Memory()
                self._call("nvmlDeviceGetMinorNumber", handle,
                           ctypes.pointer(minor))
                self._call("nvmlDeviceGetMemoryInfo", handle,
                           ctypes.pointer(mem))
                idx = minor.value
                coords = topo.coords(idx) if idx < topo.num_chips else (idx,)
                out.append(ChipRecord(
                    idx, coords,
                    override if override is not None else mem.total >> 20,
                    f"/dev/nvidia{idx}"))
            return out

    @property
    def mesh(self) -> MeshTopology:
        if self._lib is None:
            return MeshTopology((1,))
        with self._lock:
            return MeshTopology((max(self._count(), 1),))


def detect_enumerator():
    """:class:`NvmlEnumerator` when NVML loads and finds cards, else
    None (callers fall back to an explicit fake configuration)."""
    nvml = NvmlEnumerator()
    if nvml.available() and nvml.enumerate():
        return nvml
    return None
