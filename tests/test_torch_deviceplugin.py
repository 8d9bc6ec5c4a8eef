"""The port's GPU enumerator (tpushare_torch/deviceplugin/enumerator.py)
over an injected fake NVML, and the reference's ``DevicePlugin``
(tpushare/deviceplugin/plugin.py) run over it on a fake cluster: the
resource report, one allocate, and the health check after a card
vanishes. The real NVML runs in ``chip_smoke.py``'s card phase."""

import ctypes

import pytest

from tests.test_contract import make_pod
from tpushare import contract
from tpushare.cache import SchedulerCache
from tpushare.deviceplugin import DevicePlugin
from tpushare.k8s import FakeCluster
from tpushare_torch.deviceplugin import enumerator as en

H100_BYTES = 81559 * 2**20   # NVML's total of an H100 80GB HBM3


class FakeNvml:
    """NVML's calls as the enumerator makes them (pointers to ctypes
    values), over cards with these minor numbers; ``lost`` hides some."""

    def __init__(self, minors, total=H100_BYTES):
        self.minors, self.total, self.lost = list(minors), total, set()

    def _cards(self):
        return [m for m in self.minors if m not in self.lost]

    def nvmlDeviceGetCount_v2(self, count):
        count.contents.value = len(self._cards())
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        cards = self._cards()
        if index.value >= len(cards):
            return 2   # NVML_ERROR_INVALID_ARGUMENT
        handle.contents.value = 1000 + cards[index.value]
        return 0

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor.contents.value = handle.value - 1000
        return 0

    def nvmlDeviceGetMemoryInfo(self, handle, memory):
        memory.contents.total = self.total
        memory.contents.used = 0
        memory.contents.free = self.total
        return 0

    def nvmlErrorString(self, rc):
        return b"Invalid Argument"


def test_records_come_from_nvml():
    e = en.NvmlEnumerator(lib=FakeNvml([0, 1, 2, 3]))
    assert e.available()
    assert e.enumerate() == [
        en.ChipRecord(i, (i,), 81559, f"/dev/nvidia{i}") for i in range(4)]
    assert e.mesh == en.MeshTopology((4,)) and e.mesh.label() == "4"


def test_ids_are_minor_numbers_across_a_gap():
    # /dev/nvidia1 gone: the survivors keep their ids, so the plugin's
    # health check names the card that vanished
    e = en.NvmlEnumerator(lib=FakeNvml([0, 2, 3]))
    chips = e.enumerate()
    assert [c.idx for c in chips] == [0, 2, 3]
    assert [c.device_path for c in chips] == ["/dev/nvidia0", "/dev/nvidia2",
                                              "/dev/nvidia3"]
    # a 1-D mesh of the cards counted; an id past it keeps its own coord
    assert [c.coords for c in chips] == [(0,), (2,), (3,)]


def test_hbm_override(monkeypatch):
    monkeypatch.setenv("TPUSHARE_HBM_MIB", "40960")
    e = en.NvmlEnumerator(lib=FakeNvml([0, 1]))
    assert {c.hbm_mib for c in e.enumerate()} == {40960}
    monkeypatch.setenv("TPUSHARE_HBM_MIB", "lots")
    assert {c.hbm_mib for c in e.enumerate()} == {81559}


def test_an_nvml_error_names_its_call():
    class Broken(FakeNvml):
        def nvmlDeviceGetMemoryInfo(self, handle, memory):
            return 999

    with pytest.raises(RuntimeError, match="nvmlDeviceGetMemoryInfo"):
        en.NvmlEnumerator(lib=Broken([0])).enumerate()


def test_without_nvml(monkeypatch):
    # the library does not load: not available, no records, and
    # detect_enumerator returns None (the reference's contract)
    monkeypatch.setattr(en, "NVML_LIBRARY", "libnvidia-ml-absent.so.1")
    e = en.NvmlEnumerator()
    assert not e.available() and e.enumerate() == []
    assert en.detect_enumerator() is None


def test_memory_struct_is_nvml_memory_t():
    # nvmlMemory_t: three unsigned long long, total first
    assert ctypes.sizeof(en._Memory) == 24
    assert [f[0] for f in en._Memory._fields_] == ["total", "free", "used"]


@pytest.mark.parametrize("chips,mesh,shape", [
    (4, "2x2", (2, 2)), (4, None, (2, 2)), (3, None, (3,)), (8, "8", (8,))])
def test_fake_enumerator_shapes(chips, mesh, shape):
    e = en.FakeEnumerator(chips, 81559, mesh)
    assert e.mesh.shape == shape
    assert [c.idx for c in e.enumerate()] == list(range(chips))
    assert e.enumerate()[-1].coords == e.mesh.coords(chips - 1)


def test_fake_enumerator_rejects_a_wrong_mesh():
    with pytest.raises(ValueError):
        en.FakeEnumerator(4, 81559, "4x4")


def _plugin(nvml):
    fc = FakeCluster()
    fc.add_tpu_node("g1", chips=len(nvml.minors), hbm_per_chip_mib=81559,
                    mesh=str(len(nvml.minors)))
    return fc, DevicePlugin(fc, "g1", en.NvmlEnumerator(lib=nvml))


def test_device_plugin_reports_the_cards():
    fc, plugin = _plugin(FakeNvml([0, 1, 2, 3]))
    report = plugin.resource_report()
    assert report["status"]["capacity"] == {
        contract.RESOURCE_HBM: str(4 * 81559), contract.RESOURCE_COUNT: "4"}
    assert report["metadata"]["labels"][contract.LABEL_MESH] == "4"
    plugin.register_node()
    node = fc.get_node("g1")
    assert node["status"]["allocatable"][contract.RESOURCE_HBM] == str(
        4 * 81559)


def test_device_plugin_allocates_a_placed_pod():
    fc, plugin = _plugin(FakeNvml([0, 1, 2, 3]))
    cache = SchedulerCache(fc)
    cache.build_cache()
    pod = fc.create_pod(make_pod(hbm=8192, name="w1"))
    cache.get_node_info("g1").allocate(pod, fc)
    resp = plugin.allocate(hbm_mib=8192)
    assert resp["pod"]["name"] == "w1"
    chip = resp["chip_ids"][0]
    assert resp["devices"] == [f"/dev/nvidia{chip}"]
    env = resp["env"]
    assert env[contract.ENV_HBM_LIMIT] == "8192"
    assert env[contract.ENV_HBM_CHIP_TOTAL] == "81559"
    assert env[contract.ENV_MEM_FRACTION] == f"{8192 / 81559:.4f}"
    assert contract.is_assigned(fc.get_pod("default", "w1"))


def test_device_plugin_health_marks_the_vanished_card():
    nvml = FakeNvml([0, 1, 2, 3])
    fc, plugin = _plugin(nvml)
    assert plugin.check_health() == set()
    nvml.lost = {2}
    assert plugin.check_health() == {2}
    cm = fc.get_configmap("kube-system", "unhealthy-tpu-g1")
    assert cm["data"]["chips"] == "2"
