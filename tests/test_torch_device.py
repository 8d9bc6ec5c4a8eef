"""Where the port runs: entry points take the card unless the CPU is
asked for, raise when CUDA is missing, and the kernel wrapper launches
its kernel or raises for CUDA tensors, taking the plain version only for
CPU tensors. These tests run without CUDA."""

import dataclasses

import numpy as np
import pytest
import torch

from tpushare_torch.kernels import build, flash
from tpushare_torch.workloads import model as tm
from tpushare_torch.workloads import resolve_device, serve

torch.set_num_threads(2)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        resolve_device("meta")


def test_serve_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.build_server(["--preset", "llama-tiny", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_server(["--preset", "llama-tiny", "--port", "0",
                            "--device", "cuda"])


def test_entry_defaults_to_cuda_and_raises_without_it(no_cuda):
    from tpushare_torch.entry import entry
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    fn, (params, tokens) = entry(device="cpu", attn="einsum")
    assert tokens.shape == (2, 128) and params["embed"].shape == (2048, 512)
    assert tokens.device.type == "cpu"


class _FakeCuda:
    """The attributes the wrapper reads of a tensor, on a CUDA device
    that this machine does not have."""

    def __init__(self, shape, dtype=torch.bfloat16, last_stride=1):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        strides[-1] = last_stride
        self._strides = tuple(strides)

    def dim(self):
        return len(self.shape)

    def stride(self, dim=None):
        return self._strides if dim is None else self._strides[dim]


def test_cuda_tensors_go_to_the_kernel_never_the_plain_version(monkeypatch):
    calls = []

    def kernel():
        calls.append("kernel")
        raise RuntimeError("kernel library requested")

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(flash, "_kernel", kernel)
    monkeypatch.setattr("tpushare_torch.workloads.attention."
                        "flash_attention_plain", plain)
    q, kv = _FakeCuda((1, 4, 8, 64)), _FakeCuda((1, 2, 8, 64))
    before = flash.LAUNCHES
    with pytest.raises(RuntimeError, match="kernel library requested"):
        flash.flash_fwd(q, kv, kv, True)
    assert calls == ["kernel"] and flash.LAUNCHES == before


def test_cuda_tensors_go_to_the_pipelined_kernel_when_asked(monkeypatch):
    calls = []

    def pipelined():
        calls.append("pipelined")
        raise RuntimeError("pipelined library requested")

    def plain(*a, **kw):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(flash, "_kernel_pipelined", pipelined)
    monkeypatch.setattr(flash, "_kernel",
                        lambda: pytest.fail("K1 asked for under pipelined"))
    monkeypatch.setattr("tpushare_torch.workloads.attention."
                        "flash_attention_plain", plain)
    q, kv = _FakeCuda((1, 4, 8, 64)), _FakeCuda((1, 2, 8, 64))
    before = (flash.LAUNCHES, flash.LAUNCHES_PIPELINED)
    with pytest.raises(RuntimeError, match="pipelined library requested"):
        flash.flash_fwd(q, kv, kv, False, pipelined=True)
    assert calls == ["pipelined"]
    assert (flash.LAUNCHES, flash.LAUNCHES_PIPELINED) == before


@pytest.mark.parametrize("q,k,match", [
    (_FakeCuda((1, 4, 8, 64), torch.float16), _FakeCuda((1, 2, 8, 64),
                                                        torch.float16),
     "fp32 or bf16"),
    (_FakeCuda((1, 4, 8, 96)), _FakeCuda((1, 2, 8, 96)), "head_dim"),
    (_FakeCuda((1, 4, 8, 64), last_stride=2), _FakeCuda((1, 2, 8, 64)),
     "contiguous last dimension"),
    (_FakeCuda((1, 4, 8, 64)), _FakeCuda((1, 3, 8, 64)), "kv heads divide"),
    (_FakeCuda((1, 4, 8, 64)), torch.zeros(1, 2, 8, 64), "all on cpu or"),
], ids=["fp16", "head-dim", "strided", "gqa", "mixed-devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch, q, k,
                                                       match):
    monkeypatch.setattr(flash, "_kernel", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match=match):
        flash.flash_fwd(q, k, k, True)


def test_cpu_forward_with_flash_never_loads_the_library():
    cfg = dataclasses.replace(tm.PRESETS["llama-tiny"], attn="flash")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    before = flash.LAUNCHES
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                                (2, 16)))
    logits = tm.forward(params, tokens, cfg)
    assert torch.isfinite(logits).all()
    assert flash.LAUNCHES == before == 0
    assert "flash_fwd" not in build._LOADED


def test_library_path_follows_the_sources(monkeypatch, tmp_path):
    (tmp_path / "flash_fwd.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("flash_fwd")
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("libflash_fwd-")
    assert build.library_path("flash_fwd") == first
    (tmp_path / "flash_fwd.cu").write_text("// two\n")
    assert build.library_path("flash_fwd") != first


def test_build_names_a_missing_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
