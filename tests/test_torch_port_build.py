"""The binding of the port's native libraries (``unetseg_tpu_torch/_build.py``).

A tiny C++ library with a C interface, built with g++ into a build
directory of the test's own, stands in for the kernels: one build and one
``CDLL`` however many threads load it at once, its entry points typed as declared, the kept build log
read back as ``ptxas -v`` resources, and the entry points' return codes
raised with the kernel's name.  Then the port's own declarations: each
library keeps its compiler command (so its hashed file name), and one
reset sets every launch counter to 0.
"""

import ctypes
import threading
import time

import pytest

from unetseg_tpu_torch import _build, graphs
from unetseg_tpu_torch.benchmarks import dec1_phases
from unetseg_tpu_torch.io import native
from unetseg_tpu_torch.ops import (attention, cc_kernel, conv, conv_s8, dec1,
                                   groupnorm, halo_copy, relpos_bias)

SOURCE = r"""extern "C" {
int add(int a, int b) { return a + b; }
double half(double x) { return x / 2; }
int code(int c) { return c; }
int smem(int bkc, int bn, int fold) { return 1000 * bkc + 10 * bn + fold; }
}
"""
FUNCTIONS = {"add": (ctypes.c_int, [ctypes.c_int] * 2),
             "half": (ctypes.c_double, [ctypes.c_double]),
             "code": (ctypes.c_int, [ctypes.c_int]),
             "smem": (ctypes.c_int, [ctypes.c_int] * 3)}
GXX = ["g++", "-O1", "-shared", "-fPIC"]
# What ``nvcc -Xptxas -v`` prints, cut to two kernels and a helper.
PTXAS_LOG = (
    "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120conv3x3_"
    "wgmma_kernelILi64ELi128ELb1EEEv14CUtensorMap_stS1_PK13__nv_bfloat16' "
    "for 'sm_90a'\n"
    "ptxas info    : Function properties for _ZN12_GLOBAL__N_120conv3x3_"
    "wgmma_kernelILi64ELi128ELb1EEEv14CUtensorMap_stS1_PK13__nv_bfloat16\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 96 registers, 900 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function '_Z17dec1_wgmma_kernelILi16EEv"
    "PKv' for 'sm_90a'\n"
    "ptxas info    : Function properties for _Z17dec1_wgmma_kernelILi16EEvPKv"
    "\n    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
    "ptxas info    : Used 166 registers, 1024 bytes smem\n"
    "ptxas info    : Function properties for _Z6helperv\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")


def _library(tmp_path, monkeypatch, compiler=lambda: GXX):
    """A fresh library of :data:`SOURCE`, built into ``tmp_path``."""
    src = tmp_path / "tiny.cpp"
    src.write_text(SOURCE)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return _build.Library("libtiny", compiler, [str(src)],
                          functions=FUNCTIONS)


def test_threads_share_one_build_and_one_cdll(tmp_path, monkeypatch):
    lib = _library(tmp_path, monkeypatch)
    builds, real = [], _build.build_shared

    def slow_build(*args, **kwargs):
        builds.append(args[0])
        time.sleep(0.2)  # the other threads arrive while this one builds
        return real(*args, **kwargs)

    monkeypatch.setattr(_build, "build_shared", slow_build)
    start = threading.Barrier(8)
    got = [None] * 8

    def load(i):
        start.wait()
        got[i] = lib.load()

    threads = [threading.Thread(target=load, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert builds == ["libtiny"]
    assert all(g is got[0] for g in got) and got[0] is not None
    assert lib.path.startswith(str(tmp_path / "build"))
    assert lib.load() is got[0] and builds == ["libtiny"]


def test_declared_entry_points_are_typed(tmp_path, monkeypatch):
    lib = _library(tmp_path, monkeypatch).load()
    for fn, (restype, argtypes) in FUNCTIONS.items():
        assert getattr(lib, fn).restype is restype
        assert list(getattr(lib, fn).argtypes) == argtypes
    assert lib.add(2, 3) == 5
    assert lib.half(3) == 1.5  # converted to double only when typed


def _logged(tmp_path, monkeypatch):
    """The tiny library built by a compiler that prints :data:`PTXAS_LOG`
    as nvcc's ``-Xptxas -v`` does."""
    log = tmp_path / "ptxas.log"
    log.write_text(PTXAS_LOG)
    script = f"cat {log} >&2; exec g++ \"$@\""
    return _library(tmp_path, monkeypatch,
                    lambda: ["sh", "-c", script, "sh", *GXX[1:]])


def test_resources_read_the_kept_build_log(tmp_path, monkeypatch):
    lib = _logged(tmp_path, monkeypatch)
    info = lib.ptxas()  # builds the library first
    assert _build.read_log(lib.path) == PTXAS_LOG
    assert sorted(info.values(), key=str) == sorted([
        {"registers": 96, "spill_bytes": 0, "smem_static": 0},
        {"registers": 166, "spill_bytes": 8, "smem_static": 1024},
        {"registers": None, "spill_bytes": 0, "smem_static": 0}], key=str)
    (args, k1), = lib.instantiations("conv3x3_wgmma_kernel")
    assert args == (64, 128, True) and k1["registers"] == 96
    (args, k6), = lib.instantiations("dec1_wgmma_kernel")
    assert args == (16,) and k6["spill_bytes"] == 8
    assert lib.instantiations("conv3x3_s8_wgmma_kernel") == []


def test_conv_rows_name_each_field(tmp_path, monkeypatch):
    """The rows ``chip_smoke.py`` prints as ``conv_resources``: the
    template's fields, ptxas's, and the entry point's dynamic shared
    memory, in that order."""
    lib = _logged(tmp_path, monkeypatch)
    assert conv._resources(lib, "conv3x3_wgmma_kernel", "smem") == [
        {"bkc": 64, "bn": 128, "fold": True, "registers": 96,
         "spill_bytes": 0, "smem_static": 0, "smem_dynamic": 65281}]
    assert list(conv._resources(lib, "conv3x3_wgmma_kernel", "smem")[0]) \
        == ["bkc", "bn", "fold", "registers", "spill_bytes", "smem_static",
            "smem_dynamic"]


@pytest.mark.parametrize("err,reason", [
    (0, None), (-1, "tile plan refused"),
    (-2, "no cuTensorMapEncodeTiled in the driver"),
    (-3, "tensor map refused"), (700, "CUDA error 700")])
def test_a_return_code_raises_naming_kernel_and_reason(tmp_path, monkeypatch,
                                                       err, reason):
    lib = _library(tmp_path, monkeypatch).load()
    if reason is None:
        _build.check(lib.code(err), "conv3x3")
        return
    with pytest.raises(RuntimeError) as e:
        _build.check(lib.code(err), "conv3x3")
    assert str(e.value) == f"conv3x3 kernel launch failed: {reason}"


def test_a_failed_build_raises_and_loads_nothing(tmp_path, monkeypatch):
    lib = _library(tmp_path, monkeypatch)
    (tmp_path / "tiny.cpp").write_text("int broken(")
    with pytest.raises(RuntimeError, match="building libtiny failed"):
        lib.load()
    assert lib.path is None


PTXAS = ["-Xptxas", "-v"]
KERNEL_LIBRARIES = [
    (conv.LIBRARY, "libconv3x3", [conv.SOURCE], [conv.HEADER], PTXAS),
    (conv.LIBRARY_F32, "libconv3x3_f32", [conv.SOURCE_F32], [conv.HEADER],
     PTXAS),
    (conv_s8.LIBRARY, "libconv3x3_s8", [conv_s8.SOURCE], [conv.HEADER],
     PTXAS),
    (dec1.LIBRARY, "libdec1_fused", [dec1.SOURCE], [conv.HEADER], PTXAS),
    (dec1_phases.LIBRARY, "libdec1_phases", [dec1.SOURCE], [conv.HEADER],
     ["-DDEC1_PHASES"]),
    (groupnorm.LIBRARY, "libgroupnorm_nhwc", [groupnorm.SOURCE], [], PTXAS),
    (relpos_bias.LIBRARY, "librelpos_bias", [relpos_bias.SOURCE], [], PTXAS),
    (cc_kernel.LIBRARY, "libcc_label", [cc_kernel.SOURCE], [], PTXAS),
    (halo_copy.LIBRARY, "libhalo_copy", [halo_copy.SOURCE], [], [])]


@pytest.mark.parametrize("library,name,sources,deps,flags", KERNEL_LIBRARIES,
                         ids=[row[1] for row in KERNEL_LIBRARIES])
def test_each_kernel_library_keeps_its_command(monkeypatch, library, name,
                                               sources, deps, flags):
    """The name, nvcc command, sources and headers the kernel libraries
    were built from before the binding moved into ``_build``: the hashed
    file names under ``_build/`` stay the same."""
    monkeypatch.setattr(_build, "nvcc", lambda: "/cuda/bin/nvcc")
    assert (library.name, library.sources, library.deps) == \
        (name, sources, deps)
    assert library.compiler() == ["/cuda/bin/nvcc", *_build.NVCC_FLAGS,
                                  *flags]


def test_host_library_keeps_the_makefile_line():
    assert native.LIBRARY.name == "libunetseg_host"
    assert native.LIBRARY.compiler() == ["g++", "-O3", "-std=c++17",
                                         "-fPIC", "-fopenmp", "-shared"]
    assert [p.rsplit("/", 1)[1] for p in native.LIBRARY.sources] == \
        ["contour.cpp", "emit.cpp"]
    assert native.load == native.LIBRARY.load


def test_one_reset_zeroes_every_launch_counter():
    counters = (conv.LAUNCHES, conv.DGRAD_LAUNCHES, conv_s8.LAUNCHES,
                dec1.LAUNCHES, groupnorm.LAUNCHES, cc_kernel.LAUNCHES,
                halo_copy.LAUNCHES, attention.LAUNCHES, relpos_bias.LAUNCHES)
    for counter in counters:
        assert any(c is counter for c in graphs.COUNTERS)
        for name in counter:
            counter[name] += 3
    graphs.reset_launches()
    assert all(n == 0 for counter in counters for n in counter.values())
