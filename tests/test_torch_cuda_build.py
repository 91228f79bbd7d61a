"""The build of the port's CUDA C++ kernels (``cunvsm_torch/ops/cuda_build.py``)
and the cast's binding to it, on a machine without nvcc or a card.

A stand-in ``nvcc`` (a Python script that writes the file named by ``-o``)
shows where the library goes, that it is moved into place whole, and that
it is built once per source content; the real compiler runs only where a
CUDA toolkit and a card are (``chip_smoke.py``).
"""

import ctypes
import os
import stat
import sys
from types import SimpleNamespace

import pytest

from cunvsm_torch.ops import cast, cuda_build, window_mean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("cast_bf16.cu",)


def _fake_nvcc(directory, rc=0):
    """An executable ``nvcc`` in ``directory`` that appends its arguments to
    ``calls.txt`` and writes ``built`` to the ``-o`` file, or fails."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "nvcc")
    with open(path, "w") as f:
        f.write(
            f"#!{sys.executable}\n"
            "import os, sys\n"
            "here = os.path.dirname(os.path.abspath(__file__))\n"
            "open(os.path.join(here, 'calls.txt'), 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
            f"if {rc}:\n"
            "    sys.stderr.write('error: boom\\n')\n"
            f"    sys.exit({rc})\n"
            "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('built')\n"
        )
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


@pytest.fixture
def no_toolkit(monkeypatch, tmp_path):
    """No CUDA_HOME, an empty PATH, and the build directory in tmp_path."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build" / "cuda"))
    return tmp_path


def test_nvcc_command_targets_sm_90a():
    cmd = cuda_build.nvcc_command("nvcc", SOURCES, "out.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == "out.so"
    assert cmd[-1] == os.path.join(REPO, "cunvsm_torch", "csrc", "cast_bf16.cu")


def test_library_lies_under_build_cuda():
    path = cuda_build.library_path("cast_bf16", SOURCES)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "cuda")
    assert os.path.basename(path).startswith("libcast_bf16-") and path.endswith(".so")
    assert "build/" in open(os.path.join(REPO, ".gitignore")).read().split()


def test_library_name_follows_every_source_byte(monkeypatch, tmp_path):
    src = open(os.path.join(cuda_build.CSRC, "cast_bf16.cu"), "rb").read()
    (tmp_path / "cast_bf16.cu").write_bytes(src)
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    first = cuda_build.library_path("cast_bf16", SOURCES)
    (tmp_path / "cast_bf16.cu").write_bytes(src[:-1] + bytes([src[-1] ^ 1]))
    assert cuda_build.library_path("cast_bf16", SOURCES) != first
    (tmp_path / "cast_bf16.cu").write_bytes(src)
    assert cuda_build.library_path("cast_bf16", SOURCES) == first


def test_library_name_follows_the_flags(monkeypatch):
    first = cuda_build.library_path("cast_bf16", SOURCES)
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("cast_bf16", SOURCES) != first


def test_missing_nvcc_raises(no_toolkit):
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_library("cast_bf16", SOURCES)
    assert not os.path.exists(cuda_build.BUILD_DIR)


def test_cast_launcher_raises_without_nvcc(no_toolkit):
    """What a CUDA tensor's cast meets on a machine without nvcc: an error
    naming nvcc, not a plain fallback."""
    with pytest.raises(RuntimeError, match="nvcc"):
        cast._cast_kernel.__wrapped__()


def test_find_nvcc_takes_cuda_home_first(no_toolkit, monkeypatch):
    home = _fake_nvcc(no_toolkit / "home" / "bin")
    on_path = _fake_nvcc(no_toolkit / "onpath")
    monkeypatch.setenv("PATH", os.path.dirname(on_path))
    assert cuda_build.find_nvcc() == on_path
    monkeypatch.setenv("CUDA_HOME", str(no_toolkit / "home"))
    assert cuda_build.find_nvcc() == home


def test_find_nvcc_passes_over_a_cuda_home_without_nvcc(no_toolkit, monkeypatch):
    (no_toolkit / "home" / "bin").mkdir(parents=True)
    monkeypatch.setenv("CUDA_HOME", str(no_toolkit / "home"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()
    on_path = _fake_nvcc(no_toolkit / "onpath")
    monkeypatch.setenv("PATH", os.path.dirname(on_path))
    assert cuda_build.find_nvcc() == on_path


def test_build_moves_a_whole_library_into_place_once(no_toolkit, monkeypatch):
    bindir = no_toolkit / "home" / "bin"
    _fake_nvcc(bindir)
    monkeypatch.setenv("CUDA_HOME", str(no_toolkit / "home"))
    path = cuda_build.build_library("cast_bf16", SOURCES)
    assert path == cuda_build.library_path("cast_bf16", SOURCES)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert open(path).read() == "built"
    assert os.listdir(cuda_build.BUILD_DIR) == [os.path.basename(path)]
    (call,) = (bindir / "calls.txt").read_text().splitlines()
    out = call.split()[call.split().index("-o") + 1]
    assert out != path and os.path.dirname(out) == cuda_build.BUILD_DIR
    assert cuda_build.build_library("cast_bf16", SOURCES) == path
    assert len((bindir / "calls.txt").read_text().splitlines()) == 1


def test_failed_build_raises_with_the_compiler_output(no_toolkit, monkeypatch):
    _fake_nvcc(no_toolkit / "home" / "bin", rc=2)
    monkeypatch.setenv("CUDA_HOME", str(no_toolkit / "home"))
    with pytest.raises(RuntimeError, match="boom"):
        cuda_build.build_library("cast_bf16", SOURCES)
    assert os.listdir(cuda_build.BUILD_DIR) == []


def test_bind_declares_the_c_signature():
    """Pointers and the stream as c_void_p (a plain int would cut them to
    32 bits), n as long long, the cudaError_t back as int."""
    lib = SimpleNamespace(cunvsm_cast_f32_bf16=SimpleNamespace())
    fn = cast.bind(lib)
    assert fn is lib.cunvsm_cast_f32_bf16
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_source_declares_the_bound_entry_point():
    src = open(os.path.join(cuda_build.CSRC, "cast_bf16.cu")).read()
    decl = " ".join(src[src.index('extern "C"'):src.index("{", src.index('extern "C"'))].split())
    assert decl == ('extern "C" int cunvsm_cast_f32_bf16(const float* x, __nv_bfloat16* y, '
                    "long long n, cudaStream_t stream)")


def test_window_mean_binding_declares_the_c_signature():
    """The window mean's pointers and stream as c_void_p, its sizes as long
    long or int, the reciprocal as a float."""
    lib = SimpleNamespace(cunvsm_window_mean=SimpleNamespace())
    fn = window_mean.bind(lib)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert fn is lib.cunvsm_window_mean
    assert fn.argtypes == [ptr, i, ptr, ptr, ptr, ll, i, ll, i, ctypes.c_float, ptr]
    assert fn.restype is ctypes.c_int
    src = open(os.path.join(cuda_build.CSRC, "window_mean.cu")).read()
    decl = " ".join(src[src.index('extern "C"'):src.index("{", src.index('extern "C"'))].split())
    assert decl == ('extern "C" int cunvsm_window_mean(const void* table, int bf16_table, '
                    "const long long* idx, const void* fw, float* out, long long batch, "
                    "int window, long long dim, int bf16_sum, float inv, cudaStream_t stream)")
