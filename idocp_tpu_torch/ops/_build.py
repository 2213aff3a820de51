"""Build and load every native library of the port, and launch its hand
kernels (no JAX twin: XLA compiles the JAX package's Pallas kernel).

``CUDA`` compiles each ``ops/csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
``ops/_build/``; ``HOST`` compiles each ``hybrid/csrc/*.cpp`` (the schedule
discretizer) with the host C++ compiler (``$CXX``, else ``c++`` or ``g++``)
into ``hybrid/_build/``. Both directories are git-ignored. One rule for both:
a library has a plain C interface, is loaded with ``ctypes`` and is named by
the hash of its source and flags, so a changed source is rebuilt and an
unchanged one reused; it is compiled to a temporary file and renamed into
place, so that processes building it together never load half a file; a
failed build raises with the compiler's output and leaves no library.
Nothing is built at import, and a host library never looks for ``nvcc``.

A kernel wrapper checks its inputs, allocates its outputs and calls
``launch``, which runs the entry point ``<wrapper>_f32`` / ``_f64`` of a
library on the current stream of the tensors' device and counts the launch in
``<wrapper>.launches`` and, while ``<wrapper>.shapes`` is a list (a reader
such as ``tools.mfu_report`` sets it), in ``shapes``; ``counted`` gives a
wrapper both. Inside ``capturing()`` (a CUDA graph records the launch) the
launch is logged instead, and counted by ``count`` each time the graph
replays.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

_PKG = Path(__file__).resolve().parents[1]


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return [str(Path(cand) / "bin" / "nvcc")]
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "idocp_tpu_torch need the CUDA toolkit")
    return [found]


def _cxx():
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++ / g++ / $CXX) found: the "
                           "schedule library of idocp_tpu_torch needs one")
    return shlex.split(cxx)


@dataclasses.dataclass(frozen=True)
class Toolchain:
    """A kind of source: its suffix, its directory, where its libraries go,
    and the compiler's command (a function) and flags."""
    suffix: str
    csrc: Path
    out: Path
    compiler: Callable
    flags: tuple


CUDA = Toolchain(".cu", _PKG / "ops" / "csrc", _PKG / "ops" / "_build", _nvcc,
                 ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                  "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"))
HOST = Toolchain(".cpp", _PKG / "hybrid" / "csrc", _PKG / "hybrid" / "_build",
                 _cxx, ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"))

_libs: dict = {}
_entries: dict = {}
#: inside ``capturing()``: the (wrapper, shape) of each launch captured
_captured = None
#: seconds spent in the compiler and its output, per source, for reports
build_log: dict = {}


def sources():
    """Names (without suffix) of every CUDA kernel source."""
    return sorted(p.stem for p in CUDA.csrc.glob("*" + CUDA.suffix))


def _source(name: str):
    """(toolchain, source path, library path) of the source ``name``."""
    for chain in (CUDA, HOST):
        src = chain.csrc / (name + chain.suffix)
        if src.exists():
            digest = hashlib.sha256(src.read_bytes() + " ".join(
                chain.flags).encode()).hexdigest()[:16]
            return chain, src, chain.out / f"lib{name}_{digest}.so"
    raise ValueError(f"no native source named {name!r}")


def build_all(names=None) -> float:
    """Compile every missing library of ``names`` (default: the CUDA
    sources), all compilers started together. Returns the wall seconds."""
    t0 = time.time()
    procs = []
    for name in sources() if names is None else names:
        chain, src, target = _source(name)
        if target.exists():
            continue
        chain.out.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [*chain.compiler(), *chain.flags, "-o", str(tmp), str(src)]
        try:
            procs.append((name, target, tmp, time.time(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        except OSError as exc:
            raise RuntimeError(f"could not run {cmd[0]!r}: {exc}") from exc
    failed = []
    for name, target, tmp, started, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = {"seconds": time.time() - started, "output": out}
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"building {name} failed (rc={proc.returncode}):\n"
                          f"{out[-2000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of the source ``name`` (built at first use)."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(_source(name)[2]))
    return _libs[name]


def counted(wrapper):
    """The kernel wrapper with its counters: ``launches`` 0, ``shapes`` None."""
    wrapper.launches, wrapper.shapes = 0, None
    return wrapper


def count(wrapper, shape):
    """One launch of ``wrapper`` of ``shape`` in its counters."""
    wrapper.launches += 1
    if wrapper.shapes is not None:
        wrapper.shapes.append(shape)


@contextlib.contextmanager
def capturing():
    """Inside the block a launch runs on a stream that a CUDA graph
    captures, and is not counted: the block gives the list of the
    (wrapper, shape) launched, for ``count`` at each replay."""
    global _captured
    was, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = was


def _current_stream(index: int) -> int:
    """Handle of the current CUDA stream of device ``index``. PyTorch's
    internal accessor returns it without building a ``Stream`` object, which
    costs more than the rest of a wrapper call together."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def entry(library: str, name: str, dtype, argtypes):
    """The C entry point ``<name>_f32`` / ``_f64`` of ``library``, taking
    ``argtypes`` and then the stream and returning a CUDA error code."""
    fn = _entries.get((library, name, dtype))
    if fn is None:
        fn = getattr(load(library),
                     name + ("_f32" if dtype == torch.float32 else "_f64"))
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[library, name, dtype] = fn
    return fn


def launch(wrapper, library: str, device, dtype, argtypes, args, shape):
    """One launch of ``wrapper``'s entry point with ``args``; ``shape`` is
    what ``wrapper.shapes`` records of it."""
    fn = entry(library, wrapper.__name__, dtype, argtypes)
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _current_stream(index))
    else:  # a launch goes to the calling thread's current device
        with torch.cuda.device(index):
            err = fn(*args, _current_stream(index))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"CUDA error {err}")
    if _captured is not None:
        _captured.append((wrapper, shape))
    else:
        count(wrapper, shape)
