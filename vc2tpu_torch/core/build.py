"""Build and load the port's native code: CUDA kernels and host C++.

Each source has a plain C interface and is compiled into
``_build/lib<name>-<hash>.so`` inside this package, at first use: a CUDA
kernel ``csrc/<name>.cu`` by ``nvcc``, a host routine ``csrc/<name>.cpp``
by the host C++ compiler (``Source.compiler``). A kernel may include
headers generated from Python tables (``Source.headers``: file name and
text); they are written next to the library and put on the include path.
The hash covers the source, the headers of ``csrc/`` it includes (the
decode core ``golomb_decode.cuh`` that the two unpacks share, the code
writer ``golomb_encode.cuh`` of the packs and the LD rate control), the
generated headers, the compiler and its flags, so a stale library is never
loaded. The library is opened with
ctypes; the wrappers set ``argtypes``.

A missing compiler or a failed build raises: there is no other route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Source:
    """A source ``csrc/<name>.cu`` (``compiler`` "nvcc") or
    ``csrc/<name>.cpp`` (``compiler`` "c++", the host compiler), and the
    headers generated for it, as ((file name, text), ...)."""

    name: str
    headers: tuple = ()
    compiler: str = "nvcc"

    @property
    def path(self) -> str:
        ext = ".cu" if self.compiler == "nvcc" else ".cpp"
        return os.path.join(CSRC, self.name + ext)

    @property
    def flags(self) -> tuple:
        return NVCC_FLAGS if self.compiler == "nvcc" else CXX_FLAGS


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def cxx_path() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found: the host "
                       "routines cannot be built (set CXX)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def included_headers(path: str) -> list[str]:
    """The headers of ``csrc/`` that the file at ``path`` includes with
    ``#include "..."``, and theirs, in the order first met."""
    out, todo = [], [path]
    while todo:
        with open(todo.pop(0), "rb") as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            dep = os.path.join(CSRC, name.decode())
            if os.path.exists(dep) and dep not in out:
                out.append(dep)
                todo.append(dep)
    return out


def library_path(src: Source) -> str:
    h = hashlib.sha256()
    for path in [src.path, *included_headers(src.path)]:
        with open(path, "rb") as f:
            h.update(f.read())
    for fname, text in src.headers:
        h.update(fname.encode() + b"\0" + text.encode() + b"\0")
    h.update(src.compiler.encode() + b"\0" + " ".join(src.flags).encode())
    return os.path.join(BUILD_DIR, f"lib{src.name}-{h.hexdigest()[:16]}.so")


def _start(src: Source):
    """Start the build of ``src`` unless its library exists.
    Returns (path, process or None)."""
    out = library_path(src)
    if os.path.exists(out):
        return out, None
    tmp = f"{out}.{os.getpid()}.tmp"
    gen = f"{tmp}.include"
    os.makedirs(gen, exist_ok=True)
    for fname, text in src.headers:
        with open(os.path.join(gen, fname), "w") as f:
            f.write(text)
    compiler = nvcc_path() if src.compiler == "nvcc" else cxx_path()
    cmd = [compiler, *src.flags, "-I", gen, "-o", tmp, src.path]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return out, (proc, tmp, gen)


def build(*sources: Source) -> list[str]:
    """Build the sources, all compiler processes running at once. Returns
    the library paths; raises RuntimeError on a failed build."""
    started = [(src, *_start(src)) for src in sources]
    errors = []
    for src, out, job in started:
        if job is None:
            continue
        proc, tmp, gen = job
        log = proc.communicate()[0].decode(errors="replace")
        shutil.rmtree(gen, ignore_errors=True)
        if proc.returncode != 0:
            errors.append(f"{src.compiler} failed for "
                          f"{os.path.basename(src.path)}:\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out for _src, out, _job in started]


def load(src: Source) -> ctypes.CDLL:
    """The library of ``src``, built first if it is missing. The wrappers
    call this once (they cache the configured library)."""
    (path,) = build(src)
    return ctypes.CDLL(path)
