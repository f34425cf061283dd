"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, into ``multitreegp_tpu_torch/_build/`` (listed in
``.gitignore``); the library's file name carries a hash of its source, the
headers it includes (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a current one is reused. A failed
build raises; nothing falls back.

Flags: ``-fmad=false`` keeps ``a*b+c`` from being contracted into an FMA, so
the kernels round exactly as their plain PyTorch versions do; division and
square root stay IEEE (no fast-math). ``-Xptxas -v`` makes ``ptxas`` report
each kernel's registers, stack frame and spills; the report of a build in
this process is kept in :data:`build_logs`.

Each source has three kinds of build (:class:`Variant`): the default one;
the extended one (``-DMTGP_EXT_OPS``, the library ``<name>_ext``), whose tree
kernels also compute the operators past ``+ - * / sin cos``
(``csrc/tree_eval.cuh``); and one user build per generated header of user
operators (:func:`user_variant`: ``-DMTGP_EXT_OPS -DMTGP_USER_OPS -include
_build/user_ops_<hash16>.h``, the library ``<name>_u<hash12>``, the hash the
header's sha256; ``core/user_ops.py`` writes the header's text). A function
set within ``+ - * / sin cos`` never loads another build, so it runs the code
it always ran; the others are made at the first use of a set that needs
them. Each of the three has a wide-state form (:func:`widened`: its flags
and ``-DMTGP_WIDE_STATE``, the library ``<name>..._wide``) in which the SR
sources (``sr_fitness``, ``sr_rollout``, ``sr_adaptive``) compile their
instance for any state dim and trajectory count, and ``policy`` its
instance for any hidden state and number of targets, instead of the fixed
ones (``csrc/tree_prog_wide.cuh``), made at the first use of a
configuration the fixed instances do not take. The policy source also has a
user-environment form of each (:func:`env_variant`: its flags and
``-DMTGP_USER_ENV -include _build/user_env_<hash16>.h``, the library
``policy..._e<hash12>``), whose one plant is the struct ``core/user_envs.py``
generated from a torch environment's methods.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple, Union

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

EXTENDED_FLAGS = ("-DMTGP_EXT_OPS",)  # the extended build's extra flags (nvcc and g++)
USER_FLAGS = EXTENDED_FLAGS + ("-DMTGP_USER_OPS",)  # a user build's, besides its -include
WIDE_FLAGS = ("-DMTGP_WIDE_STATE",)  # a wide-state build's, besides its variant's
ENV_FLAGS = ("-DMTGP_USER_ENV",)  # a user-environment build's, besides its -include


@dataclass(frozen=True)
class Variant:
    """One build of a source: the library name's suffix, the extra flags
    (nvcc and g++), for a user build the generated operator header's text
    and for a user-environment build the generated plant's, which the
    compiler includes before the source (in that order)."""

    suffix: str = ""
    flags: Tuple[str, ...] = ()
    header: str = field(default="", repr=False)
    env_header: str = field(default="", repr=False)


DEFAULT = Variant()
EXTENDED = Variant("_ext", EXTENDED_FLAGS)


def user_variant(header: str) -> Variant:
    """The user build of a generated header (``<name>_u<hash12>``)."""
    return Variant("_u" + header_hash(header)[:12], USER_FLAGS, header)


def widened(variant: Union[bool, "Variant"]) -> Variant:
    """The wide-state form of ``variant`` (the SR sources' instance for any
    state dim and trajectory count, the policy source's for any hidden state
    and number of targets): its flags and ``-DMTGP_WIDE_STATE``, its suffix
    and ``_wide``, its header."""
    variant = as_variant(variant)
    return Variant(variant.suffix + "_wide", variant.flags + WIDE_FLAGS, variant.header,
                   variant.env_header)


def env_variant(variant: Union[bool, "Variant"], env_header: str) -> Variant:
    """``variant`` (an operator build) with a generated plant as the policy
    source's one environment: its flags and ``-DMTGP_USER_ENV``, its suffix
    and ``_e<hash12>`` (the hash the plant header's sha256)."""
    variant = as_variant(variant)
    return Variant(variant.suffix + "_e" + header_hash(env_header)[:12], variant.flags + ENV_FLAGS,
                   variant.header, env_header)


def header_hash(header: str) -> str:
    """sha256 of a generated header's text, the key of its user build."""
    return hashlib.sha256(header.encode()).hexdigest()


def as_variant(variant: Union[bool, Variant]) -> Variant:
    """``variant``, or for a bool the extended (True) or default build."""
    if isinstance(variant, Variant):
        return variant
    return EXTENDED if variant else DEFAULT


def header_path(variant: Variant) -> Path:
    """Where a user build's header is written (``_build/``), the same path
    for the same text."""
    return BUILD_DIR / f"user_ops_{header_hash(variant.header)[:16]}.h"


def env_header_path(variant: Variant) -> Path:
    """Where a user-environment build's plant header is written
    (``_build/``), the same path for the same text."""
    return BUILD_DIR / f"user_env_{header_hash(variant.env_header)[:16]}.h"


def _write_text(text: str, path: Path) -> List[str]:
    """Write a generated header to ``path`` (atomically, unless it holds the
    text already) and return the compiler flags that include it."""
    if not text:
        return []
    if not path.exists() or path.read_text() != text:
        path.parent.mkdir(parents=True, exist_ok=True)
        # a file of its own per writer: builds of one header run in parallel
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f"{path.name}.", suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return ["-include", str(path)]


def _write_header(variant: Variant, out_dir: Path) -> List[str]:
    """Write a build's generated headers into ``out_dir`` and return the
    compiler flags that include them: the operators', then the plant's."""
    return (_write_text(variant.header, Path(out_dir) / header_path(variant).name)
            + _write_text(variant.env_header, Path(out_dir) / env_header_path(variant).name))

_loaded: Dict[str, ctypes.CDLL] = {}
# seconds from the start of a build until its nvcc finished, per library
# (variant_name) built in this process (0.0 when reused)
build_seconds: Dict[str, float] = {}
# nvcc's output (the ptxas resource report) per library built in this process
build_logs: Dict[str, str] = {}
# one lock per library file, held while a thread builds it
_locks: Dict[Path, threading.Lock] = {}
_locks_guard = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    candidates = [
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes, directly
    or through another header, in first-include order."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def variant_name(name: str, variant: Union[bool, Variant] = False) -> str:
    """The library's name: ``name``, ``name_ext`` for the extended build,
    ``name_u<hash12>`` for a user build, then ``_e<hash12>`` for a
    user-environment build, and ``_wide`` after any of them for its
    wide-state form."""
    return name + as_variant(variant).suffix


def _flags(variant: Variant) -> tuple:
    return NVCC_FLAGS + variant.flags


def library_path(name: str, variant: Union[bool, Variant] = False) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the file name hashes
    the source, the headers it includes, the flags and a user build's
    generated header, so editing any of them rebuilds it."""
    variant = as_variant(variant)
    h = hashlib.sha256(" ".join(_flags(variant)).encode())
    if variant.header:
        h.update(b"user_ops.h\0" + variant.header.encode())
    if variant.env_header:
        h.update(b"user_env.h\0" + variant.env_header.encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{variant_name(name, variant)}-{h.hexdigest()[:16]}.so"


def build(*names: str, variant: Union[bool, Variant] = False) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` (in ``variant``'s build: True for the
    extended one) unless a library of the same source exists; the ``nvcc``
    processes run in parallel, one per source. A thread that asks for a
    library another thread is building waits for that build.
    :data:`build_seconds` and :data:`build_logs` key each by
    :func:`variant_name`."""
    variant = as_variant(variant)
    outs = [library_path(name, variant) for name in names]
    with contextlib.ExitStack() as held:
        for out in sorted(set(outs)):
            with _locks_guard:
                lock = _locks.setdefault(out, threading.Lock())
            held.enter_context(lock)
        _build_missing(names, outs, variant)
    return outs


def _build_missing(names, outs, variant: Variant) -> None:
    todo = []
    for name, out in zip(names, outs):
        if out.exists():
            build_seconds.setdefault(variant_name(name, variant), 0.0)
        else:
            todo.append((name, out))
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    include = _write_header(variant, BUILD_DIR)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name, out in todo:
            tmp_out = Path(tmp) / out.name
            cmd = [nvcc, *_flags(variant), *include, "-o", str(tmp_out), str(CSRC_DIR / f"{name}.cu")]
            log = open(Path(tmp) / f"{name}.log", "w+")  # a file, so no pipe fills up
            jobs.append((name, out, tmp_out, cmd, log,
                         subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        failed, pending = [], jobs
        while pending:
            time.sleep(0.05)
            for name, out, tmp_out, cmd, log, proc in [j for j in pending if j[-1].poll() is not None]:
                key = variant_name(name, variant)
                build_seconds[key] = time.perf_counter() - t0
                log.seek(0)
                build_logs[key] = log.read()
                log.close()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{build_logs[key]}")
                else:
                    os.replace(tmp_out, out)  # atomic: a concurrent loader sees all or nothing
            pending = [j for j in pending if j[-1].returncode is None]
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str, variant: Union[bool, Variant] = False) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` in ``variant``'s build
    (True: the extended one); cached per process.

    Every library exports ``const char* mtgp_error_string(int)``."""
    key = variant_name(name, variant)
    if key not in _loaded:
        refuse_in_capture(f"loading {key}")
        lib = ctypes.CDLL(str(build(name, variant=variant)[0]))
        lib.mtgp_error_string.argtypes = [ctypes.c_int]
        lib.mtgp_error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
    return _loaded[key]


def refuse_in_capture(what: str) -> None:
    """Raise ``RuntimeError`` where ``what`` (a cache miss: a build, a load,
    a table copied from the host) would run inside a CUDA graph capture. The
    warm-up step before each capture fills every cache the captured step
    reads, so a miss there means the captured step differs from it."""
    import torch

    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} during a CUDA graph capture: the warm-up step missed it")


def build_host(name: str, out_dir: Path, variant: Union[bool, Variant] = False) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (in ``variant``'s build: True for the
    extended one; a user build's headers are written to ``out_dir``) for the
    host with the C++ compiler and load it. Without ``__CUDACC__`` the source
    builds its per-lane code into a plain lane loop (``<name>_host``), so
    tests can check the kernel's logic against its plain version where there
    is no card. Contraction is off (``-ffp-contract=off``) as on the card."""
    variant = as_variant(variant)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler found")
    out = Path(out_dir) / f"{variant_name(name, variant)}_host.so"
    include = _write_header(variant, out_dir)
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
           *variant.flags, *include, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {name}.cu failed:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaError_t``."""
    if status != 0:
        msg = lib.mtgp_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
