"""The names of the program's own CUDA kernels, read from its built
libraries, and the kernel names of a profiler trace in the same form.

A library built by ``nvcc`` holds each ``__global__`` function's mangled
name (its host stub and the name it registers with the runtime).  The
qualified name is taken from it, the anonymous namespace dropped:
``_ZN4flyp27attention_fwd_stream_kernelILb1ELb1EEEvNS_8AttnArgsE`` gives
``flyp::attention_fwd_stream_kernel``, which is also what
:func:`trace_name` makes of the profiler's ``void
flyp::attention_fwd_stream_kernel<true, true>(flyp::AttnArgs)``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Set

_MANGLED = re.compile(rb"_Z[0-9A-Za-z_]{4,}")
_ANON = "_GLOBAL__N_1"


def demangle_qualified(mangled: str) -> Optional[str]:
    """The qualified name of a mangled function name, without template
    arguments and parameters; None where it is not a plain or nested name."""
    if not mangled.startswith("_Z"):
        return None
    s, i = mangled, 2
    nested = i < len(s) and s[i] == "N"
    if nested:
        i += 1
        while i < len(s) and s[i] in "KVr":
            i += 1
    parts = []
    while i < len(s) and s[i].isdigit():
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        n = int(s[i:j])
        if j + n > len(s):
            return None
        parts.append(s[j:j + n])
        i = j + n
        if not nested:
            break
    parts = [p for p in parts if p != _ANON]
    return "::".join(parts) if parts else None


def library_kernels(path: Path) -> Set[str]:
    """Qualified names of the functions a built library names."""
    names = set()
    for m in _MANGLED.finditer(Path(path).read_bytes()):
        q = demangle_qualified(m.group().decode())
        if q:
            names.add(q)
    return names


def trace_name(name: str) -> str:
    """A profiler kernel name in the form of :func:`demangle_qualified`."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def program_kernels() -> dict:
    """{source: qualified names} of the program's current builds (the
    libraries of ``flyp_tpu_torch/ops/_kernels.py`` that match today's
    sources)."""
    from flyp_tpu_torch.ops import _kernels

    out = {}
    for name in sorted(p.stem for p in _kernels.CSRC_DIR.glob("*.cu")):
        lib = _kernels.library_path(name)
        if not lib.exists():
            raise FileNotFoundError(f"the program's library {lib} is not built")
        out[name] = library_kernels(lib)
    return out
