"""Build and load the repo's native C++ libraries (``native/*.cpp``).

Each library is compiled with g++ into ``<repo>/build/native/`` on first
use and rebuilt whenever its source is newer than the built file.  The
compiler writes to a temporary name in that directory, which is then
renamed into place, so no process ever loads a library that another one
is still writing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Sequence

__all__ = ["BUILD_DIR", "load_native"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")


def load_native(src_name: str, lib_name: str,
                extra_flags: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """Load ``BUILD_DIR/lib_name``, (re)building it from
    ``native/src_name`` when it is missing or older than the source.
    Returns None when the source is absent or g++ cannot build it, so the
    caller's NumPy implementation takes over."""
    src = os.path.join(REPO_ROOT, "native", src_name)
    if not os.path.exists(src):
        return None
    out = os.path.join(BUILD_DIR, lib_name)
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=lib_name + ".", suffix=".tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-std=c++17", "-O3", "-march=native", *extra_flags,
               "-shared", "-fPIC", src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        return ctypes.CDLL(out)
    except OSError:
        return None
