"""Where the port puts the libraries it compiles at first use.

In a checkout (or any install whose package directory can be written) that
is `ignnition_tpu_torch/_build/`, listed in .gitignore. An installed package
usually lies in a directory the user cannot write: then the libraries go to
a per-user cache directory, `$XDG_CACHE_HOME/ignnition_tpu_torch` or
`~/.cache/ignnition_tpu_torch`. Library names hash their sources, so one
cache serves several installs.
"""

from __future__ import annotations

import os
from pathlib import Path


def _writable(path: Path) -> bool:
    return os.access(path, os.W_OK | os.X_OK)


def build_dir(package_dir: Path) -> Path:
    """`package_dir/_build` where it can be written (or made), else the
    per-user cache directory."""
    local = package_dir / "_build"
    if _writable(local) if local.is_dir() else _writable(package_dir):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "ignnition_tpu_torch"
