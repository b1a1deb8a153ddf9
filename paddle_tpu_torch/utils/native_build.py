"""The shared native-library build step (the counterpart of
``paddle_tpu/utils/native_build.py``).

A library is compiled to a file private to this process and then renamed
onto its final path, so a process that loads the library at the same time
(a DataLoader worker, a second interpreter) never opens a half-written
``.so``.  The C ABI shim (``inference/capi.py``) and the native tokenizer
(``text/fast_tokenizer.py``) build through it."""
from __future__ import annotations

import os
import subprocess
from typing import Sequence

__all__ = ["build_shared_lib"]


def build_shared_lib(cmd_prefix: Sequence[str], sources: Sequence[str],
                     so_path: str, verbose: bool = False,
                     what: str = "native build",
                     link_flags: Sequence[str] = ()) -> str:
    """Run ``cmd_prefix + sources + ['-o', <tmp>] + link_flags`` and
    rename the result onto ``so_path``.  Raises RuntimeError with the
    compiler's output when it fails."""
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = list(cmd_prefix) + list(sources) + ["-o", tmp_path] \
        + list(link_flags)
    if verbose:
        print(f"{what}:", " ".join(cmd))
    d = os.path.dirname(so_path)
    if d:
        os.makedirs(d, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise RuntimeError(f"{what}: compiler failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp_path, so_path)
    return so_path
