"""Import the JAX package's framework-free modules without importing JAX.

The port shares `rcmvsnet_tpu.core.io`, `rcmvsnet_tpu.data.*` and
`rcmvsnet_tpu.fusion.*` (numpy / cv2 / scipy only) instead of forking them.
But `rcmvsnet_tpu/core/__init__.py` runs `from . import io, geometry`, and
`core/geometry.py` imports jax, so a plain `import rcmvsnet_tpu.core.io` —
or `rcmvsnet_tpu.data.dtu_test`, which imports it — pulls JAX in.

`import_shared` first registers `rcmvsnet_tpu.core` as a lazy package: the
same directory, its submodules imported on first use (`core.io` alone for
the port; `core.geometry` still resolves for JAX code in the same process).
If the real package is already loaded, it is left as it is.
"""
from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import sys
from pathlib import Path
from types import ModuleType


def _register_lazy_core() -> None:
    name = "rcmvsnet_tpu.core"
    if name in sys.modules:
        return
    import rcmvsnet_tpu          # its __init__ imports nothing
    path = Path(rcmvsnet_tpu.__file__).resolve().parent / "core"
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [str(path)]
    core = importlib.util.module_from_spec(spec)

    def __getattr__(attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        try:
            return importlib.import_module(f"{name}.{attr}")
        except ModuleNotFoundError as e:
            raise AttributeError(f"module {name!r} has no attribute "
                                 f"{attr!r}") from e

    core.__getattr__ = __getattr__
    sys.modules[name] = core
    rcmvsnet_tpu.core = core


def import_shared(module: str) -> ModuleType:
    """`importlib.import_module` for a framework-free module of
    rcmvsnet_tpu (e.g. "rcmvsnet_tpu.data.dtu_test"), without JAX."""
    _register_lazy_core()
    return importlib.import_module(module)
