"""Optional-dependency probing (the PyTorch port's own copy of
``runia_core_tpu/import_helper_functions.py``).

Behavioral parity with reference ``runia_core/import_helper_functions.py:5-73``
(raise/warn/ignore policy, module-or-None return), implemented as a
``find_spec`` existence check followed by a single import pass.
"""

from __future__ import annotations

import importlib
import importlib.util
import types
import warnings
from typing import Optional, Tuple, Union

__all__ = ["module_exists"]

# Modules we already warned about (warn-once semantics unless warn_every_time).
_ALREADY_WARNED: set = set()


def _is_importable(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, AttributeError, ValueError):
        # find_spec raises for dotted names whose parent package is missing.
        return False


def module_exists(
    *names: str,
    error: str = "ignore",
    warn_every_time: bool = False,
) -> Optional[Union[types.ModuleType, Tuple[types.ModuleType, ...]]]:
    """Probe optional dependencies and import them if all are present.

    Returns the imported module (a tuple when several names are given), or
    ``None`` when any is missing. The ``error`` policy controls what happens
    for missing modules: ``"raise"`` raises ImportError, ``"warn"`` emits one
    warning per module (once per process unless ``warn_every_time``), and
    ``"ignore"`` stays silent.
    """
    if error not in ("raise", "warn", "ignore"):
        raise ValueError(f"error policy must be 'raise', 'warn' or 'ignore', got {error!r}")

    missing = [n for n in names if not _is_importable(n)]
    if missing:
        joined = ", ".join(repr(n) for n in missing)
        plural = "modules" if len(missing) > 1 else "module"
        message = f"Optional {plural} {joined} not installed; install to enable this feature."
        if error == "raise":
            raise ImportError(message)
        if error == "warn":
            for name in missing:
                if warn_every_time or name not in _ALREADY_WARNED:
                    warnings.warn(
                        f"Optional module {name!r} not installed; "
                        "install to enable this feature.",
                        stacklevel=2,
                    )
                    _ALREADY_WARNED.add(name)
        return None

    modules = tuple(importlib.import_module(n) for n in names)
    return modules[0] if len(modules) == 1 else modules
