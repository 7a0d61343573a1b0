"""The reference's backbones, one module a value of the configuration's
`backbone` key: `<backbone>.py` in this directory. A new backbone is a new
file here; nothing else of the benchmark names one. Each module provides

- `build(c)`: a module of the reference's own `Linear` and `Conv2d` (so
  that the control's `qdtype` reaches it) that maps (B, C, S, S) images to
  the three feature maps at strides 8, 16 and 32, its parameter names
  those of the program's backbone;
- `channels(c)`: the channels of those three maps;
- `flops(c)`: one image's FLOPs through it, by `counts.py`'s rules;
- optionally `init(name, z, init)`: the benchmark's weight of the
  backbone parameter `name` (its name inside the backbone) from `z`, its
  slice of the seeded normal draw, and the configuration's `assumed`
  init values; None leaves it to `common.make_weights`' generic rules.

`c` is the configuration's `cape` dict.
"""

from __future__ import annotations

import importlib
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))


def module(name: str) -> ModuleType:
    """The backbone `name`, imported once a process."""
    path = os.path.join(HERE, f"{name}.py")
    if not (name.isidentifier() and os.path.isfile(path)):
        raise SystemExit(f"no backbone {name!r}: no file {path}")
    return importlib.import_module(f"{__name__}.{name}")
