"""``TupleModule``: an ``nn.Module`` that holds NamedTuples of parameters.

Each floating-point tensor field becomes a buffer named ``<prefix>_<field>``,
so ``.to(device)`` moves them together; every other field (ints, names,
host index tensors, Python settings) is kept as it is.  ``held(prefix)``
rebuilds the NamedTuple from the current buffers.
"""
from __future__ import annotations

import torch
from torch import nn


class TupleModule(nn.Module):
    def __init__(self):
        super().__init__()
        self._static = {}

    def hold(self, prefix: str, tup) -> None:
        static = {}
        for name, val in tup._asdict().items():
            if torch.is_tensor(val) and val.is_floating_point():
                self.register_buffer(f"{prefix}_{name}", val)
            else:
                static[name] = val
        self._static[prefix] = (type(tup), static)

    def held(self, prefix: str):
        cls, static = self._static[prefix]
        return cls(**{name: static[name] if name in static else getattr(self, f"{prefix}_{name}")
                      for name in cls._fields})
