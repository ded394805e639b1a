"""The kernels' packed weights, made once per version of their sources.

Each kernel wrapper that launches a kernel on packed weights (``ops.rdb``,
``ops.conv3x3``, ``ops.deform_conv``) asks ``packed`` for them, naming its
packer: the wrapper alone knows its kernel's layout, and callers pass plain
parameters. An entry is keyed by the packer, its flags and the identity of
each source tensor, and holds the sources' ``(device, data_ptr, _version)``:
an optimizer's in-place step, a ``load_state_dict`` or a move to another
device repacks. The entry holds its sources by weak reference only and is
dropped when one of them is collected, so a freed model frees its packings
and a tensor at a recycled address never reads another's. Nothing is stored
on the tensors themselves: ``torch.save`` would pickle it with the weight.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Sequence

import torch

_lock = threading.Lock()
_entries: dict = {}  # (pack_fn, flags, ids of the sources) -> _Entry


class _Entry:
    __slots__ = ("refs", "stamps", "value")

    def __init__(self, tensors):
        self.refs = tuple(weakref.ref(t) for t in tensors)
        self.stamps = None
        self.value = None


def _leaves(sources) -> list:
    """The tensors of ``sources``: tensors or (nested) sequences of them."""
    out = []
    for s in sources:
        if isinstance(s, torch.Tensor):
            out.append(s)
        else:
            out.extend(_leaves(s))
    return out


def packed(pack_fn: Callable, sources: Sequence, *flags):
    """``pack_fn(*sources, *flags)``, made under ``torch.no_grad()`` (packed
    weights carry no gradient: the kernels' backward goes to the sources)
    and cached until a source tensor changes. ``sources`` are the packer's
    tensor arguments (tensors, or sequences of them, as the packer takes
    them); ``flags`` (hashable: ``mxu_bf16``) are part of the key, as the
    packer is, so two layouts of the same weights never alias. Threads that
    ask together for a packing not yet made (a server's first requests)
    pack it once."""
    tensors = _leaves(sources)
    key = (pack_fn, flags, tuple(map(id, tensors)))
    stamps = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
    with _lock:
        entry = _entries.get(key)
        if entry is None or any(r() is not t for r, t in zip(entry.refs, tensors)):
            entry = _entries[key] = _Entry(tensors)
            for t in tensors:
                weakref.finalize(t, _entries.pop, key, None)
        if entry.stamps != stamps:
            with torch.no_grad():
                entry.value = pack_fn(*sources, *flags)
            entry.stamps = stamps
        return entry.value
