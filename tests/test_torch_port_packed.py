"""PyTorch port: the kernels' packed-weight cache (``ops/_packed.py``).

A counting stand-in packer shows when ``packed`` packs: once per version of
its sources, an entry per packer and flags, an entry that goes with its
source tensor, and a new tensor that never reads a freed one's packing. The
cache's lock and its gradient are tested beside the server
(``test_torch_port_serve.py``) and the kernels' autograd
(``test_torch_port_autograd.py``)."""

import gc

import pytest
import torch

from deepbedmap_tpu_torch.ops import _packed

calls = []


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, as every port test file
    takes it: the suite runs files in parallel worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pack_twice(w, flag=False):
    calls.append(("twice", flag))
    return w * 2 + flag


def pack_neg(w, flag=False):
    calls.append(("neg", flag))
    return -w


def _entries_of(t):
    return [k for k in _packed._entries if id(t) in k[2]]


def in_place_update():
    w = torch.ones(4)
    first = _packed.packed(pack_twice, [w])
    assert _packed.packed(pack_twice, [w]) is first and len(calls) == 1
    w.add_(1.0)  # bumps _version, as an optimizer's step does
    second = _packed.packed(pack_twice, [w])
    assert len(calls) == 2 and torch.equal(second, torch.full((4,), 4.0))


def flags_and_layouts():
    w = torch.ones(4)
    got = {(fn, flag): _packed.packed(fn, [w], flag)
           for fn in (pack_twice, pack_neg) for flag in (False, True)}
    again = {(fn, flag): _packed.packed(fn, [w], flag)
             for fn in (pack_twice, pack_neg) for flag in (False, True)}
    assert len(calls) == 4 and len(_entries_of(w)) == 4
    assert all(again[k] is got[k] for k in got)
    assert torch.equal(got[pack_twice, True], torch.full((4,), 3.0))
    assert torch.equal(got[pack_neg, False], -w)


def freed_with_source():
    w = torch.ones(4)
    value = _packed.packed(pack_twice, [w])
    assert len(_entries_of(w)) == 1
    key = _entries_of(w)[0]
    del w, value
    gc.collect()
    assert key not in _packed._entries


def new_tensor_at_freed_address():
    w = torch.zeros(1024)
    _packed.packed(pack_twice, [w])
    del w
    gc.collect()
    fresh = torch.ones(1024)  # the same size: it may take w's memory and id
    assert torch.equal(_packed.packed(pack_twice, [fresh]), torch.full((1024,), 2.0))
    assert len(calls) == 2
    view = fresh.detach()  # the same address and version counter, another tensor
    assert _packed.packed(pack_twice, [view]) is not _packed.packed(pack_twice, [fresh])
    assert len(calls) == 3


@pytest.mark.parametrize("case", [in_place_update, flags_and_layouts, freed_with_source,
                                  new_tensor_at_freed_address], ids=lambda f: f.__name__)
def test_packed_cache(case):
    calls.clear()
    case()
