"""The pool of page-locked output buffers behind ``carver._host_array``.

The pool's allocate and release functions are swapped for plain numpy
memory, so its bookkeeping runs without a card: which buffer an array is
handed out over, when a buffer serves again, the budget of
``PINNED_SHARE`` of the host's memory, and the three counters on
``_host_array``. The copy into a buffer is the card's; here the test
writes the values, as the copy would."""

import mmap

import numpy as np
import pytest
import torch

from vacancy_tpu_torch import carver as carver_mod

SHAPE = (3, 64, 32)
OTHER = (6, 32, 32)  # as many bytes, another shape
NBYTES = -(-4 * int(np.prod(SHAPE)) // mmap.PAGESIZE) * mmap.PAGESIZE


class _Numpy:
    """Plain numpy memory in place of page-locked memory; records what it
    allocates and releases."""

    def __init__(self):
        self.live = {}  # address -> bytes

    def pin(self, nbytes):
        owner = np.empty(nbytes, np.uint8)
        self.live[owner.ctypes.data] = nbytes
        return owner, owner.ctypes.data

    def unpin(self, owner, address):
        assert self.live.pop(address) == owner.nbytes


@pytest.fixture
def memory(monkeypatch):
    """A fresh pool over plain numpy memory as ``carver._POOL``, zeroed
    counters, and a host whose budget holds four buffers of ``SHAPE``."""
    mem = _Numpy()
    monkeypatch.setattr(carver_mod, "_POOL",
                        carver_mod._PinnedPool(mem.pin, mem.unpin))
    for name in ("pinned", "staged", "pinned_bytes"):
        monkeypatch.setattr(carver_mod._host_array, name, 0)
    budget_buffers(monkeypatch, 4)
    return mem


def budget_buffers(monkeypatch, n):
    """Physical memory such that ``PINNED_SHARE`` of it is ``n`` buffers."""
    monkeypatch.setattr(carver_mod, "_physical_bytes",
                        lambda: round(n * NBYTES / carver_mod.PINNED_SHARE))


def host_array(values):
    """What ``_host_array`` does with a CUDA tensor of ``values``, the copy
    done on the host: an array from the pool with the values in it, or
    None where the call would be staged."""
    out = carver_mod._POOL.take(values.shape, values.dtype)
    if out is not None:
        out[...] = values
    return out


def values(k, shape=SHAPE):
    return np.full(shape, k, np.float32) + np.arange(
        np.prod(shape), dtype=np.float32).reshape(shape)


def test_released_array_buffer_is_handed_out_again(memory):
    a = host_array(values(1))
    first = a.ctypes.data
    assert a.shape == SHAPE and a.dtype == np.float32
    assert np.array_equal(a, values(1))
    del a
    b = host_array(values(2))
    assert b.ctypes.data == first
    assert np.array_equal(b, values(2))
    assert list(memory.live) == [first]
    assert carver_mod._host_array.pinned == 2
    assert carver_mod._host_array.staged == 0


KEEPS = {
    "whole": lambda a: a,
    "view": lambda a: a[1:],
    "asarray": np.asarray,
    "tensor": torch.from_numpy,
}


@pytest.mark.parametrize("keep", list(KEEPS))
def test_kept_array_is_never_overwritten(memory, keep):
    """A result the caller keeps, whole or through a view or a tensor over
    it, is never handed out again: later calls with other values leave it
    as it was."""
    kept = KEEPS[keep](host_array(values(1)))
    kept_at = kept.data_ptr() if isinstance(kept, torch.Tensor) \
        else kept.ctypes.data
    seen = set()
    for k in range(2, 6):
        later = host_array(values(k))
        assert np.array_equal(later, values(k))
        seen.add(later.ctypes.data)
        del later  # freed at once: the next call takes its buffer again
    want = values(1)[1:] if keep == "view" else values(1)
    assert np.array_equal(np.asarray(kept), want)
    assert len(seen) == 1
    assert not any(lo <= kept_at < lo + NBYTES for lo in seen)
    assert carver_mod._host_array.pinned_bytes == 2 * NBYTES


def test_budget_of_two_buffers_sends_the_third_call_to_the_staged_path(
        memory, monkeypatch):
    budget_buffers(monkeypatch, 2)
    a = host_array(values(1))
    b = host_array(values(2))
    assert host_array(values(3)) is None
    assert carver_mod._host_array.staged == 1
    assert carver_mod._host_array.pinned == 2
    assert carver_mod._host_array.pinned_bytes == 2 * NBYTES
    assert np.array_equal(a, values(1)) and np.array_equal(b, values(2))
    del b  # room again, in the buffer b held
    c = host_array(values(4))
    assert c is not None and carver_mod._host_array.staged == 1
    assert len(memory.live) == 2


def test_free_buffer_of_another_shape_is_freed_to_make_room(memory,
                                                            monkeypatch):
    budget_buffers(monkeypatch, 2)
    kept = host_array(values(1))
    other = host_array(values(7, OTHER))
    other_at = other.ctypes.data
    del other
    a = host_array(values(2))
    assert a is not None and carver_mod._host_array.staged == 0
    assert other_at not in memory.live  # unpinned and released
    assert sorted(memory.live) == sorted([kept.ctypes.data, a.ctypes.data])
    assert carver_mod._host_array.pinned_bytes == 2 * NBYTES
    assert np.array_equal(kept, values(1))


def test_kept_buffer_of_another_shape_is_not_freed(memory, monkeypatch):
    budget_buffers(monkeypatch, 2)
    kept = host_array(values(1))
    other = host_array(values(7, OTHER))
    assert host_array(values(2)) is None
    assert carver_mod._host_array.staged == 1
    assert len(memory.live) == 2
    assert np.array_equal(kept, values(1))
    assert np.array_equal(other, values(7, OTHER))


def test_array_larger_than_the_budget_is_staged_and_frees_nothing(
        memory, monkeypatch):
    other = host_array(values(7, OTHER))
    del other  # a free buffer the call could free, and will not
    budget_buffers(monkeypatch, 0.5)
    assert host_array(values(2)) is None
    assert carver_mod._host_array.staged == 1
    assert carver_mod._host_array.pinned_bytes == NBYTES
    assert len(memory.live) == 1


def test_memory_the_host_will_not_lock_is_staged(memory, monkeypatch):
    def refuse(nbytes):
        raise RuntimeError("cudaErrorMemoryAllocation")

    monkeypatch.setattr(carver_mod._POOL, "pin", refuse)
    assert host_array(values(1)) is None
    assert carver_mod._host_array.staged == 1
    assert carver_mod._host_array.pinned_bytes == 0


def test_pinned_bytes_follows_allocation_and_release(memory, monkeypatch):
    count = carver_mod._host_array
    a = host_array(values(1))
    assert count.pinned_bytes == NBYTES
    b = host_array(values(2, OTHER))
    assert count.pinned_bytes == 2 * NBYTES
    c = host_array(np.zeros(5, np.uint8))  # rounded up to one page
    assert count.pinned_bytes == 2 * NBYTES + mmap.PAGESIZE
    del a, b
    assert count.pinned_bytes == 2 * NBYTES + mmap.PAGESIZE  # kept pinned
    budget_buffers(monkeypatch, 1 + mmap.PAGESIZE / NBYTES)
    d = host_array(values(3, (2, 2)))  # frees the buffers a, then b held
    assert count.pinned_bytes == 2 * mmap.PAGESIZE
    assert sum(memory.live.values()) == count.pinned_bytes
    del c, d
    budget_buffers(monkeypatch, mmap.PAGESIZE / NBYTES)
    e = host_array(values(4, (3, 3)))  # frees the buffers c, then d held
    assert count.pinned_bytes == mmap.PAGESIZE
    assert list(memory.live) == [e.ctypes.data]
    assert count.pinned == 5 and count.staged == 0
