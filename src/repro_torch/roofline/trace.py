"""The per-device counter: one rank's work, read from the ops it runs
(counterpart of what ``compiled.cost_analysis()``, ``memory_analysis()`` and
``hlo_parse.py`` read from XLA's per-device program).

:class:`DeviceCounter` is a ``TorchDispatchMode``. It returns
``NotImplemented`` for a DTensor, so DTensor's own dispatch runs and the
counter sees the local ops DTensor issues on the rank's blocks, which are
the device's work; the ops DTensor's sharding propagator runs on the
global shapes, only to learn their output metadata, are not counted (they
run inside ``ShardingPropagator._propagate_tensor_meta_non_cached``,
which :meth:`DeviceCounter.__enter__` wraps), nor is the arithmetic of a
shard's offset, which DTensor does with tensor ops (run on real integers
even under a fake mode). It runs alike on fake tensors
(the dry run, nothing on a device) and on real ones (a step on the card,
counted the same way).

What it records, per rank:

* **flops**: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, PyTorch's attention) and the formulas the port's kernels
  register (:mod:`repro_torch.kernels.counts`: B4-B6b). Element-wise work
  is not counted, as ``FlopCounterMode`` counts none; XLA's
  ``cost_analysis`` counts it too, so the two packages' FLOPs differ by
  convention.
* **bytes accessed**: each op's inputs read once and outputs written once,
  XLA's unfused "bytes accessed". An input broadcast with stride 0 counts
  its distinct elements. Views, empty allocations and collectives move no
  bytes here (the collectives' traffic is the wire term).
* **collectives**: each ``_c10d_functional`` collective as (kind, result
  bytes, group size), the input of
  :func:`repro_torch.roofline.collectives.collective_wire_bytes`.
* **memory**: the bytes of live local storage, each storage rounded up to
  the CUDA caching allocator's 512-byte blocks, from the arguments
  registered with :meth:`DeviceCounter.hold` on; a storage counts from the
  op that makes it to its release (a weak reference). ``peak_bytes`` is
  its high-water mark.

Calls go by op name under ``ops``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

#: The CUDA caching allocator hands out blocks in multiples of 512 bytes.
BLOCK = 512

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "wait_tensor", "set_", "resize_",
               "record_stream"}

_uncounted = [0]  # > 0 while DTensor runs ops for its own metadata


def _round(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


def distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a dimension broadcast with
    stride 0 counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _local(x):
    return x._local_tensor if isinstance(x, DTensor) else x


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's local work while it is entered (the module's
    docstring says what)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int, int]] = []
        self.ops = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        self._stack = contextlib.ExitStack()

    # -- memory ---------------------------------------------------------------

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        nbytes = _round(st.nbytes())
        self._seen[st] = nbytes
        weakref.finalize(st, self._free, nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        blocks) as live from now on, as a step's arguments are; returns
        their bytes, each storage once."""
        before = self.live_bytes
        for leaf in tree_flatten(tree)[0]:
            self._track(_local(leaf))
        return self.live_bytes - before

    # -- the mode -------------------------------------------------------------

    def __enter__(self):
        # DTensor's own metadata work runs uncounted: the sharding
        # propagator's run of each new op on global fake arguments, and a
        # shard's size and offset (a strided shard's too), computed with
        # tensor ops and read back to the host, so on real integers
        from torch.distributed.tensor import _utils
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
        for owner, name, on_host in (
                (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                 False),
                (_utils, "_compute_local_shape_and_global_offset", True),
                (_StridedShard, "local_shard_size_and_offset", True),
                (_StridedShard, "_local_shard_size_and_offset", True)):
            method = owner.__dict__.get(name)
            if isinstance(method, staticmethod):
                method = staticmethod(_uncounted_call(method.__func__,
                                                      on_host))
            elif callable(method):
                method = _uncounted_call(method, on_host)
            else:  # not in this release
                continue
            self._stack.enter_context(patched(owner, name, method))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _uncounted[0] or func.namespace == "prim":
            return out
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        self.ops[f"{ns}.{name}"] += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if ns in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
            self.collectives.append(
                (_COLLECTIVES[name], sum(t.nbytes for t in outs),
                 _group_size(kwargs.get("group_name", args[-1]))))
        elif ns in ("aten", "repro_torch") and not func.is_view \
                and name not in _NO_TRAFFIC:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(distinct_bytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _uncounted_call(fn, on_host: bool):
    """``fn`` run uncounted, and with ``on_host`` outside any fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _uncounted[0] += 1
        try:
            with (unset_fake_temporarily() if on_host
                  else contextlib.nullcontext()):
                return fn(*args, **kwargs)
        finally:
            _uncounted[0] -= 1
    return wrapped


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` set to ``value`` for the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def kernel_ops(counter: DeviceCounter) -> dict:
    """The port's kernel ops (``repro_torch.*``) the counter saw, calls by
    op name."""
    return {k.split(".", 1)[1]: v for k, v in sorted(counter.ops.items())
            if k.startswith("repro_torch.")}


__all__ = ["DeviceCounter", "distinct_bytes", "kernel_ops", "BLOCK"]
