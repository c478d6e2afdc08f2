"""CUDA graphs: the port's counterpart of the JAX package's compiled programs.

The JAX package runs a path as one jitted program (``llm/generate.py``'s
``lax.scan`` decode, ``inference/image_level.py``'s scorer); eager PyTorch
enqueues each of its hundreds of kernels from the host, which leaves the card
idle between them. :class:`CudaGraph` records one program's kernels into a
CUDA graph once and replays the graph, one host call for all of them:

* the program reads and writes **static buffers**, tensors allocated before
  capture whose addresses the graph keeps: its own inputs (``inputs``,
  copied in by :meth:`CudaGraph.load`), its outputs (``outputs``, which a
  later replay overwrites: copy what you keep) and any state the caller's
  function closes over;
* it is **warmed up** on the capture stream before capture, so that cuDNN
  and cuBLAS plans, the kernel library's build and first-use allocations
  (``ops/quant_matmul.py``'s workspace, which a graph owns, see
  :func:`current_graph`) happen outside it; the random draws of the warm-up
  are taken back;
* every graph allocates from **one memory pool** per device
  (``torch.cuda.graph_pool_handle()``), shared by all of the port's live
  graphs: they replay one after another on one stream and keep nothing they
  return in the pool. When the last of them goes, so does the pool, and the
  next capture opens a new one;
* the ``torch.Generator`` objects ``fn`` draws from are **registered** with
  the graph, so every replay draws what the same calls would draw eagerly
  from the generator's state and advances it. A program owns its
  generators; :func:`drawing_from` lends one a caller's state for a call;
* **launch counts**: a kernel wrapper counts its launches with
  :func:`count_launch` where it enqueues them. Under capture nothing
  launches, so the count goes to the graph being captured, and each replay
  adds it.

A capture that fails raises; nothing falls back to running eagerly. Captures
use the thread-local error mode: a synchronising or otherwise unsafe call of
the capturing thread still fails the capture, while other threads (the
submitters of ``llm/service.py``) stay free to use the card.

:func:`host_sync` marks the one place an entry point waits for the card, the
copy of its results to the host: under
``torch.cuda.set_sync_debug_mode("error")`` any other synchronising call of
the port raises.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "CudaGraph", "ProgramCache", "copy_to_host", "count_launch", "current_graph", "drawing_from", "host_sync", "upload",
]

_shared = {}  # device index -> _SharedPool
_retired = []  # pools, streams and graphs of failed captures: the allocators may still refer to them
_active = threading.local()  # .graph: the CudaGraph being warmed up or captured on this thread


class _SharedPool:
    """The memory pool the live graphs of the port on one device share, and
    the stream they are warmed up and captured on. PyTorch's allocators drop
    a pool when the last graph in it goes, and a later capture into that
    pool's handle fails: :meth:`handle` opens a new pool once no graph of
    the old one is alive."""

    def __init__(self, index: int):
        with torch.cuda.device(index):
            self.stream = torch.cuda.Stream()
        self.graphs = weakref.WeakSet()
        self._handle = None

    def handle(self):
        if not self.graphs:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def current_graph() -> Optional["CudaGraph"]:
    """The :class:`CudaGraph` being warmed up or captured, or None. A kernel
    wrapper that needs scratch memory keeps it in that graph's
    ``workspaces``: allocated during the warm-up, owned by the graph, and
    never shared with eager calls or other graphs."""
    return getattr(_active, "graph", None)


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>``, a kernel wrapper's launch count, where
    it enqueues its kernel. Under a stream capture the kernel only joins a
    graph: the launch goes to the :class:`CudaGraph` being captured, whose
    every replay adds it, and a capture made outside :class:`CudaGraph`
    counts nothing."""
    if torch.cuda.is_current_stream_capturing():
        graph = current_graph()
        if graph is not None:
            graph.launches[(wrapper, attr)] = graph.launches.get((wrapper, attr), 0) + 1
        return
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


@contextlib.contextmanager
def drawing_from(own: torch.Generator, source: torch.Generator):
    """Inside the block, draws from ``own`` (a program's generator, which
    its graph registered) take ``source``'s place: ``source``'s state is
    copied into ``own`` first, and ``own``'s, advanced past the draws, back
    into ``source`` after. A program thus draws what an eager call would
    draw from the caller's generator, whatever generator object it is."""
    own.set_state(source.get_state())
    try:
        yield
    finally:
        source.set_state(own.get_state())


class CudaGraph:
    """``fn(**inputs)`` captured into a CUDA graph on ``device``.

    ``inputs`` are example tensors: the graph keeps copies of them as its
    static inputs, and ``fn`` is called with those. What ``fn`` returns (a
    tensor, a tuple of tensors or None) is copied into static outputs at the
    end of every replay. ``generators`` are the ``torch.Generator`` objects
    ``fn`` draws from (PyTorch's default CUDA generator is registered by the
    capture itself). ``warmup`` eager calls precede the capture.
    ``CudaGraph.captures`` counts the captures made in this process.
    """

    captures = 0

    def __init__(
        self,
        fn: Callable,
        inputs: Optional[Mapping[str, torch.Tensor]] = None,
        generators: Sequence[torch.Generator] = (),
        device=None,
        warmup: int = 2,
    ):
        device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CudaGraph captures CUDA work; got device {device}")
        if warmup < 1:
            raise ValueError("CudaGraph needs at least one warm-up call")
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.device = torch.device("cuda", index)
        self.inputs = {name: t.clone() for name, t in (inputs or {}).items()}
        self.generators = tuple(generators)
        self.workspaces = {}
        self.launches = {}  # (wrapper, attribute) -> kernels a replay launches
        self.graph = torch.cuda.CUDAGraph()
        if index not in _shared:
            _shared[index] = _SharedPool(index)
        pool = _shared[index]
        from runia_core_tpu_torch.utils.profiling import span  # profiling imports this module, through timing

        with span("runia.graph.capture"):
            self._capture_into(pool, index, fn, warmup)
        pool.graphs.add(self)
        CudaGraph.captures += 1
        self.replays = 0

    def _capture_into(self, pool: "_SharedPool", index: int, fn: Callable, warmup: int) -> None:
        """The warm-up calls on ``pool``'s capture stream, then the capture
        of ``fn`` into ``self.graph`` in ``pool``."""
        stream = pool.stream
        _active.graph = self
        try:
            # Warm-up on the capture stream, its random draws taken back.
            default = torch.cuda.default_generators[index]
            states = [(g, g.get_state()) for g in self.generators + (default,)]
            stream.wait_stream(torch.cuda.current_stream(index))
            with torch.cuda.stream(stream):
                for _ in range(warmup):
                    example = fn(**self.inputs)
            torch.cuda.current_stream(index).wait_stream(stream)
            for g, state in states:
                g.set_state(state)
            # Static outputs live outside the pool, for the graph's life.
            self.outputs = tuple(torch.empty_like(t) for t in self._as_tuple(example))

            for g in self.generators:
                if g is not default:  # the capture registers the default generator itself
                    self.graph.register_generator_state(g)
            with torch.cuda.stream(stream):
                # Thread-local: only this thread's unsafe calls are checked, so
                # a serving worker's capture survives CUDA work on other threads.
                self.graph.capture_begin(pool=pool.handle(), capture_error_mode="thread_local")
                try:
                    captured = self._as_tuple(fn(**self.inputs))
                    if len(captured) != len(self.outputs):
                        raise RuntimeError("CudaGraph: fn returned another number of tensors than in its warm-up")
                    for dst, src in zip(self.outputs, captured):
                        dst.copy_(src)
                    self.graph.capture_end()
                except BaseException:
                    # A failed capture leaves the allocators recording into
                    # the pool for this graph: retire both, later graphs
                    # take a new pool and stream.
                    with contextlib.suppress(RuntimeError):
                        self.graph.capture_end()
                    _retired.append((_shared.pop(index), self.graph))
                    raise
            torch.cuda.current_stream(index).wait_stream(stream)
        finally:
            _active.graph = None

    @staticmethod
    def _as_tuple(result) -> tuple:
        if result is None:
            return ()
        return tuple(result) if isinstance(result, (tuple, list)) else (result,)

    def load(self, **tensors: torch.Tensor) -> None:
        """Copy new values into the static inputs of those names."""
        for name, t in tensors.items():
            self.inputs[name].copy_(t)

    def replay(self) -> tuple:
        """Run the graph on the current stream; returns the static outputs."""
        self.graph.replay()
        self.replays += 1
        for (fn_, attr), n in self.launches.items():
            setattr(fn_, attr, getattr(fn_, attr) + n)
        return self.outputs


class ProgramCache:
    """A bounded LRU of built programs (graphs and what owns them): the
    least recently used go past ``maxsize`` entries, or while the entries'
    device buffers (a program's ``nbytes``) add up to more than
    ``max_bytes``; the newest entry always stays. A caller that still holds
    a dropped program keeps it working.

    A new program whose graph read prepared parameters (a ResNet's,
    ``models/resnet.py::_prepared``) drops the programs that read another
    copy of the same parameters: the weights were edited between the two
    captures, and one cache never serves both versions."""

    def __init__(self, maxsize: int, max_bytes: Optional[int] = None):
        self.maxsize = maxsize
        self.max_bytes = max_bytes
        self.entries: "OrderedDict[Hashable, object]" = OrderedDict()

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key) -> bool:
        return key in self.entries

    @property
    def nbytes(self) -> int:
        return sum(getattr(program, "nbytes", 0) for program in self.entries.values())

    def get(self, key):
        program = self.entries.get(key)
        if program is not None:
            self.entries.move_to_end(key)
        return program

    def put(self, key, program) -> None:
        self.entries[key] = program
        self.entries.move_to_end(key)
        while len(self.entries) > self.maxsize or (
            self.max_bytes is not None and len(self.entries) > 1 and self.nbytes > self.max_bytes
        ):
            self.entries.popitem(last=False)

    def get_or_build(self, key, build: Callable[[], object]):
        program = self.get(key)
        if program is None:
            program = build()
            read = _prepared_reads(program)
            if read:
                self.discard(lambda k: any(read.get(name, copy) is not copy
                                           for name, copy in _prepared_reads(self.entries[k]).items()))
            self.put(key, program)
        return program

    def discard(self, match: Callable[[Hashable], bool]) -> None:
        """Drop every entry whose key ``match`` accepts."""
        for key in [key for key in self.entries if match(key)]:
            del self.entries[key]


def _prepared_reads(program) -> dict:
    """The prepared parameters a program (a :class:`CudaGraph`) read, by
    ``("prepared", owner id, key)``."""
    workspaces = getattr(program, "workspaces", {})
    return {name: copy for name, copy in workspaces.items() if isinstance(name, tuple) and name[:1] == ("prepared",)}


@contextlib.contextmanager
def host_sync(device):
    """Allow a synchronising call for the block: the copy of an entry
    point's results to the host, the one place it waits for ``device``.
    Elsewhere ``torch.cuda.set_sync_debug_mode`` applies as the caller set
    it."""
    if torch.device(device).type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a GPU through pinned memory, without
    waiting for the copy."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def copy_to_host(*tensors: Optional[torch.Tensor]):
    """Numpy copies of device tensors (None stays None): the one wait for
    the device."""
    device = next(t.device for t in tensors if t is not None)
    with host_sync(device):
        return tuple(None if t is None else t.to("cpu", copy=True).numpy() for t in tensors)
