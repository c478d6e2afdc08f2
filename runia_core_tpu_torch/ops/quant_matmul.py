"""Weight-only int8 matrix product: the wrapper of ``csrc/quant_matmul.cu``.

Counterpart of ``runia_core_tpu/ops/quant_matmul.py`` (the TPU kernel
``quant_matmul``). Contract, as ``models/llama.py::QDense`` stores its
weights::

    x     (..., K)  bfloat16 / float32   activations (decode: rows = batch)
    wq    (K, N)    int8                 per-output-channel symmetric weights
    scale (N,)      float32              dequant scale per output channel
    out   (..., N)  x.dtype              (x @ wq) summed in f32, * scale, rounded once

:func:`quant_matmul` routes by where its tensor lies: a CPU tensor goes to
:func:`quant_matmul_plain`, a CUDA tensor to the kernel, which launches or
raises. :func:`quant_matmul_supported` states the kernel's contract; a caller
takes another route for a shape outside it, before any launch, as
``models/llama.py::QDense`` does above 1024 rows.

The kernel is a split-K weight stream: :func:`plan_split_k` cuts K into
ranges so that every shape fills the card's SMs, each range is summed by its
own block, and the last block to arrive at an output tile adds the partial
sums in split order (see the note in the source).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.utils.graphs import count_launch, current_graph

__all__ = [
    "MAX_ROWS", "SplitKPlan", "plan_split_k", "quant_matmul", "quant_matmul_plain", "quant_matmul_supported",
]

# Decode, speculative verify and lane-chunk prefill stay under it; above it a
# product is compute-bound and one dequantized weight serves all the rows.
MAX_ROWS = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's tiling (csrc/quant_matmul.cu: BN, KT) and the grid it aims at:
# two blocks for each of the H100's 132 SMs (132, 330 and 528 blocks were
# slower at the decode shapes).
BLOCK_N = 128
STAGE_K = 64
TARGET_BLOCKS = 2 * 132


class SplitKPlan(NamedTuple):
    """How one product is cut into blocks: the grid is (n_tiles, splits,
    row_blocks); split s sums K rows [s * k_per_split, min(K, (s + 1) *
    k_per_split))."""

    block_rows: int    # rows per block: 16, 32 or 64 (1, 2 or 4 m16 tiles)
    row_blocks: int
    n_tiles: int       # column tiles of BLOCK_N
    splits: int
    k_per_split: int   # a multiple of STAGE_K
    scratch_floats: int  # f32 partial sums the launch needs (0 without a split)

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.splits * self.row_blocks


@functools.lru_cache(maxsize=1024)
def plan_split_k(rows: int, k: int, n: int) -> SplitKPlan:
    """Cut a (rows, K) @ (K, N) product for the kernel. Without a split the
    grid has one block per (column tile, row block); K is split as many ways
    as keeps the grid within TARGET_BLOCKS, in whole stages of STAGE_K rows,
    so only the last range can be ragged."""
    block_rows = 16 if rows <= 16 else 32 if rows <= 32 else 64
    row_blocks = -(-rows // block_rows)
    n_tiles = -(-n // BLOCK_N)
    k_tiles = -(-k // STAGE_K)
    want = min(k_tiles, max(1, TARGET_BLOCKS // (n_tiles * row_blocks)))
    tiles_per_split = -(-k_tiles // want)
    splits = -(-k_tiles // tiles_per_split)
    scratch = splits * row_blocks * block_rows * n_tiles * BLOCK_N if splits > 1 else 0
    return SplitKPlan(block_rows, row_blocks, n_tiles, splits, tiles_per_split * STAGE_K, scratch)


_workspaces = {}  # (device index, stream) -> (f32 scratch, zeroed int32 tile counters)


def _workspace(device: torch.device, stream: int, plan: SplitKPlan):
    """The scratch of partial sums and the output tiles' arrival counters of
    one stream, or of the CUDA graph being warmed up or captured
    (``utils/graphs.py``), which owns its own. Launches of a stream, and of
    a graph, run one after the other, so they share both: the scratch is
    written before it is read within a launch, and the counters are zero
    before a launch and set back to zero by it. A graph's workspace is made
    by its warm-up; one that would be made during a capture (inside the
    graph's memory pool) raises."""
    graph = current_graph()
    if graph is None:
        store, key = _workspaces, (device.index, stream)
    else:
        store, key = graph.workspaces, ("quant_matmul", device.index)
    scratch, counters = store.get(key, (None, None))
    tiles = plan.n_tiles * plan.row_blocks
    if scratch is None or scratch.numel() < plan.scratch_floats or counters.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "quant_matmul: its workspace would be allocated inside a CUDA graph capture; "
                "capture through utils.graphs.CudaGraph, whose warm-up allocates it"
            )
        scratch = torch.empty((max(plan.scratch_floats, 1 << 22),), dtype=torch.float32, device=device)
        counters = torch.zeros((max(tiles, 4096),), dtype=torch.int32, device=device)
        store[key] = (scratch, counters)
    return scratch, counters


def quant_matmul_supported(rows: int) -> bool:
    """True if a product of ``rows`` rows is in the kernel's contract. The
    kernel masks ragged K and N itself, so only the row count limits it
    (the TPU version's K % 128 and VMEM budget do not apply)."""
    return 0 < rows <= MAX_ROWS


def quant_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``(x.float() @ wq.float()) * scale``,
    cast to x.dtype."""
    out = (x.to(torch.float32) @ wq.to(torch.float32)) * scale.to(torch.float32)
    return out.to(x.dtype)


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (wq * scale)`` with wq kept int8 in device memory.

    ``x`` may carry leading batch dimensions; they are flattened to rows.
    ``quant_matmul.launches`` counts the kernel's launches.
    """
    if not x.is_cuda:
        return quant_matmul_plain(x, wq, scale)
    *lead, k = x.shape
    rows = x.numel() // k if k else 0
    if x.dtype not in _DTYPE_CODES or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"quant_matmul takes float32/bfloat16 x, int8 wq and float32 scale; got {x.dtype}, "
            f"{wq.dtype}, {scale.dtype}"
        )
    if wq.ndim != 2 or wq.shape[0] != k or scale.shape != (wq.shape[1],):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, wq {tuple(wq.shape)}, scale {tuple(scale.shape)}")
    if not quant_matmul_supported(rows):
        raise ValueError(f"quant_matmul takes 1..{MAX_ROWS} rows; got {rows}")
    x2 = x.reshape(rows, k)
    for name, t in (("x", x2), ("wq", wq), ("scale", scale)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"quant_matmul: {name} must be contiguous on {x.device}")
    n = wq.shape[1]
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if n == 0 or k == 0:
        return out.zero_().reshape(*lead, n)
    plan = plan_split_k(rows, k, n)
    lib = _kernels.library()
    with _kernels.device_guard(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, counters = _workspace(x.device, stream, plan)
        code = lib.runia_quant_matmul(
            x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            counters.data_ptr(), rows, k, n, plan.block_rows, plan.splits, plan.k_per_split,
            _DTYPE_CODES[x.dtype], stream,
        )
    _kernels.check(code, "quant_matmul")
    count_launch(quant_matmul)
    return out.reshape(*lead, n)


quant_matmul.launches = 0
