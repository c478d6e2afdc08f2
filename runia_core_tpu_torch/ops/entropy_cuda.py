"""Marginal KL entropy on the GPU: the wrapper of ``csrc/marginal_entropy.cu``.

Counterpart of ``runia_core_tpu/ops/entropy_pallas.py`` (the TPU kernel
``marginal_entropy_pallas``). :func:`marginal_entropy_cuda` routes by where
its tensor lies: a CPU tensor goes to :func:`marginal_entropy_plain`, a CUDA
tensor to the kernel, which either launches or raises. A shape outside the
kernel's contract is the caller's to route elsewhere, before any launch:
:func:`marginal_entropy_supported` states the contract, and the public
``ops/entropy.py::marginal_entropy`` takes the sorted-window form where it
says no, as the JAX function picks between its own routes.

What the kernels' design fixes outside the device code is decided here, in
Python the CPU tests reach: the sorting network (:func:`batcher_pairs`, from
which ``csrc/kl_sort_networks.cuh`` is generated), the launch plan
(:func:`entropy_plan`) and, step by step, the kernels' selection itself
(:func:`kernel_twin_kth_distances`).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.ops.entropy import _BIG, _digamma_const, _marginal_entropy_sorted
from runia_core_tpu_torch.utils.graphs import count_launch

__all__ = [
    "CHUNK", "MAX_N", "REGISTER_WIDTHS", "STATIC_K", "EntropyPlan", "batcher_pairs", "block_width", "entropy_plan",
    "kernel_twin_kth_distances", "marginal_entropy_cuda", "marginal_entropy_plain",
    "marginal_entropy_supported", "resident_width", "sort_network_header",
]

# The limits of both entropy kernels (this file and mc_entropy_cuda.py) are
# decided here alone; the C++ side takes the plan it is given.
MAX_N = 512  # the largest cloud (n, or S) the kernels are held to
MAX_SMEM = 227 * 1024  # dynamic shared memory one block may opt into on sm_90
_WIDTHS = (128, 64, 32)  # block widths the kernels take (csrc/kl_entropy.cuh valid_width)
REGISTER_WIDTHS = (8, 16, 32, 64)  # column lengths sorted in registers (template instances)
CHUNK = REGISTER_WIDTHS[-1]  # longer columns: register-sorted chunks of 64, merged in shared memory (kChunk)
SM_SMEM = 228 * 1024  # shared memory of one SM, of which each resident block reserves 1 KB
STATIC_K = 5  # the estimator's usual k (neighbors_for): also compiled in as a constant (kStaticK)

# The plain version of the kernel: the sorted-window form of ops/entropy.py.
marginal_entropy_plain = _marginal_entropy_sorted


def batcher_pairs(n: int, first_p: int = 1) -> List[Tuple[int, int]]:
    """Comparators (i, j), i < j, of Batcher's odd-even merge sort on n wires
    (Knuth's merge exchange, TAOCP 5.2.2 M): after ``min -> i, max -> j`` for
    each pair in order, the wires ascend. For n no power of two it is the
    next power's network without the comparators that touch a wire >= n,
    which +inf padding would leave in place.

    ``first_p`` skips the merges of runs shorter than it: with ``first_p``
    a power of two, the result sorts wires whose aligned runs of ``first_p``
    already ascend. The device code runs these very loops for the merges in
    shared memory (csrc/kl_entropy.cuh merge_sorted_chunks)."""
    pairs = []
    p = first_p
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j + k < n:
                # wires j .. j + k - 1 lie in one group of 2 p, and so do their partners
                if j // (2 * p) == (j + k) // (2 * p):
                    pairs += [(j + i, j + i + k) for i in range(min(k, n - j - k))]
                j += 2 * k
            k //= 2
        p *= 2
    return pairs


def sort_network_header() -> str:
    """The text of ``csrc/kl_sort_networks.cuh``: one macro per register
    width, listing :func:`batcher_pairs` as ``CX(i, j)`` with constant
    indices. tests/test_torch_entropy_plan.py holds the checked-in file to it."""
    lines = [
        "// Batcher odd-even merge sorting networks as comparator lists with constant",
        "// wire indices, for columns sorted in registers (kl_entropy.cuh).",
        "// Generated by runia_core_tpu_torch/ops/entropy_cuda.py::sort_network_header();",
        "// do not edit: change batcher_pairs() there and write the file anew.",
        "#pragma once",
    ]
    for width in REGISTER_WIDTHS:
        pairs = batcher_pairs(width)
        lines += ["", f"// {width} wires, {len(pairs)} comparators", f"#define RUNIA_SORT_NETWORK_{width}(CX) \\"]
        rows = [pairs[at : at + 6] for at in range(0, len(pairs), 6)]
        for index, row in enumerate(rows):
            end = " \\" if index + 1 < len(rows) else ""
            lines.append("  " + " ".join(f"CX({i}, {j})" for i, j in row) + end)
    return "\n".join(lines) + "\n"


def kernel_twin_kth_distances(column: torch.Tensor, k: int) -> torch.Tensor:
    """What the kernels select, step by step, for one column of n scalars:
    chunks of the register width padded with +1e30 and sorted by the
    network, the chunks merged by the network's later passes, then per point
    the least, over the windows of k + 1 sorted neighbours that hold it and
    lie inside the column, of the larger distance to the window's two ends.
    Returns the n k-th-neighbour distances in sorted order (unclamped).
    The CPU tests hold this to :func:`marginal_entropy_plain`'s bit for bit."""
    n = column.shape[0]
    width = next((w for w in REGISTER_WIDTHS if n <= w), CHUNK)
    values = column.to(torch.float32).tolist()
    for base in range(0, n, width):
        chunk = values[base : base + width] + [_BIG] * max(0, base + width - n)
        for i, j in batcher_pairs(width):
            chunk[i], chunk[j] = min(chunk[i], chunk[j]), max(chunk[i], chunk[j])
        values[base : base + width] = chunk[: min(width, n - base)]
    for i, j in batcher_pairs(n, first_p=width):
        values[i], values[j] = min(values[i], values[j]), max(values[i], values[j])
    xs = torch.tensor(values, dtype=torch.float32)
    kth = torch.empty(n, dtype=torch.float32)
    for i in range(n):
        best = torch.tensor(_BIG, dtype=torch.float32)
        for start in range(max(0, i - k), min(i, n - 1 - k) + 1):
            best = torch.minimum(best, torch.maximum(xs[i] - xs[start], xs[start + k] - xs[i]))
        kth[i] = best
    return kth


def block_width(rows: int, extra_bytes: int = 0) -> int:
    """Threads (one column each) per block of an entropy kernel: the widest
    of 128, 64, 32 whose ``rows`` staged floats per column plus
    ``extra_bytes`` fit one block's shared memory; 0 if none does."""
    return next((w for w in _WIDTHS if rows * w * 4 + extra_bytes <= MAX_SMEM), 0)


def resident_width(rows: int, extra_bytes: int = 0) -> int:
    """The block width, of those that fit (:func:`block_width`), that keeps
    the most warps resident on an SM, the wider at a tie; 0 if none fits.
    One thread sorts one column alone, so a long column in a wide block
    leaves an SM one block of few warps and nothing to hide its latency
    behind: at n = 512 three 32-wide blocks run where one 64-wide would."""
    def warps(width):
        blocks = min(32, SM_SMEM // (rows * width * 4 + extra_bytes + 1024))
        return min(64, blocks * width // 32)

    fitting = [w for w in _WIDTHS if rows * w * 4 + extra_bytes <= MAX_SMEM]
    return max(fitting, key=lambda w: (warps(w), w), default=0)


class EntropyPlan(NamedTuple):
    """How one launch of kernel 1 is laid out."""

    register_width: int  # 8, 16, 32 or 64: the template instance (values sorted in registers at a time)
    static_k: bool  # k = 5 and n <= 64: the instance with k compiled in, the column never leaves registers
    merged: bool  # n > 64: the sorted chunks are merged in shared memory
    width: int  # threads per block, one column each; 0: no width fits
    smem_bytes: int  # dynamic shared memory: the sorted column, n floats per thread; none with static_k


@functools.lru_cache(maxsize=128)
def entropy_plan(n: int, k: int) -> EntropyPlan:
    """The launch plan for clouds of n samples with k neighbours. It does not
    depend on d or the tensor's address: a thread loads its own column with
    4-byte loads, which any d and any f32 address take."""
    register_width = next((w for w in REGISTER_WIDTHS if n <= w), CHUNK)
    static_k = k == STATIC_K and n <= CHUNK
    width = _WIDTHS[0] if static_k else resident_width(n)
    return EntropyPlan(register_width, static_k, n > CHUNK, width, 0 if static_k else n * width * 4)


def marginal_entropy_supported(n: int, k: int) -> bool:
    """True if the kernel takes clouds of n samples with k neighbours."""
    return 1 <= k < n <= MAX_N and entropy_plan(n, k).width > 0


def marginal_entropy_cuda(clouds: torch.Tensor, k: int, min_dist: float = 1e-5) -> torch.Tensor:
    """Marginal h(z_i) per cloud and dimension: (B, n, d) f32 -> (B, d) f32.

    ``marginal_entropy_cuda.launches`` counts the kernel's launches.
    """
    if not clouds.is_cuda:
        return marginal_entropy_plain(clouds, k, min_dist)
    if clouds.ndim != 3 or clouds.dtype != torch.float32 or not clouds.is_contiguous():
        raise ValueError(
            "marginal_entropy_cuda takes a contiguous (B, n, d) float32 tensor; got "
            f"{clouds.dtype} of shape {tuple(clouds.shape)}, contiguous={clouds.is_contiguous()}"
        )
    b, n, d = clouds.shape
    if not marginal_entropy_supported(n, k):
        raise ValueError(f"need 1 <= k < n <= {MAX_N}; got k={k}, n={n}")
    out = torch.empty((b, d), dtype=torch.float32, device=clouds.device)
    if out.numel() == 0:
        return out
    plan = entropy_plan(n, k)
    lib = _kernels.library()
    with _kernels.device_guard(clouds.device):
        code = lib.runia_marginal_entropy(
            clouds.data_ptr(), out.data_ptr(), b, n, d, k, plan.register_width, int(plan.static_k), plan.width,
            float(min_dist), _digamma_const(k, n), torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "marginal_entropy")
    count_launch(marginal_entropy_cuda)
    return out


marginal_entropy_cuda.launches = 0
