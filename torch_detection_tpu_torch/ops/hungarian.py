"""Exact linear sum assignment (the Hungarian matching of set losses), with
its CUDA kernel.

Counterpart of ``torch_detection_tpu/ops/hungarian.py``: the shortest
augmenting path algorithm (Jonker-Volgenant, as Crouse 2016 and scipy),
one outer augmentation a valid row, each a Dijkstra over the columns. The
pieces:

* ``linear_sum_assignment_plain``: the plain PyTorch version, step for
  step the reference's loops with the same float32 expressions, one
  problem at a time; it runs on the CPU tensors of the tests and is the
  version the kernel is held against;
* ``batched_linear_sum_assignment_cuda``: the wrapper of the hand-written
  kernel ``csrc/hungarian.cu``, one launch for a batch of problems;
* ``batched_linear_sum_assignment``: dispatches on the cost's device, CPU
  tensors to the plain version, CUDA tensors to the kernel, which launches
  or raises.

The reference keeps the matching inside the jitted step with no host round
trip. In eager PyTorch every Dijkstra step's test of its sink would be a
host sync, so on the card the whole loop runs in the kernel and a training
step's matching is one launch with no copy to the host.

Every float operation is an add, a subtract or a compare, so the kernel and
the plain version give the same ``col4row``, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from .. import kernels

_BIG = 1e9  # what NaN and +-inf costs become, as the reference's nan_to_num
_MAX_COLUMNS = 1024  # the kernel's block: one thread a column


def _check(cost: Tensor, row_valid: Optional[Tensor]) -> None:
    if cost.dim() != 3:
        raise ValueError(f"cost must be (P, G, Q), got {tuple(cost.shape)}")
    g, q = cost.shape[1:]
    if g > q:
        raise ValueError(f"need rows <= columns, got {g} x {q}")
    if row_valid is not None and row_valid.shape != cost.shape[:2]:
        raise ValueError(f"row_valid {tuple(row_valid.shape)} does not match cost "
                         f"{tuple(cost.shape)}")


def _solve(c: Tensor, n_rows: int) -> Tensor:
    """``col4row`` (G,) int32 of the first ``n_rows`` rows of the float32
    (G, Q) cost ``c``; the other rows stay -1. The reference's loops, with
    its expressions in its order."""
    g, q = c.shape
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=c.device)
    u = torch.zeros(g, dtype=torch.float32, device=c.device)
    v = torch.zeros(q, dtype=torch.float32, device=c.device)
    col4row = [-1] * g
    row4col = [-1] * q
    rows = torch.arange(g, device=c.device)
    for cur_row in range(n_rows):
        # Dijkstra from cur_row over the columns
        sink, i = -1, cur_row
        min_val = torch.zeros((), dtype=torch.float32, device=c.device)
        sr = torch.zeros(g, dtype=torch.bool, device=c.device)
        sc = torch.zeros(q, dtype=torch.bool, device=c.device)
        spc = torch.full((q,), float("inf"), dtype=torch.float32, device=c.device)
        path = torch.full((q,), -1, dtype=torch.int64, device=c.device)
        while sink < 0:
            linear_sum_assignment_plain.dijkstra_steps += 1
            sr[i] = True
            r = min_val + c[i] - u[i] - v
            better = ~sc & (r < spc)
            spc = torch.where(better, r, spc)
            path = torch.where(better, i, path)
            masked = torch.where(sc, inf, spc)
            j = int(torch.argmin(masked))  # the lowest index among equal minima
            min_val = masked[j]
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
        # dual update
        u[cur_row] += min_val
        safe_cols = torch.tensor(col4row, device=c.device).clamp(0, q - 1)
        row_mask = sr & (rows != cur_row)
        u = u + torch.where(row_mask, min_val - spc[safe_cols], 0.0)
        v = v - torch.where(sc, min_val - spc, 0.0)
        # augment along the alternating path
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            j, col4row[i] = col4row[i], j
            if i == cur_row:
                break
    return torch.tensor(col4row, dtype=torch.int32, device=c.device)


def linear_sum_assignment_plain(cost: Tensor, row_valid: Optional[Tensor] = None) -> Tensor:
    """The plain version: ``col4row`` (P, G) int32 of each (G, Q) problem of
    ``cost`` (P, G, Q), G <= Q, the column matched to each row. With
    ``row_valid`` (P, G), only the valid rows are matched, moved to the
    front in their order first, and the others get -1. NaN and +inf costs
    count as 1e9, -inf as -1e9."""
    _check(cost, row_valid)
    out = []
    for p in range(cost.shape[0]):
        c = torch.nan_to_num(cost[p].float(), nan=_BIG, posinf=_BIG, neginf=-_BIG)
        if row_valid is None:
            out.append(_solve(c, c.shape[0]))
            continue
        valid = row_valid[p].bool()
        order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid rows first
        col4row = _solve(c[order], int(valid.sum()))
        out.append(torch.where(valid, torch.zeros_like(col4row).index_put((order,), col4row), -1))
    return torch.stack(out) if out else torch.zeros(cost.shape[:2], dtype=torch.int32,
                                                    device=cost.device)


# Dijkstra steps the plain version has run in this process: each relaxes
# every column once, so they count the work a problem's data needs
linear_sum_assignment_plain.dijkstra_steps = 0


def batched_linear_sum_assignment_cuda(cost: Tensor, row_valid: Optional[Tensor] = None) -> Tensor:
    """The kernel ``csrc/hungarian.cu``: ``col4row`` (P, G) int32, one
    thread block a problem, one launch for all of them.
    ``batched_linear_sum_assignment_cuda.launches`` counts launches."""
    _check(cost, row_valid)
    if cost.device.type != "cuda":
        raise ValueError("batched_linear_sum_assignment_cuda takes CUDA tensors")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    p, g, q = cost.shape
    if q > _MAX_COLUMNS:
        raise ValueError(f"the kernel takes at most {_MAX_COLUMNS} columns, got {q}")
    out = torch.empty((p, g), dtype=torch.int32, device=cost.device)
    if p * g == 0:
        return out
    cost = cost.contiguous()
    if row_valid is not None:
        if row_valid.device != cost.device:
            raise ValueError("row_valid must lie on the cost's device")
        row_valid = row_valid.to(torch.uint8).contiguous()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = _kernel()(cost.data_ptr(), row_valid.data_ptr() if row_valid is not None else None,
                       p, g, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hungarian failed to launch: CUDA error {rc}")
    batched_linear_sum_assignment_cuda.launches += 1
    return out


batched_linear_sum_assignment_cuda.launches = 0


def _kernel():
    """``hungarian(cost, row_valid or NULL, problems, rows, columns, col4row,
    stream)`` from its library."""
    fn = kernels.load("hungarian").hungarian
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def batched_linear_sum_assignment(cost: Tensor, row_valid: Optional[Tensor] = None) -> Tensor:
    """``col4row`` (P, G) int32 of each (G, Q) problem of ``cost``: the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if cost.device.type == "cuda":
        return batched_linear_sum_assignment_cuda(cost, row_valid)
    if cost.device.type != "cpu":
        raise ValueError(f"no linear sum assignment for device {cost.device}")
    return linear_sum_assignment_plain(cost, row_valid)

