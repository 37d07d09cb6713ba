"""A byte trace's columns as Montgomery word planes, laid out on the device.

A prover's trace arrives as a (T, w, 16) uint8 array of little-endian
encodings, row-major: row r holds its w elements side by side. The LDE wants
each column as (4, O) Montgomery word planes (ops/limbs.py), the T rows
followed by O - T pad rows. ``upload`` copies the caller's array to the
device as it is, with the pad rows' (w, 4, O - T) standard-form words beside
it; ``mont_planes`` turns the two into (w, 4, O) int32 Montgomery planes,
column j's planes being out[j]. For a CUDA tensor it launches csrc/
trace_layout.cu's ``trace_layout`` (one launch for every column); for a CPU
tensor, and only because it lies on the CPU, it takes ``mont_planes_plain``:
a view of the bytes as int32 words, a permute to planes, the concatenation
with the pad block and field_kernels.to_mont a column (on a CUDA tensor one
fp_mont_mul launch a column: the route the kernel is timed against).
"""

from __future__ import annotations

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops.limbs import NUM_WORDS
from stark_anatomy_tpu_torch.utils import telemetry


def upload(trace: np.ndarray, pad: np.ndarray, device) -> tuple:
    """The (T, w, 16) uint8 trace and the (w, 4, P) uint32 pad words as
    tensors on `device`, one copy each straight from the caller's arrays (a
    trace that is not C-contiguous, or is read-only, is copied first; on the
    CPU the trace's tensor shares its memory). To a CUDA device both are
    copies from pageable memory: a device-wait."""
    if trace.dtype != np.uint8 or trace.ndim != 3 or trace.shape[2] != 16:
        raise ValueError(f"expected a (T, w, 16) uint8 trace, got {trace.dtype} {trace.shape}")
    if not (trace.flags.c_contiguous and trace.flags.writeable):
        trace = np.array(trace, order="C")
    # through a flat view: numpy gives a copied empty array zero strides
    body = torch.from_numpy(trace.reshape(-1)).view(trace.shape)
    words = torch.from_numpy(np.ascontiguousarray(pad, dtype=np.uint32).view(np.int32))
    with telemetry.device_wait(device):
        return body.to(device), words.to(device)


def _check(body: torch.Tensor, pad: torch.Tensor) -> None:
    if body.dtype != torch.uint8 or body.dim() != 3 or body.shape[2] != 16 or not body.is_contiguous():
        raise ValueError(f"trace_layout.body: expected a contiguous (T, w, 16) uint8 tensor, got "
                         f"{body.dtype} {tuple(body.shape)}")
    w = body.shape[1]
    if pad.dtype != torch.int32 or pad.dim() != 3 or tuple(pad.shape[:2]) != (w, NUM_WORDS) \
            or not pad.is_contiguous():
        raise ValueError(f"trace_layout.pad: expected a contiguous ({w}, {NUM_WORDS}, P) int32 tensor, "
                         f"got {pad.dtype} {tuple(pad.shape)}")
    if pad.device != body.device:
        raise ValueError("trace_layout: body and pad lie on different devices")
    if body.shape[0] + pad.shape[2] < 1:
        raise ValueError("trace_layout: no rows")


def mont_planes_plain(body: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """mont_planes as a permute, a concatenation and to_mont a column (any
    device)."""
    _check(body, pad)
    planes = torch.cat([body.view(torch.int32).permute(1, 2, 0), pad], dim=2)
    for column in planes:
        fk.to_mont(column, out=column)
    return planes


def mont_planes(body: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """(w, 4, T + P) int32 Montgomery planes of the (T, w, 16) uint8 byte rows
    `body` followed by the (w, 4, P) int32 standard-form words `pad`."""
    if body.device.type != "cuda":
        return mont_planes_plain(body, pad)
    _check(body, pad)
    if body.data_ptr() % 16:
        raise ValueError("trace_layout.body: the kernel reads 16-byte rows and needs a 16-byte aligned tensor")
    rows, w = body.shape[:2]
    pad_len = pad.shape[2]
    out = torch.empty((w, NUM_WORDS, rows + pad_len), dtype=torch.int32, device=body.device)
    with torch.cuda.device(body.device):
        _build.launch("trace_layout", body.data_ptr(), rows, w, pad.data_ptr() if pad_len else None,
                      pad_len, out.data_ptr(), out.stride(0), out.stride(1))
    return out
