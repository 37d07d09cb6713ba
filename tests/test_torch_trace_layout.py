"""PyTorch port, the trace layout (ops/trace_layout.py): a byte trace and its
pad rows as Montgomery word planes, held word for word to the host route
each column took before (bytes_to_words, the concatenation with the pad
words, to_tensor, to_mont). The kernel's own tests need a card and are in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import trace_layout
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import bytes_to_words, random_felt_words, to_tensor, words_to_bytes


def _trace(rng, t_len: int, w: int) -> np.ndarray:
    """(T, w, 16) random canonical encodings, with p - 1 and 0 among them."""
    enc = words_to_bytes(random_felt_words(rng, t_len * w)).reshape(t_len, w, 16).copy()
    enc[0, 0] = np.frombuffer((PRIME - 1).to_bytes(16, "little"), np.uint8)
    enc[t_len // 2, w - 1] = 0
    enc[-1, 0] = np.frombuffer((PRIME - 1).to_bytes(16, "little"), np.uint8)
    return enc


def _pad(rng, pad_len: int, w: int) -> np.ndarray:
    """(w, 4, P) uint32 standard-form words of P canonical rows."""
    return np.stack([random_felt_words(rng, pad_len) for _ in range(w)])


def _host_route(trace: np.ndarray, pad: np.ndarray) -> torch.Tensor:
    columns = []
    for j in range(trace.shape[1]):
        body = bytes_to_words(np.ascontiguousarray(trace[:, j, :]))
        columns.append(fk.to_mont(to_tensor(np.concatenate([body, pad[j]], axis=1), "cpu")))
    return torch.stack(columns)


@pytest.mark.parametrize("pad_len", [128, 159, 0])
@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("log_o", [10, 14])
def test_the_planes_equal_the_host_route_of_each_column(log_o, w, pad_len):
    rng = np.random.default_rng(log_o * 100 + w * 10 + pad_len)
    o = 1 << log_o
    trace, pad = _trace(rng, o - pad_len, w), _pad(rng, pad_len, w)
    kept = trace.copy()
    body, tail = trace_layout.upload(trace, pad, "cpu")
    assert body.data_ptr() == trace.ctypes.data  # the caller's memory, no copy first
    got = trace_layout.mont_planes(body, tail)
    assert got.shape == (w, 4, o) and got.dtype == torch.int32
    assert torch.equal(got, _host_route(trace, pad))
    assert np.array_equal(trace, kept)


@pytest.mark.parametrize("view", ["rows", "columns", "read-only", "read-only, no rows"])
def test_a_strided_or_read_only_trace_is_copied_and_laid_out_the_same(view):
    rng = np.random.default_rng(7)
    o, pad_len, w = 1 << 10, 128, 2
    whole = _trace(rng, 2 * (o - pad_len), 2 * w)
    read_only = np.frombuffer(whole[: o - pad_len, :w].tobytes(), np.uint8).reshape(o - pad_len, w, 16)
    if view == "read-only, no rows":  # a mesh block that holds pad rows alone
        pad_len, read_only = o, read_only[o - pad_len :]
    trace = {"rows": whole[::2, :w], "columns": whole[: o - pad_len, 1::2], "read-only": read_only,
             "read-only, no rows": read_only}[view]
    assert not (trace.flags.c_contiguous and trace.flags.writeable)
    pad = _pad(rng, pad_len, w)
    got = trace_layout.mont_planes(*trace_layout.upload(trace, pad, "cpu"))
    assert torch.equal(got, _host_route(np.ascontiguousarray(trace), pad))


def test_malformed_inputs_are_refused():
    rng = np.random.default_rng(3)
    trace, pad = _trace(rng, 64, 2), _pad(rng, 64, 2)
    with pytest.raises(ValueError, match="uint8 trace"):
        trace_layout.upload(trace.view(np.uint32), pad, "cpu")
    with pytest.raises(ValueError, match="uint8 trace"):
        trace_layout.upload(trace.reshape(64, 32), pad, "cpu")
    body, tail = trace_layout.upload(trace, pad, "cpu")
    with pytest.raises(ValueError, match="pad"):
        trace_layout.mont_planes(body, tail[:1])
    with pytest.raises(ValueError, match="body"):
        trace_layout.mont_planes(body.transpose(0, 1), tail)
