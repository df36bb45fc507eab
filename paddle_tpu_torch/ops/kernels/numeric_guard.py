"""The numeric guard's kernels: their wrappers, tables and plain versions.

The JAX package computes the numeric guard in XLA (paddle_tpu/framework/
executor.py: the per-var finite mask of ``_make_step``, :707-718, and
``_skip_guard``'s revert, :101-114); the kernels are
``csrc/numeric_guard.cu``, whose header says what bounds them and how
their design meets that:

- ``finite_flags(tensors, flags, table)``: one launch over a list of
  float tensors. ``flags`` is a uint8 tensor of ``len(tensors) + 2``:
  ``flags[i]`` becomes 1 when tensor i holds a NaN or an Inf, else 0;
  ``flags[n]`` 1 when any does, else 0; ``flags[n + 1]`` (the sticky byte)
  is set to 1 when any does and is otherwise left as it was.
- ``guarded_copy(pairs, table, gate=None)``: one launch copying each
  ``(src, dst)`` pair of like tensors, byte for byte; with ``gate`` (a
  one-byte uint8 tensor) only when the gate is non-zero, read on the
  device.

Each runs its kernel for CUDA tensors and its plain version for CPU
tensors; it never falls back from one to the other. ``table`` is a
``TensorTable`` (the kernel's pointer table on the device; made per
caller): inside a CUDA graph capture its rows are kept on the host and
written by ``TensorTable.flush()`` after the capture ends, since the
captured kernel reads them only when it replays. ``launches`` and
``copy_launches`` count the two kernels' launches.
"""
import numpy as np
import torch

from . import build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}

launches = 0
copy_launches = 0


def is_guarded_dtype(dtype):
    """A dtype the finite check covers (the JAX package's inexact
    dtypes that the port's tensors take)."""
    return dtype in _CODES


def finite_flags_plain(tensors, flags):
    """finite_flags in plain PyTorch, on the tensors' device (the CPU
    path and the kernel's oracle)."""
    n = len(tensors)
    bad = torch.stack([~torch.isfinite(t).all() for t in tensors]) \
        if n else torch.zeros((0,), dtype=torch.bool, device=flags.device)
    flags[:n] = bad.to(torch.uint8)
    flags[n] = bad.any().to(torch.uint8)
    flags[n + 1] = flags[n + 1] | flags[n]
    return flags


def guarded_copy_plain(pairs, gate=None):
    """guarded_copy in plain PyTorch: a gate read on the device becomes a
    select, so a clean step writes each destination's own bytes back."""
    for src, dst in pairs:
        if gate is None:
            dst.copy_(src)
        else:
            dst.copy_(torch.where(gate.reshape(()).bool(), src, dst))


class TensorTable(object):
    """A kernel's table of rows (4 int64 each) on the device. ``set``
    writes the rows at once outside a capture; inside one it keeps them
    for ``flush`` (the captured kernel reads them when it replays), and
    the buffer must exist already (``reserve``): memory a capture
    allocates may be memory the step's own earlier temporaries freed,
    which every replay writes again, so rows written there after the
    capture would not survive a replay."""

    def __init__(self, device):
        self.device = device
        self.buf = None
        self._pending = None

    def reserve(self, n):
        """A buffer of at least ``n`` rows (outside a capture)."""
        if self.buf is None or self.buf.shape[0] < max(1, n):
            self.buf = torch.empty((max(1, n), 4), dtype=torch.int64,
                                   device=self.device)
        return self.buf

    def set(self, rows):
        host = torch.from_numpy(np.asarray(rows, dtype=np.int64)
                                .reshape(-1, 4))
        if torch.cuda.is_current_stream_capturing():
            if self.buf is None or self.buf.shape[0] < host.shape[0]:
                raise RuntimeError(
                    "a kernel table needs %d rows inside a capture; "
                    "reserve them before it" % host.shape[0])
            self._pending = host
        else:
            self.reserve(host.shape[0])[:host.shape[0]].copy_(host)
            self._pending = None
        return self.buf

    def flush(self):
        """Write the rows kept during a capture (outside it)."""
        if self._pending is not None:
            self.buf[:self._pending.shape[0]].copy_(self._pending)
            self._pending = None


def _check(tensors, device):
    for t in tensors:
        if t.device != device:
            raise ValueError("numeric guard: tensors on %s and %s"
                             % (device, t.device))
        if t.dtype not in _CODES:
            raise ValueError("numeric guard: no finite check for %s"
                             % t.dtype)


def finite_flags(tensors, flags, table):
    """See the module docstring."""
    global launches
    if flags.device.type == "cpu":
        return finite_flags_plain(tensors, flags)
    if flags.device.type != "cuda":
        raise ValueError("finite_flags runs on CUDA (kernel) or CPU (plain "
                         "version), got a %s tensor" % flags.device.type)
    _check(tensors, flags.device)
    if flags.dtype != torch.uint8 or flags.numel() != len(tensors) + 2:
        raise ValueError("finite_flags: flags must be %d uint8 bytes"
                         % (len(tensors) + 2))
    lib = build.load()
    chunk = lib.ptt_finite_chunk()
    rows, first = [], 0
    tensors = [t if t.is_contiguous() else t.contiguous() for t in tensors]
    for t in tensors:
        rows.append((t.data_ptr(), t.numel(), _CODES[t.dtype], first))
        first += -(-t.numel() // chunk)
    buf = table.set(rows)
    rc = lib.ptt_finite_flags(buf.data_ptr(), len(tensors), first,
                              flags.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    build.check(rc, "finite_flags")
    launches += 1
    return flags


def guarded_copy(pairs, table, gate=None):
    """See the module docstring."""
    global copy_launches
    if not pairs:
        return
    device = pairs[0][1].device
    if device.type == "cpu":
        return guarded_copy_plain(pairs, gate)
    if device.type != "cuda":
        raise ValueError("guarded_copy runs on CUDA (kernel) or CPU (plain "
                         "version), got a %s tensor" % device.type)
    rows, first = [], 0
    lib = build.load()
    chunk = lib.ptt_copy_chunk()
    for src, dst in pairs:
        if src.device != device or dst.device != device:
            raise ValueError("guarded_copy: tensors on %s and %s/%s"
                             % (device, src.device, dst.device))
        if src.shape != dst.shape or src.dtype != dst.dtype or not (
                src.is_contiguous() and dst.is_contiguous()):
            raise ValueError("guarded_copy copies like dense tensors, got "
                             "%s %s -> %s %s" % (src.dtype, tuple(src.shape),
                                                 dst.dtype, tuple(dst.shape)))
        nbytes = src.numel() * src.element_size()
        rows.append((src.data_ptr(), dst.data_ptr(), nbytes, first))
        first += -(-nbytes // chunk)
    if gate is not None and (gate.device != device or gate.numel() != 1
                             or gate.dtype != torch.uint8):
        raise ValueError("guarded_copy: the gate must be one uint8 byte on "
                         "%s" % device)
    buf = table.set(rows)
    rc = lib.ptt_guarded_copy(buf.data_ptr(), len(rows), first,
                              None if gate is None else gate.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    build.check(rc, "guarded_copy")
    copy_launches += 1
