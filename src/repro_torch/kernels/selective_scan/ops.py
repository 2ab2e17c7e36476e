"""The selective-scan op (port of ``repro/kernels/selective_scan/ops.py``).

``selective_scan`` takes the reference's layout (all float32): dt/x
``(B,S,Di)``, A ``(Di,N)``, b/c ``(B,S,N)``, h0 ``(B,Di,N)``, and returns
``(y (B,S,Di), h_final (B,Di,N))``. A CPU tensor takes the plain version
(``ref.py``, the sequential recurrence); a CUDA tensor launches the kernels
of ``csrc/selective_scan.cu`` (unless the mode is ``ref``).

The kernels replace the Pallas ``selective_scan``
(``repro/kernels/selective_scan/selective_scan.py``). Unlike that kernel
they take any ``Di`` and any ``S`` (no block or chunk multiples) and a state
of at most ``MAX_STATE`` entries per channel. A block walks 32 channels;
where ``B * ceil(Di / 32)`` blocks cannot fill the card, time is split into
chunks of 128 steps (``plan_chunk``) and the call is three launches (chunk
states, their carry, the walk that writes y), else one.
``selective_scan_cuda.launches`` counts calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, counts, select, stream
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

MAX_STATE = 16          # 4 lanes of 4 states per channel
CHANNELS = 32           # channels per block (csrc: kThreads / kLanes)
CHUNK = 128             # time steps per chunk where time is split
ONE_WALK_BLOCKS_PER_SM = 2   # one walk per channel fills the card from here


def plan_chunk(B: int, S: int, Di: int, sms: int) -> int:
    """Time steps per chunk for a call on a card of ``sms`` SMs: ``S``
    (one walk, one launch) when ``S <= CHUNK`` or the ``B * ceil(Di /
    CHANNELS)`` blocks of one walk reach ``ONE_WALK_BLOCKS_PER_SM`` per SM;
    else ``CHUNK``. Chunking does the exps of all chunks but the last
    twice, yet where one walk leaves the card idle the walk is
    latency-bound: at B 1 x S 4,224 x Di 3,200 on an H100 (100 blocks),
    chunks of 128 were the fastest measured, ahead of one walk and of longer
    chunks; at B 4 x S 144 (400 blocks) one walk was faster than two
    chunks. The cut at 2 blocks per SM lies between those readings and is
    itself unmeasured: B 2 or 3 of the long request (200 or 300 blocks)
    was not timed either way."""
    blocks = B * -(-Di // CHANNELS)
    if S <= CHUNK or blocks >= ONE_WALK_BLOCKS_PER_SM * sms:
        return max(S, 1)
    return CHUNK


def n_chunks(S: int, chunk: int) -> int:
    """The chunks a call of ``S`` steps in chunks of ``chunk`` makes."""
    return -(-S // chunk) if S > chunk else 1


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("selective_scan")
    lib.selective_scan.argtypes = ([ctypes.c_int] * 5
                                   + [ctypes.c_void_p] * 10)
    lib.selective_scan.restype = ctypes.c_int
    return lib


def selective_scan_cuda(dt: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan kernels on contiguous float32 CUDA tensors of the
    shapes above."""
    B, S, Di = x.shape
    N = A.shape[-1]
    dev = x.device
    for name, t, shape in (("dt", dt, (B, S, Di)), ("A", A, (Di, N)),
                           ("b", b, (B, S, N)), ("c", c, (B, S, N)),
                           ("x", x, (B, S, Di)), ("h0", h0, (B, Di, N))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"selective_scan kernel: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"selective_scan kernel: tensors on {dev}, not cuda")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"selective_scan kernel: state size N={N} outside "
                         f"[1, {MAX_STATE}]")
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    if B == 0 or Di == 0:
        return y, h_final
    chunk = plan_chunk(B, S, Di, _sms(dev.index))
    links = n_chunks(S, chunk) - 1
    scratch = x.new_empty(2 * B * links * Di * N) if links else None
    rc = _lib().selective_scan(
        B, S, Di, N, chunk, dt.data_ptr(), A.data_ptr(), b.data_ptr(),
        c.data_ptr(), x.data_ptr(), h0.data_ptr(), y.data_ptr(),
        h_final.data_ptr(), None if scratch is None else scratch.data_ptr(),
        stream.current(dev))
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {rc}")
    counts.add(selective_scan_cuda)
    return y, h_final


selective_scan_cuda.launches = 0


def selective_scan(dt: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba1 scan; see ``ref.selective_scan_ref`` for the semantics.
    The kernel gets contiguous copies of strided inputs."""
    if not select.use_kernel(impl, x):
        return selective_scan_ref(dt, A, b, c, x, h0)
    return selective_scan_cuda(*(t.contiguous() for t in (dt, A, b, c, x,
                                                          h0)))
