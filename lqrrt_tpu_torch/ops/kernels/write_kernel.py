"""In-place block-column write ``dst[:, :, start:start+B] = src`` (port of
lqrrt_tpu/ops/pallas/write_kernel.py ``block_column_write``).

The CUDA kernel (``csrc/block_write.cu``; its header says what bounds it on
the H100 and how it is built) reads ``start`` from device memory, so a
commit never asks the host where it lands.  Unlike the Pallas writer it
takes any ``start``: columns at or past N are dropped, and there is no
512-alignment requirement.

``block_write`` takes the plain PyTorch version for a CPU tensor and the
kernel for a CUDA tensor; there is no other path.  ``block_write.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch


def block_write_plain(dst: torch.Tensor, src: torch.Tensor,
                      start: torch.Tensor) -> torch.Tensor:
    """The plain version: a slice assignment at a 0-d int ``start``,
    masked at N.  Reads ``start`` on the host (``int``), so it syncs on a
    device tensor -- the CPU path and the kernel's check only."""
    N, B = dst.shape[-1], src.shape[-1]
    s = int(start)
    lo, hi = max(s, 0), min(s + B, N)
    if hi > lo:
        dst[..., lo:hi] = src[..., lo - s:hi - s]
    return dst


def _check(dst, src, start):
    if dst.dtype != torch.float32 or src.dtype != torch.float32:
        raise TypeError("block_write takes float32 dst and src")
    if dst.dim() != 3 or src.dim() != 3 or dst.shape[:2] != src.shape[:2]:
        raise ValueError(f"block_write needs (A, C, N) dst and (A, C, B) src, "
                         f"got {tuple(dst.shape)} and {tuple(src.shape)}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("block_write needs contiguous dst and src")
    if start.dtype != torch.int32 or start.numel() != 1:
        raise TypeError("block_write takes start as one int32 element")
    if not (src.device == dst.device == start.device):
        raise ValueError("block_write: dst, src and start must share a device")


def block_write(dst: torch.Tensor, src: torch.Tensor,
                start: torch.Tensor) -> torch.Tensor:
    """dst[:, :, start:start+B] = src in place; returns ``dst``.

    dst (A, C, N) f32, src (A, C, B) f32, start a 0-d int32 tensor on the
    same device (read on the device by the kernel)."""
    _check(dst, src, start)
    if dst.device.type == "cpu":
        return block_write_plain(dst, src, start)
    if dst.device.type != "cuda":
        raise ValueError(f"block_write: unsupported device {dst.device}")
    from . import _build

    A, C, N = dst.shape
    B = src.shape[-1]
    if A * C > 65535:
        raise ValueError(f"block_write: {A * C} rows exceed the grid's "
                         "65535")
    if B == 0:
        return dst
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    with torch.cuda.device(dst.device):
        err = _build.lib().lqrrt_block_write(
            dst.data_ptr(), src.data_ptr(), start.data_ptr(), A * C, N, B,
            stream)
    _build.check(err, "block_write")
    block_write.launches += 1
    return dst


block_write.launches = 0
