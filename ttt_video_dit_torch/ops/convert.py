"""float32 -> bfloat16 conversion of the layer stack's weights: the CUDA
kernel's wrapper, its plain version, and the autograd Function around them.

Port of ttt_video_dit_tpu/ops/pallas/convert.py (K7: _convert_kernel,
reached through opaque_convert from models/dit/dit.py:_make_scan_param_pin).
Under ``scan_layers = true`` (the training TOMLs) the JAX package casts each
transformer layer's 2-D Dense kernels to the compute dtype through that
kernel, with a VJP that casts the cotangent back to float32. The port
unrolls the layers and keeps the cast where the pin puts it: in training,
each 2-D ``Linear`` weight inside ``DiffusionTransformer.layers`` is cast by
:class:`OpaqueConvertFunction` at each call (models/ttt/layer.py:Linear).
Kernel: ``csrc/convert.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from ttt_video_dit_torch.ops import _build
from ttt_video_dit_torch.parallel.sharded import refuse_dtensors

# Launches of the CUDA kernel (the plain version does not count).
launches = 0


def convert_f32_bf16_plain(x):
    """The cast the kernel computes: ``x.to(torch.bfloat16)`` (round to nearest even)."""
    return x.to(torch.bfloat16)


def _lib():
    lib = _build.load("convert")
    if lib.convert_f32_bf16.argtypes is None:
        lib.convert_f32_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.convert_f32_bf16.restype = ctypes.c_int
    return lib


def convert_f32_bf16(x):
    """K7: ``x`` (float32, contiguous) rounded to bfloat16. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise ValueError."""
    global launches
    refuse_dtensors("convert_f32_bf16", x)
    if x.device.type == "cpu":
        return convert_f32_bf16_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"convert_f32_bf16 takes a contiguous, 16-byte aligned float32 CUDA tensor; got "
                         f"{x.dtype} on {x.device}, contiguous {x.is_contiguous()}")
    lib = _lib()
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.convert_f32_bf16(x.data_ptr(), y.data_ptr(), x.numel(),
                                   torch.cuda.get_device_properties(x.device).multi_processor_count,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "convert_f32_bf16 launch")
    launches += 1
    return y


class OpaqueConvertFunction(torch.autograd.Function):
    """float32 -> bfloat16 through K7 (or, with ``plain``, its plain version);
    the backward casts the cotangent back to float32, as _opaque_bwd does."""

    @staticmethod
    def forward(ctx, x, plain):
        return convert_f32_bf16_plain(x) if plain else convert_f32_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None


def opaque_convert(x, dtype, plain: bool = False):
    """``x`` in ``dtype``: through :class:`OpaqueConvertFunction` for a 2-D
    float32 -> bfloat16 cast (the JAX pin's _eligible), else ``x.to(dtype)``."""
    refuse_dtensors("opaque_convert", x)
    if x.dtype == dtype:
        return x
    if x.ndim == 2 and x.dtype == torch.float32 and dtype == torch.bfloat16:
        return OpaqueConvertFunction.apply(x, plain)
    return x.to(dtype)
