"""Kernels B1, B2 and B3 as ``torch.library`` custom ops.

The kernels load through ctypes (``ops/_build.py``), which ``torch.export``
cannot trace. Registered as custom ops in the namespace
``asv_torch``, they appear in an exported graph as single nodes
(``torch.ops.asv_torch.lfcc``, ``.res2_chain``, ``.attention_pooling``)
and run again when the graph runs. Each op has

- a CUDA implementation that calls the kernel's launcher
  (``lfcc_cuda.lfcc_kernel``, ``res2_chain_cuda.res2_chain_kernel``,
  ``attn_pool_cuda.attention_pooling_kernel``), which counts the launch,
  and raises on what the kernel does not take: a CUDA tensor never
  reaches a plain version;
- a CPU implementation, the kernel's plain version;
- a fake implementation giving the output's shape and type, for tracing.

The launchers are looked up on their modules at each call, so a caller
that swaps in the plain version there (``chip_smoke.py`` does, to hold a
path against its plain twin on the card) swaps it here too.

The wrappers ``CudaLFCC.cepstra``, ``res2_chain_infer`` and
``attention_pooling`` call these ops, so the serving graph, the front
end and an exported artifact share one route. Loading a saved artifact
needs the ops registered: import this module before
``torch.export.load``.
"""

from __future__ import annotations

from typing import Optional

import torch

from asvspoof2021_air_tpu_torch.ops import attn_pool_cuda, dsp, lfcc_cuda
from asvspoof2021_air_tpu_torch.ops import res2_chain_cuda
from asvspoof2021_air_tpu_torch.ops.lfcc import LFCCConfig

NAMESPACE = "asv_torch"
OPS = ("lfcc", "res2_chain", "attention_pooling")


def _lfcc_config(hop: int, win: int, n_fft: int, n_filters: int):
    return LFCCConfig(win_length=win, hop_length=hop, n_fft=n_fft,
                      n_filters=n_filters)


@torch.library.custom_op(f"{NAMESPACE}::lfcc", mutates_args=())
def lfcc(x: torch.Tensor, window: torch.Tensor, twiddle: torch.Tensor,
         bands: torch.Tensor, weights: torch.Tensor, dct: torch.Tensor,
         cs: torch.Tensor, fb: torch.Tensor, hop: int, win: int, n_fft: int,
         n_filters: int) -> torch.Tensor:
    """B1: pre-emphasized (B, L) f32 -> (B, T, n_filters) cepstra, with the
    constants of ``CudaLFCC`` (the kernel's window, twiddles, bands and
    weights; the plain version's [cos | sin] ``cs`` and filterbank
    ``fb``)."""
    raise NotImplementedError(f"{NAMESPACE}::lfcc on {x.device}")


@lfcc.register_kernel("cuda")
def _lfcc_cuda(x, window, twiddle, bands, weights, dct, cs, fb, hop, win,
               n_fft, n_filters):
    return lfcc_cuda.lfcc_kernel(x, window, twiddle, bands, weights, dct,
                                 _lfcc_config(hop, win, n_fft, n_filters))


@lfcc.register_kernel("cpu")
def _lfcc_cpu(x, window, twiddle, bands, weights, dct, cs, fb, hop, win,
              n_fft, n_filters):
    return lfcc_cuda.lfcc_plain(x, cs, fb, dct,
                                _lfcc_config(hop, win, n_fft, n_filters))


@lfcc.register_fake
def _lfcc_fake(x, window, twiddle, bands, weights, dct, cs, fb, hop, win,
               n_fft, n_filters):
    return x.new_empty((x.shape[0], dsp.num_frames(x.shape[1], hop),
                        n_filters), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::res2_chain", mutates_args=())
def res2_chain(x: torch.Tensor, w: torch.Tensor, cb: torch.Tensor,
               a: torch.Tensor, b: torch.Tensor, dilation: int, scale: int,
               valid_len: Optional[int] = None) -> torch.Tensor:
    """B2: the Res2 chain of one Bottle2neck, x (B, T, width * scale) ->
    the same shape and type (``res2_chain_cuda.res2_chain_infer``)."""
    raise NotImplementedError(f"{NAMESPACE}::res2_chain on {x.device}")


@res2_chain.register_kernel("cuda")
def _res2_chain_cuda(x, w, cb, a, b, dilation, scale, valid_len=None):
    return res2_chain_cuda.res2_chain_kernel(
        x, w, cb, a, b, dilation=dilation, scale=scale, valid_len=valid_len)


@res2_chain.register_kernel("cpu")
def _res2_chain_cpu(x, w, cb, a, b, dilation, scale, valid_len=None):
    return res2_chain_cuda.res2_chain_plain(
        x, w, cb, a, b, dilation=dilation, scale=scale, valid_len=valid_len)


@res2_chain.register_fake
def _res2_chain_fake(x, w, cb, a, b, dilation, scale, valid_len=None):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::attention_pooling", mutates_args=())
def attention_pooling(x: torch.Tensor, wx: torch.Tensor, wm: torch.Tensor,
                      ws: torch.Tensor, ba: torch.Tensor, s: torch.Tensor,
                      bias: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                      wx_planes: Optional[torch.Tensor],
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """B3: attentive-statistics pooling, x (B, T, D) -> (B, 2 D) f32, with
    the fields of ``attn_pool_cuda.PoolParams`` as arguments."""
    raise NotImplementedError(f"{NAMESPACE}::attention_pooling on "
                              f"{x.device}")


def _pool_params(wx, wm, ws, ba, s, bias, wb, bb, wx_planes):
    return attn_pool_cuda.PoolParams(wx, wm, ws, ba, s, bias, wb, bb,
                                     wx_planes)


@attention_pooling.register_kernel("cuda")
def _attention_pooling_cuda(x, wx, wm, ws, ba, s, bias, wb, bb, wx_planes,
                            valid_len=None):
    return attn_pool_cuda.attention_pooling_kernel(
        x, _pool_params(wx, wm, ws, ba, s, bias, wb, bb, wx_planes),
        valid_len)


@attention_pooling.register_kernel("cpu")
def _attention_pooling_cpu(x, wx, wm, ws, ba, s, bias, wb, bb, wx_planes,
                           valid_len=None):
    return attn_pool_cuda.attention_pooling_plain(
        x, _pool_params(wx, wm, ws, ba, s, bias, wb, bb, wx_planes),
        valid_len)


@attention_pooling.register_fake
def _attention_pooling_fake(x, wx, wm, ws, ba, s, bias, wb, bb, wx_planes,
                            valid_len=None):
    return x.new_empty((x.shape[0], 2 * x.shape[2]), dtype=torch.float32)
