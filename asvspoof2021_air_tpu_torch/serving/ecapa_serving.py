"""ECAPA serving forward with the fused CUDA kernels, in its three tiers.

Counterpart of the JAX package's ``serving/ecapa_int8.ecapa_apply_int8``
with ``fused_chain=True``: in the compute type,

- the stem conv k=5, ReLU, inference BN;
- three Bottle2necks, each: 1x1 conv, ReLU, BN; the Res2 chain as kernel
  B2 (``ops/res2_chain_cuda.py``); 1x1 conv, ReLU, BN; the SE gate, whose
  mean over T counts only the first ``valid_len`` rows; the residual;
- the MFA as three products summed, + bias, ReLU;
- the attention pooling as kernel B3 (``ops/attn_pool_cuda.py``), in f32;
- the head (``serving/ecapa_fused.py``).

The stem, 1x1 and MFA products are plain large matrix products (XLA's in
JAX) and run as ``F.conv1d`` / ``torch.matmul``. ``quantize`` picks the
tier, as in JAX: ``False`` keeps every product in the compute type (the
bf16 serving tier); ``True`` runs the six 1x1 convs and the three MFA
products as int8 x int8 -> int32 products (``ops/quantize.qdot``,
``torch._int_mm``) with per-output-channel weight scales, packed once
here, and per-tensor activation scales, dynamic or the static
``act_scales`` of ``serving/ecapa_int8.calibrate_act_scales``; ``"mfa"``
quantizes the MFA products only. The SE products are never quantized.

``valid_len`` marks alignment padding when the caller has some: rows at
and past it are zeroed at the input and masked by every cross-time
statistic, so the float result equals the unpadded forward. The padded
rows still carry values after the stem's bias, and a dynamic activation
scale reads them, as JAX's does when it pads T to a multiple of 8
(``ecapa_int8.ecapa_apply_int8(fused_chain=True)`` pads the same way).

The weights are buffers of the module, so ``torch.export`` carries them
into an artifact; the kernels are custom ops (``ops/custom_ops.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from asvspoof2021_air_tpu_torch._device import disable_tf32, resolve_device
from asvspoof2021_air_tpu_torch.models.common import BN_EPS
from asvspoof2021_air_tpu_torch.ops.attn_pool_cuda import (
    PoolParams, attention_pooling, pack_pool_params)
from asvspoof2021_air_tpu_torch.ops.quantize import qdot, quant_w
from asvspoof2021_air_tpu_torch.ops.res2_chain_cuda import (
    pack_chain_params, res2_chain_infer)
from asvspoof2021_air_tpu_torch.serving.ecapa_fused import Head
from asvspoof2021_air_tpu_torch.utils.profiling import span

DILATIONS = (2, 3, 4)
QUANTIZE = (False, True, "mfa")
# The quantized sites, named as JAX's observer names them.
SITES = tuple(f"b{i}_{io}" for i in range(3) for io in ("in", "out")) + \
    tuple(f"mfa_{i}" for i in range(3))


class _Product(torch.nn.Module):
    """x (..., K) @ w (K, N) in the compute type, or as :func:`qdot` with
    w's int8 codes packed once (stored (N, K), the layout cuBLASLt's int8
    products read fastest) when ``quantize``."""

    def __init__(self, w: torch.Tensor, dtype: torch.dtype, quantize: bool):
        super().__init__()
        self.dtype, self.quantize = dtype, quantize
        if quantize:
            q, s = quant_w(w)
            self.register_buffer("w8", q.t().contiguous())
            self.register_buffer("ws", s)
        else:
            self.register_buffer("w", w.to(dtype))

    def forward(self, x: torch.Tensor, act_scale=None) -> torch.Tensor:
        if self.quantize:
            return qdot(x, self.w8.t(), self.ws, self.dtype, act_scale)
        return x @ self.w


class _Block(torch.nn.Module):
    """One Bottle2neck's buffers."""

    def __init__(self, sd, t: str, dilation: int, scale: int,
                 dtype: torch.dtype, quantize: bool, affine):
        super().__init__()
        self.dilation = dilation
        pw = lambda n: sd[n + ".weight"][:, :, 0].t().contiguous()
        self.conv1 = _Product(pw(t + ".conv1"), dtype, quantize)
        self.conv3 = _Product(pw(t + ".conv3"), dtype, quantize)
        # B2 takes its conv weights in the compute type, its bias and BN
        # affine in f32.
        w, cb, a, b = pack_chain_params(sd, t, scale)
        for name, v in (("chain_w", w.to(dtype)), ("chain_cb", cb),
                        ("chain_a", a), ("chain_b", b),
                        ("b1", sd[t + ".conv1.bias"].to(dtype)),
                        ("b3", sd[t + ".conv3.bias"].to(dtype)),
                        ("se_w1", pw(t + ".se.se.1").to(dtype)),
                        ("se_b1", sd[t + ".se.se.1.bias"].to(dtype)),
                        ("se_w4", pw(t + ".se.se.4").to(dtype)),
                        ("se_b4", sd[t + ".se.se.4.bias"].to(dtype))):
            self.register_buffer(name, v)
        for name, bn in (("bn1", "bn1"), ("bn3", "bn3"), ("se_bn", "se.se.3")):
            a, b = affine(f"{t}.{bn}")
            self.register_buffer(name + "_a", a)
            self.register_buffer(name + "_b", b)

    def chain(self) -> Tuple[torch.Tensor, ...]:
        return self.chain_w, self.chain_cb, self.chain_a, self.chain_b


class ServingECAPA(torch.nn.Module):
    """Weights laid out once for the serving graph; call with (B, T, F)
    features to get (embedding, logits) in f32. ``quantize`` False, True
    or "mfa" picks the tier; ``act_scales`` ({site: scale} for
    :data:`SITES`) makes the quantized tiers' activation scales static."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], *,
                 dtype: torch.dtype = torch.bfloat16, model_scale: int = 8,
                 quantize=False, act_scales: Optional[Dict[str, float]] = None,
                 device="cuda"):
        super().__init__()
        if not any(quantize is q for q in QUANTIZE):
            raise ValueError(f"quantize must be one of {QUANTIZE}, got "
                             f"{quantize!r}")
        self.device = resolve_device(device)
        self.dtype, self.scale, self.quantize = dtype, model_scale, quantize
        sd = {k: v.to(self.device, torch.float32)
              for k, v in state_dict.items()}

        def affine(name):
            inv = sd[name + ".weight"] / torch.sqrt(
                sd[name + ".running_var"] + BN_EPS)
            return (inv.to(dtype), (sd[name + ".bias"]
                                    - sd[name + ".running_mean"] * inv
                                    ).to(dtype))

        self.register_buffer("stem_w", sd["conv1.weight"].to(dtype))
        self.register_buffer("stem_b", sd["conv1.bias"].to(dtype))
        self.register_buffer("bn1_a", affine("bn1")[0])
        self.register_buffer("bn1_b", affine("bn1")[1])
        self.blocks = torch.nn.ModuleList(
            _Block(sd, f"layer{i + 1}", d, model_scale, dtype,
                   quantize is True, affine)
            for i, d in enumerate(DILATIONS))
        C = sd["layer1.conv1.weight"].shape[0]
        mfa = sd["layer4.weight"][:, :, 0].t().contiguous()     # (3 C, N)
        # JAX quantizes each third of the MFA kernel on its own.
        self.mfa = torch.nn.ModuleList(
            _Product(mfa[i * C:(i + 1) * C], dtype, quantize is not False)
            for i in range(3))
        self.register_buffer("mfa_b", sd["layer4.bias"].to(dtype))
        for name, v in pack_pool_params(sd)._asdict().items():
            self.register_buffer("pool_" + name, v)
        self.head = Head(sd, dtype)
        self.calibrated = act_scales is not None
        if self.calibrated:
            unknown = set(act_scales) - set(SITES)
            if unknown:
                raise ValueError(f"act_scales: unknown sites {sorted(unknown)}"
                                 f"; the sites are {SITES}")
            for site, v in act_scales.items():
                # JAX's jnp.asarray(scale, f32): the float rounded to f32
                self.register_buffer(f"scale_{site}", torch.tensor(
                    float(v), dtype=torch.float32, device=self.device))
        # Every buffer its own contiguous copy: torch.export saves buffers
        # that share a storage (the MFA's thirds, slices of the attention's
        # kernel) or are strided views as partial views of a storage, which
        # it warns may not load right off the CPU.
        for mod in self.modules():
            for name, buf in list(mod.named_buffers(recurse=False)):
                setattr(mod, name,
                        buf.clone(memory_format=torch.contiguous_format))

    def _site(self, site: str, v: torch.Tensor, observer):
        """The static activation scale of ``site`` (None: dynamic), after
        handing the activation to ``observer``."""
        if observer is not None:
            observer(site, v)
        return getattr(self, f"scale_{site}") if self.calibrated else None

    def _block(self, i: int, blk: _Block, x: torch.Tensor, t_sem: int,
               observer) -> torch.Tensor:
        # JAX's observer sees the 1x1 sites only where they are quantized.
        site = (lambda s, v: self._site(s, v, observer)) \
            if self.quantize is True else (lambda s, v: None)
        out = blk.conv1(x, site(f"b{i}_in", x)) + blk.b1
        out = torch.relu(out) * blk.bn1_a + blk.bn1_b
        out = res2_chain_infer(out, *blk.chain(), dilation=blk.dilation,
                               scale=self.scale, valid_len=t_sem)
        out = blk.conv3(out, site(f"b{i}_out", out)) + blk.b3
        out = torch.relu(out) * blk.bn3_a + blk.bn3_b
        y = out[:, :t_sem].sum(dim=1) / t_sem
        y = torch.relu(y @ blk.se_w1 + blk.se_b1) * blk.se_bn_a + blk.se_bn_b
        y = torch.sigmoid(y @ blk.se_w4 + blk.se_b4)
        return out * y[:, None, :] + x

    def forward(self, feats: torch.Tensor, valid_len: Optional[int] = None,
                observer: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding, logits) of (B, T, F) features; ``observer(site,
        activation)`` sees each quantized site's input, as JAX's does."""
        if self.dtype == torch.float32:
            disable_tf32()
        with span("asv.trunk"):
            x = feats.to(self.device, self.dtype)
            T = x.shape[1]
            t_sem = T if valid_len is None else int(valid_len)
            if t_sem != T:
                keep = torch.arange(T, device=self.device) < t_sem
                x = x * keep[None, :, None].to(self.dtype)
            x = F.conv1d(x.transpose(1, 2), self.stem_w,
                         padding=2).transpose(1, 2)
            x = (torch.relu(x + self.stem_b) * self.bn1_a
                 + self.bn1_b).contiguous()
            xs = []
            for i, blk in enumerate(self.blocks):
                x = self._block(i, blk, x, t_sem, observer)
                xs.append(x)
            acc = None
            for i, (xi, prod) in enumerate(zip(xs, self.mfa)):
                term = prod(xi, self._site(f"mfa_{i}", xi, observer))
                acc = term if acc is None else acc + term
            x = torch.relu(acc + self.mfa_b)
        with span("asv.pool"):
            pool = PoolParams(*(getattr(self, "pool_" + f)
                                for f in PoolParams._fields))
            pooled = attention_pooling(x, pool, valid_len=t_sem)
        return self.head(pooled)


def ecapa_apply_serving(state_dict: Dict[str, torch.Tensor],
                        feats: torch.Tensor, *,
                        dtype: torch.dtype = torch.bfloat16,
                        valid_len: Optional[int] = None, model_scale: int = 8,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(embedding, logits) for ECAPA inference through the fused kernels,
    from the port's ECAPA state_dict. For repeated calls build
    :class:`ServingECAPA` once."""
    model = ServingECAPA(state_dict, dtype=dtype, model_scale=model_scale,
                         device=device)
    return model(feats, valid_len=valid_len)
