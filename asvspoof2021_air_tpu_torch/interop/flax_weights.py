"""Model weights between the JAX package's flax variable trees and the
port's state_dicts, for every model family.

:func:`from_flax_variables` is the inverse of the JAX package's
``interop/torch_port.port_ecapa``, ``port_resnet``, ``port_lcnn``,
``port_se_res2net50``, ``port_convnet``, ``port_rawnet`` and
``port_subband``: it turns ``{"params", "batch_stats"}`` (numpy arrays,
flax names) into the port's state_dict (reference names):

- Conv kernel (K, I, O)        -> Conv1d weight (O, I, K)
- Conv kernel (KH, KW, I, O)   -> Conv2d weight (O, I, KH, KW)
- Dense kernel (I, O)          -> Linear weight (O, I), or a 1x1 Conv1d
                                  weight (O, I, 1) inside the SE module
- mfa_kernel (3C, 1536)        -> layer4.weight (1536, 3C, 1)
- attn_kernel (4608, 128)      -> attention.0.weight (128, 4608, 1)
                                  ((1536, 128) without context); Conv_1
                                  (1, 128, 1536 or, for a non-"ECA"
                                  encoder, 1) -> attention.3; no
                                  BatchNorm_3 (bn7) without out_bn
- att_weights (H, 1)           -> attention.att_weights (1, H) (ResNet)
- LCNN's Dense_0 (H W 32, 160), rows in NHWC order (h, w, c)
                               -> out.1.weight (160, 32 H W), columns in
                                  NCHW order (c, h, w); ConvNet's Dense_0
                                  (H W 64, 256) -> fc1.weight alike
- GRULayer wi (C, 3H), wh (H, 3H), bi, bh
                               -> gru.weight_ih_l{k} (3H, C),
                                  weight_hh_l{k} (3H, H), bias_ih_l{k},
                                  bias_hh_l{k} (RawNet2)
- BatchNorm scale/bias + mean/var -> weight/bias/running_mean/running_var
  (an affine-free BN has only the statistics)

:func:`random_flax_variables` makes a seeded tree with exactly the names
and shapes the JAX model's ``init`` gives, for every family, so a
full-width model can be built without JAX or a checkpoint.

:func:`from_flax_classifier` does the same for the JAX
``ChannelClassifier`` (``Dense_0``/``Dense_1`` -> ``classifier.0``/``.3``).

:func:`from_flax_train_state` carries a whole JAX ``TrainState`` (ECAPA,
the loss module's parameters, the ADV_AUG channel classifiers, every
Adam's moments and the step) into the port's checkpoint form (``train/state.py``), so both packages can start
from one mid-training state. It reads the state's arrays through numpy and
imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from asvspoof2021_air_tpu_torch.models.convnet import convnet_extent
from asvspoof2021_air_tpu_torch.models.registry import (
    MODEL_REGISTRY, resnet_nodes)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(sd, name, p):
    sd[name + ".weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    sd[name + ".bias"] = _t(p["bias"])


def _dense(sd, name, p, as_conv1x1=False):
    w = np.asarray(p["kernel"]).T
    sd[name + ".weight"] = _t(w[:, :, None] if as_conv1x1 else w)
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def _conv2d(sd, name, p):
    sd[name + ".weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def _bn(sd, name, p, s):
    """A BatchNorm's entries; ``p`` None for an affine-free one."""
    if p is not None:
        sd[name + ".weight"] = _t(p["scale"])
        sd[name + ".bias"] = _t(p["bias"])
    sd[name + ".running_mean"] = _t(s["mean"])
    sd[name + ".running_var"] = _t(s["var"])


def _check_model(model: str) -> None:
    if model not in (*MODEL_REGISTRY, "subband"):
        raise ValueError(f"unknown model {model!r}; choices: "
                         f"{sorted((*MODEL_REGISTRY, 'subband'))}")


def from_flax_variables(variables, model_scale: int = 8,
                        model: str = "ecapa", num_nodes: int = 60
                        ) -> Dict[str, torch.Tensor]:
    """The JAX model's variables -> the port's state_dict (f32 CPU
    tensors) of ``model``: ``ECAPA_TDNN`` (``model_scale``), ``ResNet``
    ("18"), ``LCNN``, ``SERes2Net50`` ("res2net", layers 3/4/6/3, scale 4),
    ``ConvNet`` ("cnn", either variant), ``RawNet`` ("rawnet") or
    ``Subband`` ("subband"). ``num_nodes``, the input's frequency dim,
    fixes the permutation of the head after a flatten (LCNN, ConvNet, each
    band of Subband)."""
    _check_model(model)
    if model == "resnet":
        return _resnet_from_flax(variables)
    if model == "lcnn":
        return _lcnn_from_flax(variables, num_nodes)
    if model == "res2net":
        return _res2net_from_flax(variables)
    if model == "cnn":
        return _convnet_from_flax(variables, num_nodes)
    if model == "rawnet":
        return _rawnet_from_flax(variables)
    if model == "subband":
        return _subband_from_flax(variables, num_nodes)
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", p["Conv_0"])
    _bn(sd, "bn1", p["BatchNorm_0"], s["BatchNorm_0"])
    for li in range(3):
        t, bp, bs = f"layer{li + 1}", p[f"Bottle2neck_{li}"], \
            s[f"Bottle2neck_{li}"]
        _conv(sd, t + ".conv1", bp["Conv_0"])
        _bn(sd, t + ".bn1", bp["BatchNorm_0"], bs["BatchNorm_0"])
        for j in range(model_scale - 1):
            _conv(sd, f"{t}.convs.{j}", bp[f"Conv_{j + 1}"])
            _bn(sd, f"{t}.bns.{j}", bp[f"BatchNorm_{j + 1}"],
                bs[f"BatchNorm_{j + 1}"])
        _conv(sd, t + ".conv3", bp[f"Conv_{model_scale}"])
        _bn(sd, t + ".bn3", bp[f"BatchNorm_{model_scale}"],
            bs[f"BatchNorm_{model_scale}"])
        se_p, se_s = bp["SEModule1D_0"], bs["SEModule1D_0"]
        _dense(sd, t + ".se.se.1", se_p["Dense_0"], as_conv1x1=True)
        _bn(sd, t + ".se.se.3", se_p["BatchNorm_0"], se_s["BatchNorm_0"])
        _dense(sd, t + ".se.se.4", se_p["Dense_1"], as_conv1x1=True)
    sd["layer4.weight"] = _t(np.asarray(p["mfa_kernel"]).T[:, :, None])
    sd["layer4.bias"] = _t(p["mfa_bias"])
    sd["attention.0.weight"] = _t(np.asarray(p["attn_kernel"]).T[:, :, None])
    sd["attention.0.bias"] = _t(p["attn_bias"])
    _bn(sd, "attention.2", p["BatchNorm_1"], s["BatchNorm_1"])
    _conv(sd, "attention.3", p["Conv_1"])
    _bn(sd, "bn5", p["BatchNorm_2"], s["BatchNorm_2"])
    _dense(sd, "fc6", p["Dense_0"])
    _dense(sd, "fc7", p["Dense_1"])
    if "BatchNorm_3" in p:          # out_bn=False has none
        _bn(sd, "bn7", p["BatchNorm_3"], s["BatchNorm_3"])
    return sd


# ResNet18's flax blocks PreActBlock_0..7: (input channels, planes,
# stride); a block whose shape changes has a projection, flax's Conv_0
RESNET18_BLOCKS = tuple((cin, planes, stride) for cin, planes, stride in (
    (16, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
    (256, 256, 1), (256, 512, 2), (512, 512, 1)))


def _resnet_from_flax(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv2d(sd, "conv1", p["Conv_0"])
    _bn(sd, "bn1", p["BatchNorm_0"], s["BatchNorm_0"])
    for i, (cin, planes, stride) in enumerate(RESNET18_BLOCKS):
        t, bp, bs = f"layer{i // 2 + 1}.{i % 2}", p[f"PreActBlock_{i}"], \
            s[f"PreActBlock_{i}"]
        _bn(sd, t + ".bn1", bp["BatchNorm_0"], bs["BatchNorm_0"])
        _bn(sd, t + ".bn2", bp["BatchNorm_1"], bs["BatchNorm_1"])
        proj = stride != 1 or cin != planes
        if proj:
            _conv2d(sd, t + ".shortcut.0", bp["Conv_0"])
        _conv2d(sd, t + ".conv1", bp[f"Conv_{int(proj)}"])
        _conv2d(sd, t + ".conv2", bp[f"Conv_{int(proj) + 1}"])
    _conv2d(sd, "conv5", p["Conv_1"])
    _bn(sd, "bn5", p["BatchNorm_1"], s["BatchNorm_1"])
    sd["attention.att_weights"] = _t(
        np.asarray(p["SelfAttentionPooling_0"]["att_weights"]).T)
    _dense(sd, "fc", p["Dense_0"])
    _dense(sd, "fc_mu", p["Dense_1"])
    return sd


LCNN_BNS = ("conv2.2", "conv3.3", "conv4.2", "conv6.2", "conv7.2",
            "conv8.2")


def _lcnn_from_flax(variables, num_nodes: int) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(9):
        _conv2d(sd, f"conv{i + 1}.0", p[f"Conv_{i}"])
    for i, name in enumerate(LCNN_BNS):
        _bn(sd, name, None, s[f"BatchNorm_{i}"])
    k = np.asarray(p["Dense_0"]["kernel"])           # (H W 32, 160)
    H = num_nodes // 16
    W = k.shape[0] // (32 * H)
    sd["out.1.weight"] = _t(k.reshape(H, W, 32, -1).transpose(3, 2, 0, 1)
                            .reshape(k.shape[1], -1))
    sd["out.1.bias"] = _t(p["Dense_0"]["bias"])
    _dense(sd, "out.3", p["Dense_1"])
    _dense(sd, "fc_mu", p["Dense_2"])
    return sd


def _res2net_from_flax(variables, layers=(3, 4, 6, 3),
                       scale: int = 4) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i, (conv_name, bn_name) in enumerate((("conv1.0", "conv1.1"),
                                              ("conv1.3", "conv1.4"),
                                              ("conv1.6", "bn1"))):
        _conv2d(sd, conv_name, p[f"Conv_{i}"])
        _bn(sd, bn_name, p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"])
    i = 0
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            sd.update(res2net_block_from_flax(
                {"params": p[f"SEBottle2neck_{i}"],
                 "batch_stats": s[f"SEBottle2neck_{i}"]}, scale,
                f"layer{stage + 1}.{b}."))
            i += 1
    _dense(sd, "cls_layer", p["Dense_0"])
    return sd


def res2net_block_from_flax(variables, scale: int = 4, prefix: str = ""
                            ) -> Dict[str, torch.Tensor]:
    """One JAX ``SEBottle2neck``'s variables -> the port's
    ``SEBottle2neck`` entries, their names prefixed by ``prefix``."""
    bp, bs = variables["params"], variables["batch_stats"]
    nums = 1 if scale == 1 else scale - 1
    sd: Dict[str, torch.Tensor] = {}
    names = ["conv1"] + [f"convs.{j}" for j in range(nums)] + ["conv3"]
    bns = ["bn1"] + [f"bns.{j}" for j in range(nums)] + ["bn3"]
    if f"Conv_{nums + 2}" in bp:
        names.append("downsample.1")
        bns.append("downsample.2")
    for j, (c, n) in enumerate(zip(names, bns)):
        _conv2d(sd, prefix + c, bp[f"Conv_{j}"])
        _bn(sd, prefix + n, bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"])
    _dense(sd, prefix + "se.fc.0", bp["SELayer2D_0"]["Dense_0"])
    _dense(sd, prefix + "se.fc.2", bp["SELayer2D_0"]["Dense_1"])
    return sd


def _convnet_from_flax(variables, num_nodes: int
                       ) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    attention = "SelfAttentionPooling_0" in p
    for i in range(5 if attention else 4):
        _conv2d(sd, f"layer{i + 1}.0", p[f"Conv_{i}"])
        _bn(sd, f"layer{i + 1}.1", p[f"BatchNorm_{i}"],
            s[f"BatchNorm_{i}"])
    if attention:
        sd["attention.att_weights"] = _t(
            np.asarray(p["SelfAttentionPooling_0"]["att_weights"]).T)
        _dense(sd, "fc2", p["Dense_0"])
        _dense(sd, "fc3", p["Dense_1"])
        return sd
    k = np.asarray(p["Dense_0"]["kernel"])           # (H W 64, 256)
    H = convnet_extent(num_nodes, 1)[0]
    W = k.shape[0] // (64 * H)
    sd["fc1.weight"] = _t(k.reshape(H, W, 64, -1).transpose(3, 2, 0, 1)
                          .reshape(k.shape[1], -1))
    sd["fc1.bias"] = _t(p["Dense_0"]["bias"])
    _dense(sd, "fc2", p["Dense_1"])
    _dense(sd, "fc3", p["Dense_2"])
    return sd


def _rawnet_from_flax(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _bn(sd, "first_bn", p["BatchNorm_0"], s["BatchNorm_0"])
    for i in range(6):
        t, bp, bs = f"block{i}.0", p[f"ResidualBlock_{i}"], \
            s[f"ResidualBlock_{i}"]
        bns = ["bn2"] if i == 0 else ["bn1", "bn2"]   # the first: no bn1
        for j, name in enumerate(bns):
            _bn(sd, f"{t}.{name}", bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"])
        for j, name in enumerate(("conv1", "conv2", "conv_downsample")):
            if f"Conv_{j}" in bp:
                _conv(sd, f"{t}.{name}", bp[f"Conv_{j}"])
        _dense(sd, f"fc_attention{i}.0", p[f"FMSAttention_{i}"]["Dense_0"])
    _bn(sd, "bn_before_gru", p["BatchNorm_1"], s["BatchNorm_1"])
    k = 0
    while f"GRULayer_{k}" in p:
        g = p[f"GRULayer_{k}"]
        sd[f"gru.weight_ih_l{k}"] = _t(np.asarray(g["wi"]).T)
        sd[f"gru.weight_hh_l{k}"] = _t(np.asarray(g["wh"]).T)
        sd[f"gru.bias_ih_l{k}"] = _t(g["bi"])
        sd[f"gru.bias_hh_l{k}"] = _t(g["bh"])
        k += 1
    _dense(sd, "fc1_gru", p["Dense_0"])
    _dense(sd, "fc2_gru", p["Dense_1"])
    return sd


def _subband_from_flax(variables, num_nodes: int
                       ) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    n = sum(1 for k in p if k.startswith("LCNN_"))
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n):
        band = _lcnn_from_flax({"params": p[f"LCNN_{i}"],
                                "batch_stats": s[f"LCNN_{i}"]},
                               num_nodes // n)
        sd.update({f"sub{i + 1}.{k}": v for k, v in band.items()})
    return sd


def random_flax_variables(seed: int, C: int = 512, model_scale: int = 8,
                          n_feat: int = 60, enc_dim: int = 256,
                          n_out: int = 2, stat_noise: float = 0.05,
                          model: str = "ecapa", feat_len: int = 750,
                          model_kwargs: Optional[Dict[str, Any]] = None):
    """Seeded numpy variables of the JAX ``model`` in the flax tree's names
    and shapes (ECAPA: ``C``, ``model_scale``; ResNet18 and LCNN at their
    fixed widths; LCNN's head sized for ``feat_len``; ``n_feat`` the input's
    frequency dim; ECAPA's variant fields ``context``, ``encoder_type``
    and ``out_bn`` from ``model_kwargs``, the JAX model's defaults
    otherwise). SE-Res2Net50 ("res2net"), ConvNet ("cnn"), RawNet2
    ("rawnet") and Subband ("subband") take their shapes from the port's
    model built on the CPU with ``model_kwargs`` (ConvNet's
    ``subband_attention``, RawNet2's ``d_args``, Subband's
    ``subband_num``; ``n_out``, ``enc_dim``, ``n_feat`` and ``feat_len``
    where the family takes them), mapped back to the flax names and
    layouts that :func:`from_flax_variables` reads.

    Kernels are lecun-normal (std 1/sqrt(fan_in)), biases small; BatchNorm
    scales, biases and running statistics are perturbed by ``stat_noise``
    so the inference affine is not the identity."""
    _check_model(model)
    g = np.random.default_rng(seed)
    width = C // model_scale

    def kernel(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return (g.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def vec(n, base=0.0):
        return (base + stat_noise * g.standard_normal(n)).astype(np.float32)

    def conv(*shape):
        return {"kernel": kernel(*shape), "bias": vec(shape[-1])}

    def bn_stats(n):
        return {"mean": vec(n),
                "var": (1.0 + stat_noise * g.random(n)).astype(np.float32)}

    def bn(n):
        return {"scale": vec(n, 1.0), "bias": vec(n)}, bn_stats(n)

    if model == "resnet":
        return _random_resnet(kernel, conv, bn, enc_dim, n_out, n_feat)
    if model == "lcnn":
        return _random_lcnn(conv, bn_stats, enc_dim, n_out, n_feat, feat_len)
    if model != "ecapa":
        shapes = _port_shapes(model, n_out, enc_dim, n_feat, feat_len,
                              model_kwargs or {})
        return _FlaxFromShapes(shapes, kernel, vec, bn, bn_stats).build(
            model, n_feat, feat_len)
    params: Dict = {"Conv_0": conv(5, n_feat, C)}
    stats: Dict = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn(C)
    for li in range(3):
        bp: Dict = {"Conv_0": conv(1, C, width * model_scale)}
        bs: Dict = {}
        bp["BatchNorm_0"], bs["BatchNorm_0"] = bn(width * model_scale)
        for j in range(1, model_scale):
            bp[f"Conv_{j}"] = conv(3, width, width)
            bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"] = bn(width)
        bp[f"Conv_{model_scale}"] = conv(1, width * model_scale, C)
        bp[f"BatchNorm_{model_scale}"], bs[f"BatchNorm_{model_scale}"] = bn(C)
        se_bn_p, se_bn_s = bn(128)
        bp["SEModule1D_0"] = {"Dense_0": conv(C, 128),
                              "BatchNorm_0": se_bn_p,
                              "Dense_1": conv(128, C)}
        bs["SEModule1D_0"] = {"BatchNorm_0": se_bn_s}
        params[f"Bottle2neck_{li}"], stats[f"Bottle2neck_{li}"] = bp, bs
    params["mfa_kernel"] = kernel(3 * C, 1536)
    params["mfa_bias"] = vec(1536)
    variant = model_kwargs or {}
    params["attn_kernel"] = kernel(
        3 * 1536 if variant.get("context", True) else 1536, 128)
    params["attn_bias"] = vec(128)
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn(128)
    params["Conv_1"] = conv(
        1, 128, 1536 if variant.get("encoder_type", "ECA") == "ECA" else 1)
    params["BatchNorm_2"], stats["BatchNorm_2"] = bn(3072)
    params["Dense_0"] = conv(3072, enc_dim)
    params["Dense_1"] = conv(enc_dim, n_out)
    if variant.get("out_bn", True):
        params["BatchNorm_3"], stats["BatchNorm_3"] = bn(n_out)
    return {"params": params, "batch_stats": stats}


def _random_resnet(kernel, conv, bn, enc_dim, n_out, n_feat):
    nodes = resnet_nodes(n_feat)
    params: Dict = {"Conv_0": {"kernel": kernel(9, 3, 1, 16)}}
    stats: Dict = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn(16)
    for i, (cin, planes, stride) in enumerate(RESNET18_BLOCKS):
        bp: Dict = {}
        bs: Dict = {}
        bp["BatchNorm_0"], bs["BatchNorm_0"] = bn(cin)
        bp["BatchNorm_1"], bs["BatchNorm_1"] = bn(planes)
        convs = [(3, 3, cin, planes), (3, 3, planes, planes)]
        if stride != 1 or cin != planes:
            convs.insert(0, (1, 1, cin, planes))
        for j, shape in enumerate(convs):
            bp[f"Conv_{j}"] = {"kernel": kernel(*shape)}
        params[f"PreActBlock_{i}"], stats[f"PreActBlock_{i}"] = bp, bs
    params["Conv_1"] = {"kernel": kernel(nodes, 3, 512, 256)}
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn(256)
    params["SelfAttentionPooling_0"] = {"att_weights": kernel(256, 1)}
    params["Dense_0"] = conv(512, enc_dim)
    params["Dense_1"] = conv(enc_dim, n_out)
    return {"params": params, "batch_stats": stats}


def _random_lcnn(conv, bn_stats, enc_dim, n_out, n_feat, feat_len):
    params: Dict = {}
    cin = 1
    for i, (cout, k) in enumerate(((64, 5), (64, 1), (96, 3), (96, 1),
                                   (128, 3), (128, 1), (64, 3), (64, 1),
                                   (64, 3))):
        params[f"Conv_{i}"] = conv(k, k, cin, cout)
        cin = cout // 2
    bn_widths = (32, 48, 48, 64, 32, 32)
    batch_stats = {f"BatchNorm_{i}": bn_stats(n)
                   for i, n in enumerate(bn_widths)}
    flat = 32 * (n_feat // 16) * (feat_len // 16)
    params["Dense_0"] = conv(flat, 160)
    params["Dense_1"] = conv(80, enc_dim)
    params["Dense_2"] = conv(enc_dim, n_out)
    return {"params": params, "batch_stats": batch_stats}


def _port_shapes(model: str, n_out: int, enc_dim: int, n_feat: int,
                 feat_len: int, kwargs: Dict[str, Any]) -> Dict[str, tuple]:
    """name -> shape of the port model's state_dict, built on the CPU."""
    from asvspoof2021_air_tpu_torch.models import (
        ConvNet, RawNet, SERes2Net50, Subband)
    if model == "res2net":
        net = SERes2Net50(num_classes=n_out, device="cpu", **kwargs)
    elif model == "cnn":
        net = ConvNet(num_classes=n_out, enc_dim=enc_dim, feat_dim=n_feat,
                      feat_len=feat_len, device="cpu", **kwargs)
    elif model == "rawnet":
        net = RawNet(device="cpu", **kwargs)
    else:
        net = Subband(num_nodes=n_feat, enc_dim=enc_dim, num_classes=n_out,
                      feat_len=feat_len, device="cpu", **kwargs)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


class _FlaxFromShapes:
    """A seeded flax tree whose every leaf maps, by the layouts of
    :func:`from_flax_variables`, onto the port state_dict ``shapes``."""

    def __init__(self, shapes, kernel, vec, bn, bn_stats):
        self.shapes, self.kernel, self.vec = shapes, kernel, vec
        self.bn_, self.bn_stats = bn, bn_stats

    def _bias(self, name, d):
        if name + ".bias" in self.shapes:
            d["bias"] = self.vec(self.shapes[name + ".bias"][0])
        return d

    def conv2d(self, name):
        o, i, kh, kw = self.shapes[name + ".weight"]
        return self._bias(name, {"kernel": self.kernel(kh, kw, i, o)})

    def conv1d(self, name):
        o, i, k = self.shapes[name + ".weight"]
        return self._bias(name, {"kernel": self.kernel(k, i, o)})

    def dense(self, name):
        o, i = self.shapes[name + ".weight"]
        return self._bias(name, {"kernel": self.kernel(i, o)})

    def bn(self, name):
        """(params or None for an affine-free BN, batch stats)."""
        n = self.shapes[name + ".running_mean"][0]
        if name + ".weight" in self.shapes:
            return self.bn_(n)
        return None, self.bn_stats(n)

    def has(self, name) -> bool:
        return name + ".weight" in self.shapes

    def build(self, model: str, n_feat: int, feat_len: int):
        return getattr(self, "_" + model)(n_feat, feat_len)

    def _put_bn(self, params, stats, key, name):
        p, st = self.bn(name)
        if p is not None:
            params[key] = p
        stats[key] = st

    def _res2net(self, n_feat, feat_len):
        params: Dict = {}
        stats: Dict = {}
        for i, (c, b) in enumerate((("conv1.0", "conv1.1"),
                                    ("conv1.3", "conv1.4"),
                                    ("conv1.6", "bn1"))):
            params[f"Conv_{i}"] = self.conv2d(c)
            self._put_bn(params, stats, f"BatchNorm_{i}", b)
        i = 0
        for stage in range(4):
            b = 0
            while self.has(f"layer{stage + 1}.{b}.conv1"):
                t = f"layer{stage + 1}.{b}."
                nums = sum(1 for k in self.shapes
                           if k.startswith(t + "convs.")
                           and k.endswith(".weight"))
                names = (["conv1"] + [f"convs.{j}" for j in range(nums)]
                         + ["conv3"])
                bns = ["bn1"] + [f"bns.{j}" for j in range(nums)] + ["bn3"]
                if self.has(t + "downsample.1"):
                    names.append("downsample.1")
                    bns.append("downsample.2")
                bp: Dict = {}
                bs: Dict = {}
                for j, (c, n) in enumerate(zip(names, bns)):
                    bp[f"Conv_{j}"] = self.conv2d(t + c)
                    self._put_bn(bp, bs, f"BatchNorm_{j}", t + n)
                bp["SELayer2D_0"] = {"Dense_0": self.dense(t + "se.fc.0"),
                                     "Dense_1": self.dense(t + "se.fc.2")}
                params[f"SEBottle2neck_{i}"] = bp
                stats[f"SEBottle2neck_{i}"] = bs
                i += 1
                b += 1
        params["Dense_0"] = self.dense("cls_layer")
        return {"params": params, "batch_stats": stats}

    def _cnn(self, n_feat, feat_len):
        params: Dict = {}
        stats: Dict = {}
        attention = "attention.att_weights" in self.shapes
        for i in range(5 if attention else 4):
            params[f"Conv_{i}"] = self.conv2d(f"layer{i + 1}.0")
            self._put_bn(params, stats, f"BatchNorm_{i}", f"layer{i + 1}.1")
        dense = ["fc2", "fc3"]
        if attention:
            h = self.shapes["attention.att_weights"][1]
            params["SelfAttentionPooling_0"] = {
                "att_weights": self.kernel(h, 1)}
        else:
            dense.insert(0, "fc1")
        for j, name in enumerate(dense):
            params[f"Dense_{j}"] = self.dense(name)
        return {"params": params, "batch_stats": stats}

    def _rawnet(self, n_feat, feat_len):
        params: Dict = {}
        stats: Dict = {}
        self._put_bn(params, stats, "BatchNorm_0", "first_bn")
        for i in range(6):
            t = f"block{i}.0"
            bp: Dict = {}
            bs: Dict = {}
            bns = ["bn2"] if i == 0 else ["bn1", "bn2"]
            for j, name in enumerate(bns):
                self._put_bn(bp, bs, f"BatchNorm_{j}", f"{t}.{name}")
            for j, name in enumerate(("conv1", "conv2", "conv_downsample")):
                if self.has(f"{t}.{name}"):
                    bp[f"Conv_{j}"] = self.conv1d(f"{t}.{name}")
            params[f"ResidualBlock_{i}"] = bp
            stats[f"ResidualBlock_{i}"] = bs
            params[f"FMSAttention_{i}"] = {
                "Dense_0": self.dense(f"fc_attention{i}.0")}
        self._put_bn(params, stats, "BatchNorm_1", "bn_before_gru")
        k = 0
        while f"gru.weight_ih_l{k}" in self.shapes:
            h3, c = self.shapes[f"gru.weight_ih_l{k}"]
            params[f"GRULayer_{k}"] = {
                "wi": self.kernel(c, h3), "wh": self.kernel(h3 // 3, h3),
                "bi": self.vec(h3), "bh": self.vec(h3)}
            k += 1
        params["Dense_0"] = self.dense("fc1_gru")
        params["Dense_1"] = self.dense("fc2_gru")
        return {"params": params, "batch_stats": stats}

    def _subband(self, n_feat, feat_len):
        params: Dict = {}
        stats: Dict = {}
        i = 1
        while f"sub{i}.fc_mu.weight" in self.shapes:
            band = {k[len(f"sub{i}."):]: v for k, v in self.shapes.items()
                    if k.startswith(f"sub{i}.")}
            sub = _FlaxFromShapes(band, self.kernel, self.vec, self.bn_,
                                  self.bn_stats)
            bp: Dict = {f"Conv_{j}": sub.conv2d(f"conv{j + 1}.0")
                        for j in range(9)}
            bp["Dense_0"] = sub.dense("out.1")
            bp["Dense_1"] = sub.dense("out.3")
            bp["Dense_2"] = sub.dense("fc_mu")
            bs = {f"BatchNorm_{j}": sub.bn(src)[1] for j, src in enumerate(
                ("conv2.2", "conv3.3", "conv4.2", "conv6.2", "conv7.2",
                 "conv8.2"))}
            params[f"LCNN_{i - 1}"] = bp
            stats[f"LCNN_{i - 1}"] = bs
            i += 1
        return {"params": params, "batch_stats": stats}


def from_flax_classifier(params) -> Dict[str, torch.Tensor]:
    """The JAX ``ChannelClassifier``'s params -> the port's
    ``ChannelClassifier`` state_dict (the inverse of the JAX package's
    ``interop/torch_port.port_channel_classifier``)."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "classifier.0", params["Dense_0"])
    _dense(sd, "classifier.3", params["Dense_1"])
    return sd


def _adam(opt_state, to_state_dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """An optax chain's ``ScaleByAdamState`` (count, mu, nu) ->
    ``torch.optim.Adam``'s state ``{step, exp_avg, exp_avg_sq}`` per
    parameter name, the trees mapped by ``to_state_dict``."""
    adam = next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    mu, nu = to_state_dict(adam.mu), to_state_dict(adam.nu)
    count = float(np.asarray(adam.count))
    return {name: {"step": torch.tensor(count), "exp_avg": mu[name],
                   "exp_avg_sq": nu[name]} for name in mu}


def _param_entries(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var"))}


def from_flax_train_state(state, model_scale: int = 8, model: str = "ecapa",
                          num_nodes: int = 60) -> Dict[str, Any]:
    """The JAX ``TrainState`` of a run of ``model`` -> the port's
    checkpoint dict (``TrainState.load_state_dict``):

    - params and batch_stats -> ``model`` (the port's state_dict);
    - ``loss_params`` -> ``loss_module``, the loss module's state_dict
      under the same names and layouts (``center`` of OC-Softmax, Isolate
      and IsolateSquare, ``weight`` of P2SGrad, ``centers`` of AMSoftmax),
      or None;
    - the backbone's ``ScaleByAdamState`` (count, mu, nu) ->
      ``optimizer``: per parameter name, ``torch.optim.Adam``'s state
      ``{step, exp_avg, exp_avg_sq}``;
    - ``clf_params``/``clf2_params`` (ADV_AUG) -> ``classifier`` and
      ``classifier2`` state_dicts, their Adam states -> ``clf_optimizer``
      and ``clf2_optimizer``; None where the run has no such classifier;
    - ``step`` -> ``step``.

    The loss module's SGD and the learning-rate schedules hold no state."""
    bs = state.batch_stats
    to_sd = lambda tree: from_flax_variables(
        {"params": tree, "batch_stats": bs}, model_scale, model, num_nodes)
    optimizer = _adam(state.opt_state,
                      lambda tree: _param_entries(to_sd(tree)))
    loss = (None if state.loss_params is None
            else {k: _t(v) for k, v in state.loss_params.items()})
    out = {"step": int(np.asarray(state.step)), "model": to_sd(state.params),
           "loss_module": loss, "optimizer": optimizer}
    for name, opt_name, params, opt in (
            ("classifier", "clf_optimizer", state.clf_params,
             state.clf_opt_state),
            ("classifier2", "clf2_optimizer", state.clf2_params,
             state.clf2_opt_state)):
        have = params is not None
        out[name] = from_flax_classifier(params) if have else None
        out[opt_name] = _adam(opt, from_flax_classifier) if have else None
    return out
