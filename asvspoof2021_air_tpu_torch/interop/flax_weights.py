"""ECAPA weights between the JAX package's flax variable tree and the port's
state_dict.

:func:`from_flax_variables` is the inverse of the JAX package's
``interop/torch_port.port_ecapa``: it turns ``{"params", "batch_stats"}``
(numpy arrays, flax names) into the port's state_dict (reference names):

- Conv kernel (K, I, O)        -> Conv1d weight (O, I, K)
- Dense kernel (I, O)          -> Linear weight (O, I), or a 1x1 Conv1d
                                  weight (O, I, 1) inside the SE module
- mfa_kernel (3C, 1536)        -> layer4.weight (1536, 3C, 1)
- attn_kernel (4608, 128)      -> attention.0.weight (128, 4608, 1)
- BatchNorm scale/bias + mean/var -> weight/bias/running_mean/running_var

:func:`random_flax_variables` makes a seeded tree with exactly the names
and shapes ``ECAPA_TDNN(...).init`` gives, so a full-width model can be
built without JAX or a checkpoint.

:func:`from_flax_classifier` does the same for the JAX
``ChannelClassifier`` (``Dense_0``/``Dense_1`` -> ``classifier.0``/``.3``).

:func:`from_flax_train_state` carries a whole JAX ``TrainState`` (ECAPA,
the OC-Softmax center, the ADV_AUG channel classifiers, every Adam's
moments and the step) into the port's checkpoint form (``train/state.py``), so both packages can start
from one mid-training state. It reads the state's arrays through numpy and
imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(sd, name, p):
    sd[name + ".weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    sd[name + ".bias"] = _t(p["bias"])


def _dense(sd, name, p, as_conv1x1=False):
    w = np.asarray(p["kernel"]).T
    sd[name + ".weight"] = _t(w[:, :, None] if as_conv1x1 else w)
    sd[name + ".bias"] = _t(p["bias"])


def _bn(sd, name, p, s):
    sd[name + ".weight"] = _t(p["scale"])
    sd[name + ".bias"] = _t(p["bias"])
    sd[name + ".running_mean"] = _t(s["mean"])
    sd[name + ".running_var"] = _t(s["var"])


def from_flax_variables(variables, model_scale: int = 8
                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``ECAPA_TDNN`` variables -> the port's ``ECAPA_TDNN``
    state_dict (f32 CPU tensors)."""
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
    _bn(sd, "bn7", p["BatchNorm_3"], s["BatchNorm_3"])
    return sd


def random_flax_variables(seed: int, C: int = 512, model_scale: int = 8,
                          n_feat: int = 60, enc_dim: int = 256,
                          n_out: int = 2, stat_noise: float = 0.05):
    """Seeded numpy ECAPA variables in the flax tree's names and shapes.

    Kernels are lecun-normal (std 1/sqrt(fan_in)), biases small; BatchNorm
    scales, biases and running statistics are perturbed by ``stat_noise``
    so the inference affine is not the identity."""
    g = np.random.default_rng(seed)
    width = C // model_scale

    def kernel(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return (g.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def vec(n, base=0.0):
        return (base + stat_noise * g.standard_normal(n)).astype(np.float32)

    def conv(*shape):
        return {"kernel": kernel(*shape), "bias": vec(shape[-1])}

    def bn(n):
        return ({"scale": vec(n, 1.0), "bias": vec(n)},
                {"mean": vec(n),
                 "var": (1.0 + stat_noise * g.random(n)).astype(np.float32)})

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
    params["attn_kernel"] = kernel(3 * 1536, 128)
    params["attn_bias"] = vec(128)
    params["BatchNorm_1"], stats["BatchNorm_1"] = bn(128)
    params["Conv_1"] = conv(1, 128, 1536)
    params["BatchNorm_2"], stats["BatchNorm_2"] = bn(3072)
    params["Dense_0"] = conv(3072, enc_dim)
    params["Dense_1"] = conv(enc_dim, n_out)
    params["BatchNorm_3"], stats["BatchNorm_3"] = bn(n_out)
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


def from_flax_train_state(state, model_scale: int = 8) -> Dict[str, Any]:
    """The JAX ``TrainState`` of an ECAPA run -> the port's checkpoint
    dict (``TrainState.load_state_dict``):

    - params and batch_stats -> ``model`` (the port's state_dict);
    - ``loss_params["center"]`` -> ``loss_module`` ``{"center"}``, or None;
    - the backbone's ``ScaleByAdamState`` (count, mu, nu) ->
      ``optimizer``: per parameter name, ``torch.optim.Adam``'s state
      ``{step, exp_avg, exp_avg_sq}``;
    - ``clf_params``/``clf2_params`` (ADV_AUG) -> ``classifier`` and
      ``classifier2`` state_dicts, their Adam states -> ``clf_optimizer``
      and ``clf2_optimizer``; None where the run has no such classifier;
    - ``step`` -> ``step``.

    The center's SGD and the learning-rate schedules hold no state."""
    bs = state.batch_stats
    model = from_flax_variables({"params": state.params, "batch_stats": bs},
                                model_scale)
    optimizer = _adam(state.opt_state, lambda tree: _param_entries(
        from_flax_variables({"params": tree, "batch_stats": bs},
                            model_scale)))
    loss = (None if state.loss_params is None
            else {"center": _t(state.loss_params["center"])})
    out = {"step": int(np.asarray(state.step)), "model": model,
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
