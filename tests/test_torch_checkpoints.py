"""Systems trained elsewhere, scored by the port, against the JAX scorer
on the same weights (scores within 1e-4, f32 on the CPU):

(a) a JAX TrainState saved by the JAX ``save_checkpoint`` goes through
    ``tools/jax_checkpoint_to_torch.py`` into a port run folder, which the
    port's ``cli.generate_score`` loads and scores;
(b) reference-style PyTorch checkpoints, a state_dict and a whole pickled
    module, load through ``interop/checkpoints`` into the port's ECAPA.
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu.scoring as jscoring
from asvspoof2021_air_tpu.interop.torch_port import port_ecapa
from asvspoof2021_air_tpu.losses.one_class import OCSoftmax as JOCSoftmax
from asvspoof2021_air_tpu.models import registry as j_registry
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.train.checkpoint import save_checkpoint
from asvspoof2021_air_tpu.train.loop import TrainConfig as JConfig
from asvspoof2021_air_tpu.train.loop import setup_training
from asvspoof2021_air_tpu_torch.cli.generate_score import load_system
from asvspoof2021_air_tpu_torch.interop.checkpoints import (
    ecapa_from_state_dict, load_torch_checkpoint)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables, random_flax_variables)
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.scoring import make_score_fn

ROOT = Path(__file__).resolve().parent.parent
C, ENC, T, B = 64, 32, 50, 8
_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_torch", ROOT / "tools" / "jax_checkpoint_to_torch.py")
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)


def jax_model():
    return JECAPA(C=C, model_scale=8, n_out=2, n_feat=60, enc_dim=ENC)


@pytest.fixture(scope="module")
def jax_scorer():
    """One jit of the JAX scorer for the file: (variables, center, feats)
    -> the OC-Softmax score."""
    model, loss = jax_model(), JOCSoftmax(feat_dim=ENC, r_real=0.9,
                                          r_fake=0.2, alpha=20.0)

    @jax.jit
    def score(variables, center, feats):
        emb, logits = model.apply(variables, feats, False)
        return jscoring.score_rule("ocsoftmax", emb, logits, loss,
                                   {"params": {"center": center}})

    return score


def feats(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T, 60)).astype(
        np.float32)


def test_jax_train_state_through_the_converter_scores_as_jax(
        tmp_path, monkeypatch, jax_scorer):
    monkeypatch.setitem(
        j_registry.MODEL_REGISTRY, "ecapa",
        lambda enc_dim=256, nclasses=2, feat_dim=60, **kw: jax_model())
    cfg = JConfig(out_fold=str(tmp_path / "jax"), model="ecapa",
                  add_loss="ocsoftmax", enc_dim=ENC, feat_len=T,
                  r_fake=0.3, path_to_features="/nowhere")
    state = setup_training(cfg, steps_per_epoch=1)[2]
    tree = random_flax_variables(7, C=C, model_scale=8, enc_dim=ENC)
    center = np.random.default_rng(8).uniform(-1, 1, (1, ENC)).astype(
        np.float32)
    state = state.replace(params=tree["params"],
                          batch_stats=tree["batch_stats"],
                          loss_params={"center": center}, step=5)
    os.makedirs(tmp_path / "jax")
    with open(tmp_path / "jax" / "args.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    save_checkpoint(str(tmp_path / "jax" / "best"), state)

    converter.main(["--model_dir", str(tmp_path / "jax"), "--out",
                    str(tmp_path / "port")])
    args = json.load(open(tmp_path / "port" / "args.json"))
    assert (args["C"], args["model_scale"], args["add_loss"],
            args["r_fake"]) == (C, 8, "ang_iso", 0.3)
    # the feature path is a port field since the port trains from
    # features; lambda_ and lr_d since it trains ADV_AUG
    assert args["path_to_features"] == "/nowhere"
    assert (args["lambda_"], args["lr_d"]) == (cfg.lambda_, cfg.lr_d)
    sd, loss_mod, pcfg = load_system(str(tmp_path / "port"), device="cpu")
    assert pcfg.feat_len == T and loss_mod.r_fake == 0.3
    assert torch.load(tmp_path / "port" / "best.pt",
                      weights_only=True)["step"] == 5

    x = feats(1)
    got = make_score_fn(sd, loss_mod, "ang_iso", model_scale=pcfg.model_scale,
                        device="cpu")(x).numpy()
    want = np.asarray(jax_scorer(tree, center, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("form", ["state_dict", "module"])
def test_reference_torch_checkpoint_scores_as_jax(tmp_path, form,
                                                  jax_scorer):
    """Synthetic weights saved as a reference checkpoint would be: a
    state_dict with torch BatchNorm's counters, or a whole pickled module;
    the JAX side gets them through ``port_ecapa``."""
    sd = from_flax_variables(random_flax_variables(11, C=C, model_scale=8,
                                                   enc_dim=ENC))
    path = tmp_path / "ref.pth"
    if form == "module":
        module = ecapa_from_state_dict(sd, device="cpu")
        torch.save(module, path)
    else:
        extra = {k.replace("running_mean", "num_batches_tracked"):
                 torch.tensor(3) for k in sd if k.endswith("running_mean")}
        torch.save({**sd, **extra}, path)
    loaded = load_torch_checkpoint(str(path))
    assert set(loaded) == set(sd)
    model = ecapa_from_state_dict(loaded, device="cpu")
    assert not model.training and model.fc6.out_features == ENC

    center = np.random.default_rng(12).uniform(-1, 1, (1, ENC)).astype(
        np.float32)
    oc = OCSoftmax(feat_dim=ENC, r_real=0.9, r_fake=0.2, alpha=20.0,
                   device="cpu")
    with torch.no_grad():
        oc.center.copy_(torch.from_numpy(center))
    x = feats(2)
    got = make_score_fn(model.state_dict(), oc, "ocsoftmax",
                        device="cpu")(x).numpy()
    variables = port_ecapa({k: v.numpy() for k, v in loaded.items()})
    want = np.asarray(jax_scorer(variables, center, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    with torch.no_grad():
        _emb, logits = model(torch.from_numpy(x))
    assert np.isfinite(logits.numpy()).all()
