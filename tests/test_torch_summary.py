"""``models/summary.summarize`` of every family against the JAX model's
parameter table, and JAX runs of ConvNet and RawNet2 through
``tools/jax_checkpoint_to_torch.py``, on the CPU."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asvspoof2021_air_tpu.train.loop as jloop
from asvspoof2021_air_tpu.models.registry import build_model as j_build
from asvspoof2021_air_tpu.models.summary import parameter_table
from asvspoof2021_air_tpu.train.checkpoint import (
    save_checkpoint as j_save_checkpoint)
from asvspoof2021_air_tpu_torch.interop.flax_weights import (
    from_flax_variables)
from asvspoof2021_air_tpu_torch.models.summary import summarize
from test_torch_train_families import (  # noqa: F401  (the fixture)
    ENC, RAWNET_TINY, _fast_jax_init, _two_threads, family_input,
    family_variables, jax_model, port_model)


@pytest.mark.parametrize("family", ["cnn", "rawnet"])
def test_jax_run_through_the_converter(tmp_path, monkeypatch, family):
    """A JAX ConvNet + ang_iso run (feat_len 32) and a JAX RawNet2 run at
    the tiny arguments, converted by ``tools/jax_checkpoint_to_torch.py``:
    the port's run folder keeps the family, the loss, ``feat_len`` and
    ``rawnet_args``, and its checkpoint holds ``from_flax_variables``' map
    of the JAX weights (ConvNet's head permuted) and the step."""
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                     "jax_checkpoint_to_torch.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    _fast_jax_init(monkeypatch)
    T = 32
    add_loss = "ang_iso" if family == "cnn" else None
    cfg = jloop.TrainConfig(out_fold=str(tmp_path / "jax"), model=family,
                            add_loss=add_loss, enc_dim=ENC, feat_len=T,
                            rawnet_args=RAWNET_TINY, on_the_fly=True)
    state = jloop.setup_training(cfg, steps_per_epoch=1)[2]
    x = family_input(family, np.random.default_rng(9), T)
    tree = family_variables(family, x, 9, T)
    state = state.replace(params=tree["params"],
                          batch_stats=tree["batch_stats"], step=3)
    os.makedirs(tmp_path / "jax")
    with open(tmp_path / "jax" / "args.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    j_save_checkpoint(str(tmp_path / "jax" / "best"), state)
    converter.main(["--model_dir", str(tmp_path / "jax"), "--out",
                    str(tmp_path / "port")])
    args = json.load(open(tmp_path / "port" / "args.json"))
    assert (args["model"], args["add_loss"], args["feat_len"],
            args["rawnet_args"]) == (family, add_loss, T, RAWNET_TINY)
    ckpt = torch.load(tmp_path / "port" / "best.pt", weights_only=False)
    want = from_flax_variables(tree, model=family)
    assert ckpt["step"] == 3 and set(ckpt["model"]) == set(want)
    assert all(torch.equal(ckpt["model"][k], want[k]) for k in want)


FAMILIES = {"ecapa": 32, "resnet": 32, "lcnn": 48, "res2net": 24, "cnn": 32,
            "rawnet": 0}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_summarize_counts_equal_jax(family):
    """``summarize`` of each family's port model: its parameter count and
    bytes equal the JAX model's (``parameter_table`` of its init tree) and
    its output shapes the JAX model's; the table is printed and the
    module's BN statistics and mode are left as they were."""
    frames = FAMILIES[family]
    x = family_input(family, np.random.default_rng(3), frames, lead=(2,))
    jm = j_build("ecapa", enc_dim=ENC) if family == "ecapa" \
        else jax_model(family, frames)
    model = port_model(family, frames).eval()
    shapes = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    rows = parameter_table(shapes[1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lines = []
    info = summarize(model, torch.from_numpy(x), train=True,
                     print_fn=lines.append)
    assert info["n_params"] == sum(r[2] for r in rows)
    assert info["n_bytes"] == 4 * info["n_params"]
    assert info["output_shapes"] == [tuple(o.shape) for o in shapes[0]]
    assert len(info["rows"]) == len(list(model.parameters()))
    assert any("Total params" in line for line in lines)
    assert not model.training
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
