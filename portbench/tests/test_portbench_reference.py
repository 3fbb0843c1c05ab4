"""The plain reference against the port's plain versions on the CPU, at
tiny sizes, in float32: LFCC and its padding, ECAPA-TDNN and ResNet18 in
eval and train mode, OC-Softmax and the dual optimizer over first steps;
and the weights' names and shapes against the port's models."""

import pytest
import torch

from portbench.harness import bench, inputs
from portbench.reference import common

TINY = {"ecapa_tdnn_512": {"channels": 32, "feat_len": 40},
        "resnet18_air": {"feat_len": 40}}


def _cfg(name, **over):
    cfg = bench.read_json(bench.HERE / "configs" / f"{name}.json")
    cfg.update(over)
    return cfg, bench.load_file(bench.HERE / "configs" / f"{name}.py", name)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(TINY))
def test_spec_names_and_shapes_are_the_ports(name):
    from asvspoof2021_air_tpu_torch.models.registry import build_model

    cfg, mod = _cfg(name)
    kw = {"C": cfg["channels"], "model_scale": cfg["scale"]} \
        if name.startswith("ecapa") else {}
    model = build_model(cfg["port_model"], enc_dim=cfg["embedding"],
                        feat_dim=cfg["feat_dim"], feat_len=cfg["feat_len"],
                        device="cpu", **kw)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(s) for k, s, _ in mod.param_spec(cfg)
           if not k.startswith("loss.")}
    assert got == want


def test_lfcc_matches_the_port_front_end():
    from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

    cfg, _ = _cfg("ecapa_tdnn_512")
    traffic = {"pool_batches": 1, "batch": 5, "max_samples": 39 * 160,
               "sample_rate": 16000, "bonafide_share": 0.2,
               "lengths": {"median_s": 0.2, "sigma": 0.6, "min_s": 0.05,
                           "max_s": 1.0},
               "signal": {"gain": [0.02, 0.5], "mod_hz": [2.0, 8.0],
                          "mod_depth": 0.8}}
    pool = inputs.wave_pool(traffic, 3, torch.device("cpu"))
    wave, length = pool["wave"][0], pool["length"][0]
    assert int(length.min()) < 39 * 160      # short rows are repeat-padded
    port = OnDeviceFrontend(feat_len=40, padding="repeat", device="cpu")(
        {"wave": wave, "length": length})
    ref = common.repeat_pad(common.lfcc(wave, length, cfg["frontend"]),
                            length, 160, 40)
    assert _rel(port, ref) < 1e-5


def _port_model(name, cfg, weights, train):
    from asvspoof2021_air_tpu_torch.models.registry import build_model

    kw = {"C": cfg["channels"], "model_scale": cfg["scale"]} \
        if name.startswith("ecapa") else {}
    m = build_model(cfg["port_model"], enc_dim=cfg["embedding"],
                    feat_dim=cfg["feat_dim"], feat_len=cfg["feat_len"],
                    device="cpu", **kw)
    m.load_state_dict({k: v for k, v in weights.items()
                       if not k.startswith("loss.")})
    return m.train(train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_model_matches_the_port(name, train):
    cfg, mod = _cfg(name, **TINY[name])
    w = inputs.make_weights(mod.param_spec(cfg), 11, torch.device("cpu"))
    feats = torch.randn(6, 40, 60, generator=torch.Generator().manual_seed(2))
    model = _port_model(name, cfg, w, train)
    noise = mod.train_noise(cfg, 5, 0, 6, 40, torch.device("cpu"))
    args = (feats,) if noise is None or not train else (feats, noise)
    with torch.no_grad():
        emb, logits = model(*args)
        r_emb, r_logits = mod.reference.forward(w, feats, train, noise, cfg)
    assert _rel(emb, r_emb) < 1e-4
    assert _rel(logits, r_logits) < 1e-4


def test_ecapa_serving_graph_matches_the_reference():
    from asvspoof2021_air_tpu_torch.serving.ecapa_serving import ServingECAPA

    cfg, mod = _cfg("ecapa_tdnn_512", **TINY["ecapa_tdnn_512"])
    w = inputs.make_weights(mod.param_spec(cfg), 12, torch.device("cpu"))
    feats = torch.randn(4, 40, 60, generator=torch.Generator().manual_seed(3))
    net = ServingECAPA({k: v for k, v in w.items()
                        if not k.startswith("loss.")}, dtype=torch.float32,
                       device="cpu")
    emb, _ = net(feats)
    r_emb, _ = mod.reference.forward(w, feats, False, None, cfg)
    assert _rel(emb, r_emb) < 1e-4


def test_oc_softmax_matches_the_port():
    from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax

    g = torch.Generator().manual_seed(4)
    emb, center = torch.randn(8, 16, generator=g), torch.randn(1, 16,
                                                              generator=g)
    labels = torch.tensor([0, 1, 1, 1, 0, 1, 1, 1])
    loss = OCSoftmax(16, 0.9, 0.2, 20.0, device="cpu")
    with torch.no_grad():
        loss.center.copy_(center)
        got = loss(emb, labels)
    want = common.oc_softmax(emb, center, labels, 0.9, 0.2, 20.0)
    assert torch.allclose(got[0], want[0]) and torch.allclose(got[1], want[1])


def test_dual_optimizer_matches_the_ports_state():
    from asvspoof2021_air_tpu_torch.train.state import create_train_state

    g = torch.Generator().manual_seed(5)
    model = torch.nn.Linear(4, 3)
    center = torch.nn.Module()
    center.center = torch.nn.Parameter(torch.randn(1, 3, generator=g))
    st = create_train_state(model, center, lambda step: 5e-4)
    p = {"weight": model.weight.detach().clone(),
         "bias": model.bias.detach().clone(),
         "loss.center": center.center.detach().clone()}
    opt = common.DualOptimizer(["weight", "bias"], 5e-4, (0.9, 0.999), 1e-8,
                               5e-4)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        st.zero_grad()
        model.weight.grad, model.bias.grad = grads["weight"], grads["bias"]
        center.center.grad = grads["loss.center"]
        st.apply_gradients()
        p = opt.step(p, grads)
    assert torch.allclose(model.weight, p["weight"], atol=1e-7)
    assert torch.allclose(model.bias, p["bias"], atol=1e-7)
    assert torch.allclose(center.center, p["loss.center"], atol=1e-7)


def test_f32_first_steps_follow_the_reference():
    """The training task's comparison on a float32 program. The first
    step's losses (the forward) agree to round-off; the later steps'
    losses, the first moments and the change after the K steps move by
    Adam's first updates, lr sign(g), where round-off flips the sign of a
    gradient element near zero (here on this seed: the steps' mean loss
    gap 1.8e-4, the median leaf's moment 5.4e-4, the worst leaf's change
    1.6e-3)."""
    over = {"config": {"feat_len": 40, "compute_dtype": "float32"},
            "traffic": {"batch": 8, "pool_batches": 4, "steps_per_call": 4,
                        "feat_len": 40}}
    cell = bench.Cell("resnet18-train-feat-k8", overrides=over)
    dev = torch.device("cpu")
    w = inputs.make_weights(cell.config_module.param_spec(cell.config), 7,
                            dev)
    task = cell.task.Task(cell, 7, dev, w)
    task.setup()
    task.release()
    got = task.numbers()
    assert got["loss1_gap"] < 1e-5
    assert got["loss_gap_mean"] < 5e-3
    assert got["moment_gap_median"] < 5e-3
    assert got["change_gap"] < 5e-3
