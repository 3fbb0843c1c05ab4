"""The port's training CLI takes every flag of the JAX package's
``cli/train.py``: the JAX parser's whole flag set, read from its
``_actions``, parses in the port and reaches the same values;
``--test_only`` prints and returns as the JAX CLI does; ``--fused_pool``/
``--fused_bn`` take auto, on and off into the config; ``--visualize``,
``--ensemble`` and ``--num_centers`` are taken.
No tolerances: parsed values are compared exactly."""

import argparse
import os

import pytest

from asvspoof2021_air_tpu.cli.train import build_parser as j_build_parser
from asvspoof2021_air_tpu_torch.cli.train import build_parser, main
from asvspoof2021_air_tpu_torch.cli.train import config_from_args
from asvspoof2021_air_tpu_torch.cli.train import parse_args
from asvspoof2021_air_tpu_torch.train.loop import check_supported

# flags whose JAX values the port refuses (tested below on their own)
REFUSED = set()


def _value(action: argparse.Action):
    """One command-line value for ``action``: 'off' where it is a choice
    (``--fused_pool``/``--fused_bn``), else the first choice that is not
    None, or a number or string of its type."""
    if action.choices:
        if "off" in action.choices:
            return "off"
        return next(str(c) for c in action.choices if c is not None)
    if action.type is int:
        return "3"
    if action.type is float:
        return "0.25"
    if action.dest == "config":
        return None
    return "x"


def _jax_argv(out: str):
    """Every optional flag of the JAX parser once, with a value, and the
    flags that take none."""
    argv = ["-o", out]
    for action in j_build_parser()._actions:
        flag = next((s for s in action.option_strings if s.startswith("--")),
                    None)
        if flag is None or flag in {"--help", "--out_fold"} | REFUSED:
            continue
        if action.nargs == 0:
            argv.append(flag)
        elif action.nargs == "?":               # str2bool flags
            argv += [flag, "true"]
        elif _value(action) is not None:
            argv += [flag, _value(action)]
    return argv


def test_every_jax_flag_parses_in_the_port(tmp_path):
    argv = _jax_argv(str(tmp_path / "o"))
    jax_args = vars(j_build_parser().parse_args(argv))
    port_args = vars(parse_args(argv))
    assert len(argv) > 60
    missing = set(jax_args) - set(port_args)
    assert not missing, missing
    for k, v in jax_args.items():
        assert port_args[k] == v, (k, port_args[k], v)
    # the port's own flags beyond JAX's: its ECAPA widths, the device and
    # TrainConfig's early_stop_patience
    assert set(port_args) - set(jax_args) == {
        "C", "model_scale", "device", "early_stop_patience"}
    cfg = config_from_args(parse_args(argv + ["--add_loss", "ang_iso"]))
    assert (cfg.ensemble, cfg.test_only, cfg.visualize) == (3, True, True)
    assert (cfg.fused_pool, cfg.fused_bn) == ("off", "off")


@pytest.mark.parametrize("flag", ["fused_pool", "fused_bn"])
def test_fused_flags_take_auto_and_on_and_refuse_off(tmp_path, flag):
    """auto, on and off reach the config as given ("auto" by default) and
    pass ``check_supported``; off is no longer refused. A value that is
    not a choice is refused by argparse, and one that reaches a config
    otherwise by ``check_supported``."""
    base = ["-o", str(tmp_path / "o")]
    assert getattr(config_from_args(parse_args(base)), flag) == "auto"
    for value in ("auto", "on", "off"):
        cfg = config_from_args(parse_args(base + [f"--{flag}", value]))
        assert getattr(cfg, flag) == value
        check_supported(cfg)
    with pytest.raises(SystemExit):       # argparse: not a choice
        build_parser().parse_args(base + [f"--{flag}", "maybe"])
    cfg = config_from_args(parse_args(base))
    setattr(cfg, flag, "maybe")
    with pytest.raises(ValueError, match=flag):
        check_supported(cfg)


def test_test_only_prints_and_returns(tmp_path, capsys):
    out = tmp_path / "o"
    main(["-o", str(out), "-f", str(tmp_path / "none"), "--test_only",
          "--device", "cpu"])
    assert "test_only" in capsys.readouterr().out
    assert not os.path.exists(out)        # nothing trained, nothing written


def test_visualize_is_refused_by_name_and_ensemble_is_taken(tmp_path):
    """``--visualize`` is no longer refused: it parses and passes
    ``check_supported`` (tests/test_torch_visualize.py trains with it);
    ``--ensemble`` and ``--num_centers`` are taken."""
    base = ["-o", str(tmp_path / "o"), "-f", str(tmp_path / "none"),
            "-m", "ecapa", "--device", "cpu"]
    cfg = config_from_args(parse_args(base + ["--visualize"]))
    assert cfg.visualize
    check_supported(cfg)
    cfg = config_from_args(parse_args(base + ["--ensemble", "3",
                                              "--num_centers", "5"]))
    assert cfg.ensemble == 3 and not hasattr(cfg, "num_centers")
    check_supported(cfg)
