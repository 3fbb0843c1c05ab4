"""The port's feature-file and raw-audio datasets against the JAX
package's, on synthetic trees with the reference's file layouts: the same
items in the same order (features and waveforms equal exactly, names,
tags, labels, channel and device ids equal)."""

import os

import numpy as np
import pytest
import torch

from asvspoof2021_air_tpu.data import datasets as jd
from asvspoof2021_air_tpu.data.audio_io import write_wav
from asvspoof2021_air_tpu_torch.data import datasets as pd
from tests.flac_encoder import encode_flac

D = 60
LA_CH, DEV = "amr[br=10k2,nodtx]", "iPadirRecording-16000.ir"


def save_feat(path, t: int, seed: int, as_pt: bool) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    x = np.random.default_rng(seed).standard_normal((1, t, D)).astype(
        np.float32)
    if as_pt:
        torch.save(torch.from_numpy(x[0]), path + ".pt")   # (T, D)
    else:
        np.save(path + ".npy", x)


def assert_same_items(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert len(got) == len(want)
        assert got[0].dtype == want[0].dtype
        assert np.array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (i, a, b)


@pytest.fixture(scope="module")
def feature_tree(tmp_path_factory):
    """ori/<part>/LFCC, aug/dev/LFCC (LA channels), augdf/dev/LFCC (DF),
    augpa/dev/LFCC (channel + device), eval/LFCC; .npy and .pt mixed."""
    root = tmp_path_factory.mktemp("feats")
    k = 0
    for part, prefix in (("train", "T"), ("dev", "D"), ("eval", "E")):
        for i in range(6):
            label = "bonafide" if i % 3 == 0 else "spoof"
            tag = "-" if label == "bonafide" else f"A0{1 + i % 6}"
            name = f"{i:06d}_LA_{prefix}_{1000 + 7 * i}_{tag}_{label}"
            save_feat(str(root / "ori" / part / "LFCC" / name), 20 + 3 * i,
                      k, as_pt=i % 2 == 1)
            k += 1
    for tree, suffix in (("aug", f"_{LA_CH}"), ("augdf", "_mp3[16k]"),
                         ("augpa", f"_{LA_CH}_{DEV}")):
        for i in range(4):
            label = "bonafide" if i % 2 == 0 else "spoof"
            tag = "-" if label == "bonafide" else "A04"
            name = f"{i:06d}_LA_D_{2000 + i}_{tag}_{label}{suffix}"
            save_feat(str(root / tree / "dev" / "LFCC" / name), 30, k,
                      as_pt=i == 3)
            k += 1
    for i in range(5):
        save_feat(str(root / "eval" / "LFCC" / f"{i:06d}_LA_E_{3000 + i}"),
                  25 + i, k, as_pt=i == 2)
        k += 1
    return root


@pytest.mark.parametrize("part", ["train", "dev", "eval"])
@pytest.mark.parametrize("genuine_only", [False, True])
def test_asvspoof2019_feature_dataset_equals_jax(feature_tree, part,
                                                 genuine_only):
    args = ("LA", str(feature_tree / "ori"), part, "LFCC", genuine_only)
    port, ref = pd.ASVspoof2019FeatureDataset(*args), \
        jd.ASVspoof2019FeatureDataset(*args)
    assert port.files == ref.files
    assert_same_items(port, ref)


@pytest.mark.parametrize("tree,variant,with_device", [
    ("aug", "LA", False), ("augdf", "DF", False), ("augpa", "LA", True)])
def test_augmented_feature_dataset_equals_jax(feature_tree, tree, variant,
                                              with_device):
    args = (str(feature_tree / "ori"), str(feature_tree / tree), "dev",
            "LFCC", variant, with_device)
    port, ref = pd.AugmentedFeatureDataset(*args), \
        jd.AugmentedFeatureDataset(*args)
    assert port.num_original == ref.num_original == 6
    assert_same_items(port, ref)


def test_eval_feature_dataset_and_pt_loading_equal_jax(feature_tree):
    port = pd.EvalFeatureDataset(str(feature_tree / "eval"))
    assert_same_items(port, jd.EvalFeatureDataset(str(feature_tree / "eval")))
    pt = [f for f in port.files if f.endswith(".pt")]
    assert pt and pd.load_feature_file(pt[0]).shape == (1, 27, D)
    with pytest.raises(ValueError, match="LA or PA"):
        pd.ASVspoof2019FeatureDataset("DF", str(feature_tree / "ori"))


def _wave(n: int, seed: int) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).clip(
        -1, 1).astype(np.float32)


def _flac(path, n: int, seed: int) -> None:
    pcm = np.round(_wave(n, seed) * 32767).astype(np.int64)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_flac(pcm, kind="fixed2", block_size=1152))


def _wav(path, n: int, seed: int) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(str(path), _wave(n, seed))


def test_asvspoof2021_eval_raw_dataset_wav_and_flac_equals_jax(tmp_path):
    root = tmp_path / "LA_eval"
    for i in range(5):
        sub = root / ("flac" if i % 2 else "wav") / f"s{i % 2}"
        if i % 2:
            _flac(str(sub / f"LA_E_{9000 - i}.flac"), 2000 + 100 * i, i)
        else:
            _wav(sub / f"LA_E_{9000 - i}.wav", 2000 + 100 * i, i)
    port, ref = pd.ASVspoof2021EvalRawDataset(str(root)), \
        jd.ASVspoof2021EvalRawDataset(str(root))
    assert port.files == ref.files
    assert {os.path.splitext(f)[1] for f in port.files} == {".wav", ".flac"}
    assert_same_items(port, ref)


@pytest.mark.parametrize("with_device", [False, True])
def test_augmented_raw_audio_dataset_equals_jax(tmp_path, with_device):
    proto = tmp_path / "proto"
    proto.mkdir()
    lines = []
    for i in range(3):
        fname = f"LA_D_{4000 + i}"
        suffix = f"_{LA_CH}" + (f"_{DEV}" if with_device else "")
        _wav(tmp_path / "db" / "dev" / f"c{i}" / f"{fname}{suffix}.wav",
             1500 + 50 * i, i)
        lines.append(f"LA_0001 {fname} - {'A07' if i == 2 else '-'} "
                     f"{'spoof' if i == 2 else 'bonafide'}")
    (proto / "ASVspoof2019.LA.cm.dev.trl.txt").write_text("\n".join(lines))
    args = (str(tmp_path / "db"), str(proto), "dev", with_device)
    assert_same_items(pd.AugmentedRawAudioDataset(*args),
                      jd.AugmentedRawAudioDataset(*args))


def test_asvspoof2015_and_vcc2020_raw_datasets_equal_jax(tmp_path):
    db, proto = tmp_path / "db2015", tmp_path / "proto2015"
    proto.mkdir()
    lines = []
    for i, (tag, label) in enumerate([("human", "human"), ("S3", "spoof"),
                                      ("S10", "spoof")]):
        _wav(db / "dev" / f"SPK{i}" / f"D_{i:03d}.wav", 1200, i)
        lines.append(f"SPK{i} D_{i:03d} {tag} {label}")
    (proto / "cm_develop.ndx").write_text("\n".join(lines) + "\n")
    args = (str(db), str(proto), "dev")
    assert_same_items(pd.ASVspoof2015RawDataset(*args),
                      jd.ASVspoof2015RawDataset(*args))

    spoof, bona = tmp_path / "vcc_spoof", tmp_path / "vcc_bona"
    for i in range(2):
        _wav(spoof / f"T{10 + i}" / "TEF1" / f"E3000{i}.wav", 1000, 20 + i)
        _wav(bona / "SEF1" / "wav" / f"E1000{i}.wav", 1100, 30 + i)
    args = (str(spoof), str(bona))
    assert_same_items(pd.VCC2020RawDataset(*args),
                      jd.VCC2020RawDataset(*args))
