"""Port scoring slice against the JAX package: the OC-Softmax loss and
score, the front-end's padding policies, and waveform -> score file end to
end on a synthetic corpus (f32 on the CPU)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asvspoof2021_air_tpu.data.audio_io import write_wav
from asvspoof2021_air_tpu.data.datasets import RawAudioDataset as JRawDataset
from asvspoof2021_air_tpu.losses.one_class import OCSoftmax as JOCSoftmax
from asvspoof2021_air_tpu.metrics import eer_from_score_file as j_eer
from asvspoof2021_air_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from asvspoof2021_air_tpu.scoring import score_raw_to_file as j_score_raw
from asvspoof2021_air_tpu.scoring import score_rule as j_score_rule
from asvspoof2021_air_tpu.train.frontend import OnDeviceFrontend as JFrontend
from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
from asvspoof2021_air_tpu_torch.interop.flax_weights import from_flax_variables
from asvspoof2021_air_tpu_torch.losses.one_class import OCSoftmax
from asvspoof2021_air_tpu_torch.metrics.eer import eer_from_score_file
from asvspoof2021_air_tpu_torch.scoring import score_raw_to_file, score_rule
from asvspoof2021_air_tpu_torch.train.frontend import OnDeviceFrontend

ENC = 32


def _oc_pair(center, **kw):
    port = OCSoftmax(feat_dim=center.shape[1], **kw, device="cpu")
    with torch.no_grad():
        port.center.copy_(torch.from_numpy(center))
    return JOCSoftmax(feat_dim=center.shape[1], **kw), port


def test_ocsoftmax_loss_and_score_match_jax():
    g = np.random.default_rng(0)
    center = g.uniform(-2, 2, (1, ENC)).astype(np.float32)
    emb = g.standard_normal((16, ENC)).astype(np.float32)
    labels = (np.arange(16) % 2).astype(np.int32)
    jmod, port = _oc_pair(center, r_real=0.9, r_fake=0.2, alpha=20.0)
    want_loss, want_score = jmod.apply(
        {"params": {"center": jnp.asarray(center)}}, jnp.asarray(emb),
        jnp.asarray(labels))
    loss, score = port(torch.from_numpy(emb), torch.from_numpy(labels))
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(want_score),
                               atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)


def test_default_score_rule_and_unported_rules():
    logits = np.random.default_rng(1).standard_normal((5, 2)).astype(
        np.float32)
    want = j_score_rule(None, None, jnp.asarray(logits))
    got = score_rule(None, torch.zeros(5, ENC), torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(NotImplementedError):
        score_rule("amsoftmax", torch.zeros(5, ENC), torch.zeros(5, 2))


@pytest.mark.parametrize("padding", ["repeat", "zero", "silence"])
def test_frontend_padding_matches_jax(padding):
    feat_len = 40
    g = np.random.default_rng(2)
    wave = (0.3 * g.standard_normal((3, 7000))).astype(np.float32)
    lengths = np.array([7000, 3000, 900], np.int32)
    jfe = JFrontend(feat_len=feat_len, padding=padding, use_pallas=False)
    want = np.asarray(jfe({"wave": jnp.asarray(wave),
                           "length": jnp.asarray(lengths)},
                          jax.random.PRNGKey(0)))
    fe = OnDeviceFrontend(feat_len=feat_len, padding=padding, device="cpu")
    got = fe({"wave": torch.from_numpy(wave),
              "length": torch.from_numpy(lengths)}).numpy()
    assert got.shape == want.shape == (3, feat_len, 60)
    np.testing.assert_allclose(got, want, atol=5e-4)


def _corpus(root, lengths, seed=0):
    """ASVspoof2019-layout wav corpus: bona fide noise, spoof tones."""
    g = np.random.default_rng(seed)
    wav_dir = root / "LA" / "ASVspoof2019_LA_eval" / "wav"
    proto = root / "LA" / "ASVspoof2019_LA_cm_protocols"
    wav_dir.mkdir(parents=True)
    proto.mkdir(parents=True)
    lines = []
    for i, n in enumerate(lengths):
        label = i % 2
        wav = 0.2 * g.standard_normal(n)
        if label:
            wav = 0.3 * np.sin(2 * np.pi * (500 + 40 * i) * np.arange(n)
                               / 16000) + 0.01 * wav
        write_wav(str(wav_dir / f"LA_E_{i:07d}.wav"), wav)
        lines.append(f"LA_0001 LA_E_{i:07d} - {'A07' if label else '-'} "
                     f"{'spoof' if label else 'bonafide'}")
    (proto / "ASVspoof2019.LA.cm.eval.trl.txt").write_text(
        "\n".join(lines) + "\n")


def test_slice_end_to_end_score_file_matches_jax(tmp_path):
    """Waveforms -> LFCC -> ECAPA -> OC-Softmax -> score file, both
    packages from the same weights and center. Utterances longer than the
    buffer are cropped with the same seeded draws; shorter ones are
    repeat-padded. Scores agree within 1e-4 (f32, the fused serving graph
    against the JAX model's unfused one) and the EERs are equal."""
    feat_len, bs = 60, 4
    max_samples = (feat_len - 1) * 160
    _corpus(tmp_path, [max_samples + 3000, 5000, max_samples, 2000,
                       max_samples + 900, 7000])
    model = JECAPA(C=64, model_scale=8, n_out=2, n_feat=60, enc_dim=ENC)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((2, feat_len, 60)), False)
    variables = jax.tree.map(
        lambda v: v + 0.05 * jnp.asarray(
            np.random.default_rng(1).standard_normal(v.shape), v.dtype),
        variables)
    center = np.random.default_rng(2).uniform(-2, 2, (1, ENC)).astype(
        np.float32)
    jmod, port_oc = _oc_pair(center, r_real=0.9, r_fake=0.2, alpha=20.0)

    want_path = j_score_raw(
        model, variables, JRawDataset("LA", str(tmp_path), "eval"),
        str(tmp_path / "jax_scores.txt"), labeled=True,
        frontend=JFrontend(feat_len=feat_len, padding="repeat",
                           use_pallas=False),
        loss_module=jmod, loss_vars={"params": {"center": center}},
        add_loss="ocsoftmax", batch_size=bs)
    got_path = score_raw_to_file(
        from_flax_variables(jax.tree.map(np.asarray, variables)),
        RawAudioDataset("LA", str(tmp_path), "eval"),
        str(tmp_path / "port_scores.txt"), labeled=True,
        frontend=OnDeviceFrontend(feat_len=feat_len, padding="repeat",
                                  device="cpu"),
        loss_module=port_oc, add_loss="ocsoftmax", batch_size=bs,
        dtype=torch.float32, device="cpu")

    want = [line.split() for line in open(want_path)]
    got = [line.split() for line in open(got_path)]
    assert len(got) == len(want) == 6
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got],
                               [float(r[1]) for r in want], atol=1e-4)
    assert eer_from_score_file(got_path) == j_eer(want_path)
    assert os.path.getsize(got_path) > 0
