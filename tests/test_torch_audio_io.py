"""The port's FLAC reading against the JAX package's: streams from the
test encoder (8/16/24-bit, mono and stereo, every stereo mode, several
block sizes, constant/verbatim/fixed/LPC subframes) decode to exactly the
JAX ``read_flac`` samples and rate, and ``RawAudioDataset`` over a
``flac/`` tree gives the JAX items. Exact equality: both run the same
integer decoder and the same float32 scaling."""

import numpy as np
import pytest

from asvspoof2021_air_tpu.data.audio_io import read_flac as j_read_flac
from asvspoof2021_air_tpu.data.datasets import RawAudioDataset as JRaw
from asvspoof2021_air_tpu_torch.data import audio_io
from asvspoof2021_air_tpu_torch.data.audio_io import flac_decode, load_audio
from asvspoof2021_air_tpu_torch.data.datasets import RawAudioDataset
from asvspoof2021_air_tpu_torch.ops import _host_build
from tests.flac_encoder import crc8, crc16, encode_flac

STREAMINFO_BYTES = 42     # "fLaC", the metadata block header, STREAMINFO
BPS_CODES = {8: 1, 16: 4, 24: 6}


def encode(pcm: np.ndarray, bps: int, block_size: int, kind: str,
           stereo_mode: str = "independent", sample_rate: int = 16000
           ) -> bytes:
    """``encode_flac`` with the frame headers' sample-size code set to
    ``bps`` (the test encoder always writes 16 there) and both CRCs
    recomputed. A frame's length does not depend on its number, so each
    frame is found by encoding its block alone."""
    kw = dict(sample_rate=sample_rate, bps=bps, block_size=block_size,
              kind=kind, stereo_mode=stereo_mode)
    data = bytearray(encode_flac(pcm, **kw))
    if bps == 16:
        return bytes(data)
    pos = STREAMINFO_BYTES
    for start in range(0, len(pcm), block_size):
        n = len(encode_flac(pcm[start:start + block_size], **kw)) \
            - STREAMINFO_BYTES
        frame = data[pos:pos + n]
        frame[3] = (frame[3] & 0xF1) | (BPS_CODES[bps] << 1)
        frame[7] = crc8(bytes(frame[:7]))
        frame[-2:] = crc16(bytes(frame[:-2])).to_bytes(2, "big")
        data[pos:pos + n] = frame
        pos += n
    assert pos == len(data)
    return bytes(data)


def pcm(n: int, bps: int, channels: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    top = (1 << (bps - 1)) - 1
    t = np.arange(n) / 16000
    x = 0.4 * np.sin(2 * np.pi * 330 * t)[:, None] + 0.05 * g.standard_normal(
        (n, channels))
    x[n // 3: n // 3 + 200] = 0.0                   # a digital-silence run
    out = np.clip(np.round(x * top), -top - 1, top).astype(np.int64)
    return out[:, 0] if channels == 1 else out


CASES = [  # (bps, channels, block size, subframe kind, stereo mode)
    (8, 1, 576, "verbatim", "independent"),
    (8, 2, 1152, "fixed1", "independent"),
    (16, 1, 4096, "fixed2", "independent"),
    (16, 1, 1152, "lpc", "independent"),
    (16, 1, 576, "fixed0", "independent"),
    (16, 2, 4096, "fixed2", "mid_side"),
    (16, 2, 1152, "lpc", "left_side"),
    (16, 2, 576, "verbatim", "right_side"),
    (24, 1, 4096, "lpc", "independent"),
    (24, 2, 1152, "fixed2", "mid_side"),
]


@pytest.mark.parametrize("bps,channels,block,kind,mode", CASES)
def test_load_audio_flac_equals_jax_read_flac(tmp_path, bps, channels, block,
                                              kind, mode):
    x = pcm(5000, bps, channels, seed=bps + channels + block)
    path = tmp_path / "a.flac"
    path.write_bytes(encode(x, bps, block, kind, mode))
    samples, sr, got_bps = flac_decode(path.read_bytes())
    assert (sr, got_bps) == (16000, bps)
    np.testing.assert_array_equal(samples, x.reshape(len(x), channels))
    got, got_sr = load_audio(str(path))
    want, want_sr = j_read_flac(str(path))
    assert got_sr == want_sr == 16000
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_flac_constant_subframes_and_resampling_equal_jax(tmp_path):
    """A constant stream, and an 8 kHz stream read at 16 kHz through the
    linear resampler."""
    path = tmp_path / "c.flac"
    path.write_bytes(encode(np.full(3000, -1234, np.int64), 16, 1152,
                            "constant"))
    assert np.array_equal(load_audio(str(path))[0],
                          j_read_flac(str(path))[0])
    path = tmp_path / "r.flac"
    path.write_bytes(encode(pcm(4000, 16, 1, seed=9), 16, 1152, "fixed2",
                            sample_rate=8000))
    got, sr = load_audio(str(path), 16000)
    want, want_sr = j_read_flac(str(path), 16000)
    assert sr == want_sr == 16000 and len(got) == 8000
    assert np.array_equal(got, want)


def test_flac_needs_no_soundfile_and_refuses_malformed_streams(
        monkeypatch, tmp_path):
    monkeypatch.setattr(audio_io, "_sf", None)
    path = tmp_path / "m.flac"
    path.write_bytes(encode(pcm(2000, 16, 1, seed=3), 16, 576, "lpc"))
    assert load_audio(str(path))[0].shape == (2000,)
    path.write_bytes(b"fLaC" + b"\x00" * 100)
    with pytest.raises(ValueError):
        load_audio(str(path))
    with pytest.raises(ValueError):
        flac_decode(b"not a flac file at all, padded to length......")


def test_flac_decoder_is_a_host_library_in_build():
    lib = _host_build.host_library()
    assert lib is _host_build.host_library()
    assert any(p.name.startswith("libasv_host_")
               for p in _host_build.BUILD_DIR.glob("*.so"))
    src = (_host_build.HOST_SRC / "flac_decode.cc").read_text()
    assert "augment.h" not in src and 'extern "C"' in src


def test_raw_dataset_over_flac_tree_equals_jax(tmp_path):
    flac_dir = tmp_path / "LA" / "ASVspoof2019_LA_dev" / "flac"
    proto_dir = tmp_path / "LA" / "ASVspoof2019_LA_cm_protocols"
    flac_dir.mkdir(parents=True)
    proto_dir.mkdir(parents=True)
    lines = []
    for i, (bps, ch, kind) in enumerate([(16, 1, "lpc"), (16, 2, "fixed2"),
                                         (24, 1, "fixed1"), (8, 1, "lpc")]):
        fname = f"LA_D_{1000 + i}"
        (flac_dir / f"{fname}.flac").write_bytes(
            encode(pcm(3000 + 700 * i, bps, ch, seed=i), bps, 1152, kind,
                   "mid_side" if ch == 2 else "independent"))
        lines.append(f"LA_00{i} {fname} - {'A0' + str(i) if i else '-'} "
                     f"{'spoof' if i else 'bonafide'}")
    (proto_dir / "ASVspoof2019.LA.cm.dev.trl.txt").write_text(
        "\n".join(lines) + "\n")
    port, ref = RawAudioDataset("LA", str(tmp_path), "dev"), JRaw(
        "LA", str(tmp_path), "dev")
    assert len(port) == len(ref) == 4
    for i in range(4):
        got, want = port[i], ref[i]
        assert np.array_equal(got[0], want[0])
        assert got[1:] == want[1:]
