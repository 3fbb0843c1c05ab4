"""OPT-IN system-fidelity codec tier for channel augmentation: the port's
own copy of the JAX package's ``data/system_codecs.py``.

The reference's acoustic simulator shells out to external codec binaries
for its VoIP entries (silk/silkwb at 5-30 kbps with 5/10 % loss). The
default tier is the in-repo native ACELP engine (``native/augment``,
through ``data.augment_host``). This module round-trips the silk*/silkwb*
entries through a REAL SILK-lineage codec instead: the machine's libopus
encoder forced into SILK mode (application=voip at SILK bitrates keeps
Opus in its SILK layer, asserted via the packet TOC config) and
libavcodec's native Opus decoder.

Selected with ``cli.degrade channel --fidelity system`` (or ``auto`` where
the libraries load); raises SystemCodecUnavailable, with the native tier
untouched, when libavcodec or libopus is missing. Host only: no tensor
and no device.
"""

from __future__ import annotations

import numpy as np

from asvspoof2021_air_tpu_torch.interop import avcodec as _av


class SystemCodecUnavailable(Exception):
    pass


#: Opus/SILK TOC config values 0-11 are SILK-only frames
#: (RFC 6716 §3.1); >= 12 would mean a hybrid/CELT frame slipped in.
SILK_ONLY_MAX_CONFIG = 11

_OPUS_DECODE_RATE = 48000  # the lavc native Opus decoder always emits 48 kHz


def available() -> bool:
    """True when libavcodec and its libopus encoder are loadable."""
    try:
        av, _ = _av._load()
    except _av.OracleUnavailable:
        return False
    return bool(av.avcodec_find_encoder_by_name(b"libopus")
                and av.avcodec_find_decoder_by_name(b"opus"))


def opus_silk_packets(pcm16: np.ndarray, codec_rate: int,
                      bitrate_kbps: float) -> list[bytes]:
    """Encode mono int16 PCM at ``codec_rate`` into SILK-mode Opus packets
    (20 ms frames, VoIP application, CBR-ish at ``bitrate_kbps``)."""
    try:
        return _av.ff_encode_packets(
            "libopus", pcm16, codec_rate,
            opts={"application": "voip", "b": int(bitrate_kbps * 1000),
                  "frame_duration": "20"},
            frame_samples=codec_rate // 50)
    except _av.OracleUnavailable as e:
        raise SystemCodecUnavailable(str(e))


def silk_mode_fraction(packets: list[bytes]) -> float:
    """Fraction of packets whose TOC marks a SILK-only frame."""
    if not packets:
        return 0.0
    silk = sum(1 for p in packets if p and (p[0] >> 3) <= SILK_ONLY_MAX_CONFIG)
    return silk / len(packets)


def _align_to_input(out: np.ndarray, ref: np.ndarray, rate: int) -> np.ndarray:
    """Codec+resampler chain delay is a few ms and rate-dependent; find it
    by cross-correlation against the clean input and trim, zero-padding the
    tail to the input length (same convention as the native codec hops)."""
    n = min(len(ref), len(out), 4 * rate)
    max_lag = min(rate // 10, max(len(out) - n // 2, 1))
    a = ref[:n].astype(np.float64)
    b = out.astype(np.float64)
    best_lag, best = 0, -np.inf
    for lag in range(0, max_lag, 4):
        seg = b[lag:lag + n]
        if len(seg) < n // 2:
            break
        c = float(np.dot(a[:len(seg)], seg))
        if c > best:
            best, best_lag = c, lag
    # refine around the coarse peak
    for lag in range(max(0, best_lag - 4), best_lag + 5):
        seg = b[lag:lag + n]
        c = float(np.dot(a[:len(seg)], seg))
        if c > best:
            best, best_lag = c, lag
    shifted = out[best_lag:]
    # A broken system decode must not silently become zero-padded silence:
    # require the decode to cover the input up to the fixed codec+resampler
    # delay (a few ms, rate-dependent) before padding the residual tail.
    # Delay-aware rather than a pure ratio so sub-100 ms clips — where the
    # fixed delay is a large fraction of the signal — still pass.
    max_delay = rate // 10 + 256  # cross-corr search span + safety margin
    if len(shifted) < max(len(ref) - max_delay, 0):
        raise SystemCodecUnavailable(
            f"decoded output too short to be a real decode: "
            f"{len(shifted)} of {len(ref)} samples after delay alignment")
    if len(shifted) < len(ref):
        shifted = np.concatenate(
            [shifted, np.zeros(len(ref) - len(shifted), out.dtype)])
    return shifted[:len(ref)]


def opus_silk_channel(wave, codec_rate: int = 8000,
                      bitrate_kbps: float = 12.0,
                      sample_rate: int = 16000) -> np.ndarray:
    """Real-SILK VoIP hop, mirroring augment_host.acelp_channel's
    signature: resample to the codec rate (8000 = silk NB ladder,
    16000 = silkwb), encode with libopus in SILK mode, decode with
    libavcodec's Opus decoder, resample back, delay-align and trim
    to the input length.  float32 waves in [-1, 1]."""
    from asvspoof2021_air_tpu_torch.data import augment_host as ah

    x = np.asarray(wave, np.float32)
    nb = ah.resample(x, sample_rate, codec_rate) if codec_rate != sample_rate else x
    pcm16 = np.clip(np.rint(nb * 32768.0), -32768, 32767).astype(np.int16)
    pkts = opus_silk_packets(pcm16, codec_rate, bitrate_kbps)
    try:
        dec = _av.ff_decode_packets("opus", pkts, codec_rate)
    except _av.OracleUnavailable as e:
        raise SystemCodecUnavailable(str(e))
    out48 = dec.astype(np.float32) / 32768.0
    out = ah.resample(out48, _OPUS_DECODE_RATE, sample_rate)
    return _align_to_input(out, x, sample_rate)
