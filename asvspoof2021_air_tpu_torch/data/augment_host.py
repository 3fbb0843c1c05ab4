"""The host codec tier: the native codec library over numpy float32 buffers.

The port's own binding of ``native/augment`` (the JAX package's
``data/augment_host.py``, function for function, with the same names,
signatures and buffers). The library is compiled read-only from the repo's
``native/`` sources by :func:`ops._host_build.codec_library` on first use,
with the Makefile's flags, so every function here computes bit for bit
what the JAX binding computes on the same machine. Host only: nothing here
imports torch or touches a device, so ``cli.degrade``'s worker processes
load without torch and never start CUDA.
"""

from __future__ import annotations

import ctypes

import numpy as np

_FloatPtr = ctypes.POINTER(ctypes.c_float)
_U8Ptr = ctypes.POINTER(ctypes.c_uint8)


def get_lib() -> ctypes.CDLL:
    """The codec library, built on first use, every entry point's ctypes
    signature set (``_host_build.CODEC_SIGNATURES``)."""
    from asvspoof2021_air_tpu_torch.ops._host_build import codec_library
    return codec_library()


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _ptr(x: np.ndarray):
    return x.ctypes.data_as(_FloatPtr)


def _u8(x: np.ndarray):
    return x.ctypes.data_as(_U8Ptr)


def g711_roundtrip(wave, law: str = "u") -> np.ndarray:
    x = _as_f32(wave)
    out = np.empty_like(x)
    fn = (get_lib().g711_ulaw_roundtrip if law == "u"
          else get_lib().g711_alaw_roundtrip)
    fn(_ptr(x), _ptr(out), x.size)
    return out


def g726_encode(wave, bits_per_sample: int = 4) -> np.ndarray:
    """Encode 8 kHz float audio to G.726 codes, one code per byte."""
    x = _as_f32(wave)
    out = np.zeros(x.size, np.uint8)
    get_lib().g726_encode(_ptr(x), x.size, int(bits_per_sample), _u8(out))
    return out


def g726_decode(codes, bits_per_sample: int = 4) -> np.ndarray:
    """Decode one-code-per-byte G.726 to 8 kHz float audio."""
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.empty(codes.size, np.float32)
    get_lib().g726_decode(_u8(codes), codes.size, int(bits_per_sample),
                          _ptr(out))
    return out


def g726_roundtrip(wave, bits_per_sample: int = 4) -> np.ndarray:
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().g726_roundtrip(_ptr(x), _ptr(out), x.size, bits_per_sample)
    return out


def resample(wave, in_rate: int, out_rate: int, taps: int = 33) -> np.ndarray:
    x = _as_f32(wave)
    n_out = int(np.ceil(x.size * out_rate / in_rate)) + taps
    out = np.zeros(n_out, np.float32)
    written = get_lib().resample_sinc(_ptr(x), x.size, _ptr(out),
                                      in_rate, out_rate, taps)
    return out[:written]


def fft_convolve(wave, ir) -> np.ndarray:
    x = _as_f32(wave)
    h = _as_f32(ir)
    out = np.empty_like(x)
    get_lib().fft_convolve(_ptr(x), x.size, _ptr(h), h.size, _ptr(out))
    return out


def rms_normalize(wave, target_dbfs: float) -> np.ndarray:
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().rms_normalize(_ptr(x), _ptr(out), x.size, float(target_dbfs))
    return out


CODEC_IDS = {"g711u": 0, "g711a": 1, "g726_16k": 2, "g726_24k": 3,
             "g726_32k": 4, "g726_40k": 5, "gsmfr": 6}


def telephony_channel(wave, codec: str = "g711u",
                      sample_rate: int = 16000) -> np.ndarray:
    """Full landline hop: resample to 8 kHz, codec round trip, resample
    back."""
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().telephony_channel(_ptr(x), _ptr(out), x.size, sample_rate,
                                CODEC_IDS[codec])
    return out


def acelp_channel(wave, codec_rate: int = 8000, bitrate_kbps: float = 12.2,
                  sample_rate: int = 16000) -> np.ndarray:
    """Analysis-by-synthesis ACELP hop: resample to the codec rate (8000 =
    AMR-NB/SILK-NB ladder, 16000 = AMR-WB/SILK-WB), code with the mode's
    pulse density, resample back."""
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().acelp_channel(_ptr(x), _ptr(out), x.size, sample_rate,
                            codec_rate, bitrate_kbps)
    return out


# AMR-NB storage frame sizes (bytes incl. TOC) for modes 0..7
AMRNB_MODE_BYTES = (13, 14, 16, 18, 20, 21, 27, 32)
AMRNB_MODE_NAMES = ("4k75", "5k15", "5k9", "6k7", "7k4", "7k95", "10k2",
                    "12k2")

# AMR-WB storage frame sizes (bytes incl. TOC) for modes 0..8
AMRWB_MODE_BYTES = (18, 24, 33, 37, 41, 47, 51, 59, 61)
AMRWB_MODE_NAMES = ("6k60", "8k85", "12k65", "14k25", "15k85", "18k25",
                    "19k85", "23k05", "23k85")


def _count_frames(data: bytes, sizes: dict) -> int:
    """Frames in a storage stream by walking its TOCs (DTX streams carry
    1-byte NO_DATA and 6-byte SID frames); an unknown frame type counts
    every byte, so the decoder sees room enough to reject it."""
    nframes, pos = 0, 0
    while pos < len(data):
        step = sizes.get((data[pos] >> 3) & 0x0F)
        if step is None:
            return len(data)
        nframes += 1
        pos += step
    return nframes


def _codec_hop(roundtrip, wave, sample_rate: int, codec_rate: int
               ) -> np.ndarray:
    """Resample to ``codec_rate``, ``roundtrip(x, out)``, resample back,
    trimmed or zero-padded to the input's length."""
    x = _as_f32(wave)
    if sample_rate != codec_rate:
        x = _as_f32(resample(x, sample_rate, codec_rate))
    out = np.empty_like(x)
    roundtrip(x, out)
    if sample_rate != codec_rate:
        out = resample(out, codec_rate, sample_rate)[: np.asarray(wave).size]
        pad = np.asarray(wave).size - out.size
        if pad > 0:
            out = np.concatenate([out, np.zeros(pad, np.float32)])
    return out


def amrwb_encode(wave, dtx: bool = False, mode: int = 2) -> bytes:
    """Encode 16 kHz float mono to AMR-WB storage frames at the given
    TS 26.201 mode (0 = 6.60k .. 8 = 23.85k; RFC 4867 octet-aligned
    framing); with ``dtx`` silence runs carry SID updates (type 9) and
    NO_DATA frames."""
    lib = get_lib()
    sig = np.ascontiguousarray(wave, np.float32)
    out = np.zeros((len(sig) // 320 + 4) * 61, np.uint8)
    enc = lib.amrwb_encode_dtx_mode if dtx else lib.amrwb_encode_mode
    n = enc(mode, _ptr(sig), len(sig), _u8(out))
    return bytes(out[:max(n, 0)].tobytes())


def amrwb_decode(data: bytes) -> np.ndarray:
    """Decode AMR-WB storage frames (any of the 9 modes, SID, NO_DATA) to
    16 kHz float mono."""
    buf = np.frombuffer(data, np.uint8)
    sizes = {m: AMRWB_MODE_BYTES[m] for m in range(9)}
    sizes.update({9: 6, 15: 1})
    out = np.zeros(max(_count_frames(data, sizes), 1) * 320, np.float32)
    n = get_lib().amrwb_decode(_u8(buf), len(buf), _ptr(out), len(out))
    return out[:max(n, 0)].copy()


def amrwb_channel(wave, sample_rate: int = 16000,
                  dtx: bool = False, mode: int = 2) -> np.ndarray:
    """Real AMR-WB hop at the given mode: resample to 16 kHz, full
    bitstream round trip (VAD/SID-gated when ``dtx``), resample back."""
    lib = get_lib()
    rt = lib.amrwb_roundtrip_dtx_mode if dtx else lib.amrwb_roundtrip_mode
    return _codec_hop(lambda x, out: rt(mode, _ptr(x), _ptr(out), x.size),
                      wave, sample_rate, 16000)


def amrnb_encode(wave, mode: int = 7, dtx: bool = False) -> bytes:
    """Encode 8 kHz float mono to AMR-NB storage frames at the given mode
    (0..7 = 4.75..12.2 kbps; RFC 4867 octet-aligned framing); with ``dtx``
    the stream is VAD-gated (SID type 8, NO_DATA type 15)."""
    if not 0 <= mode <= 7:
        raise ValueError(f"AMR-NB mode {mode} out of range")
    lib = get_lib()
    x = _as_f32(wave)
    out = np.zeros(((x.size + 159) // 160) * AMRNB_MODE_BYTES[mode],
                   np.uint8)
    enc = lib.amrnb_encode_dtx if dtx else lib.amrnb_encode_mode
    n = enc(mode, _ptr(x), x.size, _u8(out))
    if n < 0:
        raise ValueError(f"AMR-NB encode failed (mode {mode})")
    return bytes(out[:n])


def amrnb_decode(data: bytes) -> np.ndarray:
    """Decode AMR-NB storage frames (any mode, per-frame TOC dispatch) to
    8 kHz float mono."""
    buf = np.frombuffer(data, np.uint8)
    sizes = {8: 6, 15: 1}
    sizes.update({m: b for m, b in enumerate(AMRNB_MODE_BYTES)})
    out = np.zeros(max(_count_frames(data, sizes), 1) * 160, np.float32)
    n = get_lib().amrnb_decode_any(_u8(buf), buf.size, _ptr(out), out.size)
    if n < 0:
        raise ValueError("not a decodable AMR-NB stream")
    return out[:n]


def amrnb_channel(wave, sample_rate: int = 16000, mode: int = 7,
                  dtx: bool = False) -> np.ndarray:
    """Real AMR-NB telephony hop: resample to 8 kHz, full bitstream round
    trip at the given mode (VAD/SID-gated when ``dtx``), resample back."""
    lib = get_lib()
    rt = lib.amrnb_roundtrip_dtx if dtx else lib.amrnb_roundtrip_mode
    return _codec_hop(lambda x, out: rt(mode, _ptr(x), _ptr(out), x.size),
                      wave, sample_rate, 8000)


def mdct_codec(wave, bitrate_kbps: float, kind: str = "mp3",
               sample_rate: int = 16000) -> np.ndarray:
    """Transform-codec round trip: MDCT band quantization under the mode's
    bit budget (mp3: 576-coefficient granules, aac: 1024)."""
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().mdct_codec_roundtrip(_ptr(x), _ptr(out), x.size, sample_rate,
                                   bitrate_kbps,
                                   576 if kind == "mp3" else 1024)
    return out


def mp3_codec(wave, bitrate_kbps: float,
              sample_rate: int = 16000) -> np.ndarray:
    """Real MPEG Layer III round trip (encoder + decoder; 16 kHz runs
    MPEG-2 LSF at 8..160 kbps), delay-aligned with the input."""
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().mp3_roundtrip(_ptr(x), _ptr(out), x.size, sample_rate,
                            bitrate_kbps)
    return out


def _encode_bytes(kind: str, wave, bitrate_kbps: int,
                  sample_rate: int) -> bytes:
    lib = get_lib()
    x = _as_f32(wave)
    cap = getattr(lib, f"{kind}_encode_bound")(x.size, sample_rate,
                                               int(bitrate_kbps))
    buf = (ctypes.c_uint8 * cap)()
    n = getattr(lib, f"{kind}_encode")(_ptr(x), x.size, sample_rate,
                                       int(bitrate_kbps), buf, cap)
    if n < 0:
        raise ValueError(f"unsupported {kind} config: {sample_rate} Hz @ "
                         f"{bitrate_kbps} kbps")
    return bytes(buf[:n])


def _decode_bytes(kind: str, data: bytes, min_out: int, per_byte: int,
                  what: str):
    arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = np.zeros(max(min_out, len(data) * per_byte), np.float32)
    sr = ctypes.c_int(0)
    n = getattr(get_lib(), f"{kind}_decode")(
        ctypes.cast(arr, _U8Ptr), len(data), _ptr(out), out.size,
        ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"malformed {what} stream")
    return out[:n], sr.value


def mp3_encode(wave, bitrate_kbps: int, sample_rate: int = 16000) -> bytes:
    """Encode to .mp3 bytes (valid standard frames)."""
    return _encode_bytes("mp3", wave, bitrate_kbps, sample_rate)


def mp3_decode(data: bytes):
    """Decode .mp3 bytes -> (float32 pcm, sample_rate)."""
    return _decode_bytes("mp3", data, 4096, 60, "mp3")


def aac_codec(wave, bitrate_kbps: float,
              sample_rate: int = 16000) -> np.ndarray:
    """Real AAC-LC round trip (sine-window MDCT, scalefactor search,
    Huffman books, ADTS framing), delay-aligned with the input."""
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().aac_roundtrip(_ptr(x), _ptr(out), x.size, sample_rate,
                            bitrate_kbps)
    return out


def aac_encode(wave, bitrate_kbps: int, sample_rate: int = 16000) -> bytes:
    """Encode to AAC-LC ADTS bytes (valid standard frames)."""
    return _encode_bytes("aac", wave, bitrate_kbps, sample_rate)


def aac_decode(data: bytes):
    """Decode AAC-LC ADTS bytes -> (float32 pcm, sample_rate); covers the
    encoder's emission set (mono SCE, long sine windows)."""
    return _decode_bytes("aac", data, 8192, 120, "aac")


def frame_erasure(wave, loss_pct: float, seed: int = 0,
                  frame: int = 320) -> np.ndarray:
    """Packet loss for the SILK loss=N variants: each 20 ms frame is
    dropped with probability loss_pct/100 and concealed by repeating the
    previous frame."""
    x = _as_f32(wave).copy()
    g = np.random.default_rng(seed)
    prev = np.zeros(frame, np.float32)
    for pos in range(0, len(x) - frame + 1, frame):
        if g.random() * 100.0 < loss_pct:
            x[pos:pos + frame] = prev
        else:
            prev = x[pos:pos + frame]
    return x


def gsmfr_roundtrip(wave) -> np.ndarray:
    """GSM 06.10 Full-Rate encode->decode at 8 kHz (RPE-LTP); use
    telephony_channel(wave, 'gsmfr') for the full 16 kHz hop."""
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().gsmfr_roundtrip(_ptr(x), _ptr(out), x.size)
    return out


def gsmfr_encode(wave) -> bytes:
    """Encode 8 kHz float audio to packed 33-byte GSM frames."""
    x = _as_f32(wave)
    out = np.zeros(-(-x.size // 160) * 33, np.uint8)
    n = get_lib().gsmfr_encode(_ptr(x), x.size, _u8(out))
    return out[: n * 33].tobytes()


def gsmfr_decode(frames: bytes) -> np.ndarray:
    """Decode packed 33-byte GSM frames to 8 kHz float audio."""
    buf = np.frombuffer(frames, np.uint8)
    n_frames = buf.size // 33
    out = np.empty(n_frames * 160, np.float32)
    n = get_lib().gsmfr_decode(_u8(buf), n_frames, _ptr(out))
    if n < 0:
        raise ValueError("bad GSM frame magic")
    return out[:n]


def g729_encode(wave) -> bytes:
    """Encode 8 kHz float mono to raw ITU-T G.729 frames (10 bytes per
    10 ms)."""
    sig = np.ascontiguousarray(wave, np.float32)
    out = np.zeros((len(sig) // 80 + 2) * 10, np.uint8)
    n = get_lib().g729_encode(_ptr(sig), len(sig), _u8(out))
    return bytes(out[:max(n, 0)].tobytes())


def g729_decode(data: bytes) -> np.ndarray:
    """Decode raw G.729 frames to 8 kHz float mono."""
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((len(data) // 10 + 1) * 80, np.float32)
    n = get_lib().g729_decode(_u8(buf), len(buf), _ptr(out), len(out))
    return out[:max(n, 0)].copy()


def g729_channel(wave, sample_rate: int = 16000) -> np.ndarray:
    """Real G.729 hop: resample to 8 kHz, full bitstream round trip,
    resample back."""
    rt = get_lib().g729_roundtrip
    return _codec_hop(lambda x, out: rt(_ptr(x), _ptr(out), x.size),
                      wave, sample_rate, 8000)


_G722_MODES = {64: 1, 56: 2, 48: 3}


def _g722_mode(kbps) -> int:
    if int(kbps) not in _G722_MODES:
        raise ValueError(
            f"G.722 has embedded modes 64/56/48 kbps, got {kbps}")
    return _G722_MODES[int(kbps)]


def g722_roundtrip(wave, kbps: int = 64) -> np.ndarray:
    """ITU-T G.722 sub-band ADPCM encode->decode at 16 kHz; kbps in
    {64, 56, 48}, the embedded modes."""
    mode = _g722_mode(kbps)
    x = _as_f32(wave)
    out = np.empty_like(x)
    get_lib().g722_roundtrip(_ptr(x), _ptr(out), x.size, mode)
    return out


def g722_encode(wave) -> bytes:
    """Encode 16 kHz float audio to the G.722 bitstream (1 byte / 2
    samples, full 64 kbps embedded codes)."""
    x = _as_f32(wave)
    out = np.zeros(x.size // 2 + 1, np.uint8)
    n = get_lib().g722_encode(_ptr(x), x.size, _u8(out))
    return out[:n].tobytes()


def g722_decode(codes: bytes, kbps: int = 64) -> np.ndarray:
    """Decode a G.722 bitstream to 16 kHz float audio at the given mode."""
    mode = _g722_mode(kbps)
    buf = np.frombuffer(codes, np.uint8)
    out = np.empty(buf.size * 2, np.float32)
    n = get_lib().g722_decode(_u8(buf), buf.size, _ptr(out), mode)
    return out[:n]


def flac_decode(data: bytes):
    """Decode a FLAC stream: (samples (n, channels) int32, sample_rate,
    bits_per_sample); ValueError on malformed input."""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    sr, nch, bps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    total = lib.flac_stream_info(_u8(buf), buf.size, ctypes.byref(sr),
                                 ctypes.byref(nch), ctypes.byref(bps))
    if total < 0:
        raise ValueError("malformed FLAC stream")
    channels = max(nch.value, 1)
    # STREAMINFO's 36-bit total is trusted only within a sane bound; an
    # unknown (0) or absurd total decodes into a buffer that grows
    cap = min(max(len(data) * 1024, 1 << 16), 1 << 28)
    trusted = 0 < total <= cap
    max_samples = total if trusted else max(len(data) * 4, 1 << 16)
    while True:
        out = np.empty(max_samples * channels, np.int32)
        n = lib.flac_decode(
            _u8(buf), buf.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_samples,
            ctypes.byref(sr), ctypes.byref(nch), ctypes.byref(bps))
        if n < 0:
            raise ValueError("malformed FLAC stream")
        if n < max_samples or trusted:
            break
        max_samples *= 4
    samples = out[: n * nch.value].reshape(n, nch.value).copy()
    return samples, sr.value, bps.value
