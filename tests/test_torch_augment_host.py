"""The port's host codec tier (``data/augment_host.py`` over
``ops/_host_build.codec_library``) against the JAX package's binding of the
same native library, on the CPU.

Both libraries are compiled from ``native/augment`` with the Makefile's
code-generation flags by the same compiler on this machine, so every
function must agree BITWISE on seeded 0.25-0.5 s inputs: float outputs by
``np.array_equal``, bitstreams byte for byte. The JAX codec tests' cheap
property checks (G.711 known values, the G.726 bitrate ladder, resampler
aliasing, G.722 safety on arbitrary bytes and its invalid modes) run again
through the port's binding. The port never runs ``make`` and never writes
``native/libaugment.so``; the JAX binding builds that one itself."""

import ctypes
import inspect
import os
import subprocess

import numpy as np
import pytest

from asvspoof2021_air_tpu.data import augment_host as jah
from asvspoof2021_air_tpu_torch.data import augment_host as ah
from asvspoof2021_air_tpu_torch.ops import _host_build
from flac_encoder import encode_flac

SR = 16000


def speech(n: int = 6000, sr: int = SR, seed: int = 0) -> np.ndarray:
    """Seeded speech-like f32: two formant tones under noise, with a pause
    (so the VAD/DTX paths see silence)."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.25 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 0.1 * np.sin(2 * np.pi * 1800 * t)
    x = x + 0.03 * g.standard_normal(n)
    x[n // 2:n // 2 + n // 6] *= 0.001
    return x.astype(np.float32)


def tone(freq, sr=SR, n=SR, amp=0.3):
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def snr_db(clean, coded):
    noise = coded - clean
    return 10 * np.log10((clean ** 2).mean()
                         / max((noise ** 2).mean(), 1e-20))


NB = speech(4000, 8000, 1)          # 0.5 s at 8 kHz
WB = speech(6000, SR, 2)            # 0.375 s at 16 kHz

# every public function of both modules: (name, positional args, kwargs)
CASES = [
    ("g711_roundtrip", (WB,), {"law": "u"}),
    ("g711_roundtrip", (WB,), {"law": "a"}),
    ("g726_encode", (NB, 3), {}),
    ("g726_roundtrip", (NB, 2), {}),
    ("g726_roundtrip", (NB, 5), {}),
    ("resample", (WB, SR, 8000), {}),
    ("resample", (NB, 8000, 48000), {"taps": 17}),
    ("fft_convolve", (WB, speech(300, SR, 3)), {}),
    ("rms_normalize", (WB, -29.0), {}),
    ("telephony_channel", (WB,), {"codec": "g711a"}),
    ("telephony_channel", (WB,), {"codec": "g726_24k"}),
    ("telephony_channel", (WB,), {"codec": "gsmfr"}),
    ("acelp_channel", (WB,), {"codec_rate": 8000, "bitrate_kbps": 10.0}),
    ("acelp_channel", (WB,), {"codec_rate": 16000, "bitrate_kbps": 20.0}),
    ("amrwb_encode", (WB,), {"dtx": True, "mode": 0}),
    ("amrwb_encode", (WB,), {"mode": 7}),
    ("amrwb_channel", (WB,), {"dtx": True, "mode": 2}),
    ("amrwb_channel", (NB,), {"sample_rate": 8000, "mode": 4}),
    ("amrnb_encode", (NB,), {"mode": 0, "dtx": True}),
    ("amrnb_encode", (NB,), {"mode": 7}),
    ("amrnb_channel", (WB,), {"mode": 3, "dtx": True}),
    ("amrnb_channel", (WB,), {"mode": 7}),
    ("mdct_codec", (WB, 16.0), {"kind": "mp3"}),
    ("mdct_codec", (WB, 16.0), {"kind": "aac"}),
    ("mp3_codec", (WB, 16.0), {}),
    ("mp3_encode", (WB, 32), {}),
    ("aac_codec", (WB, 8.0), {}),
    ("aac_encode", (WB, 16), {}),
    ("frame_erasure", (WB, 10.0), {"seed": 5}),
    ("gsmfr_roundtrip", (NB,), {}),
    ("gsmfr_encode", (NB,), {}),
    ("g729_encode", (NB,), {}),
    ("g729_channel", (WB,), {}),
    ("g722_roundtrip", (WB,), {"kbps": 56}),
    ("g722_encode", (WB,), {}),
]
# decoders, fed the JAX encoder's bitstream
DECODERS = [
    ("g726_decode", lambda: (jah.g726_encode(NB, 4), 4)),
    ("amrwb_decode", lambda: (jah.amrwb_encode(WB, dtx=True, mode=2),)),
    ("amrnb_decode", lambda: (jah.amrnb_encode(NB, mode=1, dtx=True),)),
    ("mp3_decode", lambda: (jah.mp3_encode(WB, 16),)),
    ("aac_decode", lambda: (jah.aac_encode(WB, 16),)),
    ("gsmfr_decode", lambda: (jah.gsmfr_encode(NB),)),
    ("g729_decode", lambda: (jah.g729_encode(NB),)),
    ("g722_decode", lambda: (jah.g722_encode(WB), 48)),
    ("flac_decode", lambda: (encode_flac(np.round(WB * 20000).astype(
        np.int32)),)),
]


def public(module) -> set:
    return {n for n, f in vars(module).items()
            if inspect.isfunction(f) and not n.startswith("_")
            and f.__module__ == module.__name__}


def same(got, want) -> None:
    """Bitwise: arrays by dtype, shape and bytes; bytes as bytes; tuples
    element by element."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            same(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


def test_every_public_function_is_ported_with_its_signature():
    assert public(ah) == public(jah)
    assert {c[0] for c in CASES} | {d[0] for d in DECODERS} == (
        public(jah) - {"get_lib"})
    for name in public(jah):
        assert (inspect.signature(getattr(ah, name)).parameters.keys()
                == inspect.signature(getattr(jah, name)).parameters.keys()
                ), name
    assert ah.CODEC_IDS == jah.CODEC_IDS
    assert ah.AMRNB_MODE_BYTES == jah.AMRNB_MODE_BYTES
    assert ah.AMRWB_MODE_BYTES == jah.AMRWB_MODE_BYTES


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_function_bitwise_equals_jax(name, args, kwargs):
    want = getattr(jah, name)(*args, **kwargs)
    got = getattr(ah, name)(*args, **kwargs)
    same(got, want)
    if isinstance(want, np.ndarray) and want.dtype == np.float32:
        assert np.isfinite(got).all()


@pytest.mark.parametrize("name,make", DECODERS, ids=[d[0] for d in DECODERS])
def test_decoder_bitwise_equals_jax(name, make):
    args = make()
    same(getattr(ah, name)(*args), getattr(jah, name)(*args))


def test_codec_library_is_built_apart_from_native_and_the_host_library():
    """The port builds ``build/libasv_codecs_<hash>.so`` from the Makefile's
    SRCS with its flags, by its own compiler processes: it never runs make
    and leaves ``native/libaugment.so`` (the JAX binding's) untouched; the
    FLAC symbols live in this library and in ``libasv_host`` apart."""
    jah.get_lib()                    # the JAX binding's own library
    so = _host_build.NATIVE_DIR / "libaugment.so"
    before = os.stat(so).st_mtime_ns
    lib = ah.get_lib()
    assert os.stat(so).st_mtime_ns == before
    assert os.path.basename(lib._name).startswith("libasv_codecs_")
    assert os.path.dirname(lib._name) == str(_host_build.BUILD_DIR)
    srcs, headers = _host_build.codec_sources()
    text = (_host_build.NATIVE_DIR / "Makefile").read_text()
    native = _host_build.NATIVE_DIR
    assert [s.relative_to(native).as_posix() for s in srcs] == (
        text.split("SRCS = ")[1].splitlines()[0].split())
    assert _host_build.NATIVE_DIR / "augment" / "augment.h" in headers
    flags = text.split("CXXFLAGS ?= ")[1].splitlines()[0].split()
    assert set(_host_build.CODEC_FLAGS) == set(flags) - {"-Wall", "-Wextra"}
    host = _host_build.host_library()
    assert host._name != lib._name
    nm = subprocess.run(["nm", "-D", "--defined-only", host._name],
                        capture_output=True, text=True)
    if nm.returncode == 0:
        assert "flac_decode" in nm.stdout and "g722_encode" not in nm.stdout


def test_g711_ulaw_known_values():
    """Bit-exact ITU mu-law: encode(0) = 0xFF, decode(0xFF) = 0, the
    largest input saturates to 0x80, and the code round trip stays within
    the segment step."""
    lib = ah.get_lib()
    assert lib.g711_ulaw_encode_sample(0) == 0xFF
    assert lib.g711_ulaw_decode_sample(0xFF) == 0
    assert lib.g711_ulaw_encode_sample(32767) == 0x80
    for v in range(-32768, 32768, 257):
        back = lib.g711_ulaw_decode_sample(lib.g711_ulaw_encode_sample(v))
        step = max(8 << max(0, int(np.log2(max(abs(v), 1) / 16 + 1))), 8)
        assert abs(back - v) <= 2 * step + 4, (v, back)
    jlib = jah.get_lib()
    jlib.g711_alaw_encode_sample.restype = ctypes.c_uint8
    for v in (-32768, -1000, 0, 77, 32767):
        assert lib.g711_alaw_encode_sample(v) == (
            jlib.g711_alaw_encode_sample(v))


def test_g726_bitrate_ladder_and_g711_snr():
    x = tone(1000, sr=8000, n=8000)
    snrs = [snr_db(x[500:], ah.g726_roundtrip(x, bits)[500:])
            for bits in (2, 3, 4, 5)]
    assert snrs[0] < snrs[1] < snrs[2] < snrs[3], snrs
    assert snrs[2] > 20, snrs
    for law in ("u", "a"):
        assert snr_db(tone(1000), ah.g711_roundtrip(tone(1000), law)) > 30


def test_resample_round_trip_and_aliasing():
    x = tone(1000)
    down = ah.resample(x, SR, 8000)
    assert abs(len(down) - 8000) <= 33
    up = ah.resample(down, 8000, SR)
    n = min(len(up), len(x)) - 100
    assert np.corrcoef(up[50:n], x[50:n])[0, 1] > 0.98
    high = tone(6000)                 # above 8 kHz's Nyquist
    down = ah.resample(high, SR, 8000)
    assert (down[100:-100] ** 2).mean() < 1e-3 * (high ** 2).mean()


def test_fft_convolve_and_rms_normalize():
    g = np.random.default_rng(1)
    x = g.standard_normal(2000).astype(np.float32)
    ir = g.standard_normal(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(ah.fft_convolve(x, ir),
                               np.convolve(x, ir)[:2000], atol=1e-4)
    y = ah.rms_normalize(0.01 * x, -26.0)
    assert abs(20 * np.log10(np.sqrt((y ** 2).mean())) + 26.0) < 0.2


def test_g722_arbitrary_bytes_safe_and_invalid_modes_refused():
    codes = np.random.default_rng(0).integers(0, 256, 4000,
                                              dtype=np.uint8).tobytes()
    for kbps in (64, 56, 48):
        out = ah.g722_decode(codes, kbps)
        assert out.shape == (8000,) and np.isfinite(out).all()
        assert np.abs(out).max() <= 2.1
        via_bits = ah.g722_decode(ah.g722_encode(WB), kbps)[:len(WB)]
        np.testing.assert_array_equal(
            via_bits, ah.g722_roundtrip(WB, kbps)[:len(via_bits)])
    with pytest.raises(ValueError, match="64/56/48"):
        ah.g722_roundtrip(np.zeros(100, np.float32), 32)
    with pytest.raises(ValueError, match="64/56/48"):
        ah.g722_decode(b"\x00" * 10, 128)
    with pytest.raises(ValueError, match="out of range"):
        ah.amrnb_encode(NB, mode=8)
    with pytest.raises(ValueError, match="malformed"):
        ah.mp3_decode(b"\x00" * 64)
    with pytest.raises(ValueError, match="malformed FLAC"):
        ah.flac_decode(b"not a flac stream at all")


def test_host_tier_leaves_torch_and_devices_alone():
    """No function of the host tier takes or returns a tensor: the
    module imports neither torch nor a device helper."""
    src = inspect.getsource(ah)
    assert "import torch" not in src and "cuda" not in src
