"""Minimal ctypes harness over the machine's libavcodec (ffmpeg 5.x,
lavc 59): the port's own copy of the JAX package's ``interop/avcodec.py``.
No dev headers are needed: AVCodecContext fields are driven through the
AVOption API plus offsets derived from the library's own option table, and
AVPacket/AVFrame offsets are verified at load time by a pcm_s16le round
trip.

Its one consumer in the port is ``data.system_codecs``, the OPT-IN
system-fidelity augmentation tier (real SILK-mode Opus for the
silk*/silkwb* vocabulary entries). The default augmentation path stays
in-repo (the native C++ codecs); this module is never imported unless
``cli.degrade --fidelity system|auto`` or a test asks for it.

Mono 16-bit only; raises OracleUnavailable when the library or codec is
missing so callers can skip or fall back.
"""

from __future__ import annotations

import ctypes as C
import struct

import numpy as np

# AVCodecContext offsets are DERIVED at _load() time from the library's
# own AVOption table (av_opt_find on the avcodec_get_class() fake object),
# then cross-checked; the lavc-59 values shown here are documentation of
# what that derivation yields for lavc 59, not trusted constants:
#   "ar" (sample_rate) 352, "ac" (channels) 356, "frame_size" 364
#   => sample_fmt 360;  "ch_layout" 920.
CTX_SAMPLE_FMT = 360  # re-derived in _load()
CTX_FRAME_SIZE = 364  # re-derived in _load()
CTX_CH_LAYOUT = 920   # re-derived in _load()
# AVPacket/AVFrame have no AVOption table; these follow the ABI-stable
# public struct layout and are VERIFIED at _load() time by a pcm_s16le
# encode->decode round trip that fails loudly if any of them moved.
PKT_DATA = 24
PKT_SIZE = 32
FRM_DATA0 = 0
FRM_NB_SAMPLES = 112
FRM_FORMAT = 116
FRM_CH_LAYOUT = 448
AV_SAMPLE_FMT_S16 = 1
AV_OPT_SEARCH_CHILDREN = 1
# AVOption public struct: name@0 (char*), help@8 (char*), offset@16 (int).
_AVOPTION_OFFSET_FIELD = 16


class OracleUnavailable(Exception):
    pass


_libs = None


def _load():
    global _libs
    if _libs is not None:
        return _libs
    try:
        av = C.CDLL("libavcodec.so.59")
        avu = C.CDLL("libavutil.so.57")
    except OSError as e:
        raise OracleUnavailable(str(e))
    for f, res, args in [
        ("avcodec_find_decoder_by_name", C.c_void_p, [C.c_char_p]),
        ("avcodec_find_encoder_by_name", C.c_void_p, [C.c_char_p]),
        ("avcodec_alloc_context3", C.c_void_p, [C.c_void_p]),
        ("avcodec_open2", C.c_int, [C.c_void_p, C.c_void_p, C.c_void_p]),
        ("avcodec_send_packet", C.c_int, [C.c_void_p, C.c_void_p]),
        ("avcodec_receive_frame", C.c_int, [C.c_void_p, C.c_void_p]),
        ("avcodec_send_frame", C.c_int, [C.c_void_p, C.c_void_p]),
        ("avcodec_receive_packet", C.c_int, [C.c_void_p, C.c_void_p]),
        ("av_packet_alloc", C.c_void_p, []),
        ("av_new_packet", C.c_int, [C.c_void_p, C.c_int]),
        ("av_packet_unref", None, [C.c_void_p]),
    ]:
        g = getattr(av, f)
        g.restype, g.argtypes = res, args
    for f, res, args in [
        ("av_frame_alloc", C.c_void_p, []),
        ("av_frame_unref", None, [C.c_void_p]),
        ("av_frame_get_buffer", C.c_int, [C.c_void_p, C.c_int]),
        ("av_opt_set_int", C.c_int,
         [C.c_void_p, C.c_char_p, C.c_longlong, C.c_int]),
        ("av_opt_set", C.c_int,
         [C.c_void_p, C.c_char_p, C.c_char_p, C.c_int]),
        ("av_opt_find", C.c_void_p,
         [C.c_void_p, C.c_char_p, C.c_char_p, C.c_int, C.c_int]),
        ("av_channel_layout_copy", C.c_int, [C.c_void_p, C.c_void_p]),
    ]:
        g = getattr(avu, f)
        g.restype, g.argtypes = res, args
    try:
        av.avcodec_get_class.restype = C.c_void_p
        av.avcodec_get_class.argtypes = []
    except AttributeError as e:
        raise OracleUnavailable(str(e))
    _libs = (av, avu)
    try:
        _derive_ctx_offsets(av, avu)
        _selfcheck_pcm_roundtrip()
    except OracleUnavailable:
        _libs = None
        raise
    return _libs


def _opt_offset(avu, cls_ptr, name: str) -> int:
    """Field offset of an AVCodecContext option, read from the library's
    own AVOption table (av_opt_find over a fake {AVClass*} object)."""
    fake = C.c_void_p(cls_ptr)
    opt = avu.av_opt_find(C.byref(fake), name.encode(), None, 0, 0)
    if not opt:
        raise OracleUnavailable(f"AVOption {name!r} not found")
    return C.cast(C.c_void_p(opt + _AVOPTION_OFFSET_FIELD),
                  C.POINTER(C.c_int)).contents.value


def _derive_ctx_offsets(av, avu):
    """Re-derive the AVCodecContext field offsets from the AVOption table
    so an ABI bump of the library can never silently shift them."""
    global CTX_SAMPLE_FMT, CTX_FRAME_SIZE, CTX_CH_LAYOUT
    cls = av.avcodec_get_class()
    if not cls:
        raise OracleUnavailable("avcodec_get_class returned NULL")
    off_ar = _opt_offset(avu, cls, "ar")
    off_ac = _opt_offset(avu, cls, "ac")
    off_fs = _opt_offset(avu, cls, "frame_size")
    off_cl = _opt_offset(avu, cls, "ch_layout")
    # sample_fmt has no AVOption; it sits between channels and frame_size
    # in every lavc ABI (public struct order: sample_rate, channels,
    # sample_fmt, frame_size). Bracket-check before trusting it.
    if not (0 < off_ar < off_ac < off_fs and off_fs - off_ac == 8
            and off_cl > off_fs):
        raise OracleUnavailable(
            f"AVCodecContext layout unexpected: ar={off_ar} ac={off_ac} "
            f"frame_size={off_fs} ch_layout={off_cl}")
    CTX_SAMPLE_FMT = off_ac + 4
    CTX_FRAME_SIZE = off_fs
    CTX_CH_LAYOUT = off_cl


def _selfcheck_pcm_roundtrip():
    """Verify the (non-derivable) AVPacket/AVFrame offsets by a pcm_s16le
    encode->decode round trip: exercises PKT_DATA/PKT_SIZE, FRM_DATA0/
    FRM_NB_SAMPLES/FRM_FORMAT and FRM_CH_LAYOUT end to end. Any offset
    drift makes this fail (wrong bytes, wrong count, or open/buffer
    errors), downgrading the oracle to unavailable instead of corrupt."""
    pcm = (np.arange(640, dtype=np.int32) * 37 % 4099 - 2048).astype(np.int16)
    bits = ff_encode("pcm_s16le", pcm, 8000)
    if bits != pcm.tobytes():
        raise OracleUnavailable("pcm_s16le encode self-check mismatch")
    back = ff_decode("pcm_s16le", bits, 8000)
    if not np.array_equal(back, pcm):
        raise OracleUnavailable("pcm_s16le decode self-check mismatch")


def _set_i32(ptr, off, val):
    C.cast(C.c_void_p(ptr + off), C.POINTER(C.c_int)).contents.value = val


def _get_i32(ptr, off):
    return C.cast(C.c_void_p(ptr + off), C.POINTER(C.c_int)).contents.value


def _get_ptr(ptr, off):
    return C.cast(C.c_void_p(ptr + off), C.POINTER(C.c_void_p)).contents.value


def _set_opts(avu, ctx, opts, strict=True):
    """Apply AVOptions: int values via av_opt_set_int, str via av_opt_set
    (e.g. libopus application=voip)."""
    for k, v in (opts or {}).items():
        if isinstance(v, str):
            r = avu.av_opt_set(C.c_void_p(ctx), k.encode(), v.encode(),
                               AV_OPT_SEARCH_CHILDREN)
        else:
            r = avu.av_opt_set_int(C.c_void_p(ctx), k.encode(), int(v),
                                   AV_OPT_SEARCH_CHILDREN)
        if strict and r != 0:
            raise OracleUnavailable(f"opt {k}: {r}")


def ff_decode(codec: str, data: bytes, sample_rate: int,
              opts: dict | None = None, chunk: int = 1000) -> np.ndarray:
    """Decode a raw mono bitstream with the named lavc decoder -> int16."""
    av, avu = _load()
    dec = av.avcodec_find_decoder_by_name(codec.encode())
    if not dec:
        raise OracleUnavailable(f"no decoder {codec}")
    ctx = av.avcodec_alloc_context3(dec)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ar", sample_rate,
                       AV_OPT_SEARCH_CHILDREN)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ac", 1, AV_OPT_SEARCH_CHILDREN)
    _set_opts(avu, ctx, opts)
    if av.avcodec_open2(ctx, dec, None) != 0:
        raise OracleUnavailable(f"open {codec}")
    out = []
    frame = avu.av_frame_alloc()
    for i in range(0, len(data), chunk):
        seg = data[i:i + chunk]
        pkt = av.av_packet_alloc()
        av.av_new_packet(pkt, len(seg))
        C.memmove(_get_ptr(pkt, PKT_DATA), seg, len(seg))
        if av.avcodec_send_packet(ctx, pkt) != 0:
            raise OracleUnavailable("send_packet")
        while av.avcodec_receive_frame(ctx, frame) == 0:
            nb = _get_i32(frame, FRM_NB_SAMPLES)
            d0 = _get_ptr(frame, FRM_DATA0)
            fmt = _get_i32(frame, FRM_FORMAT)
            if fmt in (AV_SAMPLE_FMT_S16, 6):  # S16 / S16P mono
                out.append(np.frombuffer(C.string_at(d0, nb * 2),
                                         np.int16).copy())
            elif fmt in (3, 8):  # FLT / FLTP
                f = np.frombuffer(C.string_at(d0, nb * 4), np.float32)
                out.append(np.clip(np.rint(f * 32768.0), -32768,
                                   32767).astype(np.int16))
            else:
                raise OracleUnavailable(f"sample fmt {fmt}")
            avu.av_frame_unref(frame)
        av.av_packet_unref(pkt)
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def ff_decode_packets(codec: str, packets: list[bytes], sample_rate: int,
                      opts: dict | None = None) -> np.ndarray:
    """Decode a list of pre-split packets (for codecs whose raw frames are
    not self-delimiting, e.g. raw AAC raw_data_blocks) -> int16."""
    av, avu = _load()
    dec = av.avcodec_find_decoder_by_name(codec.encode())
    if not dec:
        raise OracleUnavailable(f"no decoder {codec}")
    ctx = av.avcodec_alloc_context3(dec)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ar", sample_rate,
                       AV_OPT_SEARCH_CHILDREN)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ac", 1, AV_OPT_SEARCH_CHILDREN)
    _set_opts(avu, ctx, opts)
    if av.avcodec_open2(ctx, dec, None) != 0:
        raise OracleUnavailable(f"open {codec}")
    out = []
    frame = avu.av_frame_alloc()

    def _drain():
        while av.avcodec_receive_frame(ctx, frame) == 0:
            nb = _get_i32(frame, FRM_NB_SAMPLES)
            d0 = _get_ptr(frame, FRM_DATA0)
            fmt = _get_i32(frame, FRM_FORMAT)
            if fmt in (AV_SAMPLE_FMT_S16, 6):
                out.append(np.frombuffer(C.string_at(d0, nb * 2),
                                         np.int16).copy())
            elif fmt in (3, 8):  # FLT / FLTP
                f = np.frombuffer(C.string_at(d0, nb * 4), np.float32)
                out.append(np.clip(np.rint(f * 32768.0), -32768,
                                   32767).astype(np.int16))
            else:
                raise OracleUnavailable(f"sample fmt {fmt}")
            avu.av_frame_unref(frame)

    for seg in packets:
        pkt = av.av_packet_alloc()
        av.av_new_packet(pkt, len(seg))
        C.memmove(_get_ptr(pkt, PKT_DATA), seg, len(seg))
        if av.avcodec_send_packet(ctx, pkt) != 0:
            raise OracleUnavailable("send_packet")
        _drain()
        av.av_packet_unref(pkt)
    av.avcodec_send_packet(ctx, None)  # flush
    _drain()
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def ff_encode_packets(codec: str, pcm16: np.ndarray, sample_rate: int,
                      opts: dict | None = None,
                      frame_samples: int = 320) -> list[bytes]:
    """Like ff_encode but returns the individual packets (frames)."""
    av, avu = _load()
    enc = av.avcodec_find_encoder_by_name(codec.encode())
    if not enc:
        raise OracleUnavailable(f"no encoder {codec}")
    ctx = av.avcodec_alloc_context3(enc)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ar", sample_rate,
                       AV_OPT_SEARCH_CHILDREN)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ac", 1, AV_OPT_SEARCH_CHILDREN)
    if avu.av_opt_set(C.c_void_p(ctx), b"ch_layout", b"mono",
                      AV_OPT_SEARCH_CHILDREN) != 0:
        raise OracleUnavailable("ch_layout")
    _set_i32(ctx, CTX_SAMPLE_FMT, AV_SAMPLE_FMT_S16)
    _set_opts(avu, ctx, opts)
    if av.avcodec_open2(ctx, enc, None) != 0:
        # int16 input may be unsupported (e.g. aac wants flt); retry FLTP
        ctx = av.avcodec_alloc_context3(enc)
        avu.av_opt_set_int(C.c_void_p(ctx), b"ar", sample_rate,
                           AV_OPT_SEARCH_CHILDREN)
        avu.av_opt_set_int(C.c_void_p(ctx), b"ac", 1, AV_OPT_SEARCH_CHILDREN)
        avu.av_opt_set(C.c_void_p(ctx), b"ch_layout", b"mono",
                       AV_OPT_SEARCH_CHILDREN)
        _set_i32(ctx, CTX_SAMPLE_FMT, 8)  # FLTP
        _set_opts(avu, ctx, opts, strict=False)
        if av.avcodec_open2(ctx, enc, None) != 0:
            raise OracleUnavailable(f"open {codec}")
        as_float = True
    else:
        as_float = False
    fs = _get_i32(ctx, CTX_FRAME_SIZE)
    if fs <= 0:
        fs = frame_samples
    pkts: list[bytes] = []
    pkt = av.av_packet_alloc()
    pcm16 = np.ascontiguousarray(pcm16, np.int16)

    def _drain():
        while av.avcodec_receive_packet(ctx, pkt) == 0:
            pkts.append(C.string_at(_get_ptr(pkt, PKT_DATA),
                                    _get_i32(pkt, PKT_SIZE)))
            av.av_packet_unref(pkt)

    for i in range(0, len(pcm16) - fs + 1, fs):
        frame = avu.av_frame_alloc()
        _set_i32(frame, FRM_NB_SAMPLES, fs)
        _set_i32(frame, FRM_FORMAT, 8 if as_float else AV_SAMPLE_FMT_S16)
        if avu.av_channel_layout_copy(C.c_void_p(frame + FRM_CH_LAYOUT),
                                      C.c_void_p(ctx + CTX_CH_LAYOUT)) != 0:
            raise OracleUnavailable("frame ch_layout")
        if avu.av_frame_get_buffer(frame, 0) != 0:
            raise OracleUnavailable("frame buffer")
        seg = pcm16[i:i + fs]
        if as_float:
            f = (seg.astype(np.float32) / 32768.0)
            C.memmove(_get_ptr(frame, FRM_DATA0), f.ctypes.data, fs * 4)
        else:
            C.memmove(_get_ptr(frame, FRM_DATA0), seg.ctypes.data, fs * 2)
        if av.avcodec_send_frame(ctx, frame) != 0:
            raise OracleUnavailable("send_frame")
        _drain()
        avu.av_frame_unref(frame)
    av.avcodec_send_frame(ctx, None)  # flush
    _drain()
    return pkts


def ff_encode(codec: str, pcm16: np.ndarray, sample_rate: int,
              opts: dict | None = None, frame_samples: int = 320) -> bytes:
    """Encode mono int16 PCM with the named lavc encoder -> bitstream."""
    av, avu = _load()
    enc = av.avcodec_find_encoder_by_name(codec.encode())
    if not enc:
        raise OracleUnavailable(f"no encoder {codec}")
    ctx = av.avcodec_alloc_context3(enc)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ar", sample_rate,
                       AV_OPT_SEARCH_CHILDREN)
    avu.av_opt_set_int(C.c_void_p(ctx), b"ac", 1, AV_OPT_SEARCH_CHILDREN)
    if avu.av_opt_set(C.c_void_p(ctx), b"ch_layout", b"mono",
                      AV_OPT_SEARCH_CHILDREN) != 0:
        raise OracleUnavailable("ch_layout")
    _set_i32(ctx, CTX_SAMPLE_FMT, AV_SAMPLE_FMT_S16)
    _set_opts(avu, ctx, opts)
    if av.avcodec_open2(ctx, enc, None) != 0:
        raise OracleUnavailable(f"open {codec}")
    fs = _get_i32(ctx, CTX_FRAME_SIZE)
    if fs <= 0:
        fs = frame_samples
    out = bytearray()
    pkt = av.av_packet_alloc()
    pcm16 = np.ascontiguousarray(pcm16, np.int16)
    for i in range(0, len(pcm16) - fs + 1, fs):
        frame = avu.av_frame_alloc()
        _set_i32(frame, FRM_NB_SAMPLES, fs)
        _set_i32(frame, FRM_FORMAT, AV_SAMPLE_FMT_S16)
        if avu.av_channel_layout_copy(C.c_void_p(frame + FRM_CH_LAYOUT),
                                      C.c_void_p(ctx + CTX_CH_LAYOUT)) != 0:
            raise OracleUnavailable("frame ch_layout")
        if avu.av_frame_get_buffer(frame, 0) != 0:
            raise OracleUnavailable("frame buffer")
        seg = pcm16[i:i + fs]
        C.memmove(_get_ptr(frame, FRM_DATA0), seg.ctypes.data, fs * 2)
        if av.avcodec_send_frame(ctx, frame) != 0:
            raise OracleUnavailable("send_frame")
        while av.avcodec_receive_packet(ctx, pkt) == 0:
            out += C.string_at(_get_ptr(pkt, PKT_DATA),
                               _get_i32(pkt, PKT_SIZE))
            av.av_packet_unref(pkt)
        avu.av_frame_unref(frame)
    av.avcodec_send_frame(ctx, None)  # flush
    while av.avcodec_receive_packet(ctx, pkt) == 0:
        out += C.string_at(_get_ptr(pkt, PKT_DATA),
                           _get_i32(pkt, PKT_SIZE))
        av.av_packet_unref(pkt)
    return bytes(out)
