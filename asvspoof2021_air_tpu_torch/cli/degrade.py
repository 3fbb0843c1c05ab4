"""Offline corpus degradation CLI, host only: the port's counterpart of
the JAX package's ``cli.degrade`` (the reference's
channel_simulation/simulated_{channel,compression,device}.py).

Walks a wav directory and writes degraded copies with the reference naming
convention ``<stem>_<channel>.wav`` (codec/compression) or
``<stem><ir-stem>.wav`` (device IRs), through the native C++ codec tier
(``data.augment_host``) and, for the silk entries under ``--fidelity
system|auto``, the machine's libopus (``data.system_codecs``). Sampling is
seeded on the main process and the per-file work fans out over ``-j``
spawned processes, so the files, names and bytes are the JAX CLI's for the
same seed, at any ``-j``. It takes no ``--device``: nothing here runs on
the card, and no worker starts CUDA.

    python -m asvspoof2021_air_tpu_torch.cli.degrade channel -i <wavs> \
        -o <out> --sampling random [--fidelity native] [-j 4]
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import random
import re
import zlib
from typing import List

import numpy as np

from asvspoof2021_air_tpu_torch.data import augment_host as ah
from asvspoof2021_air_tpu_torch.data.audio_io import read_wav, write_wav

# Codec vocabulary of the reference channel pipeline (its
# simulated_channel.py); each name maps to the closest native codec chain
# available in-process.
LANDLINE = ["g711[law=u]", "g711[law=a]", "g726[law=u,br=16k]",
            "g726[law=u,br=24k]", "g726[law=u,br=32k]", "g726[law=u,40k]",
            "g726[law=a,br=16k]", "g726[law=a,br=24k]", "g726[law=a,br=32k]",
            "g726[law=a,br=40k]"]
VOIP = ["silk[br=5k]", "silk[br=10k]", "silk[br=15k]", "silk[br=20k]",
        "silk[br=5k,loss=5]", "silk[br=10k,loss=5]", "silk[br=15k,loss=5]",
        "silk[br=20k,loss=5]", "silk[br=5k,loss=10]", "silk[br=10k,loss=10]",
        "silk[br=15k,loss=10]", "silk[br=20k,loss=10]", "silkwb[br=10k]",
        "silkwb[br=20k]", "silkwb[br=30k]", "silkwb[br=10k,loss=5]",
        "silkwb[br=20k,loss=5]", "silkwb[br=30k,loss=5]",
        "silkwb[br=10k,loss=10]", "silkwb[br=20k,loss=10]",
        "silkwb[br=30k,loss=10]"]
CELLULAR = ["amr[br=4k75]", "amr[br=5k15]", "amr[br=5k9]", "amr[br=6k7]",
            "amr[br=7k4]", "amr[br=7k95]", "amr[br=10k2]", "amr[br=12k2]",
            "amr[br=4k75,nodtx]", "amr[br=5k9,nodtx]", "amr[br=6k7,nodtx]",
            "amr[br=7k4,nodtx]", "amr[br=7k95,nodtx]", "amr[br=10k2,nodtx]",
            "amrwb[br=6k6]", "amrwb[br=12k65]", "amrwb[br=15k85]",
            "amrwb[br=23k05]", "amrwb[br=6k6,nodtx]", "amrwb[br=12k65,nodtx]",
            "amrwb[br=15k85,nodtx]", "amrwb[br=23k05,nodtx]"]
COMMON = ["g722[br=64k]", "g722[br=56k]", "g722[br=48k]", "g729a", "g728",
          "gsmfr"]

COMPRESSION = ["mp3[8k]", "mp3[16k]", "mp3[32k]",
               "aac[8k]", "aac[16k]", "aac[32k]"]
RMS_LEVELS = [-26, -29, -32, -35]


def load_filelist(path: str, pattern: str = "*.wav") -> List[str]:
    """Every file under ``path`` matching ``pattern``, sorted."""
    out = []
    for root, _dirs, files in os.walk(path):
        for fn in fnmatch.filter(files, pattern):
            out.append(os.path.join(root, fn))
    return sorted(out)


def _codec_bits(name: str) -> int:
    for key, bits in (("16k", 2), ("24k", 3), ("32k", 4), ("40k", 5)):
        if key in name:
            return bits
    return 4


def _parse_kbps(name: str, default: float) -> float:
    """'br=4k75' -> 4.75, 'br=23k05' -> 23.05, 'br=5k' -> 5.0"""
    m = re.search(r"br=(\d+)k(\d*)", name)
    if not m:
        return default
    return float(f"{m.group(1)}.{m.group(2) or 0}")


def _parse_loss(name: str) -> float:
    m = re.search(r"loss=(\d+)", name)
    return float(m.group(1)) if m else 0.0


# AMR-NB bitrates (kbps) -> codec mode index 0..7
_AMRNB_RATES = (4.75, 5.15, 5.9, 6.7, 7.4, 7.95, 10.2, 12.2)


def _amrnb_mode(kbps: float):
    for i, r in enumerate(_AMRNB_RATES):
        if abs(kbps - r) < 0.05:
            return i
    return None


# AMR-WB bitrates (kbps) -> codec mode index (all 9 TS 26.201 modes
# encode and decode natively)
_AMRWB_ENC_RATES = {6.6: 0, 8.85: 1, 12.65: 2, 14.25: 3, 15.85: 4,
                    18.25: 5, 19.85: 6, 23.05: 7, 23.85: 8}


def _amrwb_mode(kbps: float):
    for r, i in _AMRWB_ENC_RATES.items():
        if abs(kbps - r) < 0.05:
            return i
    return None


def resolve_fidelity(fidelity: str = "auto") -> str:
    """Resolve the SILK-tier fidelity setting. ``auto`` (the default)
    promotes the silk*/silkwb* entries to the REAL SILK-mode Opus tier
    whenever the machine's libopus is loadable, and takes the
    self-contained native ACELP tier otherwise: the JAX CLI's own rule,
    real codec when available, never an error. Explicit ``system``
    demands the real tier (callers may then see SystemCodecUnavailable);
    explicit ``native`` pins the self-contained tier (bit-reproducible
    with no system library)."""
    if fidelity != "auto":
        return fidelity
    global _AUTO_FIDELITY
    if _AUTO_FIDELITY is None:
        try:
            from asvspoof2021_air_tpu_torch.data import system_codecs
            _AUTO_FIDELITY = "system" if system_codecs.available() \
                else "native"
        except Exception:
            _AUTO_FIDELITY = "native"
    return _AUTO_FIDELITY


_AUTO_FIDELITY = None


def apply_codec(wave: np.ndarray, name: str, sr: int = 16000,
                erasure_seed: int = 0, fidelity: str = "auto") -> np.ndarray:
    """Map a reference codec name onto the native codec tier:

    - G.711 / G.726: bit-faithful companding / ADPCM round trips
    - gsmfr: real GSM 06.10 RPE-LTP bitstream round trip
    - amr[br=4k75 .. 12k2]: REAL 3GPP AMR-NB bitstream round trips at
      all 8 modes (from-scratch encoders+decoders against
      probe-recovered tables — native/augment/amrnb.cc + amrnb_low.cc;
      streams decode on libavcodec's amrnb)
    - amrwb[...]: real AMR-WB bitstream round trips at the entry's mode;
      g729a: a real G.729 bitstream round trip
    - SILK / SILK-WB / G.728 and rates off the AMR ladders: the native
      analysis-by-synthesis ACELP codec at the mode's bitrate (AMR frame
      structure and pulse ladder; not 3GPP/Skype bit-compatible —
      native/augment/acelp.cc); SILK loss=N adds 20 ms frame-erasure
      concealment
    - G.722: real ITU-T sub-band ADPCM at 64/56/48 kbps (QMF band split +
      embedded 6/5/4-bit low band + 2-bit high band, 16 kHz native —
      native/augment/g722.cc)

    ``fidelity`` controls the silk*/silkwb* tier: the default ``auto``
    uses the REAL SILK-lineage codec (the machine's libopus forced into
    SILK mode — data/system_codecs.py) whenever that library is
    loadable and the native ACELP tier otherwise; ``system`` demands
    the real tier (raises SystemCodecUnavailable if missing);
    ``native`` pins the self-contained tier.  All other entries are
    unaffected (the native tier is already bit-exact or has no system
    equivalent).
    """
    fidelity = resolve_fidelity(fidelity)
    if name.startswith("g711"):
        codec = "g711a" if "law=a" in name else "g711u"
        return ah.telephony_channel(wave, codec, sr)
    if name.startswith("g726"):
        bits = _codec_bits(name)
        return ah.telephony_channel(wave, f"g726_{8 * bits}k", sr)
    if name == "gsmfr":
        # real GSM 06.10 Full-Rate bitstream round trip (native RPE-LTP)
        return ah.telephony_channel(wave, "gsmfr", sr)
    if name.startswith("g722"):
        # snap nonstandard rates to the nearest embedded G.722 mode
        kbps = min((64, 56, 48), key=lambda m: abs(m - _parse_kbps(name, 64.0)))
        if sr == 16000:
            return ah.g722_roundtrip(wave, kbps)
        # G.722 runs at 16 kHz; resample through the codec rate otherwise
        out = ah.g722_roundtrip(ah.resample(wave, sr, 16000), kbps)
        return ah.resample(out, 16000, sr)[: len(wave)]
    if name.startswith(("amrwb", "silkwb")):
        kbps = _parse_kbps(name, 12.65)
        if fidelity == "system" and name.startswith("silkwb"):
            from asvspoof2021_air_tpu_torch.data.system_codecs import opus_silk_channel
            out = opus_silk_channel(wave, 16000, kbps, sr)
        elif name.startswith("amrwb[") and _amrwb_mode(kbps) is not None:
            # real AMR-WB bitstream round trip at the entry's mode; dtx is
            # the 3GPP default for the plain entries
            out = ah.amrwb_channel(wave, sr, dtx="nodtx" not in name,
                                   mode=_amrwb_mode(kbps))
        else:
            out = ah.acelp_channel(wave, 16000, kbps, sr)
        loss = _parse_loss(name)
        if loss:
            seed = zlib.crc32(name.encode()) ^ erasure_seed
            out = ah.frame_erasure(out, loss, seed=seed, frame=sr // 50)
        return out
    if name.startswith(("amr", "silk", "g729", "g728")):
        kbps = _parse_kbps(name, 8.0 if name.startswith("g729") else 12.2)
        if name.startswith("g728"):
            kbps = 16.0
        if fidelity == "system" and name.startswith("silk"):
            from asvspoof2021_air_tpu_torch.data.system_codecs import opus_silk_channel
            out = opus_silk_channel(wave, 8000, kbps, sr)
        elif name.startswith("g729"):
            # real ITU-T G.729 bitstream round trip
            out = ah.g729_channel(wave, sr)
        elif name.startswith("amr[") and _amrnb_mode(kbps) is not None:
            # real AMR-NB bitstream round trip at the entry's mode; dtx is
            # the 3GPP default: only the `nodtx` entries skip the VAD/SID
            # comfort-noise framing
            out = ah.amrnb_channel(wave, sr, mode=_amrnb_mode(kbps),
                                   dtx="nodtx" not in name)
        else:
            out = ah.acelp_channel(wave, 8000, kbps, sr)
        loss = _parse_loss(name)
        if loss:
            seed = zlib.crc32(name.encode()) ^ erasure_seed
            out = ah.frame_erasure(out, loss, seed=seed, frame=sr // 50)
        return out
    # anything else: narrowband ADPCM fallback
    low = any(k in name for k in ("4k75", "5k15", "5k9", "5k", "6k7"))
    return ah.telephony_channel(wave, "g726_16k" if low else "g726_24k", sr)


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _map_tasks(worker, tasks, jobs: int) -> int:
    """Run per-file degrade tasks serially or over a process pool; sampling
    already happened on the main process, so outputs are identical for any
    jobs value."""
    if jobs <= 1:
        return sum(worker(t) for t in tasks)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # Spawned, not forked: a caller that has started CUDA (or any thread)
    # must not be forked; the workers run host codecs only. Each worker's
    # BLAS takes one thread (the pool is the parallelism): the system
    # tier's delay search runs numpy dots, and -j workers of a thread per
    # core each ran it 7x slower on 8 cores than one process did.
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        with ProcessPoolExecutor(
                max_workers=jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            return sum(pool.map(worker, tasks))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v



def _degrade_one_file(task) -> int:
    """Worker: run all sampled codecs for one source file (used by both the
    serial path and the --jobs process pool)."""
    f, codecs, output_path, target_sr, fidelity = task
    wave, _sr = read_wav(f, target_sr)
    stem = os.path.basename(f).split(".")[0]
    for codec in codecs:
        # per-(utterance, codec) erasure seed: loss patterns must differ
        # across files AND across codecs of one file, like the
        # acoustic-simulator's random loss
        out = apply_codec(wave, codec, target_sr,
                          erasure_seed=zlib.crc32(f"{stem}:{codec}".encode()),
                          fidelity=fidelity)
        write_wav(os.path.join(output_path, f"{stem}_{codec}.wav"),
                  out, target_sr)
    return len(codecs)


def channel_degrade(input_path: str, output_path: str, target_sr: int = 16000,
                    mode: str = "parallel", seed: int = 0,
                    jobs: int = 1, fidelity: str = "auto") -> int:
    """The reference's simulated_channel.py: ``random`` takes one codec of
    the whole vocabulary per file, ``parallel`` 7 landline + 6 VoIP + 6
    cellular + 2 common.

    The reference shells out one subprocess per (file, codec), serially;
    here the codecs run in-process, and ``jobs`` fans the per-file work out
    over a process pool (codec sampling stays seeded on the main process,
    so outputs are identical for any jobs value)."""
    rng = random.Random(seed)
    files = load_filelist(input_path)
    os.makedirs(output_path, exist_ok=True)
    tasks = []
    for f in files:
        if mode == "random":
            codecs = [rng.choice(LANDLINE + VOIP + CELLULAR + COMMON)]
        else:
            codecs = (rng.sample(LANDLINE, 7) + rng.sample(VOIP, 6)
                      + rng.sample(CELLULAR, 6) + rng.sample(COMMON, 2))
        tasks.append((f, codecs, output_path, target_sr,
                      resolve_fidelity(fidelity)))
    return _map_tasks(_degrade_one_file, tasks, jobs)


def _compress_one_file(task) -> int:
    f, opt_levels, output_path, target_sr = task
    wave, _sr = read_wav(f, target_sr)
    stem = os.path.basename(f).split(".")[0]
    for opt, level in opt_levels:
        out = ah.rms_normalize(wave, level)
        kind, rate = opt.split("[")
        kbps = float(rate.rstrip("]").rstrip("k"))
        if kind == "mp3":
            # real MPEG Layer III bitstream codec (native/augment/mp3.cc)
            out = ah.mp3_codec(out, kbps, target_sr)
        else:
            # real AAC-LC bitstream codec (native/augment/aac.cc)
            out = ah.aac_codec(out, kbps, target_sr)
        write_wav(os.path.join(output_path, f"{stem}_{opt}.wav"),
                  out, target_sr)
    return len(opt_levels)


def compression_degrade(input_path: str, output_path: str,
                        target_sr: int = 16000, mode: str = "parallel",
                        seed: int = 0, jobs: int = 1) -> int:
    """The reference's simulated_compression.py: RMS normalization to a random level then lossy compression: mp3 runs
    a real from-scratch MPEG Layer III codec (valid standard bitstreams,
    native/augment/mp3.cc); aac runs a real from-scratch AAC-LC codec
    (valid ADTS bitstreams, native/augment/aac.cc). ``jobs``
    fans per-file work over a process pool with sampling kept on the main
    process (outputs identical for any value)."""
    rng = random.Random(seed)
    files = load_filelist(input_path)
    os.makedirs(output_path, exist_ok=True)
    tasks = []
    for f in files:
        opts = COMPRESSION if mode == "parallel" else [rng.choice(COMPRESSION)]
        opt_levels = [(opt, rng.choice(RMS_LEVELS)) for opt in opts]
        tasks.append((f, opt_levels, output_path, target_sr))
    return _map_tasks(_compress_one_file, tasks, jobs)


def _device_one_file(task) -> int:
    f, ir_paths, output_path, target_sr = task
    wave, _sr = read_wav(f, target_sr)
    stem = os.path.basename(f).split(".")[0]
    for ir_path in ir_paths:
        if ir_path.endswith(".npy"):
            ir = np.load(ir_path).astype(np.float32).ravel()
        else:
            ir, _ = read_wav(ir_path, target_sr)
        out = ah.fft_convolve(wave, ir)
        peak = np.abs(out).max()
        if peak > 1.0:
            out = out / peak
        ir_stem = os.path.splitext(os.path.basename(ir_path))[0]
        write_wav(os.path.join(output_path, f"{stem}{ir_stem}.wav"),
                  out, target_sr)
    return len(ir_paths)


def device_degrade(input_path: str, output_path: str, ir_dir: str,
                   target_sr: int = 16000, mode: str = "parallel",
                   n_device: int = 27, n_space: int = 3, seed: int = 0,
                   jobs: int = 1) -> int:
    """The reference's simulated_device.py: convolve with recorded device/space IRs (wav or .npy files in ir_dir).
    ``jobs`` fans per-file work over a process pool with IR sampling kept
    on the main process (outputs identical for any value)."""
    rng = random.Random(seed)
    files = load_filelist(input_path)
    irs = sorted(
        load_filelist(ir_dir, "*.wav") + load_filelist(ir_dir, "*.npy")
    )
    if not irs:
        raise ValueError(f"no IR files in {ir_dir}")
    os.makedirs(output_path, exist_ok=True)
    tasks = []
    for f in files:
        k = min(n_device, len(irs)) if mode == "parallel" else 1
        tasks.append((f, rng.sample(irs, k), output_path, target_sr))
    return _map_tasks(_device_one_file, tasks, jobs)


def make_irs(output_path: str, target_sr: int = 16000, seed: int = 0) -> int:
    """Materialize a synthetic IR bank under the reference's full inventory
    names (74 device + 15 space stems, the reference's IR file lists):
    device IRs are
    modal-resonance speaker/telephone responses, space IRs are early
    reflections + RT60 reverb tails. Stand-ins for the recorded corpora
    (which the reference does not ship either); written as wavs so
    ``degrade device --ir_dir`` consumes them directly."""
    from asvspoof2021_air_tpu_torch.data.protocol import (
        DEVICE_IR_INVENTORY, SPACE_IR_INVENTORY)
    from asvspoof2021_air_tpu_torch.ops.augment import (
        synthesize_device_ir, synthesize_space_ir)

    g = np.random.default_rng(seed)
    dev_dir = os.path.join(output_path, "devices")
    space_dir = os.path.join(output_path, "space")
    os.makedirs(dev_dir, exist_ok=True)
    os.makedirs(space_dir, exist_ok=True)
    n = 0
    for stem in DEVICE_IR_INVENTORY:
        ir = synthesize_device_ir(g, sr=target_sr)
        write_wav(os.path.join(dev_dir, stem + ".wav"),
                  ir / max(np.abs(ir).max(), 1e-9) * 0.9, target_sr)
        n += 1
    for stem in SPACE_IR_INVENTORY:
        ir = synthesize_space_ir(g, sr=target_sr)
        write_wav(os.path.join(space_dir, stem + ".wav"),
                  ir / max(np.abs(ir).max(), 1e-9) * 0.9, target_sr)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser("offline corpus degradation")
    p.add_argument("mode", choices=["channel", "compression", "device",
                                    "make-irs"])
    p.add_argument("-i", "--input", type=str, default="")
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("-r", "--sample_rate", type=int, default=16000)
    p.add_argument("--sampling", type=str, default="parallel",
                   choices=["random", "parallel"])
    p.add_argument("--ir_dir", type=str, default="")
    p.add_argument("--seed", type=int, default=688)
    p.add_argument("-j", "--jobs", type=int, default=1,
                   help="process-pool workers (outputs are identical for "
                        "any value; sampling stays seeded on the main "
                        "process)")
    p.add_argument("--fidelity", type=str, default="auto",
                   choices=["auto", "native", "system"],
                   help="channel mode only — silk*/silkwb* tier: 'auto' "
                        "(default) uses real SILK-mode Opus via the "
                        "machine's libopus (data/system_codecs.py) when "
                        "loadable, else the self-contained ACELP tier; "
                        "'system' demands the real tier; 'native' pins "
                        "the self-contained one")
    args = p.parse_args(argv)
    if args.fidelity == "system":
        from asvspoof2021_air_tpu_torch.data import system_codecs
        if not system_codecs.available():
            p.error("--fidelity system: libavcodec/libopus not "
                    "loadable; use --fidelity native (or auto)")
    if args.mode == "channel":
        tier = resolve_fidelity(args.fidelity)
        print(f"fidelity {args.fidelity} -> {tier} (silk tier)")
        args.fidelity = tier

    if args.mode == "make-irs":
        n = make_irs(args.output, args.sample_rate, args.seed)
        print(f"wrote {n} impulse responses to {args.output}")
        return
    if not args.input:
        p.error("-i/--input is required for this mode")
    if args.mode == "channel":
        n = channel_degrade(args.input, args.output, args.sample_rate,
                            args.sampling, args.seed, jobs=args.jobs,
                            fidelity=args.fidelity)
    elif args.mode == "compression":
        n = compression_degrade(args.input, args.output, args.sample_rate,
                                args.sampling, args.seed, jobs=args.jobs)
    else:
        n = device_degrade(args.input, args.output, args.ir_dir,
                           args.sample_rate, args.sampling, seed=args.seed,
                           jobs=args.jobs)
    print(f"wrote {n} degraded files to {args.output}")


if __name__ == "__main__":
    main()
