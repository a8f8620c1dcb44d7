"""Host-side audio I/O and synthetic audio, numpy only: the port's copy of
``dasp_tpu/utils/audio.py``.

Wav decode, clip range reads, batch loading and dataset indexing go through
the port's native C++ runtime (:mod:`dasp_tpu_torch.native`, built from
``native/dasp_io.cpp``) with a pure-Python/scipy fallback. Everything here
returns numpy, as the JAX package's functions do; the input pipeline
(:mod:`dasp_tpu_torch.utils.pipeline`) moves batches to the card.
``synthetic_batch`` draws the same clips as the JAX package's from the same
``np.random.Generator`` (plucked strings and swept tones with enveloped
noise), for runs without a dataset.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from .. import native

__all__ = [
    "load_wav", "save_wav", "synthetic_batch", "index_wav_dataset",
    "load_clip", "load_clip_batch",
]


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 array (channels, samples), sample_rate)."""
    if native.available():
        try:
            return native.wav_read(path)
        except RuntimeError:
            pass  # exotic codec (e.g. ADPCM): fall back to scipy
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # (channels, samples)
    return data, sr


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write (channels, samples) float32 audio to a 16-bit wav."""
    if native.available():
        native.wav_write(path, audio, sample_rate)
        return
    from scipy.io import wavfile

    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    audio = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sample_rate, (audio.T * 32767.0).astype(np.int16))


def _pluck(rng: np.random.Generator, length: int, sr: int) -> np.ndarray:
    """Karplus-Strong plucked string."""
    f0 = rng.uniform(82.0, 440.0)
    period = max(2, int(sr / f0))
    burst = rng.standard_normal(period).astype(np.float32)
    out = np.zeros(length, dtype=np.float32)
    out[:period] = burst
    # out[n] = 0.498 (out[n - period] + out[n - period + 1]) in float32, a
    # period of samples at a time: in each block only the last sample reads
    # the block's own first one (the same bits as the loop over n)
    c = np.float32(0.996 * 0.5)
    for s in range(period, length, period):
        m = min(length - s, period - 1)
        out[s:s + m] = c * (out[s - period:s - period + m] + out[s - period + 1:s - period + 1 + m])
        if length - s >= period:
            out[s + period - 1] = c * (out[s - 1] + out[s])
    return out


def _chirp_noise(rng: np.random.Generator, length: int, sr: int) -> np.ndarray:
    """A swept tone plus enveloped noise (speech-like spectral movement)."""
    t = np.arange(length, dtype=np.float32) / sr
    f0 = rng.uniform(100.0, 400.0)
    f1 = rng.uniform(800.0, 4000.0)
    sweep = np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t**2 / (2 * t[-1] + 1e-9)))
    env = np.abs(np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t)) ** 2
    noise = rng.standard_normal(length).astype(np.float32) * 0.1
    return (sweep * env + noise * env).astype(np.float32)


def synthetic_batch(
    rng: np.random.Generator, batch_size: int, length: int, sample_rate: int = 44100, kind: str = "mixed",
) -> np.ndarray:
    """A batch of synthetic mono audio, (batch, 1, length) float32, each
    clip scaled to a peak of 0.7: plucks (``kind="pluck"``), swept tones
    with noise (``"chirp"``), or alternating, plucks first (``"mixed"``)."""
    out = np.zeros((batch_size, 1, length), dtype=np.float32)
    for i in range(batch_size):
        use_pluck = kind == "pluck" or (kind == "mixed" and i % 2 == 0)
        sig = _pluck(rng, length, sample_rate) if use_pluck else _chirp_noise(rng, length, sample_rate)
        out[i, 0] = 0.7 * sig / (np.abs(sig).max() + 1e-9)
    return out


def index_wav_dataset(root_dir: str, length: int, silence_threshold: float = 1e-4) -> List[Tuple[str, int]]:
    """Pre-index (file, offset) chunks of ``length`` samples from a
    directory of wavs (recursively, in sorted order), skipping chunks whose
    peak is under ``silence_threshold``. Uses the native streaming peak
    scanner when available (one pass, no whole-file Python decode)."""
    examples = []
    for path in sorted(glob.glob(os.path.join(root_dir, "**/*.wav"), recursive=True)):
        try:
            if native.available():
                peaks = native.chunk_peaks(path, length)
            else:
                audio, _ = load_wav(path)
                n = audio.shape[-1] // length
                peaks = np.array([
                    np.abs(audio[:, i * length:(i + 1) * length]).max()
                    for i in range(n)
                ])
        except Exception:
            continue
        for i in np.nonzero(peaks >= silence_threshold)[0]:
            examples.append((path, int(i) * length))
    return examples


def load_clip(example: Tuple[str, int], length: int) -> np.ndarray:
    """Load one pre-indexed chunk -> (channels, length) float32 in [-1, 1].

    The native path decodes exactly the requested byte range; the
    fallback decodes the whole file and slices.
    """
    path, offset = example
    if native.available():
        try:
            audio, _ = native.wav_read(path, offset=offset, frames=length)
            return np.clip(audio, -1.0, 1.0)
        except RuntimeError:
            pass
    audio, _ = load_wav(path)
    clip = np.clip(audio[:, offset : offset + length], -1.0, 1.0)
    if clip.shape[-1] < length:  # clip overlaps EOF: zero-fill like native
        clip = np.pad(clip, ((0, 0), (0, length - clip.shape[-1])))
    return clip


_wav_channels_cache: dict = {}


def _wav_channels(path: str) -> int:
    """Channel count from the wav header (native, header-only read), cached."""
    n = _wav_channels_cache.get(path)
    if n is None:
        n = native.wav_info(path)[1]
        _wav_channels_cache[path] = n
    return n


def load_clip_batch(
    examples: List[Tuple[str, int]], length: int, channels: int = 1,
    mono_mix: bool = True, num_threads: int = 0, pad_mode: str = "zero",
) -> np.ndarray:
    """Load a batch of pre-indexed clips -> (batch, channels, length).

    Native path: one C++ thread pool fills the contiguous output buffer
    directly from disk (range reads, no GIL), the DataLoader-worker
    analogue for file-backed training. Fallback: sequential
    :func:`load_clip` + mono mix in numpy.

    When a file has fewer channels than requested, ``pad_mode`` picks
    how the missing rows are filled: ``"zero"`` (silence) or
    ``"repeat"`` (cycle the source channels — mono files duplicate to
    every output channel).
    """
    if pad_mode not in ("zero", "repeat"):
        raise ValueError(f"pad_mode must be 'zero' or 'repeat', got {pad_mode!r}")
    if native.available():
        try:
            out = native.load_batch(examples, length, channels=channels,
                                    mono_mix=mono_mix, num_threads=num_threads)
            if pad_mode == "repeat" and not mono_mix and channels > 1:
                for i, (path, _off) in enumerate(examples):
                    src = _wav_channels(path)
                    if 0 < src < channels:
                        for k in range(src, channels):
                            out[i, k] = out[i, k % src]
            return np.clip(out, -1.0, 1.0)
        except RuntimeError:
            pass
    out = np.zeros((len(examples), channels, length), dtype=np.float32)
    for i, (path, offset) in enumerate(examples):
        audio, _ = load_wav(path)  # raw decode: mix BEFORE the final clip,
        clip = audio[:, offset : offset + length]  # matching the native path
        if clip.shape[-1] < length:  # zero-pad short tails like the native path
            clip = np.pad(clip, ((0, 0), (0, length - clip.shape[-1])))
        if mono_mix:
            out[i] = clip.mean(axis=0, keepdims=True)
        else:
            src = clip.shape[0]
            take = min(channels, src)
            out[i, :take] = clip[:take]
            if pad_mode == "repeat" and src > 0:
                for k in range(take, channels):
                    out[i, k] = clip[k % src]
    return np.clip(out, -1.0, 1.0)
