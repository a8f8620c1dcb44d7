"""Synthetic audio from a seed: plucks and swept tones with noise.

A frozen copy of ``dasp_tpu_torch/utils/audio.py:68-120`` (``_pluck``,
``_chirp_noise``, ``synthetic_batch``), so that the traffic does not move
when the program's copy does.
"""

import numpy as np


def _pluck(rng: np.random.Generator, length: int, sr: int) -> np.ndarray:
    """Karplus-Strong plucked string."""
    f0 = rng.uniform(82.0, 440.0)
    period = max(2, int(sr / f0))
    burst = rng.standard_normal(period).astype(np.float32)
    out = np.zeros(length, dtype=np.float32)
    out[:period] = burst
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


def synthetic_batch(rng: np.random.Generator, batch_size: int, length: int, sample_rate: int = 44100,
                    kind: str = "mixed") -> np.ndarray:
    """A batch of synthetic mono audio, (batch, 1, length) float32, each
    clip scaled to a peak of 0.7: plucks (``kind="pluck"``), swept tones
    with noise (``"chirp"``), or alternating, plucks first (``"mixed"``)."""
    out = np.zeros((batch_size, 1, length), dtype=np.float32)
    for i in range(batch_size):
        use_pluck = kind == "pluck" or (kind == "mixed" and i % 2 == 0)
        sig = _pluck(rng, length, sample_rate) if use_pluck else _chirp_noise(rng, length, sample_rate)
        out[i, 0] = 0.7 * sig / (np.abs(sig).max() + 1e-9)
    return out
