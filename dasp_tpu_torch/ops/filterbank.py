"""Octave-band FIR filterbank design.

PyTorch counterpart of ``dasp_tpu/ops/filterbank.py``: the same cached
scipy ``firwin`` design, handed over as a tensor on the caller's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["octave_band_filterbank", "OCTAVE_BAND_CENTERS", "NUM_OCTAVE_BANDS"]

OCTAVE_BAND_CENTERS = (31.5, 63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0)
NUM_OCTAVE_BANDS = len(OCTAVE_BAND_CENTERS) + 2  # + lowpass @12 Hz + highpass @18 kHz


@lru_cache(maxsize=8)
def _design_filterbank(num_taps: int, sample_rate: float) -> np.ndarray:
    """Windowed-sinc design of the 12 bands, float32 (12, 1, num_taps),
    taps time-flipped like the JAX package's."""
    import scipy.signal

    filts = [scipy.signal.firwin(num_taps, 12, fs=sample_rate)[::-1]]
    for fc in OCTAVE_BAND_CENTERS:
        f_min = fc / np.sqrt(2)
        f_max = np.clip(fc * np.sqrt(2), a_min=0, a_max=(sample_rate / 2) * 0.999)
        filt = scipy.signal.firwin(num_taps, [f_min, f_max], fs=sample_rate, pass_zero=False)
        filts.append(filt[::-1])
    filts.append(scipy.signal.firwin(num_taps, 18000, fs=sample_rate, pass_zero=False)[::-1])
    bank = np.stack(filts, axis=0).astype(np.float32)
    bank = np.ascontiguousarray(bank[:, None, :])
    bank.setflags(write=False)  # the cache hands the same array to every caller
    return bank


def octave_band_filterbank(
    num_taps: int, sample_rate: float, device=None, dtype=torch.float32
) -> torch.Tensor:
    """12-band FIR filterbank: lowpass@12Hz, 10 octave bands 31.5 Hz-16 kHz,
    highpass@18kHz, shape (12, 1, num_taps), taps time-flipped.

    Args:
        num_taps: number of FIR taps (odd).
        sample_rate: audio sample rate in Hz.
        device, dtype: where and in what type to return the taps.
    """
    if num_taps % 2 != 1:
        raise ValueError(f"num_taps must be odd, got {num_taps}")
    bank = _design_filterbank(int(num_taps), float(sample_rate))
    return torch.tensor(bank, dtype=dtype, device=device)
