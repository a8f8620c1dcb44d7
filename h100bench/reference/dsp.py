"""The effects of the style chain and of the classic live chain, computed
the plain way.

Every effect takes and returns float64 tensors of shape (bs, ch, T).

- Parametric EQ: six Audio-EQ-Cookbook biquads (low shelf, four peaking,
  high shelf) applied by frequency sampling: the cascade's response
  B(z) / A(z) on an FFT grid of at least twice the signal's length, so the
  aliased part of the impulse response lies a whole signal length down its
  decay. For these designs that is below float64's rounding.
- Compressor: the mono-summed side chain in dB, the soft-knee static curve,
  then true attack/release ballistics, y[n] = a[n] y[n-1] + (1 - a[n]) g[n]
  with a[n] the attack coefficient where g[n] < y[n-1] and the release one
  otherwise, from rest. The branch is taken by a loop over time in Python
  floats; with the branches held, the recursion is linear, and a
  log-depth associative scan gives its values and, by autograd, its
  gradient.
- Filtered-noise reverb: white noise band-limited by twelve windowed-sinc
  bands (``scipy.signal.firwin``), shaped by exponential decays and gains,
  averaged over the bands into a stereo IR; the input convolved with it by
  FFT and mixed wet/dry.
- Multi-resolution STFT loss on ``torch.stft``.

``rnd`` is the rounding that the coefficients, each stage's output, the
gain curve and the IR take: none in the reference, a cast through bfloat16
in the control. A bfloat16 denominator is kept inside the stability
triangle on its own grid (a 20 Hz shelf's poles round onto the unit
circle otherwise, and its response to infinity).
"""

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

SR = 44100
LN9 = math.log(9.0)

EQ_KINDS = ("low_shelf", "peaking", "peaking", "peaking", "peaking", "high_shelf")


def eq_ranges(sr: int = SR):
    """(lo, hi) of the 18 normalized EQ parameters: (gain dB, cutoff Hz, Q)
    for each band in order."""
    g, q = (-20.0, 20.0), (0.1, 6.0)
    cut = ((20, 2000), (80, 2000), (2000, 8000), (8000, 12000), (12000, sr // 2 - 1000), (4000, sr // 2 - 1000))
    return [r for c in cut for r in (g, c, q)]


COMP_RANGES = ((-60.0, 0.0), (1.0, 20.0), (5.0, 100.0), (5.0, 100.0), (0.0, 12.0), (0.0, 12.0))
GAIN_RANGE = (-24.0, 24.0)


def denorm(p: torch.Tensor, ranges) -> torch.Tensor:
    """Normalized (bs, n) on [0, 1] to the ranges' values, clamped first."""
    p = torch.clamp(p, 0.0, 1.0)
    lo = torch.tensor([r[0] for r in ranges], dtype=p.dtype, device=p.device)
    hi = torch.tensor([r[1] for r in ranges], dtype=p.dtype, device=p.device)
    return lo + p * (hi - lo)


def exact(t):
    return t


def bf16_round(t):
    return t.to(torch.bfloat16).to(t.dtype)


# ---------------------------------------------------------------- EQ


def biquad(gain_db, freq, q, kind: str, sr: float = SR):
    """Audio-EQ-Cookbook coefficients (b, a), each (bs, 3), a0 divided out."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * freq / sr
    cw, alpha = torch.cos(w0), torch.sin(w0) / (2.0 * q)
    if kind == "peaking":
        b = (1 + alpha * A, -2 * cw, 1 - alpha * A)
        a = (1 + alpha / A, -2 * cw, 1 - alpha / A)
    else:
        sA = torch.sqrt(A)
        s = 1.0 if kind == "low_shelf" else -1.0  # the shelves differ by the sign of cos w0's terms
        b = (A * ((A + 1) - s * (A - 1) * cw + 2 * sA * alpha),
             s * 2 * A * ((A - 1) - s * (A + 1) * cw),
             A * ((A + 1) - s * (A - 1) * cw - 2 * sA * alpha))
        a = ((A + 1) + s * (A - 1) * cw + 2 * sA * alpha,
             -s * 2 * ((A - 1) + s * (A + 1) * cw),
             (A + 1) + s * (A - 1) * cw - 2 * sA * alpha)
    b, a = torch.stack(b, -1), torch.stack(a, -1)
    return b / a[:, :1], a / a[:, :1]


def eq_sections(values: torch.Tensor, sr: float = SR, rnd: Callable = exact):
    """The six (b, a) sections from denormalized EQ values (bs, 18); under
    a rounding ``rnd``, each coefficient rounded and each denominator kept
    inside the stability triangle on the rounded grid."""
    out = []
    for i, k in enumerate(EQ_KINDS):
        b, a = biquad(values[:, 3 * i], values[:, 3 * i + 1], values[:, 3 * i + 2], k, sr)
        out.append((b, a) if rnd is exact else (rnd(b), _stable(rnd(a), rnd)))
    return out


def _stable(a: torch.Tensor, rnd: Callable) -> torch.Tensor:
    """Denominators [1, a1, a2] clamped to |a2| <= 1 - 2^-7 and |a1| <= 1 +
    a2 - 2^-7, then rounded: a pole radius a bfloat16 section can hold."""
    m = 2.0 ** -7
    a2 = torch.clamp(a[:, 2], -1.0 + m, 1.0 - m)
    lim = 1.0 + a2 - m
    a1 = torch.maximum(torch.minimum(a[:, 1], lim), -lim)
    return rnd(torch.stack([a[:, 0], a1, a2], dim=-1))


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def iir_by_frequency_sampling(x: torch.Tensor, sections) -> torch.Tensor:
    """The cascade of (b, a) sections, each (bs, 3), over x (bs, ch, T)."""
    T = x.shape[-1]
    n = next_pow2(2 * T)
    H = 1.0
    for b, a in sections:
        H = H * torch.fft.rfft(b, n) / torch.fft.rfft(a, n)
    return torch.fft.irfft(torch.fft.rfft(x, n) * H[:, None, :], n)[..., :T]


def parametric_eq(x, values, rnd: Callable = exact):
    return rnd(iir_by_frequency_sampling(x, eq_sections(values, rnd=rnd)))


# ---------------------------------------------------------------- compressor


def ballistics_branches(g: np.ndarray, aa: np.ndarray, ar: np.ndarray, y0: Optional[np.ndarray] = None):
    """The attack/release recursion from rest (or ``y0``) on rows (R, T) in
    Python floats: returns (y, attack), attack[r, n] true where
    g[r, n] < y[r, n - 1]."""
    R, T = g.shape
    y = np.empty((R, T))
    attack = np.empty((R, T), dtype=bool)
    for r in range(R):
        row, p, a_att, a_rel = g[r].tolist(), 0.0 if y0 is None else float(y0[r]), float(aa[r]), float(ar[r])
        out, br = [0.0] * T, [False] * T
        for n, v in enumerate(row):
            if v < p:
                p = a_att * p + (1.0 - a_att) * v
                br[n] = True
            else:
                p = a_rel * p + (1.0 - a_rel) * v
            out[n] = p
        y[r], attack[r] = out, br
    return y, attack


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[n] = a[n] y[n-1] + b[n] from y[-1] = 0 along the last axis, by a
    log-depth associative scan (differentiable)."""
    T, s = a.shape[-1], 1
    while s < T:
        b = torch.cat([b[..., :s], a[..., s:] * b[..., :-s] + b[..., s:]], dim=-1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], dim=-1)
        s *= 2
    return b


def gain_curve(x, thr, ratio, knee, eps: float = 1e-8):
    """Side chain (the channels' sum) in dB and the soft-knee compressor's
    gain g = x_sc - x_db (dB), (bs, T); thr, ratio, knee (bs, 1)."""
    x_db = 20.0 * torch.log10(torch.clamp(torch.abs(x.sum(dim=1)), min=eps))
    half = knee / 2.0
    knee_curve = x_db + (1.0 / ratio - 1.0) * (x_db - thr + half) ** 2 / (2.0 * torch.clamp(knee, min=1e-6))
    above = thr + (x_db - thr) / ratio
    x_sc = torch.where((x_db >= thr - half) & (x_db <= thr + half), knee_curve, x_db)
    x_sc = torch.where(x_db > thr + half, above, x_sc)
    return x_sc - x_db


def compressor(x, values, rnd: Callable = exact, sr: float = SR):
    """Feed-forward compressor on (bs, ch, T) with denormalized values (bs,
    6): threshold, ratio, attack ms, release ms, knee, makeup."""
    thr, ratio, att, rel, knee, makeup = (values[:, i:i + 1] for i in range(6))
    g = rnd(gain_curve(x, thr, ratio, knee))
    aa = rnd(torch.exp(-LN9 / (sr * att / 1e3)))
    ar = rnd(torch.exp(-LN9 / (sr * rel / 1e3)))
    _, attack = ballistics_branches(g.detach().cpu().double().numpy(),
                                    aa.detach().cpu().double().numpy()[:, 0], ar.detach().cpu().double().numpy()[:, 0])
    a = torch.where(torch.as_tensor(attack, device=g.device), aa, ar)
    y = rnd(linear_scan(a, (1.0 - a) * g))
    return rnd(x * 10.0 ** ((y + makeup)[:, None, :] / 20.0))


# ---------------------------------------------------------------- reverb

OCTAVE_CENTERS = (31.5, 63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0)


def band_filters(taps: int = 1023, sr: float = SR) -> np.ndarray:
    """The twelve bands' FIR taps (12, taps): a 12 Hz lowpass, the ten
    octave bands, an 18 kHz highpass (windowed sinc)."""
    import scipy.signal

    bank = [scipy.signal.firwin(taps, 12, fs=sr)]
    for fc in OCTAVE_CENTERS:
        hi = min(fc * math.sqrt(2), sr / 2 * 0.999)
        bank.append(scipy.signal.firwin(taps, [fc / math.sqrt(2), hi], fs=sr, pass_zero=False))
    bank.append(scipy.signal.firwin(taps, 18000, fs=sr, pass_zero=False))
    return np.stack(bank)


def fft_conv(x: torch.Tensor, h: torch.Tensor, out_len: int, start: int = 0) -> torch.Tensor:
    """The linear convolution of x and h (broadcast over leading axes),
    samples [start, start + out_len)."""
    n = next_pow2(x.shape[-1] + h.shape[-1] - 1)
    y = torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(h, n), n)
    return y[..., start:start + out_len]


def shape_ir(banded: torch.Tensor, gains: torch.Tensor, decays: torch.Tensor) -> torch.Tensor:
    """Band-limited noise (bs, 2, 12, n) under the bands' exponential
    decays and gains, averaged over the bands: the stereo IR (bs, 2, n)."""
    n = banded.shape[-1]
    t = torch.linspace(0.0, 1.0, n, dtype=banded.dtype, device=banded.device)
    env = torch.exp(-(decays[:, None, :, None] * 10.0 + 1.0) * t)
    return torch.mean(banded * env * gains[:, None, :, None], dim=2)


def noise_ir(noise: torch.Tensor, gains, decays, taps: int = 1023) -> torch.Tensor:
    """The IR from white noise (bs * 2, 12, n + taps - 1), each band's row
    filtered by its band ('valid' part of the convolution)."""
    h = torch.as_tensor(band_filters(taps), dtype=torch.float64, device=noise.device)
    n = noise.shape[-1] - taps + 1
    banded = fft_conv(noise.double(), h, n, start=taps - 1)
    return shape_ir(banded.reshape(gains.shape[0], 2, 12, n), gains, decays)


def spectral_noise_ir(re: torch.Tensor, im: torch.Tensor, gains, decays, n: int, taps: int = 1023):
    """The IR from band-limited noise drawn in the spectral domain: unit
    white noise's rfft has N(0, n/2) real and imaginary parts on interior
    bins and a real N(0, n) value at DC and Nyquist; ``re``, ``im`` (bs *
    2, 12, n // 2 + 1) are the standard normal draws. Each band's spectrum
    is that of its taps reversed in time."""
    re, im = re.double().clone(), im.double().clone()
    re[..., 0] *= math.sqrt(2.0)
    im[..., 0] = 0.0
    if n % 2 == 0:
        re[..., -1] *= math.sqrt(2.0)
        im[..., -1] = 0.0
    h = torch.as_tensor(np.ascontiguousarray(band_filters(taps)[:, ::-1]), dtype=torch.float64, device=re.device)
    banded = torch.fft.irfft(torch.complex(re, im) * math.sqrt(n / 2.0) * torch.fft.rfft(h, n), n)
    return shape_ir(banded.reshape(gains.shape[0], 2, 12, n), gains, decays)


def reverb(x, ir, mix, rnd: Callable = exact):
    """x (bs, 1 or 2, T) (mono to stereo) convolved with ir (bs, 2, n),
    the first T samples, mixed: (1 - mix) x + mix wet; mix (bs,)."""
    x = x.expand(x.shape[0], 2, x.shape[-1])
    wet = rnd(fft_conv(x, ir, x.shape[-1]))
    return rnd((1.0 - mix[:, None, None]) * x + mix[:, None, None] * wet)


def gain(x, gain_db):
    return x * 10.0 ** (gain_db[:, None, None] / 20.0)


# ---------------------------------------------------------------- loss


def stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int, eps: float = 1e-8) -> torch.Tensor:
    """|STFT| of (..., T): reflect-padded frames, periodic Hann of ``win``
    centred in ``n_fft``, magnitude sqrt(power + eps)."""
    w = torch.hann_window(win, periodic=True, dtype=x.dtype, device=x.device)
    S = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop, win, window=w, center=True, pad_mode="reflect",
                   return_complex=True)
    return torch.sqrt(S.real ** 2 + S.imag ** 2 + eps)


def mrstft_loss(y_hat, y, sizes: Sequence = ((1024, 256, 600), (2048, 512, 1200), (512, 128, 240)),
                eps: float = 1e-8):
    """Mean over the resolutions of spectral convergence (one global norm
    ratio) plus the mean absolute log-magnitude difference."""
    total = 0.0
    for n_fft, hop, win in sizes:
        m_hat, m = stft_mag(y_hat, n_fft, hop, win, eps), stft_mag(y, n_fft, hop, win, eps)
        sc = torch.linalg.vector_norm(m - m_hat) / (torch.linalg.vector_norm(m) + eps)
        total = total + sc + torch.mean(torch.abs(torch.log(m) - torch.log(m_hat)))
    return total / len(sizes)
