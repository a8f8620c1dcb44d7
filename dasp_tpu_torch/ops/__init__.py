"""Signal primitives: filter design, FFT convolution, IIR building blocks
and the hand-written CUDA kernels with their backward. PyTorch counterpart of
``dasp_tpu/ops`` (the parts the style-transfer render runs through)."""

from .ballistics_kernel import ballistics_bwd_rows_plain, ballistics_pallas, ballistics_plain
from .biquad import biquad
from .fft_filter import next_fast_len, next_pow2
from .filterbank import NUM_OCTAVE_BANDS, OCTAVE_BAND_CENTERS, octave_band_filterbank
from .fir import fft_conv_causal, fft_correlate_valid
from .iir import (
    ar_impulse_response,
    ballistics_smooth,
    block_toeplitz_operators,
    embed_first_order_sos,
    onepole_ba,
    stabilize_sos,
)
from .iir_kernel import (
    adjoint_sos,
    lfilter1_pallas,
    sosfilt_pallas,
    sosfilt_plain,
    sosfilt_rows_grad_plain,
)

__all__ = [
    "biquad",
    "next_pow2",
    "next_fast_len",
    "NUM_OCTAVE_BANDS",
    "OCTAVE_BAND_CENTERS",
    "octave_band_filterbank",
    "fft_conv_causal",
    "fft_correlate_valid",
    "ar_impulse_response",
    "ballistics_smooth",
    "block_toeplitz_operators",
    "embed_first_order_sos",
    "onepole_ba",
    "stabilize_sos",
    "sosfilt_pallas",
    "sosfilt_plain",
    "sosfilt_rows_grad_plain",
    "adjoint_sos",
    "lfilter1_pallas",
    "ballistics_pallas",
    "ballistics_plain",
    "ballistics_bwd_rows_plain",
]
