#!/usr/bin/env python3
"""Smoke run of dasp_tpu_torch on one CUDA GPU.

Builds the hand-written CUDA kernels from ``dasp_tpu_torch/csrc`` and drives
the port's style-transfer render and training step, its blind estimation
of the pitch shifter and chorus, its mastering step, its denoising step,
its serving path at full width, and its examples on wav files:

  phase 0  the card: name and power limit (nvidia-smi); fails without CUDA
  phase 1  build (nvcc, sm_90a) and load the kernels; build time
  phase 2  biquad-cascade kernel (A, a time-parallel chunked scan) on the
           EQ's shapes (8 rows x 131072, 6 sections), at a ragged T, on the
           one-pole case (1 section) and on the EQ's hardest corner (a 20 Hz /
           Q 6 low shelf), against float64 scipy and against its plain
           PyTorch version; wrapper and kernel-only device times
  phase 3  ballistics kernel (B-fwd, speculate and verify) at 8 x 1 x 131072
           on compressor gain curves (with and without y0), the 100 / 100,
           5 / 100 and 20 / 20 ms time constants, a constant g, a step, ties
           g == y, long runs of g = 0 (bursts between silences below the
           knee), a noise gate's curve (expander curve floored at its range,
           10 ms hold, swapped coefficients) and an expander's curve, the
           corruption's 262144 samples and a ragged T: bitwise
           equal to the plain loop, chunk-chained == one pass; the rounds'
           work, a call's and the kernel's device time for each
  phase 4  the slice: full-width StyleTransferNet (bf16 encoder convolutions,
           eval mode) then EQ("pallas") -> Compressor("exact_pallas") ->
           NoiseShapedReverb(65536-tap IR) -> Gain on 3 batches of 8
           (input, reference) pairs of 131072 samples; launch counts (kernel
           E's 20 a batch among them), output checks, agreement with the
           plain path, per-batch latencies
  phase 5  kernel A's gradient (save-all forward + adjoint cascade) at the
           EQ's shapes (6 sections, 7 in the adjoint), at a ragged T, the
           one-pole's and the 20 Hz / Q 6 shelf's: dsos and dx against
           float64 autograd and the plain fp32 adjoint; times of the two
           launches and of the gradient's correlations
  phase 6  the ballistics backward kernel (B-bwd, a float64 chunked scan) on
           compressor gain curves at 131072 and 262144 samples: against the
           plain reverse loop in float64 (B_BWD_TOL, and at most 2 x the
           plain fp32 loop's distance plus it), bitwise from run to run; the
           gradient through chunk-chained evaluation against float64 too
  phase 7  the training slice: full-width StyleTransferNet (bf16 encoder,
           train mode) at bs 8 on 262144-sample clips (131072-sample halves),
           65536-tap IR: 1 warm-up and 3 timed train_step calls (corruption,
           forward + loss, backward, Adam, by CUDA events); exact launch
           counts, finite loss and gradients, parameters changed; one step's
           gradients again on the plain path (EQ "exact", compressor
           "exact") from the same weights, batch and noise
  phase 8  fractional-delay kernel (C-fwd) at 8 x 131072: the blind path's
           mono pitch shifter, and at 8 x 2 x 131072 the pitch shifter
           (two wrapping taps, 60 ms window, B 256) and an LFO modulated
           delay (22 ms bound, B 512): against a float64 two-point
           reference, bitwise against its plain engine, against the dense
           plain version; ms a call and of the kernel alone, and of the
           whole effects' forward and gradient on the kernel and on the
           dense path
  phase 9  its backward (C-bwd) at the same shapes: dx, dd, dg against
           float64, the plain engine and the dense version's autograd; dd
           and dg bitwise from run to run; dx's global atomics; ms a call
           and alone, with and without dx; the reference kernel's fault
           case (a ramp with dr/dt = 20, wraps=False) against float64
  phase 10 the blind-estimation slice: the 198,354-parameter
           ParameterNetwork preset with PitchShift at bs 8 on 131072-sample
           mono clips: 1 warm-up and 3 timed steps (target render, forward
           + loss, backward, Adam, by CUDA events), exact launch counts,
           finite loss and gradients, parameters changed; one Chorus step;
           the effect's gradient with respect to a fixed p_hat three ways
           (kernel fp32, dense plain fp32, dense float64) held to bounds,
           and the net's gradients the same three ways, printed
  phase 11 the "fsm" defaults: ParametricEQ(SR) and Compressor(SR) with no
           option given (frequency sampling on cuFFT) at 8 x 2 x 131072,
           output and the gradient of mean(y ** 2) with respect to the
           normalized parameters against the same in float64 on the card:
           the compressor within 1e-4 of max(1, peak); the EQ's FIR
           application on a fixed response within it, its whole distance
           printed beside the CPU's (see phase_fsm); ms of each
  phase 12 the block-state and scan-based filters (sosfilt_blockmat and
           sosfilt_exact on the EQ's 8 x 131072 with 6 random sections,
           lfilter1_blockmat on the compressor smoother's 8 x 1 x 262144):
           output and gradient against float64, with TF32 off and then on
           (set by the caller; the output must not change), no kernel
           launched; ms a call and device ms alone, forward and gradient,
           beside kernel A (sosfilt_pallas, lfilter1_pallas) on the same
           inputs
  phase 13 the JAX bench's own step: make_style_training with EQ "block" and
           compressor "block" from phase 7's weights, batch and noise: its
           corruption, and its render loss and gradient on one corrupted
           batch, against the kernel path of the same function (EQ
           "pallas", compressor "pallas": the "block" smoother is the
           attack-only one-pole) at phase 4's and phase 7's tolerances; 1
           warm-up and 3 timed steps split as phase 7's, no kernel launched
  phase 14 the reference set through Chain: 4 mono tracks of 131072 samples
           at bs 8 through StereoPanner, StereoBus(4) and Chain([Distortion,
           ParametricEQ("pallas"), Compressor("exact_pallas"),
           StereoWidener, Gain]) from one (8, 35) normalized tensor, the
           MR-STFT loss and backward: exact launches of A (forward,
           save-all, adjoint) and B (forward, backward), output and
           gradient against the plain path (EQ "exact", compressor
           "exact"); ms of the render and of forward + backward. Each
           track first runs the mixing console's graphic EQ (GraphicEQ,
           "coupled"), from 10 more columns a track
  phase 15 the dynamics family at 8 x 2 x 131072, each effect at its
           defaults: forward and the gradient of mean(y ** 2) against the
           same function in float64 on the card (for the five users of
           kernel B, expander, sidechain compressor, noise gate, de-esser
           and limiter, its smoother the plain recursion in float64 by
           ballistics_float64, itself held to the plain loop first: the
           loop takes about 50 s a call on the card; the bitcrusher by
           bitcrusher_float64, its hold positions from the effect's fp32
           clock, a one-step flip of the rounding forgiven only within
           fp32 rounding of a half point); exact B launches (one forward,
           one backward for each kernel user, none for the others); ms a
           call, forward and forward + gradient. sosfilt_coupled on the
           graphic EQ's 10 sections at +-12 dB against float64 scipy, TF32
           off and on, beside the same formulation computed in fp32 (the
           evidence for computing in float64)
  phase 16 the mastering step (examples/mastering.py's whole chain:
           TransientShaper, DynamicEQ(3), MultibandCompressor, Exciter,
           Limiter; 47 logits, MR-STFT + 10 x MSE, Adam 2e-2) at bs 8 stereo
           clips of 131072 samples: 1 warm-up and 3 timed steps split into
           target / forward + loss / backward / Adam by CUDA events, exact B
           launches, finite loss and gradients, z changed; one step's
           render, loss and gradient of z on the plain path (limiter
           "exact") from the same z, batch and target
  phase 17 the rest of the delay family (delay, ring modulator, tremolo,
           stereo imager, convolution reverb with a 65536-tap IR, wow and
           flutter) and the WOLA family (noise profile, spectral gate,
           dynamic EQ, phaser, auto-wah, time stretch and pitch shift in
           their processors' modes) at 8 x 2 x 131072: forward and the
           gradient of mean(y ** 2) against the same function in float64 on
           the card (phase 15's rules; wow_flutter's delay parameters by
           phase 10's rule for kernel C, against float64 and the dense fp32
           path), exact launches (kernel C for
           wow_flutter, one forward and one backward; none for the rest), ms
           a call, forward and forward + gradient; tv_istft(tv_stft(x)) ==
           x to roundoff; the contractions the reference runs at
           Precision.HIGHEST (computed in float64) the same bits with TF32
           off and on, and their cost beside the fp32 einsum; the phase
           vocoder's x-gradient finite on a clip with a silent first half
  phase 18 the denoising step (examples/denoise.py: the noise profile of a
           noise-only capture, SpectralGate with it, 4 logits, MSE, Adam
           3e-2) at bs 8 mono clips of 131072 samples (the example's bs 1):
           1 warm-up and 3 timed steps split into profile / forward + loss /
           backward / Adam by CUDA events, no kernel launched, finite loss
           and gradient, z changed; one step's loss and gradient of z
           against float64 on the card
  phase 19 the serving path: benchmarks/streaming_latency.py's two chains
           through streaming.StreamChain, stereo, 131072 samples. Classic
           (parametric EQ "coupled" -> compressor -> reverb with a
           65536-tap IR) at bs 1 and 8, chunks of 128, 512 and 2048, the
           compressor's smoother "block" and "exact" (kernel B); mastering
           (transient shaper -> dynamic EQ -> exciter -> limiter "exact")
           at bs 1, chunks of 512 and 2048. Each: chunked against the
           offline render of the same chain (STREAM_TOL), "exact" bitwise
           against the same stream on the plain loop (over its first
           PLAIN_CHECK_T samples), one B-fwd launch a chunk and no B-bwd,
           ms a chunk (p50 and p99 of the main run's chunks after 20, at
           least 200, by CUDA events and by the host clock), the real-time
           margin, each stage's ms and the device work a chunk.
           Integrated loudness of the mastering output, "coupled" and
           "pallas" (kernel A, one launch), against float64 on the card;
           the 997 Hz calibration; the mastering chain's processors through
           save_preset / load_preset render the same bits; B-fwd alone on
           2 x 128 and 2 x 2048 with y0
  phase 20 file-backed training on the card: mono and stereo 16-bit wavs
           written by save_wav and indexed by index_wav_dataset (the
           native library required); 16 batches of 8 x 2 x 131072 from
           load_clip_batch through BatchPacker into device_prefetch (depth
           3, one worker) bitwise their host batches, mono-mixed ones over
           the i16 wire with the upload thread bitwise the host's decode;
           ms a batch of a blocking copy and of device_prefetch. Then the
           examples through main(argv) on --data-dir: auto_eq
           --filter-method pallas (the auto_eq preset net, bs 8 x 131072)
           4 steps, a checkpoint every 2, resumed to step 6;
           blind_estimation of pitch_shift and of the compressor with
           exact_pallas, 3 steps each; exact launches a step of A, C and
           B; then quickstart (at tests/test_integration.py's threshold),
           demo, mixing_console, streaming_demo, denoise, virtual_analog
           with pre-placed amp pairs, every wav they write on the 16-bit
           grid
  phase 21 the parallel layer (dasp_tpu_torch.parallel) and the last two
           examples. (a) A one-rank NCCL world on the card runs
           style_transfer's main --dp at full width (StyleTransferNet(),
           bs 8 x 262144, 65536-tap IR, --filter-method pallas --smoother
           exact_pallas) for STYLE_STEPS steps with a checkpoint, then
           resumes for one more: finite losses, exact A and B launches a
           step, ms a step. (b) gloo
           ranks sharing cuda:0 (sp 2 and 4) on a compressor's curve at
           8 x 2 x 131072: the exact relay bitwise the unsharded B-fwd,
           one B-fwd and one B-bwd launch a rank, its gradient against
           float64 within B_BWD_TOL; its wall time beside one unsharded
           B-fwd (ranks that share one card: correctness and launches, not
           multi-card speed). (c) The same ranks: every other sharded
           function (conv, coupled EQ, one-pole, "attack_only" and
           "parallel" ballistics, tv filter and power, MR-STFT loss)
           against the unsharded port on the card at the CPU tests'
           tolerances. (d) dp 2 x sp 2 gloo ranks run style_transfer's step
           at full width (EQ "coupled", the reverb's convolution and the
           relay sharded, BatchNorm over dp) against the one-rank step at
           the same numerics: the loss within 2e-5 and the BatchNorm
           statistics within 1e-5 (tests/test_torch_parallel_step.py's fp32
           bars); the gradient of each part of the net (encoder blocks,
           encoder dense layers, projectors) within the larger of 3e-3
           and 3 x that part's fp32 noise floor, the one-rank step's own
           distance on clips moved by an ulp (at full width the L1
           log-magnitude loss moves the encoder blocks' gradient by
           percents on such clips). A planted fault, BatchNorm on each
           rank's own statistics, must break that gradient bar. 2 B-fwd
           and 1 B-bwd a rank. (e)
           mastering's main on one rank, exact B launches
  phase 22 the coupled cascade's stream step kernel (D) at the two serving
           shapes (1 x 2 x 512 and 8 x 2 x 512, the classic chain's 6 EQ
           sections, a carried state): against its plain float64 loop and
           the block-state loop it replaces within one fp32 ulp of the
           peak; the kernel alone (profiler) and a call (CUDA events, host
           clock) beside its bound and the block-state loop's times. Phase
           19 holds every stream to one D launch a chunk (the classic
           chain's EQ, the mastering chain's exciter)
  phase 23 kernel E, one eval-mode TCN layer (conv, bias, PReLU, BatchNorm)
           in one launch, at each of the style encoder's 20 layer shapes
           at the render's merged batch (16 clips of 131072), the
           activations chained layer to layer: against its plain version
           (float64 sums) and cuDNN's path within TCN_DIFFER_SHARE's rule; the
           kernel alone (profiler) and a call (CUDA events) beside its bound
           (bf16 FLOPs over 989 TFLOP/s or bytes over 3.35 TB/s), the plain
           version's time and cuDNN's conv + PReLU + BatchNorm as
           library_ms (the port never calls it there); then the whole
           StyleTransferNet forward at bs 8 on kernel E (20 launches) and
           on cuDNN's path, and the parameters' gap between them

Prints one JSON line of per-kernel results (with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its fp32 operations over 67 TFLOP/s,
an H100 SXM's published peaks, or for kernel E its bf16 operations over 989
TFLOP/s; no single PyTorch call computes any of the other functions, so
their ``library_ms`` is null), then as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
``python3 chip_smoke.py --time-ballistics-of DIR`` only times kernel B's two
launches of the package in the checkout DIR (see :func:`time_ballistics`),
``--time-frac-delay-of DIR`` kernel C's (see :func:`time_frac_delay`),
``--time-style-step`` splits style_transfer's step (see
:func:`time_style_step`), ``--coupled-step`` runs phase 22 alone and
``--tcn-layer`` phase 23.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

SR = 44100
BS = 8
T = 131072
IR = 65536
BATCHES = 3
# kernel A's bound against float64 (tests/test_pallas_iir.py's bound for the
# TPU kernel), and the most it may exceed the plain version's own error by
A_BOUND = 2e-3
A_PLAIN_FACTOR = 2.0
# kernel A's gradient against float64, relative to the largest float64
# gradient (tests/test_torch_kernels.py's bounds: the gradient with respect
# to denominator coefficients is ill-conditioned in fp32)
A_GRAD_BOUND = {"dsos": 1e-2, "dx": 1e-3}
# the ragged case of kernel A: T - RAGGED samples, no multiple of the
# kernel's 32-sample chunk or 8192-sample tile
RAGGED = 1234
TRAIN_STEPS = 3
FULL_WIDTH_PARAMS = 10_322_246
# launches per training step: A forward in the corruption, save-all in the
# render, adjoint in the backward; B forward in the corruption and the
# render, backward once
STEP_LAUNCHES = {"sosfilt_cascade": 1, "sosfilt_cascade_save_all": 1,
                 "sosfilt_cascade_adjoint": 1, "ballistics": 2, "ballistics_bwd": 1}
# B-bwd (a float64 scan, each result rounded to fp32 once) against the plain
# reverse loop in float64: dg and dy0 relative to their largest value, daa
# and dar to the sum of |terms| of their branch; at most this, and at most
# 2 x the plain fp32 loop's own distance plus this. Rounding a float64 value
# to fp32 once moves it by at most 6e-8 of itself; measured on an H100 at
# 8 x 131072 and 262144: the kernel at most 5.1e-8, the plain fp32 loop
# 6.4e-7 to 1.8e-6
B_BWD_TOL = 2e-7
# the plain-path step against the kernel path (relative)
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_NORM_TOL = 1e-2
# kernel C against float64: at most 2 x the dense plain version's error plus
# these floors (forward: absolute; backward: of the largest float64 value;
# dd also off the fp32 kinks, where every fp32 version takes dd = 0).
# Measured on an H100 at 8 x 2 x 131072: forward 1.300e-4 (kernel, plain
# engine and dense alike); backward of each largest value dx 1.036e-4, dd
# 3.627e-1 at the fp32 kinks (8.3e-8 off them), dg 1.477e-4, the dense
# version within a factor 1.4 of the kernel either way
C_FWD_FLOOR = 1e-6
C_BWD_FLOOR = 1e-6
# C-bwd against its plain engine: dd and dg bitwise; dx summed by atomics
# in another order, within this fraction of dx's largest float64 value
C_BWD_DX_ENGINE_TOL = 1e-6
# the reference kernel's fault case: relative to the float64 peak
RAMP_TOL = 1e-5
# the "fsm" defaults in fp32 against float64 on the card, of max(1, peak)
# (tests/test_parity.py's bar for the reference's fixtures)
FSM_TOL = 1e-4
BLIND_PARAMS = {"PitchShift": 198_354, "Chorus": 198_612}
BLIND_STATS = 1_472
# launches per blind-estimation step: C-fwd in the target render and the
# re-render, C-bwd once; no A, no B
BLIND_STEP_LAUNCHES = {"frac_delay": 2, "frac_delay_bwd": 1}
# the effect's gradient d(stft_loss)/d(p_hat) at a fixed p_hat, for each
# parameter, relative to its float64 norm: the kernel's distance from float64
# at most 2 x the dense plain path's plus this floor, and its distance from
# the dense fp32 path at most EFFECT_GRAD_FP32_TOL. Measured on an H100 at
# full width in two runs: from float64 semitones 0.575-0.887 (kernel and
# dense alike: a sum of ~1e6 cancelling terms, each moved by the fp32 render
# error, so the float64 rule cannot tell a wrong kernel there) and mix
# 8.7e-3-7.05e-2; kernel vs dense fp32 at most 7.5e-4 and 1.2e-4, against
# 8.3e-2 and 1.2e-1 for C-bwd kernels with dd zeroed or scaled by 0.8. The net's gradient is printed only: both fp32
# paths sit one to four norms from float64 there.
EFFECT_GRAD_FLOOR = 1e-2
EFFECT_GRAD_FP32_TOL = 1e-2


# phases 14-16: the kernel path (or fp32) against the plain path (or
# float64): outputs within 2 x A_BOUND x max(1, peak), each gradient within
# TRAIN_GRAD_NORM_TOL of its norm; sosfilt_coupled within this of
# max(1, peak) of float64 scipy
COUPLED_TOL = 1e-5
# phase 23: kernel E against its plain version and cuDNN's path, element by
# element: all three round the convolution's output to bf16 and then add the
# bias in bf16, but their sums run in another order and BatchNorm's affine
# is grouped otherwise, so a bf16 rounding may land one ulp (2**-7 of the
# value) apart where a value lies next to a rounding boundary: |diff| <=
# 2**-7 (|gamma invstd| (2 |v| + |bias|) + |y|), v the value BatchNorm
# normalized, on at most TCN_DIFFER_SHARE of the elements
TCN_DIFFER_SHARE = 0.001
MASTERING_PARAMS = 47
# phase 15: the float64 reference ballistics against the plain loop over
# this many samples
PLAIN_CHECK_T = 16384
# phase 15: the bitcrusher's fp32 rounding may take a different step than
# float64's where u = held * 2^(bit_depth - 1) lies within this share of
# max(1, |u|) of a half point (about 16 fp32 ulps: the product's and the
# power's roundings)
HALF_POINT_WINDOW = 1e-6
# launches per mastering step: the Limiter's forward in the target
# render and in the render, its backward once
MASTERING_STEP_LAUNCHES = {"ballistics": 2, "ballistics_bwd": 1}
# phase 15: processor, its function, whether it runs kernel B at its defaults
DYNAMICS = {
    "Expander": ("expander", True), "SidechainCompressor": ("sidechain_compressor", True),
    "NoiseGate": ("noise_gate", True), "DeEsser": ("de_esser", True), "Limiter": ("limiter", True),
    "MultibandCompressor": ("multiband_compressor", False), "TransientShaper": ("transient_shaper", False),
    "GraphicEQ": ("graphic_eq", False), "Exciter": ("exciter", False),
    "AdvancedDistortion": ("advanced_distortion", False), "Bitcrusher": ("bitcrusher", False),
    "Clipper": ("clipper", False),
}


# phase 17: each effect, its processor (whose ranges give the parameters;
# None: it has none) and the options the processor sets (and time_stretch's
# out_len, the input's length, as TimeStretch sets it)
WOLA_DELAY = {
    "delay": ("Delay", {}), "ring_modulator": ("RingModulator", {}), "tremolo": ("Tremolo", {}),
    "stereo_imager": ("StereoImager", {}), "convolution_reverb": ("ConvolutionReverb", {}),
    "wow_flutter": ("WowFlutter", {}), "spectral_noise_profile": (None, {}), "spectral_gate": ("SpectralGate", {}),
    "dynamic_eq": ("DynamicEQ", {}), "phaser": ("Phaser", {}), "auto_wah": ("AutoWah", {}),
    "time_stretch": ("TimeStretch", {}), "pitch_shift_pv": ("PitchShiftPV", {"max_semitones": 12.0}),
}
# phase 17: kernel launches of one forward and gradient (wow_flutter's delay
# runs kernel C; no other effect launches a kernel)
WOLA_DELAY_LAUNCHES = {"wow_flutter": {"frac_delay": 1, "frac_delay_bwd": 1}}
# phase 17: tv_istft(tv_stft(x)) against x, of max(1, peak): fp32 FFTs of
# 4096 points and a window whose fp32 COLA sum is 1 within 6e-8
ROUNDTRIP_TOL = 1e-5
# phase 18: examples/denoise.py's noise level (dB)
DENOISE_NOISE_DB = -30.0
# phase 19: benchmarks/streaming_latency.py's serving chains, their batch
# sizes and chunk lengths, the classic chain's EQ and compressor values,
# and the chunks of a stream's run left untimed, and the fewest timed
STREAM_BS = {"classic": (1, 8), "mastering": (1,)}
STREAM_CHUNKS = {"classic": (128, 512, 2048), "mastering": (512, 2048)}
STREAM_EQ = (2.0, 200.0, 0.7, 3.0, 400.0, 1.0, -2.0, 3000.0, 2.0, 1.0, 9000.0, 1.0, 2.0, 13000.0, 1.0, -3.0, 8000.0, 0.7)
STREAM_COMP = dict(threshold_db=-24.0, ratio=4.0, attack_ms=10.0, release_ms=60.0, knee_db=6.0, makeup_gain_db=1.0)
STREAM_WARMUP = 20
STREAM_TIMED = 200
# phase 19: chunked against offline, of max(1, peak): the largest of
# tests/test_streaming.py's atols along each chain (the EQ's and the
# limiter's 5e-4)
STREAM_TOL = 5e-4
# phase 19: integrated loudness in fp32 ("coupled", "pallas") against
# float64 on the card (LU), and the 997 Hz calibration: -3.01 LUFS within
# tests/test_utils.py's 0.1 (the cookbook K-weighting of both packages
# reads -3.052 at 44.1 kHz)
LOUDNESS_TOL = 1e-3
CALIBRATION_LUFS = -3.01
CALIBRATION_TOL = 0.1

# phase 20: the wav directory (mono and stereo 16-bit files of
# DATA_SECONDS each from synthetic_batch), the batches held bitwise through
# device_prefetch, and each example run through its main(argv): the steps,
# and the kernel launches a step on the examples' kernel paths
DATA_FILES = 8
DATA_SECONDS = 6
PREFETCH_BATCHES = 16
PREFETCH_DEPTH = 3
EXAMPLE_STEPS = {"auto_eq": 4, "auto_eq resumed": 2, "blind pitch_shift": 3, "blind compressor exact_pallas": 3}
EXAMPLE_STEP_LAUNCHES = {
    "auto_eq": {"sosfilt_cascade": 1, "sosfilt_cascade_save_all": 1, "sosfilt_cascade_adjoint": 1},
    "blind pitch_shift": {"frac_delay": 2, "frac_delay_bwd": 1},
    "blind compressor exact_pallas": {"ballistics": 2, "ballistics_bwd": 1},
}
EXAMPLE_STEP_LAUNCHES["auto_eq resumed"] = EXAMPLE_STEP_LAUNCHES["auto_eq"]


# an H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes
# and fp32 operations outside the tensor cores, per second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# bf16 dense operations on the tensor cores
BF16_OPS_PER_S = 989e12
# and float64 operations outside the tensor cores
FP64_OPS_PER_S = 34e12
# fp32 operations per sample of a biquad section (5 multiplies, 4 adds)
SECTION_OPS = 9


class PhaseError(RuntimeError):
    pass


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over HBM's rate, or operations over the
    fp32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# the kernels' launch counters (dasp_tpu_torch.trace) by the names this
# script prints
LAUNCH_COUNTERS = {
    "sosfilt_cascade": "kernel_a.forward",
    "sosfilt_cascade_save_all": "kernel_a.save_all",
    "sosfilt_cascade_adjoint": "kernel_a.adjoint",
    "ballistics": "kernel_b.forward",
    "ballistics_bwd": "kernel_b.backward",
    "frac_delay": "kernel_c.forward",
    "frac_delay_bwd": "kernel_c.backward",
    "tcn_layer": "kernel_e.forward",
}


def launch_counts() -> dict:
    from dasp_tpu_torch import trace

    counts = trace.snapshot()["counts"]
    return {k: counts.get(c, 0) for k, c in LAUNCH_COUNTERS.items()}


def kernel_d_launches() -> int:
    """Kernel D's launches since the counters were last reset (not among
    LAUNCH_COUNTERS, whose phases compare all their launches with fixed
    dicts)."""
    from dasp_tpu_torch import trace

    return trace.snapshot()["counts"].get("kernel_d.forward", 0)


def reset_launch_counts() -> None:
    from dasp_tpu_torch import trace

    trace.reset()


def host_ms(fn) -> float:
    """One call of ``fn`` by the host clock, synchronized (for the plain
    loops, which launch a few small kernels per sample)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, kernels, reps: int, per_launch: bool = False) -> dict:
    """Device time per call of ``fn``, from a CUDA-only torch.profiler trace
    of ``reps`` calls after a warm-up: of the CUDA kernels whose name holds
    each of ``kernels`` (with ``per_launch``, per launch the trace recorded
    instead), and of all device work ("all"); None where the trace shows
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in (*kernels, "all"):
        hits = [e for e in events if name == "all" or name in e.key]
        us = sum(getattr(e, "device_time_total", 0) for e in hits)
        n = sum(e.count for e in hits) if per_launch and name != "all" else reps
        out[name] = us / n / 1e3 if us > 0 else None
        if per_launch and name != "all" and n != reps:
            print(f"[profiler] recorded {n} launches of {name} in {reps} calls")
    return out


def kernel_device_ms(fn, kernel: str, reps: int):
    """Device time of one launch of the CUDA kernel whose name holds
    ``kernel`` (``fn`` launches it once a call), the mean over the launches
    the trace recorded (see :func:`device_ms_by_kernel`)."""
    return device_ms_by_kernel(fn, (kernel,), reps, per_launch=True)[kernel]


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def shelf_sos(bs, device):
    """The EQ's hardest corner (ParametricEQ's low shelf at its 20 Hz and
    Q 6 limits, +12 dB): one section whose poles lie about 2.5e-4 from the
    unit circle."""
    import torch

    from dasp_tpu_torch.ops import biquad

    b, a = biquad(*(torch.full((bs,), v, device=device) for v in (12.0, 20.0, 6.0)), SR, "low_shelf")
    return torch.cat([b, a], dim=-1)[:, None, :]


def random_params(proc, rng, bs, device):
    """Denormalized parameters of ``proc`` from uniform (0, 1) draws."""
    import torch

    p = torch.tensor(rng.uniform(size=(bs, proc.num_params)).astype("float32"), device=device)
    return proc.denormalize_param_dict(proc.extract_param_dict(p))


def phase_kernel_a(rng, device):
    """Kernel A against float64 scipy and the plain version, S = 6 and S = 1."""
    import numpy as np
    import scipy.signal
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor, ParametricEQ
    from dasp_tpu_torch.ops import embed_first_order_sos, onepole_ba, stabilize_sos
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas, sosfilt_plain

    eq = random_params(ParametricEQ(SR), rng, BS, device)
    sos6 = stabilize_sos(F.parametric_eq_sos(BS, torch.float32, SR, *eq.values(), device=device))
    comp = random_params(Compressor(SR), rng, BS, device)
    alpha = torch.exp(-math.log(9.0) / (SR * comp["attack_ms"] / 1e3))
    sos1 = embed_first_order_sos(*onepole_ba(alpha))[:, None, :]
    x = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    ragged = x[..., : T - RAGGED].contiguous()

    results = {}
    # (name, sections, signal, time the plain version too)
    for name, sos, sig, plain_time in (("S=6 (EQ)", sos6, x, True), ("S=6 (EQ), ragged T", sos6, ragged, False),
                                       ("S=1 (one-pole)", sos1, x, True),
                                       ("S=1 (20 Hz / Q 6 shelf)", shelf_sos(BS, device), x, False)):
        n = sig.shape[-1]
        y_k = sosfilt_pallas(sos, sig)
        y_p = sosfilt_plain(sos, sig)
        torch.cuda.synchronize()
        sos64 = stabilize_sos(sos).double().cpu().numpy()
        x64 = sig.double().cpu().numpy()[:, 0]
        ref = np.stack([scipy.signal.sosfilt(sos64[i], x64[i]) for i in range(BS)])
        err_k = float(np.abs(y_k.double().cpu().numpy()[:, 0] - ref).max())
        err_p = float(np.abs(y_p.double().cpu().numpy()[:, 0] - ref).max())
        diff = float((y_k - y_p).abs().max())
        ms = cuda_ms(lambda: sosfilt_pallas(sos, sig), 20)
        dev_ms = kernel_device_ms(lambda: sosfilt_pallas(sos, sig), "sosfilt_cascade_kernel", 20)
        plain_ms = cuda_ms(lambda: sosfilt_plain(sos, sig), 2) if plain_time else None
        S = sos.shape[1]
        b = bound(2 * BS * n * 4 + sos.numel() * 4, SECTION_OPS * BS * n * S)
        print(f"[A {name}] T {n} | kernel vs float64 {err_k:.3e} | plain vs float64 {err_p:.3e} | "
              f"kernel vs plain {diff:.3e} | kernel {ms:.4f} ms a call (kernel alone {fmt_ms(dev_ms)} on the "
              f"device; bound {b['bound_ms']:.5f} ms by {b['bound_by']}), plain {fmt_ms(plain_ms)}")
        require(err_k <= A_BOUND, f"kernel A {name}: error {err_k:.3e} > {A_BOUND}")
        require(err_k <= A_PLAIN_FACTOR * err_p,
                f"kernel A {name}: error {err_k:.3e} > {A_PLAIN_FACTOR} x plain {err_p:.3e}")
        results[name] = {"err": err_k, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms, **b}
    return results


def alpha_ms(ms, device):
    """The (BS,) smoothing coefficient of a time constant in ms
    (functional._dynamics_common)."""
    import torch

    return torch.exp(torch.full((BS,), -math.log(9.0) / (SR * ms / 1e3), device=device))


def compressor_curve(rng, n, device):
    """A Compressor's gain curve (BS, 1, n) and its (BS,) attack and release
    coefficients, from random parameters on 0.25 * randn."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor

    comp = random_params(Compressor(SR), rng, BS, device)
    p = {k: F._param(v, BS, torch.float32, device) for k, v in comp.items()}
    x = torch.tensor((rng.standard_normal((BS, 1, n)) * 0.25).astype(np.float32), device=device)
    _, x_db, aa, ar = F._dynamics_common(x, SR, p["attack_ms"], p["release_ms"], 1e-8)
    g = F.static_gain_computer(x_db, p["threshold_db"], p["ratio"], p["knee_db"], "compressor").contiguous()
    return g, aa.reshape(BS), ar.reshape(BS)


def bursts(rng, n, device):
    """(BS, 1, n): bursts of 0.25 * randn between silences at -66 dB, each
    12000 samples long, from a random phase per row."""
    import numpy as np
    import torch

    seg = 12000
    offset = rng.integers(0, 2 * seg, (BS, 1))
    gate = np.where(((np.arange(n)[None, :] + offset) // seg) % 2 == 0, 0.25, 5e-4)
    return torch.tensor((rng.standard_normal((BS, n)) * gate).astype(np.float32), device=device)[:, None]


def gated_curve(rng, n, device):
    """A compressor's gain curve (BS, 1, n) with long runs of g = 0 exactly:
    on bursts (see :func:`bursts`), below the knee of a -20 dB threshold
    (ratio 4, knee 6 dB), where static_gain_computer returns 0."""
    import torch

    from dasp_tpu_torch import functional as F

    x_db = 20.0 * torch.log10(torch.clamp(bursts(rng, n, device).abs(), min=1e-8))
    return F.static_gain_computer(x_db, -20.0, 4.0, 6.0, "compressor").contiguous()


def dynamics_curve(rng, n, device, name, hold_ms=10.0):
    """The smoother's input (BS, 1, n) and (BS,) coefficients, in the order
    the effect passes them, of a NoiseGate ("gate": the expander curve
    floored at its range, a ``hold_ms`` hold, coefficients swapped; on
    bursts, so that it opens and closes) or an Expander ("expander": on
    0.25 * randn), from random parameters."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Expander, NoiseGate

    proc = NoiseGate(SR) if name == "gate" else Expander(SR)
    p = {k: F._param(v, BS, torch.float32, device) for k, v in random_params(proc, rng, BS, device).items()}
    if name == "gate":
        x = bursts(rng, n, device)
    else:
        x = torch.tensor((rng.standard_normal((BS, 1, n)) * 0.25).astype(np.float32), device=device)
    _, x_db, aa, ar = F._dynamics_common(x, SR, p["attack_ms"], p["release_ms"], 1e-8)
    g = F.static_gain_computer(x_db, p["threshold_db"], p["ratio"], p["knee_db"], "expander")
    if name == "gate":
        g = F._hold_max(torch.maximum(g, -p["range_db"]), int(round(SR * hold_ms / 1e3)))
        aa, ar = ar, aa
    return g.contiguous(), aa.reshape(BS), ar.reshape(BS)


def with_ties(g, aa, ar):
    """g with g[n] set to y[n-1] of the plain loop (from rest) on every 7th
    sample, so the kernel's branch compares equal values there."""
    import torch

    g = g[:, 0].cpu().clone()
    aa, ar = aa.cpu(), ar.cpu()
    y_prev = torch.zeros(g.shape[0])
    for n in range(g.shape[-1]):
        if n % 7 == 3:
            g[:, n] = y_prev
        alpha = torch.where(g[:, n] < y_prev, aa, ar)
        y_prev = (1.0 - alpha) * g[:, n] + alpha * y_prev
    return g[:, None]


def work_line(work) -> str:
    """The forward's verify work, from ``ballistics_pallas.last_work``."""
    rounds, passes, rewalked = (work[..., i] for i in range(3))
    n_tiles = work.shape[0] * work.shape[1]
    return (f"rounds per tile max {int(rounds.max())} mean {float(rounds.double().mean()):.1f}, passes max "
            f"{int(passes.max())}, samples walked again {int(rewalked.sum())} ({n_tiles} tiles)")


def phase_kernel_b(rng, device):
    """Kernel B-fwd, the speculate-and-verify kernel: bitwise equal to the
    plain loop (run on a CPU copy) and chunk-chained evaluation equal to one
    pass, on compressor curves, the time-constant corners, a constant g, a
    step, ties, the corruption's length and a ragged T; the rounds' work and
    the time of each."""
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK

    g, aa, ar = compressor_curve(rng, T, device)
    a5, a20, a100 = (alpha_ms(v, device) for v in (5.0, 20.0, 100.0))
    const = torch.full_like(g, -6.0)
    step = torch.zeros_like(g)
    step[..., T // 3 : 2 * T // 3] = -12.0
    g2, aa2, ar2 = compressor_curve(rng, 2 * T, device)
    # from a spawned generator, so that the later phases draw what they drew
    # before this case was added
    gated = gated_curve(rng.spawn(1)[0], T, device)
    gate_rng = rng.spawn(1)[0]
    gate = dynamics_curve(gate_rng, T, device, "gate")
    expander = dynamics_curve(gate_rng, T, device, "expander")
    y0 = -12.0 * torch.rand((BS, 1), device=device)
    cases = [  # name, g, attack, release, y0
        ("compressor curve", g, aa, ar, None),
        ("compressor curve, y0", g, aa, ar, y0),
        ("100 / 100 ms", g, a100, a100, None),
        ("5 / 100 ms", g, a5, a100, None),
        ("attack = release = 20 ms", g, a20, a20, None),
        ("constant g = -6 dB", const, a5, a100, None),
        ("step 0 / -12 / 0 dB", step, a5, a100, None),
        ("ties g == y every 7th sample", with_ties(g, a5, a100).to(device), a5, a100, None),
        ("long g = 0 runs (bursts, silences below the knee)", gated, aa, ar, None),
        ("noise gate curve (range floor, 10 ms hold, swapped coefficients)", *gate, None),
        ("expander curve", *expander, None),
        (f"T = {2 * T}, compressor curve", g2, aa2, ar2, None),
        (f"T = {2 * T}, 100 / 100 ms", g2, a100, a100, None),
        (f"ragged T = {T - RAGGED}", g[..., : T - RAGGED].contiguous(), aa, ar, None),
    ]
    results = {}
    for name, gc, ac, rc, y0c in cases:
        n = gc.shape[-1]
        y_k = BK.ballistics_pallas(gc, ac, rc, y0=y0c)
        work = BK.ballistics_pallas.last_work.cpu()
        rows = [t.cpu() for t in (gc, ac, rc)]
        y_p = BK.ballistics_plain(*rows, y0=None if y0c is None else y0c.cpu())
        bitwise = torch.equal(y_k.cpu(), y_p)
        diff = float((y_k.cpu() - y_p).abs().max())
        y_prev = torch.cat([torch.zeros(BS, 1, 1) if y0c is None else y0c.cpu()[..., None], y_p[..., :-1]], -1)
        ties = int((rows[0] == y_prev).sum())

        cuts = [0, n // 3, n // 3 + n // 4 + 17, n]
        state, parts = y0c, []
        for a, b in zip(cuts[:-1], cuts[1:]):
            part, (state, _) = BK.ballistics_pallas(gc[..., a:b].contiguous(), ac, rc, y0=state, return_yf=True)
            parts.append(part)
        chained = torch.equal(torch.cat(parts, dim=-1), y_k)

        call = lambda: BK.ballistics_pallas(gc, ac, rc, y0=y0c)  # noqa: E731
        ms = cuda_ms(call, 10)
        dev_ms = kernel_device_ms(call, "ballistics_kernel", 10)
        # g read, y written (the coefficients are 8 numbers each); a compare,
        # a select and one multiply-add pair per sample
        b = bound(2 * BS * n * 4, 4 * BS * n)
        print(f"[B {name}] T {n} | == plain loop bitwise: {bitwise} (max diff {diff:.3e}); chunk-chained == one "
              f"pass bitwise: {chained}; {ties} ties | {work_line(work)} | {ms:.4f} ms a call (kernel alone "
              f"{fmt_ms(dev_ms)}; bound {b['bound_ms']:.5f} ms by {b['bound_by']})")
        require(bitwise, f"kernel B {name}: differs from the plain loop by {diff:.3e}")
        require(chained, f"kernel B {name}: chunk-chained evaluation differs from one pass")
        results[name] = {"err": diff, "ms": ms, "device_ms": dev_ms, **b}

    # the plain loop launches ~5 tiny kernels per sample: one run, host clock
    plain_ms = host_ms(lambda: BK.ballistics_plain(g, aa, ar))
    print(f"[B] plain loop on the card at T {T}: {plain_ms:.1f} ms (one run, host clock)")
    results["compressor curve"]["plain_ms"] = plain_ms
    return results


def phase_slice(seed, device, card):
    """The style-transfer render at full width through kernels A, B and E
    (the encoder's 20 layers a batch, input and reference as one batch).
    Returns kernel E's launches over the measured batches."""
    import torch

    from dasp_tpu_torch.models import StyleTransferNet, apply_style_chain, make_style_processors

    torch.manual_seed(seed)
    net = StyleTransferNet(dtype=torch.bfloat16).to(device).eval()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[slice] StyleTransferNet: {n_params} parameters, bf16 encoder convolutions, eval mode")
    procs = make_style_processors(
        SR, reverb_num_samples=IR, eq_filter_method="pallas",
        compressor_smoother="exact_pallas", reverb_noise_mode="frequency",
    )
    plain = make_style_processors(
        SR, reverb_num_samples=IR, eq_filter_method="exact",
        compressor_smoother="exact", reverb_noise_mode="frequency",
    )
    data_gen = torch.Generator(device=device).manual_seed(seed)
    batches_in = [
        (0.1 * torch.randn((BS, 1, T), generator=data_gen, device=device),
         0.1 * torch.randn((BS, 1, T), generator=data_gen, device=device))
        for _ in range(BATCHES)
    ]
    noise_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def render(x, ref, processors, gen, marks=None):
        def mark():
            if marks is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)

        mark()
        params = net(x, ref)
        mark()
        y = processors["equalizer"].process_normalized(x, params["equalizer"], clip_params=True)
        mark()
        y = processors["compressor"].process_normalized(y, params["compressor"], clip_params=True)
        mark()
        y = processors["reverb"].process_normalized(y, params["reverb"], clip_params=True, generator=gen)
        mark()
        y = processors["gain"].process_normalized(y, params["gain"], clip_params=True)
        mark()
        return params, y

    names = ("encoder", "eq", "compressor", "reverb", "gain")
    with torch.inference_mode():
        # warm-up: cuDNN/cuFFT plans and kernel load (not counted)
        render(*batches_in[0], procs, torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()

        reset_launch_counts()
        outs, states = [], []
        for i, (x, ref) in enumerate(batches_in):
            states.append(noise_gen.get_state())
            marks = []
            params, y = render(x, ref, procs, noise_gen, marks)
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
            total = marks[0].elapsed_time(marks[-1])
            outs.append((params, y))
            print(f"[slice] batch {i}: " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
                  + f", render {total:.3f} ms | {card}")
        launches = launch_counts()

        print(f"[slice] launches during the {BATCHES} batches: {launches}")
        want = {k: BATCHES if k in ("sosfilt_cascade", "ballistics") else 0 for k in launches}
        want["tcn_layer"] = 20 * BATCHES
        require(launches == want, f"render launches {launches}, expected {want}")
        for params, y in outs:
            require(tuple(y.shape) == (BS, 2, T), f"output shape {tuple(y.shape)}")
            require(bool(torch.isfinite(y).all()), "non-finite output")

        # the last batch again through the plain versions, same noise
        params, y_k = outs[-1]
        x, _ = batches_in[-1]
        gen = torch.Generator(device=device)
        gen.set_state(states[-1])
        y_p = apply_style_chain(plain, x, params, generator=gen)
        torch.cuda.synchronize()
        peak = float(y_p.abs().max())
        diff = float((y_k - y_p).abs().max())
        # tolerance: kernel A's float64 bound, for each of kernel and plain,
        # relative to the signal's peak; the chain is linear in the EQ output
        # apart from the compressor's smooth gain (kernel B adds nothing:
        # it is bitwise equal to its plain loop)
        tol = 2 * A_BOUND * peak
        print(f"[slice] kernel path vs plain path: max abs diff {diff:.3e} "
              f"(tolerance {tol:.3e} = 2 x {A_BOUND} x output peak {peak:.3f})")
        require(diff <= tol, f"slice differs from the plain path by {diff:.3e} > {tol:.3e}")
    return launches["tcn_layer"]


def grad_errors(got, truth):
    """Max abs error of each gradient against float64, and relative to the
    largest float64 value."""
    out = {}
    for name in truth:
        err = float((got[name].double() - truth[name]).abs().max())
        out[name] = (err, err / float(truth[name].abs().max()))
    return out


def phase_adjoint_a(rng, device):
    """Kernel A's gradient: the save-all forward and the adjoint cascade."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor, ParametricEQ
    from dasp_tpu_torch.ops import adjoint_sos, embed_first_order_sos, onepole_ba, stabilize_sos
    from dasp_tpu_torch.ops import iir_kernel as IK

    eq = random_params(ParametricEQ(SR), rng, BS, device)
    sos6 = stabilize_sos(F.parametric_eq_sos(BS, torch.float32, SR, *eq.values(), device=device))
    comp = random_params(Compressor(SR), rng, BS, device)
    alpha = torch.exp(-math.log(9.0) / (SR * comp["attack_ms"] / 1e3))
    sos1 = embed_first_order_sos(*onepole_ba(alpha))[:, None, :]
    x_full = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    w_full = torch.tensor(rng.standard_normal((BS, 1, T)).astype(np.float32), device=device)

    results = {}
    # (name, sections, samples, time the launches)
    for name, sos, n, timed in (("S=6 (EQ)", sos6, T, True), ("S=6 (EQ), ragged T", sos6, T - RAGGED, False),
                                ("S=1 (one-pole)", sos1, T, True),
                                ("S=1 (20 Hz / Q 6 shelf)", shelf_sos(BS, device), T, False)):
        S = sos.shape[1]
        sos = sos.contiguous()
        x, w = x_full[..., :n].contiguous(), w_full[..., :n].contiguous()
        rows_x, rows_w = x.reshape(BS, n), w.reshape(BS, n)

        def kernel_grads():
            s_, x_ = sos.clone().requires_grad_(), x.clone().requires_grad_()
            (IK.sosfilt_pallas(s_, x_) * w).sum().backward()
            return {"dsos": s_.grad, "dx": x_.grad.reshape(BS, n)}

        before = launch_counts()
        got = kernel_grads()
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(used == {"sosfilt_cascade_save_all": 1, "sosfilt_cascade_adjoint": 1},
                f"kernel A gradient {name} launched {used}")
        dsos_p, dx_p = IK.sosfilt_rows_grad_plain(sos, rows_x, rows_w)
        plain = {"dsos": dsos_p, "dx": dx_p}
        s64, x64 = sos.double().requires_grad_(), rows_x.double().requires_grad_()
        (IK.sosfilt_rows_plain(s64, x64) * rows_w.double()).sum().backward()
        truth = {"dsos": s64.grad, "dx": x64.grad}
        e_k, e_p = grad_errors(got, truth), grad_errors(plain, truth)
        for g in truth:
            require(bool(torch.isfinite(got[g]).all()), f"kernel A gradient {name}: non-finite {g}")
            print(f"[A-adjoint {name}] T {n} | {g}: kernel vs float64 {e_k[g][0]:.3e} ({e_k[g][1]:.3e} of max) | "
                  f"plain adjoint vs float64 {e_p[g][0]:.3e} ({e_p[g][1]:.3e} of max)")
            require(e_k[g][1] <= A_GRAD_BOUND[g],
                    f"kernel A gradient {name}: {g} error {e_k[g][1]:.3e} of max > {A_GRAD_BOUND[g]}")
            require(e_k[g][0] <= A_PLAIN_FACTOR * e_p[g][0],
                    f"kernel A gradient {name}: {g} error {e_k[g][0]:.3e} > {A_PLAIN_FACTOR} x plain {e_p[g][0]:.3e}")

        if not timed:
            continue
        # the two launches alone, at the path's shapes
        inters = IK._CudaEngine.save_all(sos, rows_x)
        inters64 = IK.sosfilt_rows_plain(sos.double(), rows_x.double(), save_all=True)
        save_err = float((inters.double() - inters64).abs().max())
        adj = adjoint_sos(sos).contiguous()
        outs = IK._CudaEngine.adjoint(adj, rows_w)
        ms_save = cuda_ms(lambda: IK._CudaEngine.save_all(sos, rows_x), 20)
        ms_adj = cuda_ms(lambda: IK._CudaEngine.adjoint(adj, rows_w), 20)
        dev_save = kernel_device_ms(lambda: IK._CudaEngine.save_all(sos, rows_x), "sosfilt_cascade_kernel", 20)
        dev_adj = kernel_device_ms(lambda: IK._CudaEngine.adjoint(adj, rows_w), "sosfilt_cascade_kernel", 20)
        # the rest of the backward: adjoint sections, section inputs and the
        # coefficient correlations, PyTorch ops over (S, R, T)
        ms_corr = cuda_ms(lambda: IK._vjp(sos, rows_x, inters, rows_w, lambda *_: outs), 20)
        plain_save = cuda_ms(lambda: IK._PlainEngine.save_all(sos, rows_x), 2)
        plain_adj = cuda_ms(lambda: IK._PlainEngine.adjoint(adj, rows_w), 2)
        plane = BS * n * 4
        b_save = bound(plane * (1 + S) + sos.numel() * 4, SECTION_OPS * BS * n * S)
        b_adj = bound(plane * (2 + S) + adj.numel() * 4, SECTION_OPS * BS * n * (S + 1))
        print(f"[A-adjoint {name}] save-all ({S} sections) {ms_save:.4f} ms a call (kernel alone "
              f"{fmt_ms(dev_save)}; bound {b_save['bound_ms']:.5f} ms by {b_save['bound_by']}), plain "
              f"{plain_save:.4f} ms, every section vs float64 {save_err:.3e} | adjoint ({S + 1} sections) "
              f"{ms_adj:.4f} ms a call (kernel alone {fmt_ms(dev_adj)}; bound {b_adj['bound_ms']:.5f} ms by "
              f"{b_adj['bound_by']}), plain {plain_adj:.4f} ms | the gradient's correlations "
              f"(_vjp without the adjoint launch) {ms_corr:.4f} ms")
        results[name] = {"save_all": {"err": save_err, "ms": ms_save, "plain_ms": plain_save, **b_save},
                         "adjoint": {"err": e_k["dx"][0], "ms": ms_adj, "plain_ms": plain_adj, **b_adj}}
    return results


def b_bwd_errors(got, y, g, aa, ar, y0, ct):
    """B-bwd's (dg, daa, dar, dy0) on (BS, n) rows against the plain reverse
    loop run in float64 on float64 copies of the same fp32 inputs (so its
    branches are the kernel's), on CPU copies: {name: (distance of ``got``,
    distance of the plain fp32 loop, largest abs difference of ``got``)},
    the distances relative to the largest float64 value (dg, dy0) or to the
    sum of |terms| of the branch (daa, dar)."""
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK

    y, g, aa, ar, y0, ct = (t.cpu() for t in (y, g, aa, ar, y0, ct))
    ref = BK.ballistics_bwd_rows_plain(*(t.double() for t in (y, g, aa, ar, y0, ct)))
    plain = BK.ballistics_bwd_rows_plain(y, g, aa, ar, y0, ct)
    y_prev = torch.cat([y0[:, None], y[:, :-1]], dim=1).double()
    attack = g.double() < y_prev
    alpha = torch.where(attack, aa[:, None], ar[:, None]).double()
    terms = (ref[0] / (1.0 - alpha) * (y_prev - g.double())).abs()
    scales = (ref[0].abs().max(), (terms * attack).sum(-1), (terms * ~attack).sum(-1), ref[3].abs().max())
    out = {}
    for i, name in enumerate(("dg", "daa", "dar", "dy0")):
        s = torch.clamp(scales[i], min=1e-300)  # a branch never taken sums nothing, exactly
        diffs = [(v[i].cpu().reshape(ref[i].shape).double() - ref[i]).abs() for v in (got, plain)]
        out[name] = (*(float((d / s).max()) for d in diffs), float(diffs[0].max()))
    return out


def check_b_bwd(what, errors):
    for name, (k, p, _) in errors.items():
        require(k <= B_BWD_TOL and k <= 2 * p + B_BWD_TOL,
                f"kernel B-bwd {what}: {name} {k:.3e} from float64 (plain fp32 loop {p:.3e}), bound {B_BWD_TOL} "
                f"and 2 x plain + {B_BWD_TOL}")


def phase_ballistics_bwd(rng, device):
    """Kernel B-bwd, the float64 chunked adjoint, on compressor gain curves
    at T and 2 T: against the plain reverse loop in float64 beside the plain
    fp32 loop's own distance; bitwise from run to run; the gradient through
    chunk-chained evaluation against the one-pass float64 gradient."""
    import numpy as np
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK

    names = ("dg", "daa", "dar", "dy0")
    results = {}
    for n in (T, 2 * T):
        g, aa, ar = compressor_curve(rng, n, device)
        y0 = -torch.rand((BS, 1), device=device)
        ct = torch.tensor(rng.standard_normal((BS, 1, n)).astype(np.float32), device=device)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (g, aa, ar, y0)]
            (fn(*leaves) * ct).sum().backward()
            return [t.grad for t in leaves]

        before = launch_counts()
        got = grads(lambda g_, a_, r_, y_: BK.ballistics_pallas(g_, a_, r_, y0=y_))
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(used == {"ballistics": 1, "ballistics_bwd": 1}, f"kernel B gradient launched {used}")

        rows = (g.reshape(BS, n), aa, ar, y0.reshape(BS))
        ct_rows = ct.reshape(BS, n)
        y_rows = BK._CudaEngine.forward(*rows)
        err = b_bwd_errors(got, y_rows, *rows, ct_rows)
        print(f"[B-bwd T {n}] from float64 (dg, dy0 of the largest value; daa, dar of the branch's sum |terms|): "
              + ", ".join(f"{k} kernel {v[0]:.3e} / plain fp32 loop {v[1]:.3e}" for k, v in err.items()))
        check_b_bwd(f"T {n}", err)

        runs = [BK._CudaEngine.backward(y_rows, *rows, ct_rows) for _ in range(2)]
        again = {k: torch.equal(a, b) for k, a, b in zip(names, *runs)}
        print(f"[B-bwd T {n}] run to run bitwise: {again}")
        require(all(again.values()), f"kernel B-bwd T {n}: not bitwise from run to run: {again}")

        if n == T:
            cuts = [0, n // 3, n // 3 + n // 4 + 17, n]

            def chained(g_, a_, r_, y_):
                parts, state = [], y_
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    part, (state, _) = BK.ballistics_pallas(g_[..., lo:hi].contiguous(), a_, r_, y0=state,
                                                            return_yf=True)
                    parts.append(part)
                return torch.cat(parts, dim=-1)

            chain_err = b_bwd_errors(grads(chained), y_rows, *rows, ct_rows)
            print(f"[B-bwd T {n}] chunk-chained gradient from float64: "
                  + ", ".join(f"{k} {v[0]:.3e}" for k, v in chain_err.items()))
            check_b_bwd("chunk-chained", chain_err)

        call = lambda: BK._CudaEngine.backward(y_rows, *rows, ct_rows)  # noqa: E731
        ms = cuda_ms(call, 20)
        dev_ms = kernel_device_ms(call, "ballistics_bwd_kernel", 20)
        # y, g and the cotangent read, dg written; about 6 operations a sample
        b = bound(4 * BS * n * 4, 6 * BS * n)
        print(f"[B-bwd T {n}] {ms:.4f} ms a call (kernel alone {fmt_ms(dev_ms)}; bound {b['bound_ms']:.5f} ms "
              f"by {b['bound_by']})")
        results[n] = {"err": max(v[2] for v in err.values()), "ms": ms, "device_ms": dev_ms, **b}
        if n == T:
            results[n]["plain_ms"] = host_ms(lambda: BK.ballistics_bwd_rows_plain(y_rows, *rows, ct_rows))
            print(f"[B-bwd T {n}] plain reverse loop on the card {results[n]['plain_ms']:.1f} ms "
                  f"(one run, host clock)")
    return results


def time_ballistics(tree, seed, device, card):
    """B-fwd and B-bwd of the package imported from ``tree`` (a checkout of
    this commit or of another) on inputs made from ``seed``: a call by CUDA
    events, and the kernel alone (profiler) with its data in L2 and after a
    256 MB write has evicted it, at T and 2 T, on compressor curves (attack
    and release drawn from 5-100 ms per row) and at the 100 / 100 ms corner.
    Prints one JSON line. Run two trees in turns in one chip call (parent,
    change, change, parent) to compare them on one card."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import ballistics_kernel as BK

    rng = np.random.default_rng(seed)
    flush = torch.empty(64 << 20, device=device)
    out = {}
    for n in (T, 2 * T):
        x = torch.tensor((rng.standard_normal((BS, n)) * 0.25).astype(np.float32), device=device)
        g = F.static_gain_computer(20.0 * torch.log10(torch.clamp(x.abs(), min=1e-8)), -20.0, 4.0, 6.0,
                                   "compressor").contiguous()
        ms_drawn = torch.tensor(rng.uniform(5.0, 100.0, (2, BS)).astype(np.float32), device=device)
        ct = torch.tensor(rng.standard_normal((BS, n)).astype(np.float32), device=device)
        y0 = torch.zeros(BS, device=device)
        for case, (aa, ar) in (("curve", torch.exp(-math.log(9.0) / (SR * ms_drawn / 1e3))),
                               ("100 / 100 ms", (alpha_ms(100.0, device),) * 2)):
            y = BK._CudaEngine.forward(g, aa, ar, y0)
            row = {}
            for use, fn, name in (("fwd", lambda: BK._CudaEngine.forward(g, aa, ar, y0), "ballistics_kernel"),
                                  ("bwd", lambda: BK._CudaEngine.backward(y, g, aa, ar, y0, ct),
                                   "ballistics_bwd_kernel")):
                row[use] = {"ms": cuda_ms(fn, 5), "kernel_ms": kernel_device_ms(fn, name, 5),
                            "kernel_cold_ms": kernel_device_ms(lambda: (flush.zero_(), fn()), name, 5)}
            out[f"{case}, T {n}"] = row
            print(f"[time {tree}] {case}, T {n}: " + "; ".join(
                f"{use} {v['ms']:.4f} ms a call, kernel alone {fmt_ms(v['kernel_ms'])} (L2 warm), "
                f"{fmt_ms(v['kernel_cold_ms'])} (cold)" for use, v in row.items()) + f" | {card}")
    print(json.dumps({"tree": tree, "card": card, "ballistics": out}))


def phase_training(seed, device, card):
    """The training slice at full width through all kernel uses."""
    import torch

    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.models import make_style_processors

    torch.manual_seed(seed)
    net, procs, opt = TR.make_style_training(SR, device=device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[train] StyleTransferNet: {n_params} parameters, bf16 encoder, train mode; "
          f"bs {BS}, clips {2 * T}, IR {IR}, Adam lr 1e-4")
    require(n_params == FULL_WIDTH_PARAMS, f"{n_params} parameters, expected {FULL_WIDTH_PARAMS}")
    plain = make_style_processors(SR, reverb_num_samples=IR, eq_filter_method="exact",
                                  compressor_smoother="exact", reverb_noise_mode="frequency")
    data_gen = torch.Generator(device=device).manual_seed(seed + 3)
    batches = [(0.25 * torch.randn((BS, 1, 2 * T), generator=data_gen, device=device),
                TR.random_corruption(data_gen, BS, procs, device)) for _ in range(TRAIN_STEPS + 2)]
    noise_gen = torch.Generator(device=device).manual_seed(seed + 4)

    loss = TR.train_step(net, procs, opt, *batches[0], generator=noise_gen)  # warm-up
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss)), f"warm-up loss {float(loss)}")
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}

    names = ("corrupt", "forward", "backward", "optimizer")
    reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        t0 = time.perf_counter()
        loss = TR.train_step(net, procs, opt, *batches[1 + i], generator=noise_gen, mark=mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        total = marks[0].elapsed_time(marks[-1])
        finite = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())
        print(f"[train] step {i}: loss {float(loss):.6f} | " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
              + f", step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"step {i}: loss {float(loss)}")
        require(finite, f"step {i}: non-finite gradients")
        steps.append(total)
    launches = launch_counts()
    want = {k: TRAIN_STEPS * STEP_LAUNCHES.get(k, 0) for k in launches}
    print(f"[train] launches during the {TRAIN_STEPS} steps: {launches}")
    require(launches == want, f"training launches {launches}, expected {want}")
    changed = sum(not torch.equal(start[k], v) for k, v in net.state_dict().items() if v.is_floating_point())
    print(f"[train] {changed} of {sum(v.is_floating_point() for v in start.values())} "
          f"floating-point tensors of the state changed")
    require(changed > 0 and all(not torch.equal(start[k], p) for k, p in net.named_parameters()),
            "parameters did not change")
    mean_ms = sum(steps) / TRAIN_STEPS
    print(f"[train] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps "
          f"{mean_ms:.3f} ms) | {card}")
    split = device_ms_by_kernel(lambda: TR.train_step(net, procs, opt, *batches[1], generator=noise_gen),
                                ("sosfilt_cascade_kernel", "ballistics_kernel", "ballistics_bwd_kernel"), 1)
    print(f"[train] device time of one step (CUDA-only profiler trace): all device work {fmt_ms(split['all'])}, "
          f"kernel A (3 uses) {fmt_ms(split['sosfilt_cascade_kernel'])}, B-fwd (2 launches) "
          f"{fmt_ms(split['ballistics_kernel'])}, B-bwd {fmt_ms(split['ballistics_bwd_kernel'])} | {card}")

    # one step's gradients again, on the plain path: same weights, batch,
    # corruption output and render noise
    x, rand = batches[-1]
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    corrupt_state = noise_gen.get_state()
    batch = TR.corrupt(procs, x, rand, generator=noise_gen)
    render_state = noise_gen.get_state()

    def grads(processors):
        net.load_state_dict(state)
        net.zero_grad(set_to_none=True)
        noise_gen.set_state(render_state)
        loss = TR.render_loss(net, processors, *batch, generator=noise_gen)
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().clone() for k, p in net.named_parameters()}

    loss_k, g_k = grads(procs)
    t0 = time.perf_counter()
    loss_p, g_p = grads(plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    net.load_state_dict(state)
    norm = lambda g: math.sqrt(sum(float((v.double() ** 2).sum()) for v in g.values()))  # noqa: E731
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    gn_k, gn_p = norm(g_k), norm(g_p)
    gn_rel = abs(gn_k - gn_p) / gn_p
    leaf = max(float((g_k[k] - g_p[k]).abs().max()) for k in g_p) / gn_p
    print(f"[train] kernel path vs plain path (EQ 'exact', compressor 'exact'; plain step "
          f"{plain_s:.1f} s host clock): loss {loss_k:.6f} vs {loss_p:.6f}, rel err {loss_rel:.2e}; "
          f"grad-norm {gn_k:.6f} vs {gn_p:.6f}, rel err {gn_rel:.2e}; max grad-leaf err "
          f"{leaf:.2e} of grad-norm")
    require(loss_rel <= TRAIN_LOSS_TOL, f"loss rel err {loss_rel:.3e} > {TRAIN_LOSS_TOL}")
    require(gn_rel <= TRAIN_GRAD_NORM_TOL, f"grad-norm rel err {gn_rel:.3e} > {TRAIN_GRAD_NORM_TOL}")
    # what phase 13 starts from: these weights, this batch and noise
    ctx = {"procs": procs, "state": state, "batch": (x, rand), "noise_state": corrupt_state,
           "batches": batches, "seed": seed}
    return launches, ctx


def frac_delay_configs(rng, device):
    """The kernel's operands at the phases' shapes: (name, x_ext, d_stk,
    g_stk, B, Dm), built as pitch_shift and modulated_delay build them."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F

    x2 = torch.tensor((rng.standard_normal((BS, 2, T)) * 0.25).astype(np.float32), device=device)
    W = F.pitch_shift_window_samples(60.0, SR)
    semitones = torch.linspace(-7.0, 7.0, BS, device=device).reshape(BS, 1, 1)
    taps = F._pitch_shift_taps(semitones, T, W)
    Dm = math.ceil(W) + 1
    configs = [
        (name, *F._frac_delay_operands(x, taps, Dm, 256), 256, Dm)
        for name, x in (("pitch shift 8x1 (blind path)", x2[:, :1].contiguous()), ("pitch shift 8x2", x2))
    ]
    rate, depth, base = (torch.full((BS, 1, 1), v, device=device) for v in (0.8, 12.0, 8.0))
    d = F._modulated_delay_samples(rate, depth, base, T, SR)
    dmax = 22.0 * SR / 1e3
    Dm = math.ceil(dmax) + 1
    configs.append(("modulated delay 8x2", *F._frac_delay_operands(x2, [(torch.clamp(d, max=dmax), None)], Dm, 512),
                    512, Dm))
    return configs


def two_point_ref64(x_ext, d_stk, g_stk, B, Dm, ct=None):
    """Linear interpolation in float64 with tile-local coordinates: output
    sample t of tile k reads x_ext[k*B + i0] and x_ext[k*B + i0 + 1] with
    r = (t - k*B + Dm) - d, i0 = floor(r), f = r - i0; lattice points
    outside the window [0, Dm + B) read zero; gain g once t - d >= 0. With
    a cotangent ``ct`` also returns (dx, dd, dg), dd = 0 where r is an
    integer (the kernels' convention at the interpolation kink)."""
    import torch

    x, d, g = (a.double() for a in (x_ext, d_stk, g_stk))
    bs, chs, _ = x.shape
    nt, _, Tp = d.shape
    W = Dm + B
    t = torch.arange(Tp, device=x.device, dtype=torch.float64)
    j = torch.remainder(t, B)
    start = t - j
    wet = x.new_zeros((bs, chs, Tp))
    grads = None if ct is None else (torch.zeros_like(x), [], [])
    for i in range(nt):
        r = (j + Dm) - d[i]
        i0 = torch.floor(r)
        f = r - i0
        mask = (t - d[i] >= 0).double()
        gv = mask * g[i]
        pts = []
        for k, w in ((i0, 1.0 - f), (i0 + 1.0, f)):
            ok = (k >= 0) & (k < W)
            pos = (start + torch.where(ok, k, torch.zeros_like(k))).long()[:, None, :].expand(bs, chs, Tp)
            pts.append((torch.gather(x, 2, pos) * ok[:, None, :], w * ok, pos))
        (x0, w0, p0), (x1, w1, p1) = pts
        interp = w0[:, None, :] * x0 + w1[:, None, :] * x1
        wet += gv[:, None, :] * interp
        if ct is not None:
            c = ct.double()
            grads[1].append(torch.where(f == 0, 0.0, -(c * gv[:, None, :] * (x1 - x0)).sum(1)))
            grads[2].append((c * mask[:, None, :] * interp).sum(1))
            for pos, w in ((p0, w0), (p1, w1)):
                grads[0].scatter_add_(2, pos, c * (gv * w)[:, None, :])
    if ct is None:
        return wet
    return wet, (grads[0], torch.stack(grads[1]), torch.stack(grads[2]))


def phase_frac_delay_fwd(configs, device, card):
    """Kernel C-fwd against float64, its plain engine and the dense plain
    version; then the whole effects on the kernel and on the dense path."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    results = {}
    with torch.no_grad():
        for name, x_ext, d, g, B, Dm in configs:
            wet_k = FK.frac_delay_pallas(x_ext, d, g, B, Dm)
            wet_e = FK.frac_delay_plain(x_ext, d, g, B, Dm)
            wet_d = F._frac_delay_tiles_ad(B, Dm, x_ext, d, g)
            ref = two_point_ref64(x_ext, d, g, B, Dm)
            torch.cuda.synchronize()
            err = {k: float((v.double() - ref).abs().max()) for k, v in
                   (("kernel", wet_k), ("engine", wet_e), ("dense", wet_d))}
            bitwise = torch.equal(wet_k, wet_e)
            call = lambda: FK.frac_delay_pallas(x_ext, d, g, B, Dm)  # noqa: E731
            ms = cuda_ms(call, 50)
            dev_ms = kernel_device_ms(call, "frac_delay_kernel", 50)
            ms_e = cuda_ms(lambda: FK.frac_delay_plain(x_ext, d, g, B, Dm), 10)
            ms_d = cuda_ms(lambda: F._frac_delay_tiles_ad(B, Dm, x_ext, d, g), 2)
            # x_ext, delays and gains read, wet written; per tap and output
            # sample about 10 operations (read position, two weights, two
            # multiply-adds, the gain)
            nbytes = 4 * (x_ext.numel() + d.numel() + g.numel() + wet_k.numel())
            b = bound(nbytes, 10 * d.shape[0] * wet_k.numel())
            print(f"[C-fwd {name}] taps {d.shape[0]}, B {B}, Dm {Dm} | vs float64: kernel {err['kernel']:.3e}, "
                  f"plain engine {err['engine']:.3e}, dense {err['dense']:.3e} (peak {float(ref.abs().max()):.3f}) | "
                  f"kernel == plain engine bitwise: {bitwise} | kernel {ms:.4f} ms a call (alone {fmt_ms(dev_ms)}; "
                  f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}), plain engine {ms_e:.4f} ms, dense {ms_d:.3f} ms "
                  f"| {card}")
            require(bitwise, f"C-fwd {name}: kernel differs from its plain engine")
            require(bool(torch.isfinite(wet_k).all()), f"C-fwd {name}: non-finite output")
            require(err["kernel"] <= 2 * err["dense"] + C_FWD_FLOOR,
                    f"C-fwd {name}: error {err['kernel']:.3e} > 2 x dense {err['dense']:.3e} + {C_FWD_FLOOR}")
            results[name] = {"err": err["kernel"], "ms": ms, "device_ms": dev_ms, "plain_ms": ms_e, "dense_ms": ms_d,
                             **b}

    # the whole effects at fdt_ab scale: forward, and the gradient of
    # mean(y ** 2) with respect to the audio and every parameter
    rng = np.random.default_rng(1)
    x = torch.tensor((rng.standard_normal((BS, 2, T)) * 0.25).astype(np.float32), device=device)
    full = lambda v: torch.full((BS,), v, device=device)  # noqa: E731
    effects = {
        "pitch_shift": (lambda x_, st, mix, adj: F.pitch_shift(x_, SR, st, mix, adjoint=adj),
                        [torch.linspace(-7.0, 7.0, BS, device=device), full(0.7)]),
        "modulated_delay": (lambda x_, r, dp, b, m, adj: F.modulated_delay(
            x_, SR, r, dp, b, m, max_delay_ms=22.0, block=512, adjoint=adj),
            [full(0.8), full(12.0), full(8.0), full(0.7)]),
    }
    for name, (fn, params) in effects.items():
        def grad_call(adj):
            leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
            torch.mean(fn(*leaves, adj) ** 2).backward()

        times = {}
        for adj, reps in (("pallas", 20), ("ad", 2)):
            with torch.no_grad():
                fwd = cuda_ms(lambda: fn(x, *params, adj), reps)
            times[adj] = (fwd, cuda_ms(lambda: grad_call(adj), reps))
        print(f"[C effect {name} 8x2x{T}] forward: kernel path {times['pallas'][0]:.3f} ms, dense path "
              f"{times['ad'][0]:.3f} ms | gradient: kernel path {times['pallas'][1]:.3f} ms, dense path "
              f"{times['ad'][1]:.3f} ms | {card}")
    return results


def phase_frac_delay_bwd(configs, device, card):
    """Kernel C-bwd against float64, its plain engine and autograd through
    the dense plain version; dd and dg run to run; the steep ramp."""
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    gen = torch.Generator(device=device).manual_seed(11)
    results = {}
    for name, x_ext, d, g, B, Dm in configs:
        ct = torch.randn((x_ext.shape[0], x_ext.shape[1], d.shape[-1]), generator=gen, device=device)

        def autograd(fn):
            leaves = [a.clone().requires_grad_() for a in (x_ext, d, g)]
            (fn(*leaves) * ct).sum().backward()
            return [a.grad for a in leaves]

        got = autograd(lambda *a: FK.frac_delay_pallas(*a, B, Dm))
        again = autograd(lambda *a: FK.frac_delay_pallas(*a, B, Dm))
        engine = FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm)
        dense = autograd(lambda *a: F._frac_delay_tiles_ad(B, Dm, *a))
        _, truth = two_point_ref64(x_ext, d, g, B, Dm, ct)
        torch.cuda.synchronize()
        # read positions that fp32 rounds onto an integer: there every fp32
        # version takes dd = 0 (the kink) where float64 may not
        t = torch.arange(d.shape[-1], device=device)
        r32 = (torch.remainder(t, B).float() + Dm) - d
        kinks = int((r32 == torch.floor(r32)).sum())
        off_kink = r32 != torch.floor(r32)
        line = []
        for i, gname in enumerate(("dx", "dd", "dg")):
            scale = float(truth[i].abs().max())
            # dd off the kinks too: there every fp32 version takes 0, which
            # sets the all-sample error of each and would hide a wrong dd
            diffs = {k: v[i].double() - truth[i] for k, v in (("kernel", got), ("engine", engine), ("dense", dense))}
            e = {k: float(v.abs().max()) / scale for k, v in diffs.items()}
            e_off = {k: float(torch.where(off_kink, v, 0.0).abs().max()) / scale if gname == "dd" else e[k]
                     for k, v in diffs.items()}
            res = float((got[i] - engine[i]).abs().max())
            run = (torch.equal(got[i], again[i]) if i else float((got[i] - again[i]).abs().max()) / scale)
            line.append(f"{gname}: kernel {e['kernel']:.3e} (off the kinks {e_off['kernel']:.3e}), plain engine "
                        f"{e['engine']:.3e}, dense {e['dense']:.3e} (off the kinks {e_off['dense']:.3e}); kernel vs "
                        f"plain engine {res:.3e} abs; run to run " + (f"bitwise {run}" if i else f"{run:.3e}"))
            require(bool(torch.isfinite(got[i]).all()), f"C-bwd {name}: non-finite {gname}")
            for what, err in (("", e), (" off the kinks", e_off)):
                require(err["kernel"] <= 2 * err["dense"] + C_BWD_FLOOR,
                        f"C-bwd {name}: {gname} error{what} {err['kernel']:.3e} > 2 x dense {err['dense']:.3e} "
                        f"+ {C_BWD_FLOOR}")
            if i:
                require(run, f"C-bwd {name}: {gname} differs from run to run")
                require(res == 0, f"C-bwd {name}: {gname} differs from the plain engine by {res:.3e}")
            else:
                require(res <= C_BWD_DX_ENGINE_TOL * scale,
                        f"C-bwd {name}: dx differs from the plain engine by {res / scale:.3e} of its largest "
                        f"value > {C_BWD_DX_ENGINE_TOL}")
        # the blind path asks for no dx: its row reports that launch, both
        # its time and its largest difference from the plain engine's dd, dg
        _, dd_k, dg_k = FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False)
        _, dd_e, dg_e = FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm, need_dx=False)
        res_nodx = max(float((a - b).abs().max()) for a, b in ((dd_k, dd_e), (dg_k, dg_e)))
        require(res_nodx == 0, f"C-bwd {name}: without dx, dd/dg differ from the plain engine by {res_nodx:.3e}")
        # dx's global atomics: one per valid lattice point, tap and channel
        _, _, _, _, valid0, valid1 = FK._coords(d, B, Dm)
        atomics = int(valid0.sum() + valid1.sum()) * x_ext.shape[1]
        with_dx = lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm)  # noqa: E731
        no_dx = lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False)  # noqa: E731
        ms, ms_nodx = cuda_ms(with_dx, 50), cuda_ms(no_dx, 50)
        dev = kernel_device_ms(with_dx, "frac_delay_bwd_dx_kernel", 50)
        dev_nodx = kernel_device_ms(no_dx, "frac_delay_bwd_kernel", 50)
        ms_e = cuda_ms(lambda: FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm), 10)
        ms_e_nodx = cuda_ms(lambda: FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm, need_dx=False), 10)
        ms_d = cuda_ms(lambda: autograd(lambda *a: F._frac_delay_tiles_ad(B, Dm, *a)), 2)
        print(f"[C-bwd {name}] vs float64, of each largest value ({kinks} kinks): " + " | ".join(line))
        # without dx: x_ext, delays, gains and the cotangent read, dd and dg
        # written; about 12 operations per tap and output sample; with dx,
        # dx written too and 4 more operations
        nbytes = 4 * (x_ext.numel() + d.numel() + g.numel() + ct.numel() + dd_k.numel() + dg_k.numel())
        b_nodx = bound(nbytes, 12 * d.shape[0] * ct.numel())
        b_dx = bound(nbytes + 4 * x_ext.numel(), 16 * d.shape[0] * ct.numel())
        print(f"[C-bwd {name}] without dx: dd, dg vs plain engine {res_nodx:.3e} abs | kernel with dx ({atomics} "
              f"global atomics) {ms:.4f} ms a call (alone {fmt_ms(dev)}; bound {b_dx['bound_ms']:.5f} ms by "
              f"{b_dx['bound_by']}), without {ms_nodx:.4f} ms a call (alone {fmt_ms(dev_nodx)}; bound "
              f"{b_nodx['bound_ms']:.5f} ms by {b_nodx['bound_by']}) | plain engine {ms_e:.4f} ms with dx, "
              f"{ms_e_nodx:.4f} ms without | dense forward + autograd {ms_d:.3f} ms | {card}")
        results[name] = {"err": res_nodx, "ms": ms_nodx, "device_ms": dev_nodx, "plain_ms": ms_e_nodx, **b_nodx}

    # the reference kernel's fault: a ramp with dr/dt = 20, smooth within
    # each tile, on a quarter-sample grid (exact fp32 read positions)
    B, Dm = 128, 2560
    x = torch.randn((BS, 2, T), generator=gen, device=device) * 0.25
    j = torch.remainder(torch.arange(T, device=device), B).float()
    d = (Dm - 100.25 - 19.0 * j).expand(BS, 1, T)
    x_ext, d_stk, g_stk = F._frac_delay_operands(x, [(d, None)], Dm, B)
    wet = FK.frac_delay_pallas(x_ext, d_stk, g_stk, B, Dm, wraps=False)
    ref = two_point_ref64(x_ext, d_stk, g_stk, B, Dm)
    err = float((wet.double() - ref).abs().max() / ref.abs().max())
    print(f"[C ramp dr/dt = 20, wraps=False] kernel vs float64 {err:.3e} of the peak (bound {RAMP_TOL})")
    require(err <= RAMP_TOL, f"ramp: error {err:.3e} of the peak > {RAMP_TOL}")
    return results


def phase_blind(seed, device, card):
    """Blind estimation of the pitch shifter (and one chorus step) at full
    width through kernel C."""
    import copy

    import torch

    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.modules import Chorus, PitchShift
    from dasp_tpu_torch.utils.loss import stft_loss

    def counted(net):
        return (sum(p.numel() for p in net.parameters()),
                sum(b.numel() for n, b in net.named_buffers() if "running" in n))

    proc = PitchShift(SR)
    torch.manual_seed(seed)
    net, opt = TR.make_blind_estimation(proc, device=device)
    print(f"[blind] ParameterNetwork.blind_estimation(2): {counted(net)[0]} parameters, {counted(net)[1]} "
          f"BatchNorm statistics, train mode; PitchShift(60 ms); bs {BS} x 1 x {T}; Adam lr 1e-4")
    require(counted(net) == (BLIND_PARAMS["PitchShift"], BLIND_STATS), f"counts {counted(net)}")
    gen = torch.Generator(device=device).manual_seed(seed + 5)

    def batch(p):
        return (0.25 * torch.randn((BS, 1, T), generator=gen, device=device),
                torch.rand((BS, p.num_params), generator=gen, device=device))

    batches = [batch(proc) for _ in range(TRAIN_STEPS + 2)]
    loss, _ = TR.blind_estimation_step(net, proc, opt, *batches[0])  # warm-up
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss)), f"warm-up loss {float(loss)}")
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}

    reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        t0 = time.perf_counter()
        loss, param_l1 = TR.blind_estimation_step(net, proc, opt, *batches[1 + i])
        ev1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        total = ev0.elapsed_time(ev1)
        finite = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())
        print(f"[blind] step {i}: loss {float(loss):.6f}, param_l1 {float(param_l1):.4f} | "
              f"step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"step {i}: loss {float(loss)}")
        require(finite, f"step {i}: non-finite gradients")
        steps.append(total)
    launches = launch_counts()
    want = {k: TRAIN_STEPS * BLIND_STEP_LAUNCHES.get(k, 0) for k in launches}
    print(f"[blind] launches during the {TRAIN_STEPS} steps: {launches}")
    require(launches == want, f"blind-estimation launches {launches}, expected {want}")
    require(all(not torch.equal(start[k], p) for k, p in net.named_parameters()), "parameters did not change")
    mean_ms = sum(steps) / TRAIN_STEPS
    print(f"[blind] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps {mean_ms:.3f} ms) | {card}")

    # one Chorus step
    chorus = Chorus(SR)
    cnet, copt = TR.make_blind_estimation(chorus, device=device)
    require(counted(cnet) == (BLIND_PARAMS["Chorus"], BLIND_STATS), f"Chorus counts {counted(cnet)}")
    cstart = {k: p.detach().clone() for k, p in cnet.named_parameters()}
    x_c, rp_c = batch(chorus)
    reset_launch_counts()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    loss_c, _ = TR.blind_estimation_step(cnet, chorus, copt, x_c, rp_c)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[1].record()
    torch.cuda.synchronize()
    used = {k: v for k, v in launch_counts().items() if v}
    print(f"[blind] Chorus(45 ms bound) step: loss {float(loss_c):.6f}, {counted(cnet)[0]} parameters, launches "
          f"{used}, {marks[0].elapsed_time(marks[1]):.3f} ms (first step, CUDA events) | {card}")
    require(used == BLIND_STEP_LAUNCHES, f"Chorus step launches {used}")
    require(bool(torch.isfinite(loss_c)), f"Chorus loss {float(loss_c)}")
    require(all(bool(torch.isfinite(p.grad).all()) for p in cnet.parameters()), "Chorus: non-finite gradients")
    require(all(not torch.equal(cstart[k], p) for k, p in cnet.named_parameters()), "Chorus parameters did not move")

    # one step's gradients three ways, same weights and batch: kernel fp32,
    # dense plain fp32 and dense float64 (net and effect). First the
    # effect's own gradient at a fixed p_hat, which is held to bounds; then
    # the net's, which is printed only (see EFFECT_GRAD_FLOOR)
    x, rp = batches[-1]
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    # p_hat drawn from the seed, not the trained net's estimate: the net's
    # weights after the steps differ from run to run (atomics in cuDNN and in
    # C-bwd's dx), and the semitones gradient, a sum of ~1e6 cancelling
    # terms, moved with them: kernel vs dense fp32 6.2e-5 to 3.6e-2 of its
    # float64 norm over four runs on an H100
    p_hat = torch.rand((BS, proc.num_params), generator=torch.Generator(device=device).manual_seed(seed + 6),
                       device=device)

    def effect_grad(dtype, adjoint):
        xx, rr, p = x.to(dtype), rp.to(dtype), p_hat.to(dtype, copy=True).requires_grad_()
        with torch.no_grad():
            y = proc.process_normalized(xx, rr, clip_params=True, adjoint=adjoint)
        loss = stft_loss(proc.process_normalized(xx, p, clip_params=True, adjoint=adjoint), y)
        loss.backward()
        return float(loss.detach()), p.grad.double()

    def grads(dtype, adjoint):
        m = copy.deepcopy(net)
        m.load_state_dict(state)
        m.to(dtype).zero_grad(set_to_none=True)
        xx, rr = x.to(dtype), rp.to(dtype)
        with torch.no_grad():
            y = proc.process_normalized(xx, rr, clip_params=True, adjoint=adjoint)
        loss, _ = TR.blind_estimation_loss(m, proc, xx, y, adjoint=adjoint)
        loss.backward()
        return float(loss.detach()), {k: p.grad.double() for k, p in m.named_parameters()}

    for kind, fn in (("effect", effect_grad), ("net", grads)):
        before = launch_counts()
        loss_k, g_k = fn(torch.float32, "auto")
        after = launch_counts()
        require({k: after[k] - before[k] for k in after if after[k] != before[k]} == BLIND_STEP_LAUNCHES,
                f"the kernel {kind} gradient did not run through kernel C")
        loss_p, g_p = fn(torch.float32, "ad")
        loss_64, g_64 = fn(torch.float64, "ad")
        require(launch_counts() == after, "the plain paths launched a kernel")
        lerr = {k: abs(v - loss_64) / loss_64 for k, v in (("kernel", loss_k), ("plain", loss_p))}
        require(all(math.isfinite(v) for v in (loss_k, loss_p, loss_64)), f"{kind}: non-finite loss")
        if kind == "effect":
            # per parameter (column of p_hat), relative to its float64 norm
            for c, pname in enumerate(proc.param_ranges):
                n64 = float(g_64[:, c].norm())
                dist = {k: float((g[:, c] - g_64[:, c]).norm()) / n64 for k, g in (("kernel", g_k), ("plain", g_p))}
                fp32 = float((g_k[:, c] - g_p[:, c]).norm()) / n64
                print(f"[blind] d(stft_loss)/d({pname}) at a fixed p_hat, bs {BS} (float64 norm {n64:.6e}): "
                      f"distance from float64 kernel {dist['kernel']:.3e}, dense plain {dist['plain']:.3e}; "
                      f"kernel vs dense plain fp32 {fp32:.3e}")
                require(bool(torch.isfinite(g_k[:, c]).all()), f"effect gradient {pname}: non-finite")
                require(dist["kernel"] <= 2 * dist["plain"] + EFFECT_GRAD_FLOOR,
                        f"effect gradient {pname}: distance {dist['kernel']:.3e} > 2 x plain {dist['plain']:.3e} "
                        f"+ {EFFECT_GRAD_FLOOR}")
                require(fp32 <= EFFECT_GRAD_FP32_TOL,
                        f"effect gradient {pname}: kernel vs dense fp32 {fp32:.3e} > {EFFECT_GRAD_FP32_TOL}")
            print(f"[blind] effect loss {loss_k:.7f} / {loss_p:.7f} / {loss_64:.7f}, rel err kernel "
                  f"{lerr['kernel']:.3e}, plain {lerr['plain']:.3e}")
            continue
        norm = lambda g: math.sqrt(sum(float((v ** 2).sum()) for v in g.values()))  # noqa: E731
        n64 = norm(g_64)
        dist = {k: norm({n: g[n] - g_64[n] for n in g_64}) / n64 for k, g in (("kernel", g_k), ("plain", g_p))}
        nerr = {k: abs(norm(g) - n64) / n64 for k, g in (("kernel", g_k), ("plain", g_p))}
        print(f"[blind] net gradients against float64 (norm {n64:.6f}; printed only): distance kernel "
              f"{dist['kernel']:.3e}, dense plain {dist['plain']:.3e}; norm error kernel {nerr['kernel']:.3e}, "
              f"dense plain {nerr['plain']:.3e}; kernel vs dense plain fp32 "
              f"{norm({n: g_k[n] - g_p[n] for n in g_p}) / norm(g_p):.3e} of the plain norm; loss "
              f"{loss_k:.7f} / {loss_p:.7f} / {loss_64:.7f}, rel err kernel {lerr['kernel']:.3e}, "
              f"plain {lerr['plain']:.3e}")
    return launches


def phase_fsm(rng, device, card):
    """The "fsm" defaults on the card: ParametricEQ(SR) and Compressor(SR)
    with no option given, output and the gradient of mean(y ** 2) with
    respect to the normalized parameters, fp32 against float64.

    The compressor is held to FSM_TOL whole. The EQ's whole distance is
    printed beside the same fp32 function's on CPU copies (the reference's
    algorithm with another FFT library), and held to FSM_TOL where the
    rounding is the card's own: the FIR application of a fixed response H
    (the FFTs of the signal) and its gradient with respect to the signal.
    The EQ's response H = prod(rfft(b) / rfft(a)) over 262144 points, which
    the JAX package forms the same way, is ill-conditioned in fp32 near its
    resonances (a 20 Hz shelf's poles lie about 2.5e-4 from the unit
    circle): its fp32 error is printed beside the rest."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor, ParametricEQ
    from dasp_tpu_torch.ops import fft_filter as FF

    def rel(a, b):
        return float((a.to(b.dtype) - b).abs().max()) / max(1.0, float(b.abs().max()))

    x = torch.tensor((rng.standard_normal((BS, 2, T)) * 0.25).astype(np.float32), device=device)
    for proc in (ParametricEQ(SR), Compressor(SR)):
        name = type(proc).__name__
        p = torch.tensor(rng.uniform(0.05, 0.95, (BS, proc.num_params)).astype(np.float32), device=device)

        def run(dtype, dev=device):
            q = p.to(dev, dtype, copy=True).requires_grad_()
            y = proc.process_normalized(x.to(dev, dtype), q, clip_params=True)
            (y ** 2).mean().backward()
            return y.detach(), q.grad

        reset_launch_counts()
        y32, g32 = run(torch.float32)
        torch.cuda.synchronize()
        used = {k: v for k, v in launch_counts().items() if v}
        y64, g64 = run(torch.float64)
        err = {"output": rel(y32, y64), "gradient": rel(g32, g64)}
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: proc.process_normalized(x, p, clip_params=True), 10)
        grad_ms = cuda_ms(lambda: run(torch.float32), 10)
        line = (f"[fsm {name}] default options, {BS}x2x{T}: fp32 vs float64 on the card, of max(1, peak): output "
                f"{err['output']:.3e}, gradient of mean(y ** 2) w.r.t. the normalized parameters "
                f"{err['gradient']:.3e}")
        require(not used, f"fsm {name}: the FSM path launched {used}")
        require(bool(torch.isfinite(y32).all()) and bool(torch.isfinite(g32).all()), f"fsm {name}: non-finite")
        gated = err
        if isinstance(proc, ParametricEQ):
            y_cpu, g_cpu = run(torch.float32, "cpu")
            d = proc.denormalize_param_dict(proc.extract_param_dict(p))
            sos = F.parametric_eq_sos(BS, torch.float32, SR, *d.values(), device=device)
            n = FF.fsm_fft_size(T)
            H = FF.fft_sosfreqz(sos, n)

            def fir(dtype):
                xx = x.to(dtype, copy=True).requires_grad_()
                y = FF.freqdomain_fir(xx, H[:, None, :].to(xx.dtype.to_complex()), n)[..., :T]
                (y ** 2).sum().backward()  # a gradient of the signal's scale
                return y.detach(), xx.grad

            (f32, dx32), (f64, dx64) = fir(torch.float32), fir(torch.float64)
            gated = {"FIR output": rel(f32, f64), "FIR gradient w.r.t. x": rel(dx32, dx64)}
            line += (f" (printed only; the same fp32 function on CPU copies: output {rel(y_cpu, y64.cpu()):.3e}, "
                     f"gradient {rel(g_cpu, g64.cpu()):.3e}; H in fp32 vs float64 of the same coefficients "
                     f"{rel(H, FF.fft_sosfreqz(sos.double(), n)):.3e} of its peak) | on a fixed H: FIR output "
                     f"{gated['FIR output']:.3e}, the gradient of sum(y ** 2) w.r.t. x {gated['FIR gradient w.r.t. x']:.3e}")
        print(line + f" (bound {FSM_TOL}) | forward {fwd_ms:.3f} ms, forward + gradient {grad_ms:.3f} ms | kernels "
              f"launched {used} | {card}")
        for what, e in gated.items():
            require(e <= FSM_TOL, f"fsm {name}: {what} {e:.3e} of max(1, peak) from float64 > {FSM_TOL}")


def tf32_matmul(on: bool) -> None:
    """What a caller does to allow TF32 in fp32 matmuls (or to forbid it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on


def rel_err(got, truth) -> float:
    """Max abs error against a float64 truth, of the largest truth value."""
    return float((got.double() - truth).abs().max() / truth.abs().max())


def phase_block(rng, device, card):
    """Phase 12: sosfilt_blockmat and sosfilt_exact on the EQ's shapes and
    lfilter1_blockmat on the compressor smoother's, against float64 and
    beside kernel A on the same inputs, with TF32 off and on."""
    import numpy as np
    import scipy.signal
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import ParametricEQ
    from dasp_tpu_torch.ops import embed_first_order_sos, onepole_ba, stabilize_sos
    from dasp_tpu_torch.ops import iir as I
    from dasp_tpu_torch.ops import iir_kernel as IK

    eq = random_params(ParametricEQ(SR), rng, BS, device)
    sos6 = stabilize_sos(F.parametric_eq_sos(BS, torch.float32, SR, *eq.values(), device=device)).contiguous()
    x = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    w = torch.tensor(rng.standard_normal((BS, 1, T)).astype(np.float32), device=device)
    g, aa, _ = compressor_curve(rng, 2 * T, device)
    b1, a1 = onepole_ba(aa.reshape(BS, 1))
    wg = torch.tensor(rng.standard_normal((BS, 1, 2 * T)).astype(np.float32), device=device)

    def rows64(sections, sig):
        return IK.sosfilt_rows_plain(sections, sig.reshape(BS, -1)).reshape(sig.shape)

    # (problem, coefficients, signal, cotangent, coefficient names, kernel A's use, the block
    # functions, float64 forward, the float64 recursion for the gradient); every function takes
    # (*coefficients, signal)
    problems = [
        (f"EQ {BS} x {T}, 6 sections", (sos6,), x, w, ("dsos",), ("sosfilt_pallas", IK.sosfilt_pallas),
         {"sosfilt_blockmat": I.sosfilt_blockmat, "sosfilt_exact": I.sosfilt_exact},
         lambda: np.stack([scipy.signal.sosfilt(sos6[i].double().cpu().numpy(), x[i, 0].double().cpu().numpy())
                           for i in range(BS)]),
         lambda s, z: rows64(s, z)),
        (f"compressor smoother {BS} x 1 x {2 * T}", (b1, a1), g, wg, ("db", "da"),
         ("lfilter1_pallas", lambda b, a, z: IK.lfilter1_pallas(z, b, a)),
         {"lfilter1_blockmat": lambda b, a, z: I.lfilter1_blockmat(z, b, a)},
         lambda: np.stack([scipy.signal.lfilter(b1[i].double().cpu().numpy(), a1[i].double().cpu().numpy(),
                                                g[i, 0].double().cpu().numpy()) for i in range(BS)]),
         lambda b, a, z: rows64(embed_first_order_sos(b, a)[:, None], z)),
    ]

    def run(fn, coefs, sig, ct, dtype=None):
        leaves = [t.to(dtype or t.dtype).clone().requires_grad_() for t in (*coefs, sig)]
        y = fn(*leaves)
        (y * ct.to(y.dtype)).sum().backward()
        return y.detach(), [t.grad for t in leaves]

    results = {}
    for problem, coefs, sig, ct, names, (a_name, a_fn), fns, fwd64, grad64 in problems:
        names = (*names, "dx")
        ref = torch.tensor(fwd64(), device=device)
        _, truth = run(grad64, coefs, sig, ct, torch.float64)
        torch.cuda.synchronize()

        def errors(y, grads):
            out = {"output": float((y[:, 0].double() - ref).abs().max()) / max(1.0, float(ref.abs().max()))}
            out.update({n: rel_err(gr, t) for n, gr, t in zip(names, grads, truth)})
            return out

        y_a, g_a = run(a_fn, coefs, sig, ct)
        e_a = errors(y_a, g_a)
        print(f"[block {problem}] kernel A ({a_name}) from float64: "
              + ", ".join(f"{k} {v:.3e}" for k, v in e_a.items()))

        def timings(fn):
            grad = lambda: run(fn, coefs, sig, ct)  # noqa: E731
            with torch.no_grad():
                fwd = lambda: fn(*coefs, sig)  # noqa: E731
                row = {"forward_ms": cuda_ms(fwd, 5), "forward_device_ms": device_ms_by_kernel(fwd, (), 3)["all"]}
            row.update({"gradient_ms": cuda_ms(grad, 3), "gradient_device_ms": device_ms_by_kernel(grad, (), 2)["all"]})
            return row

        rows = {a_name: {"err": e_a, **timings(a_fn)}}
        for name, fn in fns.items():
            outs = {}
            for tf32 in (False, True):
                tf32_matmul(tf32)
                try:
                    before = launch_counts()
                    outs[tf32] = run(fn, coefs, sig, ct)
                    torch.cuda.synchronize()
                    used = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
                finally:
                    tf32_matmul(False)
                e = errors(*outs[tf32])
                print(f"[block {problem}] {name}, TF32 {'on' if tf32 else 'off'}: from float64 "
                      + ", ".join(f"{k} {v:.3e}" for k, v in e.items()) + f"; kernels launched {used}")
                require(not used, f"{name}: launched {used}")
                require(all(bool(torch.isfinite(t).all()) for t in (outs[tf32][0], *outs[tf32][1])),
                        f"{name}: non-finite output or gradient")
                for k, v in e.items():
                    floor = A_BOUND if k == "output" else A_GRAD_BOUND["dx" if k == "dx" else "dsos"]
                    require(v <= floor and v <= A_PLAIN_FACTOR * e_a[k] + floor,
                            f"{name} {problem}, TF32 {tf32}: {k} {v:.3e} from float64 > {floor} "
                            f"(and {A_PLAIN_FACTOR} x kernel A's {e_a[k]:.3e} + it)")
            same = torch.equal(outs[False][0], outs[True][0])
            grads_same = all(torch.equal(a, b) for a, b in zip(outs[False][1], outs[True][1]))
            print(f"[block {problem}] {name}: output with TF32 on bitwise equal to off: {same}; gradients: "
                  f"{grads_same}")
            require(same, f"{name}: the output changes with TF32")
            rows[name] = {"err": e, **timings(fn)}

        # an fp32 matmul of the same shape does change with TF32 on this card
        f = sig.reshape(BS, -1, 128)
        op = torch.randn((BS, 128, 128), device=device)
        tf32_matmul(True)
        try:
            m_on = torch.matmul(f, op)
        finally:
            tf32_matmul(False)
        tf32_gap = float((m_on - torch.matmul(f, op)).abs().max() / torch.matmul(f, op).abs().max())
        print(f"[block {problem}] an fp32 torch.matmul ({BS}, {f.shape[1]}, 128) @ ({BS}, 128, 128) with TF32 on "
              f"differs from off by {tf32_gap:.3e} of its peak")
        for name, r in rows.items():
            print(f"[block time] {problem} {name}: forward {r['forward_ms']:.4f} ms a call, "
                  f"{fmt_ms(r['forward_device_ms'])} of device work; forward + gradient {r['gradient_ms']:.4f} ms "
                  f"a call, {fmt_ms(r['gradient_device_ms'])} of device work | {card}")
        results[problem] = rows
    return results


def phase_block_step(ctx, device, card):
    """Phase 13: the JAX bench's own step (EQ "block", compressor "block")
    from phase 7's weights, batch and noise: the corruption, and the
    render's loss and gradient on one corrupted batch, against the kernel
    path of the same function; then 1 warm-up and 3 timed steps.

    The "block" smoother is the attack-only one-pole, as "pallas" (kernel A
    on a degenerate biquad); phase 7's "exact_pallas" is the true
    attack/release ballistics, another function. So the step is held to
    the kernel path with EQ "pallas" and compressor "pallas" at phase 7's
    tolerances; its distance from phase 7's own path is printed."""
    import torch

    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.models import make_style_processors

    net, procs, opt = TR.make_style_training(SR, device=device, eq_filter_method="block",
                                             compressor_smoother="block")
    same_fn = make_style_processors(SR, reverb_num_samples=IR, eq_filter_method="pallas",
                                    compressor_smoother="pallas", reverb_noise_mode="frequency")
    gen = torch.Generator(device=device)
    x, rand = ctx["batch"]

    def corrupted(processors):
        gen.set_state(ctx["noise_state"])
        return TR.corrupt(processors, x, rand, generator=gen), gen.get_state()

    # the corruption of both paths, and the render's loss and gradient of
    # both on one corrupted batch (phase 7's comparison; the bf16 encoder
    # would amplify the corruptions' rounding differences in its input)
    batch_k, render_state = corrupted(same_fn)
    reset_launch_counts()
    batch_b, _ = corrupted(procs)
    torch.cuda.synchronize()
    used = {k: v for k, v in launch_counts().items() if v}
    corrupt_diff = max(float((b - k).abs().max()) / float(k.abs().max()) for b, k in zip(batch_b, batch_k))

    def grads(processors, batch):
        net.load_state_dict(ctx["state"])
        net.zero_grad(set_to_none=True)
        gen.set_state(render_state)
        loss = TR.render_loss(net, processors, *batch, generator=gen)
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().clone() for k, p in net.named_parameters()}

    loss_7, _ = grads(ctx["procs"], batch_k)
    loss_k, g_k = grads(same_fn, batch_k)
    before = launch_counts()
    loss_b, g_b = grads(procs, batch_k)
    torch.cuda.synchronize()
    used.update({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
    net.load_state_dict(ctx["state"])
    norm = lambda g: math.sqrt(sum(float((v.double() ** 2).sum()) for v in g.values()))  # noqa: E731
    loss_rel = abs(loss_b - loss_k) / abs(loss_k)
    gn_rel = abs(norm(g_b) - norm(g_k)) / norm(g_k)
    leaf = max(float((g_b[k] - g_k[k]).abs().max()) for k in g_k) / norm(g_k)
    print(f"[block step] EQ 'block', compressor 'block' vs the kernel path of the same function (EQ 'pallas', "
          f"compressor 'pallas'), phase 7's weights, batch and noise: corruption max abs diff {corrupt_diff:.3e} of "
          f"its peak (tolerance 2 x {A_BOUND}); render loss {loss_b:.6f} vs {loss_k:.6f}, rel err {loss_rel:.2e}; "
          f"grad-norm rel err {gn_rel:.2e}; max grad-leaf err {leaf:.2e} of grad-norm; kernels launched {used} "
          f"(phase 7's path, compressor 'exact_pallas': loss {loss_7:.6f}, {abs(loss_b - loss_7) / abs(loss_7):.2e} "
          f"away)")
    require(not used, f"block step launched {used}")
    require(math.isfinite(loss_b) and all(bool(torch.isfinite(v).all()) for v in g_b.values()),
            "block step: non-finite loss or gradients")
    require(corrupt_diff <= 2 * A_BOUND, f"block corruption differs by {corrupt_diff:.3e} of its peak")
    require(loss_rel <= TRAIN_LOSS_TOL, f"block step loss rel err {loss_rel:.3e} > {TRAIN_LOSS_TOL}")
    require(gn_rel <= TRAIN_GRAD_NORM_TOL, f"block step grad-norm rel err {gn_rel:.3e} > {TRAIN_GRAD_NORM_TOL}")

    batches = ctx["batches"]
    noise_gen = torch.Generator(device=device).manual_seed(ctx["seed"] + 4)
    TR.train_step(net, procs, opt, *batches[0], generator=noise_gen)  # warm-up
    torch.cuda.synchronize()
    names = ("corrupt", "forward", "backward", "optimizer")
    reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        t0 = time.perf_counter()
        loss = TR.train_step(net, procs, opt, *batches[1 + i], generator=noise_gen, mark=mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        total = marks[0].elapsed_time(marks[-1])
        print(f"[block step] step {i}: loss {float(loss):.6f} | " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
              + f", step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"block step {i}: loss {float(loss)}")
        steps.append(total)
    used = {k: v for k, v in launch_counts().items() if v}
    require(not used, f"block steps launched {used}")
    mean_ms = sum(steps) / TRAIN_STEPS
    split = device_ms_by_kernel(lambda: TR.train_step(net, procs, opt, *batches[1], generator=noise_gen), (), 1)
    print(f"[block step] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps {mean_ms:.3f} ms); "
          f"all device work of one step {fmt_ms(split['all'])}; kernels launched {used} | {card}")


def phase_reference_chain(seed, device, card):
    """Phase 14: the reference set through Chain at full width, kernel path
    against the plain path; each track through the mixing console's graphic
    EQ first (examples/mixing_console.py:36-39)."""
    import torch

    from dasp_tpu_torch.modules import (Chain, Compressor, Distortion, Gain, GraphicEQ, ParametricEQ, StereoBus,
                                        StereoPanner, StereoWidener)
    from dasp_tpu_torch.utils import multi_resolution_stft_loss

    tracks_n = 4

    def console(eq, comp):
        chain = Chain([Distortion(SR), ParametricEQ(SR, filter_method=eq), Compressor(SR, smoother=comp),
                       StereoWidener(SR), Gain(SR)])
        return GraphicEQ(SR), StereoPanner(SR), StereoBus(SR, tracks_n), chain

    kernel, plain = console("pallas", "exact_pallas"), console("exact", "exact")
    n_eq = kernel[0].num_params
    n_params = (n_eq + 2) * tracks_n + kernel[3].num_params
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    tracks = 0.25 * torch.randn((BS, tracks_n, T), generator=gen, device=device)
    p = torch.rand((BS, n_params), generator=gen, device=device)
    target = tracks.mean(dim=1, keepdim=True).expand(BS, 2, T)
    print(f"[chain] {tracks_n} mono tracks of {T} samples at bs {BS}: GraphicEQ ('coupled') and StereoPanner per "
          f"track, StereoBus({tracks_n}), Chain of {len(kernel[3].processors)} from one ({BS}, {n_params}) tensor")

    def mix(procs, q):
        eq, panner, bus, chain = procs
        flat = tracks.reshape(BS * tracks_n, 1, T)
        flat = eq.process_normalized(flat, q[:, : n_eq * tracks_n].reshape(BS * tracks_n, n_eq), clip_params=True)
        q = q[:, n_eq * tracks_n:]
        panned = panner.process_normalized(flat, q[:, :tracks_n].reshape(BS * tracks_n, 1), clip_params=True)
        panned = panned.reshape(BS, tracks_n, 2, T).transpose(1, 2)  # (BS, 2, tracks, T)
        y = bus.process_normalized(panned, q[:, tracks_n: 2 * tracks_n], clip_params=True)
        return chain.process_normalized(y, q[:, 2 * tracks_n:], clip_params=True)

    def grad(procs):
        q = p.clone().requires_grad_()
        y = mix(procs, q)
        multi_resolution_stft_loss(y, target).backward()
        return y.detach(), q.grad

    with torch.no_grad():
        mix(kernel, p)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        y_k = mix(kernel, p)
    _, g_k = grad(kernel)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    want = {"sosfilt_cascade": 1, "sosfilt_cascade_save_all": 1, "sosfilt_cascade_adjoint": 1, "ballistics": 2,
            "ballistics_bwd": 1}
    print(f"[chain] launches, one render and one forward + backward: {launches}")
    require(launches == want, f"chain launches {launches}, expected {want}")
    require(tuple(y_k.shape) == (BS, 2, T) and bool(torch.isfinite(y_k).all()), "chain: bad output")
    require(bool(torch.isfinite(g_k).all()), "chain: non-finite gradient")

    with torch.no_grad():
        render_ms = cuda_ms(lambda: mix(kernel, p), 3)
    grad_ms = cuda_ms(lambda: grad(kernel), 3)
    t0 = time.perf_counter()
    y_p, g_p = grad(plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    peak = float(y_p.abs().max())
    diff = float((y_k - y_p).abs().max())
    tol = 2 * A_BOUND * peak
    g_rel = float((g_k - g_p).norm() / g_p.norm())
    g_leaf = float((g_k - g_p).abs().max() / g_p.abs().max())
    print(f"[chain] kernel path vs plain path (EQ 'exact', compressor 'exact'; {plain_s:.1f} s host clock): output "
          f"max abs diff {diff:.3e} (tolerance {tol:.3e} = 2 x {A_BOUND} x peak {peak:.3f}); parameter gradient "
          f"{g_rel:.3e} of its norm (tolerance {TRAIN_GRAD_NORM_TOL}), max element {g_leaf:.3e} of the largest")
    print(f"[chain] render {render_ms:.3f} ms, forward + MR-STFT loss + backward {grad_ms:.3f} ms (CUDA events, "
          f"mean of 3) | {card}")
    require(diff <= tol, f"chain output differs from the plain path by {diff:.3e} > {tol:.3e}")
    require(g_rel <= TRAIN_GRAD_NORM_TOL, f"chain gradient differs from the plain path by {g_rel:.3e}")


def ballistics_float64(g, alpha_attack, alpha_release, max_iter: int = 64):
    """Kernel B's branching recursion in g's dtype (float64) on g's device,
    by iterating on its branch pattern: with the pattern held the recursion
    is linear, one scan (``ops.onepole_varying``), and a pattern that its
    own output reproduces gives the sequential recursion's output. It
    starts from the attack-only pass and holds the pattern it found for
    the gradient, as autograd through the plain loop does. Phase 15's
    float64 reference for the kernel users, where the plain loop takes
    about 50 s a call on the card."""
    import torch

    from dasp_tpu_torch.ops import onepole_varying

    aa = torch.broadcast_to(torch.as_tensor(alpha_attack, dtype=g.dtype, device=g.device), g.shape)
    ar = torch.broadcast_to(torch.as_tensor(alpha_release, dtype=g.dtype, device=g.device), g.shape)
    with torch.no_grad():
        y = onepole_varying(g, aa)
        for _ in range(max_iter):
            attack = g < torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], dim=-1)
            y_next = onepole_varying(g, torch.where(attack, aa, ar))
            if torch.equal(y_next, y):
                break
            y = y_next
        else:
            raise PhaseError(f"ballistics_float64: no fixed point in {max_iter} iterations")
    return onepole_varying(g, torch.where(attack, aa, ar))


def bitcrusher_float64(x, bit_depth, sample_rate_hz, mix, return_u: bool = False):
    """Phase 15's reference of the bitcrusher, written out on its own: the
    hold positions from the effect's clock, which is fp32 (the tick ordinal
    ``floor(n * r + 1e-6)`` with ``r = sample_rate_hz / sample_rate``
    rounded to fp32), each sample holding the first sample of its tick
    (a sorted search, not the effect's running max), then the quantizer in
    float64: ``round(u) / 2^(bit_depth - 1)`` with ``u = held *
    2^(bit_depth - 1)``, the smooth surrogate's gradient, and the dry/wet
    mix. With ``return_u`` also returns ``u``."""
    import torch

    bs, chs, T = x.shape
    r = torch.clamp((sample_rate_hz.detach().double() / SR).float(), 0.0, 1.0).reshape(bs, 1)
    n = torch.arange(T, dtype=torch.float32, device=x.device)[None, :]
    tick = torch.floor(n * r + 1e-6)
    idx = torch.searchsorted(tick.contiguous(), tick.contiguous())
    held = torch.gather(x, -1, idx[:, None, :].expand(bs, chs, T))
    scale = torch.exp2(bit_depth - 1.0).reshape(bs, 1, 1)
    u = held * scale
    q_soft = u - torch.sin(2.0 * math.pi * u) / (2.0 * math.pi)
    q = q_soft + (torch.round(u) - q_soft).detach()
    m = mix.reshape(bs, 1, 1)
    y = (1.0 - m) * x + m * (q / scale)
    return (y, u.detach()) if return_u else y


@contextlib.contextmanager
def ballistics_replaced(fn):
    """The effects' ``smoother="exact_pallas"`` evaluated by ``fn`` while
    the block runs."""
    from dasp_tpu_torch import functional as F

    kernel = F.ballistics_pallas
    F.ballistics_pallas = lambda g, aa, ar: fn(g, aa, ar)
    try:
        yield
    finally:
        F.ballistics_pallas = kernel


@contextlib.contextmanager
def frac_delay_dense():
    """The effects' fractional delay on its dense plain version (adjoint
    "ad", no kernel) while the block runs."""
    from dasp_tpu_torch import functional as F

    matmul = F._frac_delay_matmul
    F._frac_delay_matmul = lambda x, taps, dmax, block, **kw: matmul(x, taps, dmax, block, **{**kw, "adjoint": "ad"})
    try:
        yield
    finally:
        F._frac_delay_matmul = matmul


def leaf_grads(fn, leaves, device, dtype, **options):
    """``fn`` on copies of ``leaves`` (a dict: "x" first) moved to
    ``device`` and ``dtype``: the output and the gradient of mean(y ** 2)
    with respect to each leaf (None where none reached it)."""
    import torch

    ts = {k: v.detach().to(device=device, dtype=dtype).clone().requires_grad_() for k, v in leaves.items()}
    y = fn(**ts, **options)
    (y ** 2).mean().backward()
    return y.detach(), {k: t.grad for k, t in ts.items()}


def grad_norm_errors(got, truth):
    """Each gradient's distance from its reference, of the reference's norm
    (where the reference is not zero)."""
    out = {}
    for k, t in truth.items():
        if t is None or not float(t.norm()) > 0:
            continue
        g = got[k].to(device=t.device, dtype=t.dtype) if got[k] is not None else 0 * t
        out[k] = float((g - t).norm() / t.norm())
    return out


def phase_dynamics(seed, device, card):
    """Phase 15: the twelve effects of the dynamics family at their defaults
    at full width, fp32 on the card against float64 (see the module
    docstring for the references), with exact launches; then
    sosfilt_coupled against float64 scipy with TF32 off and on, and the
    same formulation computed in fp32."""
    import numpy as np
    import scipy.signal
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch import modules as M
    from dasp_tpu_torch.ops import ballistics_kernel as BK
    from dasp_tpu_torch.ops import iir as I

    # the float64 reference of the kernel users against the plain loop in
    # float64 (on CPU copies) on a noise gate's and an expander's curves
    check_rng = np.random.default_rng(seed + 8)
    for curve in ("gate", "expander"):
        gc, ac, rc = (t.double() for t in dynamics_curve(check_rng, PLAIN_CHECK_T, device, curve))
        y_f = ballistics_float64(gc, ac.reshape(BS, 1, 1), rc.reshape(BS, 1, 1))
        y_l = BK.ballistics_plain(gc.cpu(), ac.cpu(), rc.cpu())
        err = float((y_f.cpu() - y_l).abs().max()) / max(1.0, float(y_l.abs().max()))
        print(f"[dynamics] ballistics_float64 against the plain loop in float64, {curve} curve, {BS} x "
              f"{PLAIN_CHECK_T}: {err:.3e} of max(1, peak)")
        require(err <= 1e-9, f"ballistics_float64 {err:.3e} from the plain loop")

    gen = torch.Generator(device=device).manual_seed(seed + 8)
    x = 0.25 * torch.randn((BS, 2, T), generator=gen, device=device)
    key = 0.5 * torch.randn((BS, 1, T), generator=gen, device=device)
    for name, (fname, b_user) in DYNAMICS.items():
        proc = getattr(M, name)(SR)
        p = 0.05 + 0.9 * torch.rand((BS, proc.num_params), generator=gen, device=device)
        params = proc.denormalize_param_dict(proc.extract_param_dict(p))
        if name == "GraphicEQ":
            params = {"band_gains_db": torch.stack([params[f"band{i}_gain_db"] for i in range(10)], dim=-1)}
        leaves = {"x": x, **params, **({"sidechain": key} if name == "SidechainCompressor" else {})}
        effect = getattr(F, fname)

        def fn(x, **kw):
            return effect(x, SR, **kw)

        reset_launch_counts()
        y, g = leaf_grads(fn, leaves, device, torch.float32)
        torch.cuda.synchronize()
        used = {k: v for k, v in launch_counts().items() if v}
        want = {"ballistics": 1, "ballistics_bwd": 1} if b_user else {}
        require(used == want, f"{name}: launches {used}, expected {want}")
        require(tuple(y.shape) == (BS, 2, T) and bool(torch.isfinite(y).all()), f"{name}: bad output")
        require(all(v is None or bool(torch.isfinite(v).all()) for v in g.values()), f"{name}: non-finite gradient")

        t0 = time.perf_counter()
        if name == "Bitcrusher":
            ref_name = "float64 on the card by bitcrusher_float64"
            y_r, g_r = leaf_grads(bitcrusher_float64, leaves, device, torch.float64)
        elif b_user:
            ref_name = "float64 on the card, the smoother by ballistics_float64"
            with ballistics_replaced(ballistics_float64):
                y_r, g_r = leaf_grads(fn, leaves, device, torch.float64)
        else:
            ref_name = "float64 on the card"
            y_r, g_r = leaf_grads(fn, leaves, device, torch.float64)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        diff = (y.to(y_r.device, y_r.dtype) - y_r).abs()
        if name == "Bitcrusher":
            # the rounding may flip by one step, mix / 2^(bit_depth - 1), only
            # where u lies within fp32 rounding of a half point
            _, u = bitcrusher_float64(**{k: v.double() for k, v in leaves.items()}, return_u=True)
            near_half = (u - torch.floor(u) - 0.5).abs() <= HALF_POINT_WINDOW * u.abs().clamp_min(1.0)
            step = (params["mix"].double() / torch.exp2(params["bit_depth"].double() - 1.0)).reshape(BS, 1, 1)
            flipped = int(((diff > 0.5 * step) & near_half).sum())
            beyond = float((diff - torch.where(near_half, step, 0.0)).max())
            out_err = max(0.0, beyond) / max(1.0, float(y_r.abs().max()))
            ref_name += f"; {int(near_half.sum())} samples near a half point, {flipped} of them a step apart"
        else:
            out_err = float(diff.max()) / max(1.0, float(y_r.abs().max()))
        g_err = grad_norm_errors(g, g_r)

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: fn(**leaves), 3)
        grad_ms = cuda_ms(lambda: leaf_grads(fn, leaves, device, torch.float32), 2)
        worst = max(g_err, key=g_err.get)
        print(f"[dynamics {name}] launches {used}; against {ref_name} ({ref_s:.1f} s): output {out_err:.3e} of "
              f"max(1, peak)" + (" beyond the steps forgiven" if name == "Bitcrusher" else "")
              + f", gradients of their norms up to {g_err[worst]:.3e} (d{worst}); "
              + ", ".join(f"d{k} {v:.2e}" for k, v in g_err.items())
              + f" | forward {fwd_ms:.3f} ms, forward + gradient {grad_ms:.3f} ms a call | {card}")
        require(out_err <= 2 * A_BOUND, f"{name}: output {out_err:.3e} from {ref_name}")
        require(g_err[worst] <= TRAIN_GRAD_NORM_TOL, f"{name}: d{worst} {g_err[worst]:.3e} from {ref_name}")

    # sosfilt_coupled on the graphic EQ's sections: +-12 dB, rows of +12 dB on every band
    gains = 24.0 * torch.rand((BS, 10), generator=gen, device=device) - 12.0
    gains[0] = 12.0
    sos = F.graphic_eq_sos(BS, torch.float32, SR, gains, device=device)
    sos_s = I.stabilize_sos(sos)
    xs = x.contiguous()
    t0 = time.perf_counter()
    sos64 = sos_s.double().cpu().numpy()
    x64 = xs.double().cpu().numpy()
    ref = torch.tensor(np.stack([np.stack([scipy.signal.sosfilt(sos64[b], x64[b, c]) for c in range(2)])
                                 for b in range(BS)]), device=device)
    scale = max(1.0, float(ref.abs().max()))
    print(f"[coupled] graphic EQ, {BS} x 2 x {T}, 10 sections at +-12 dB (31.5 Hz to 16 kHz); float64 scipy on the "
          f"host in {time.perf_counter() - t0:.1f} s")

    def fp32_formulation():
        rows, sos_rows = I._fold_rows(xs, sos_s)
        zi = rows.new_zeros((rows.shape[0], 10, 2))
        return I._sosfilt_coupled_rows(I._coupled_operators(sos_rows, 128), rows, zi)[0].reshape(xs.shape)

    outs = {}
    for label, f in (("float64 inside (sosfilt_coupled)", lambda: I.sosfilt_coupled(sos, xs)),
                     ("fp32 inside", fp32_formulation)):
        for tf32 in (False, True):
            tf32_matmul(tf32)
            try:
                with torch.no_grad():
                    outs[label, tf32] = f()
                torch.cuda.synchronize()
            finally:
                tf32_matmul(False)
            err = float((outs[label, tf32].double() - ref).abs().max()) / scale
            print(f"[coupled] {label}, TF32 {'on' if tf32 else 'off'}: {err:.3e} of max(1, peak) from float64")
            if label.startswith("float64"):
                require(err <= COUPLED_TOL, f"sosfilt_coupled {err:.3e} from float64 > {COUPLED_TOL}")
    require(torch.equal(outs["float64 inside (sosfilt_coupled)", False], outs["float64 inside (sosfilt_coupled)", True]),
            "sosfilt_coupled changes with TF32")

    def coupled_grad():
        leaves = [t.clone().requires_grad_() for t in (sos, xs)]
        (I.sosfilt_coupled(*leaves) ** 2).mean().backward()

    with torch.no_grad():
        fwd = lambda: I.sosfilt_coupled(sos, xs)  # noqa: E731
        fwd_ms, fwd_dev = cuda_ms(fwd, 3), device_ms_by_kernel(fwd, (), 2)["all"]
        f32_ms, f32_dev = cuda_ms(fp32_formulation, 3), device_ms_by_kernel(fp32_formulation, (), 2)["all"]
    grad_ms, grad_dev = cuda_ms(coupled_grad, 2), device_ms_by_kernel(coupled_grad, (), 1)["all"]
    print(f"[coupled time] float64 inside: forward {fwd_ms:.4f} ms a call, {fmt_ms(fwd_dev)} of device work; "
          f"forward + gradient {grad_ms:.4f} ms a call, {fmt_ms(grad_dev)} of device work; fp32 inside: forward "
          f"{f32_ms:.4f} ms a call, {fmt_ms(f32_dev)} of device work | {card}")


def phase_mastering(seed, device, card):
    """Phase 16: the mastering step (examples/mastering.py's whole chain) at
    full width: 1 warm-up and 3 timed steps, launches, and one step's
    render, loss and gradient against the plain path."""
    import torch

    from dasp_tpu_torch import modules as M
    from dasp_tpu_torch import train as TR

    chain, z, opt = TR.make_mastering(SR, bs=BS, device=device)
    require(chain.num_params == MASTERING_PARAMS, f"{chain.num_params} parameters, expected {MASTERING_PARAMS}")
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    mixes = [0.25 * torch.randn((BS, 2, T), generator=gen, device=device) for _ in range(TRAIN_STEPS + 2)]
    p_true = torch.clamp(0.5 + 0.25 * torch.randn((BS, chain.num_params), generator=gen, device=device), 0.05, 0.95)
    print(f"[mastering] Chain([{', '.join(type(p).__name__ for p in chain.processors)}]), {chain.num_params} logits; "
          f"bs {BS} stereo clips of {T} samples; MR-STFT + 10 x MSE, Adam 2e-2")

    loss = TR.mastering_step(chain, z, opt, mixes[0], p_true)  # warm-up
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss)), f"mastering warm-up loss {float(loss)}")
    z_start = z.detach().clone()
    names = ("target", "forward", "backward", "optimizer")
    reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        t0 = time.perf_counter()
        loss = TR.mastering_step(chain, z, opt, mixes[1 + i], p_true, mark=mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        total = marks[0].elapsed_time(marks[-1])
        print(f"[mastering] step {i}: loss {float(loss):.6f} | " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
              + f", step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"mastering step {i}: loss {float(loss)}")
        require(bool(torch.isfinite(z.grad).all()), f"mastering step {i}: non-finite gradient")
        steps.append(total)
    launches = {k: v for k, v in launch_counts().items() if v}
    want = {k: TRAIN_STEPS * v for k, v in MASTERING_STEP_LAUNCHES.items()}
    print(f"[mastering] launches during the {TRAIN_STEPS} steps: {launches}")
    require(launches == want, f"mastering launches {launches}, expected {want}")
    moved = float((z.detach() - z_start).abs().max())
    require(moved > 0, "mastering: z did not change")
    mean_ms = sum(steps) / TRAIN_STEPS
    split = device_ms_by_kernel(lambda: TR.mastering_step(chain, z, opt, mixes[1], p_true),
                                ("ballistics_kernel", "ballistics_bwd_kernel"), 1)
    print(f"[mastering] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps {mean_ms:.3f} ms); z "
          f"moved up to {moved:.3e}; one step's device work (profiler): all {fmt_ms(split['all'])}, B-fwd (2 "
          f"launches) {fmt_ms(split['ballistics_kernel'])}, B-bwd {fmt_ms(split['ballistics_bwd_kernel'])} | {card}")

    # one step's render, loss and gradient again on the plain path
    mix = mixes[-1]
    with torch.no_grad():
        target = chain.process_normalized(mix, p_true, clip_params=True)

    def grads(ch):
        zz = z.detach().clone().requires_grad_()
        loss, y = TR.mastering_loss(ch, zz, mix, target)
        loss.backward()
        return y.detach(), float(loss.detach()), zz.grad

    y_k, loss_k, g_k = grads(chain)
    plain = M.Chain([M.TransientShaper(SR), M.DynamicEQ(SR, num_bands=3), M.MultibandCompressor(SR), M.Exciter(SR),
                     M.Limiter(SR, smoother="exact")])
    t0 = time.perf_counter()
    y_p, loss_p, g_p = grads(plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    peak = float(y_p.abs().max())
    diff = float((y_k - y_p).abs().max())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    g_rel = float((g_k - g_p).norm() / g_p.norm())
    print(f"[mastering] kernel path vs plain path (limiter 'exact', {plain_s:.1f} s host clock): output max abs "
          f"diff {diff:.3e} (tolerance 2 x {A_BOUND} x peak {peak:.3f}); loss {loss_k:.6f} vs {loss_p:.6f}, rel "
          f"err {loss_rel:.2e}; gradient of z {g_rel:.3e} of its norm")
    require(diff <= 2 * A_BOUND * peak, f"mastering output differs from the plain path by {diff:.3e}")
    require(loss_rel <= TRAIN_LOSS_TOL, f"mastering loss rel err {loss_rel:.3e} > {TRAIN_LOSS_TOL}")
    require(g_rel <= TRAIN_GRAD_NORM_TOL, f"mastering gradient rel err {g_rel:.3e} > {TRAIN_GRAD_NORM_TOL}")


def phase_wola_delay(seed, device, card):
    """Phase 17: the rest of the delay family and the WOLA family at full
    width, each effect called with denormalized parameters from its
    processor's ranges, fp32 on the card against float64 on the card, with
    exact launches and ms a call; then the WOLA round trip, the
    contractions the reference runs at Precision.HIGHEST with TF32 off and
    on (and what float64 costs there), and the phase vocoder's x-gradient
    on a clip with silence."""
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch import modules as M
    from dasp_tpu_torch.ops import tv_istft, tv_stft

    gen = torch.Generator(device=device).manual_seed(seed + 10)
    x = 0.25 * torch.randn((BS, 2, T), generator=gen, device=device)
    ir = torch.randn((BS, IR), generator=gen, device=device) * torch.exp(
        -torch.arange(IR, device=device) / (0.1 * SR))
    noise = torch.randn((BS, 2, T), generator=gen, device=device)
    failures = []
    for fname, (pname, options) in WOLA_DELAY.items():
        leaves, opts = {"x": x}, dict(options)
        if pname is not None:
            proc = getattr(M, pname)(SR)
            p = 0.05 + 0.9 * torch.rand((BS, proc.num_params), generator=gen, device=device)
            params = proc.denormalize_param_dict(proc.extract_param_dict(p))
            if pname == "DynamicEQ":
                params = {n: torch.stack([params[f"band{i}_{n}"] for i in range(proc.num_bands)], dim=-1)
                          for n in M.DynamicEQ._NAMES}
            leaves.update(params)
        if fname == "convolution_reverb":
            leaves["ir"] = ir
        if fname == "wow_flutter":
            opts["noise"] = noise
        if fname == "time_stretch":
            opts["out_len"] = T
        effect = getattr(F, fname)

        def fn(x, **kw):
            return effect(x, **kw) if fname == "spectral_noise_profile" else effect(x, SR, **kw)

        reset_launch_counts()
        y, g = leaf_grads(fn, leaves, device, torch.float32, **opts)
        torch.cuda.synchronize()
        used = {k: v for k, v in launch_counts().items() if v}
        want = WOLA_DELAY_LAUNCHES.get(fname, {})
        t0 = time.perf_counter()
        y_r, g_r = leaf_grads(fn, leaves, device, torch.float64, **opts)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        out_err = float((y.double() - y_r).abs().max()) / max(1.0, float(y_r.abs().max()))
        g_err = grad_norm_errors(g, g_r)
        limit = {k: TRAIN_GRAD_NORM_TOL for k in g_err}
        checks = []
        if fname == "wow_flutter":
            # the delay parameters' gradients by phase 10's rule for kernel C:
            # within 2 x the dense fp32 path's distance from float64 plus
            # EFFECT_GRAD_FLOOR, and within EFFECT_GRAD_FP32_TOL of that path
            # (where fp32 and float64 read positions straddle an integer, the
            # two take different one-sided slopes, kernel and dense alike)
            with frac_delay_dense():
                _, g_d = leaf_grads(fn, leaves, device, torch.float32, **opts)
            dense_err, vs_dense = grad_norm_errors(g_d, g_r), grad_norm_errors(g, g_d)
            for k in g_err:
                if k != "x":
                    limit[k] = 2 * dense_err[k] + EFFECT_GRAD_FLOOR
                    checks.append((vs_dense[k] <= EFFECT_GRAD_FP32_TOL, f"d{k} {vs_dense[k]:.3e} from the dense path"))
            print(f"[wola/delay {fname}] the dense fp32 path (no kernel) from float64: "
                  + ", ".join(f"d{k} {v:.2e}" for k, v in dense_err.items()) + "; the kernel path from it: "
                  + ", ".join(f"d{k} {v:.2e}" for k, v in vs_dense.items()))
        worst = max(g_err, key=lambda k: g_err[k] / limit[k])
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: fn(**leaves, **opts), 3)
        grad_ms = cuda_ms(lambda: leaf_grads(fn, leaves, device, torch.float32, **opts), 2)
        print(f"[wola/delay {fname}] launches {used}; against float64 on the card ({ref_s:.1f} s): output "
              f"{out_err:.3e} of max(1, peak), gradients of their norms up to {g_err[worst]:.3e} (d{worst}); "
              + ", ".join(f"d{k} {v:.2e}" for k, v in g_err.items())
              + f" | forward {fwd_ms:.3f} ms, forward + gradient {grad_ms:.3f} ms a call | {card}")
        finite = bool(torch.isfinite(y).all()) and all(v is None or bool(torch.isfinite(v).all()) for v in g.values())
        checks += [(used == want, f"launches {used}, expected {want}"), (finite, "non-finite output or gradient"),
                   (out_err <= 2 * A_BOUND, f"output {out_err:.3e} from float64"),
                   (g_err[worst] <= limit[worst], f"d{worst} {g_err[worst]:.3e} from float64 > {limit[worst]:.3e}")]
        failures += [f"{fname}: {msg}" for ok, msg in checks if not ok]

    # the WOLA round trip at the gate's and the phase vocoder's frames
    with torch.no_grad():
        back = tv_istft(tv_stft(x, 2048, 512, 4096), T, 2048, 512)
    rt = float((back - x).abs().max()) / max(1.0, float(x.abs().max()))
    print(f"[wola] tv_istft(tv_stft(x)) at {BS} x 2 x {T}, frames 2048 / 512: {rt:.3e} of max(1, peak) from x")
    if not rt <= ROUNDTRIP_TOL:
        failures.append(f"round trip {rt:.3e} > {ROUNDTRIP_TOL}")

    # the contractions the reference runs at Precision.HIGHEST: the same bits
    # with TF32 off and on, through the effects that hold them
    p_deq = {n: torch.stack([v] * 3, dim=-1) for n, v in (
        ("frequency_hz", torch.full((BS,), 1000.0, device=device)), ("q_factor", torch.full((BS,), 2.0, device=device)),
        ("threshold_db", torch.full((BS,), -40.0, device=device)), ("ratio", torch.full((BS,), 4.0, device=device)),
        ("attack_ms", torch.full((BS,), 10.0, device=device)), ("release_ms", torch.full((BS,), 100.0, device=device)))}
    p_deq["frequency_hz"] = p_deq["frequency_hz"] * torch.tensor([0.1, 1.0, 8.0], device=device)
    rate = 0.6 + 0.8 * torch.rand((BS,), generator=gen, device=device)
    semis = 24.0 * torch.rand((BS,), generator=gen, device=device) - 12.0
    for name, run in (("dynamic_eq", lambda: F.dynamic_eq(x, SR, **p_deq)),
                      ("time_stretch (out_len)", lambda: F.time_stretch(x, SR, rate, out_len=T)),
                      ("pitch_shift_pv (max_semitones)", lambda: F.pitch_shift_pv(x, SR, semis, max_semitones=12.0))):
        outs = []
        for tf32 in (False, True):
            tf32_matmul(tf32)
            try:
                with torch.no_grad():
                    outs.append(run())
                torch.cuda.synchronize()
            finally:
                tf32_matmul(False)
        same = torch.equal(outs[0], outs[1])
        print(f"[wola] {name}: TF32 off and on {'the same bits' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{name} changes with TF32")

    # what float64 costs in those contractions: _einsum_float64 against the
    # fp32 einsum on the same operands (TF32 off), and the fp32 einsum's
    # distance from float64 with TF32 off and on
    X = tv_stft(x, 2048, 512, 4096)
    nf = X.shape[2]
    tau = torch.clamp(torch.arange(nf, device=device)[None, :] * rate[:, None], 0.0, nf - 1)
    W = torch.relu(1.0 - torch.abs(tau[:, :, None] - torch.arange(nf, device=device)))
    Xd = tv_stft(x, 1024, 256, 4096)
    P_ = (Xd.real.square() + Xd.imag.square()).mean(dim=1)
    bw = torch.rand((BS, 3, P_.shape[-1]), generator=gen, device=device) * 1e-4
    for name, eq, a, b in (("time_stretch's hat matrix", "bof,bcfk->bcok", W, X.abs()),
                           ("dynamic_eq's band levels", "bfk,bnk->bnf", P_, bw)):
        truth = torch.einsum(eq, a.double(), b.double())
        errs = {}
        for tf32 in (False, True):
            tf32_matmul(tf32)
            try:
                errs[tf32] = rel_err(torch.einsum(eq, a, b), truth)
            finally:
                tf32_matmul(False)
        f64_ms = cuda_ms(lambda: F._einsum_float64(eq, a, b), 5)
        f32_ms = cuda_ms(lambda: torch.einsum(eq, a, b), 5)
        print(f"[wola] {name} ({eq}, {tuple(a.shape)} x {tuple(b.shape)}): float64 {f64_ms:.4f} ms a call, fp32 "
              f"{f32_ms:.4f} ms; the fp32 einsum {errs[False]:.3e} (TF32 off) and {errs[True]:.3e} (TF32 on) of "
              f"the largest from float64 | {card}")

    # the phase vocoder's x-gradient on a clip whose first half is silent
    silent = x.clone()
    silent[..., : T // 2] = 0.0
    for name, run in (("time_stretch(rate=1.25)", lambda v: F.time_stretch(v, SR, 1.25)),
                      ("pitch_shift_pv(3.0)", lambda v: F.pitch_shift_pv(v, SR, 3.0)),
                      ("TimeStretch", lambda v: F.time_stretch(v, SR, rate, out_len=T)),
                      ("PitchShiftPV", lambda v: F.pitch_shift_pv(v, SR, semis, max_semitones=12.0))):
        v = silent.clone().requires_grad_()
        (run(v) ** 2).mean().backward()
        bad = int((~torch.isfinite(v.grad)).sum())
        print(f"[wola] {name} on a clip with a silent first half: {bad} non-finite x-gradient entries")
        if bad:
            failures.append(f"{name}: {bad} non-finite x-gradient entries on silence")
    require(not failures, "; ".join(failures))


def phase_denoise(seed, device, card):
    """Phase 18: the denoising step (examples/denoise.py) at full width: 1
    warm-up and 3 timed steps split into profile / forward + loss /
    backward / Adam by CUDA events, no kernel launched, finite loss and
    gradient, z changed; one step's loss and gradient of z against float64
    on the card."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.utils import synthetic_batch

    gate, z, opt = TR.make_denoise(SR, bs=BS, device=device)
    rng = np.random.default_rng(seed + 11)
    amp = 10.0 ** (DENOISE_NOISE_DB / 20.0)
    gen = torch.Generator(device=device).manual_seed(seed + 11)

    def batch():
        clean = torch.tensor(synthetic_batch(rng, BS, T, SR), device=device)
        return (clean + amp * torch.randn(clean.shape, generator=gen, device=device), clean,
                amp * torch.randn(clean.shape, generator=gen, device=device))

    batches = [batch() for _ in range(TRAIN_STEPS + 2)]
    print(f"[denoise] SpectralGate(SR), {gate.num_params} logits from logit({list(TR.DENOISE_P0)}); bs {BS} mono "
          f"clips of {T} samples (synthetic_batch), noise at {DENOISE_NOISE_DB} dB; MSE, Adam 3e-2")
    loss = TR.denoise_step(gate, z, opt, *batches[0])  # warm-up
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss)), f"denoise warm-up loss {float(loss)}")
    z_start = z.detach().clone()
    names = ("profile", "forward", "backward", "optimizer")
    reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        t0 = time.perf_counter()
        loss = TR.denoise_step(gate, z, opt, *batches[1 + i], mark=mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        total = marks[0].elapsed_time(marks[-1])
        print(f"[denoise] step {i}: loss {float(loss):.6e} | " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
              + f", step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"denoise step {i}: loss {float(loss)}")
        require(bool(torch.isfinite(z.grad).all()), f"denoise step {i}: non-finite gradient")
        steps.append(total)
    launches = {k: v for k, v in launch_counts().items() if v}
    print(f"[denoise] launches during the {TRAIN_STEPS} steps: {launches}")
    require(not launches, f"denoise launches {launches}, expected none")
    moved = float((z.detach() - z_start).abs().max())
    require(moved > 0, "denoise: z did not change")
    mean_ms = sum(steps) / TRAIN_STEPS
    split = device_ms_by_kernel(lambda: TR.denoise_step(gate, z, opt, *batches[1]), (), 1)
    print(f"[denoise] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps {mean_ms:.3f} ms); z "
          f"moved up to {moved:.3e}; one step's device work (profiler) {fmt_ms(split['all'])} | {card}")

    # one step's loss and gradient of z against float64 on the card
    noisy, clean, noise_only = batches[-1]

    def grads(dtype):
        zz = z.detach().to(dtype).clone().requires_grad_()
        with torch.no_grad():
            prof = F.spectral_noise_profile(noise_only.to(dtype))
        loss, _ = TR.denoise_loss(gate, zz, noisy.to(dtype), clean.to(dtype), prof)
        loss.backward()
        return float(loss.detach()), zz.grad

    loss_k, g_k = grads(torch.float32)
    loss_r, g_r = grads(torch.float64)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    g_rel = float((g_k.double() - g_r).norm() / g_r.norm())
    print(f"[denoise] fp32 against float64 on the card: loss {loss_k:.9e} vs {loss_r:.9e}, rel err {loss_rel:.2e}; "
          f"gradient of z {g_rel:.3e} of its norm")
    require(loss_rel <= TRAIN_LOSS_TOL, f"denoise loss rel err {loss_rel:.3e} > {TRAIN_LOSS_TOL}")
    require(g_rel <= TRAIN_GRAD_NORM_TOL, f"denoise gradient rel err {g_rel:.3e} > {TRAIN_GRAD_NORM_TOL}")


def classic_chain(bs, chunk, smoother, seed, device):
    """benchmarks/streaming_latency.py's "classic" serving chain through
    ``StreamChain``: parametric EQ ("coupled", the bench's 18 values) ->
    compressor (``smoother`` "block" or "exact") -> filtered-noise reverb
    (65536-tap IR, frequency-domain noise from ``seed``, mix 0.3), and the
    offline render of the same chain (kernel B for "exact", whose chunked
    evaluation phase 3 holds to one pass)."""
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch import streaming as S

    eq = [torch.full((bs,), v, device=device) for v in STREAM_EQ]
    comp = {k: torch.full((bs,), v, device=device) for k, v in STREAM_COMP.items()}
    rev0 = S.reverb_stream_init(
        SR, torch.full((bs, 12), 0.6), torch.full((bs, 12), 0.4), 0.3,
        torch.Generator(device=device).manual_seed(seed), num_samples=IR, chunk_len=chunk, device=device)
    chain = S.StreamChain([
        ("eq", lambda c, s: S.parametric_eq_stream(c, SR, *eq, zi=s)),
        ("comp", lambda c, s: S.compressor_stream(c, SR, **comp, zi=s, smoother=smoother)),
        ("rev", lambda c, s: S.reverb_stream(c, rev0 if s is None else s)),
    ])

    def offline(x):
        y = F.parametric_eq(x, SR, *eq, filter_method="coupled")
        y = F.compressor(y, SR, **comp, smoother={"block": "block", "exact": "exact_pallas"}[smoother])
        return F.convolution_reverb(y, SR, 0.3, rev0["ir"])

    return chain, offline


def mastering_stream_chain(bs, device):
    """benchmarks/streaming_latency.py's "mastering" serving chain through
    ``StreamChain``: transient shaper -> dynamic EQ (3 bands) -> exciter ->
    limiter (``smoother="exact"``: kernel B), and its offline render. The
    dynamic EQ's stream is the offline render delayed by its WOLA lookahead
    (frame_size - hop = 768 samples), whose frames equal the offline
    render's on the input led by that many zeros (frames of zeros give a
    unit response and leave the ballistics at rest); the exciter and the
    limiter then run on the delayed signal, as in the stream."""
    import torch
    import torch.nn.functional as nnf

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch import streaming as S

    def full(v, n=None):
        return torch.full((bs,) if n is None else (bs, n), v, device=device)

    ts = dict(attack=full(0.6), sustain=full(-0.4))
    deq = dict(frequency_hz=torch.tensor([[200.0, 1500.0, 6000.0]] * bs, device=device), q_factor=full(2.0, 3),
               threshold_db=full(-24.0, 3), ratio=full(4.0, 3), attack_ms=full(5.0, 3), release_ms=full(80.0, 3))
    exc = [full(v) for v in (3000.0, 12.0, 0.4)]
    lim = {k: full(v) for k, v in dict(threshold_db=-3.0, attack_ms=2.0, release_ms=80.0, knee_db=3.0,
                                       makeup_gain_db=0.0).items()}
    chain = S.StreamChain([
        ("ts", lambda c, s: S.transient_shaper_stream(c, SR, **ts, state=s)),
        ("deq", lambda c, s: S.dynamic_eq_stream(c, SR, **deq, state=s)),
        ("exc", lambda c, s: S.exciter_stream(c, SR, *exc, zi=s)),
        ("lim", lambda c, s: S.limiter_stream(c, SR, **lim, zi=s, smoother="exact")),
    ])
    left = 1024 - 256  # the dynamic EQ's frame_size - hop

    def offline(x):
        y = F.transient_shaper(x, SR, **ts)
        y = F.dynamic_eq(nnf.pad(y, (left, 0)), SR, **deq)[..., : x.shape[-1]]
        y = F.exciter(y, SR, *exc)
        return F.limiter(y, SR, **lim, smoother="exact_pallas")

    return chain, offline


def run_stream(chain, x, chunk, timed: int = 0):
    """``x`` (bs, ch, T) through ``chain`` chunk by chunk from rest; the
    output and the last state. With ``timed``, each chunk is also timed
    alone as a server runs it, from its call to its output on the card: by
    CUDA events around the call and by the host clock to the end of the
    event's wait. The first STREAM_WARMUP chunks are not timed, and the
    stream goes on through ``x`` again (those outputs dropped) until
    ``timed`` chunks are; then also returns the p50 and p99 of each, ms."""
    import numpy as np
    import torch

    chunks = x.split(chunk, dim=-1)
    outs, state, dev, host = [], None, [], []
    i = 0
    while i < len(chunks) or len(dev) < timed:
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
        y, state = chain(chunks[i % len(chunks)], state)
        if timed:
            end.record()
            end.synchronize()
            if i >= STREAM_WARMUP:
                host.append((time.perf_counter() - t0) * 1e3)
                dev.append(start.elapsed_time(end))
        if i < len(chunks):
            outs.append(y)
        i += 1
    y = torch.cat(outs, dim=-1)
    if not timed:
        return y, state
    return y, state, {k: tuple(float(v) for v in np.percentile(a, [50, 99])) for k, a in (("dev", dev), ("host", host))}


def stage_split(chain, x, chunk, n: int = 20):
    """Where a chunk's time goes: each stage of ``chain`` timed alone
    (synchronized before and after, host clock) over ``n`` chunks from
    rest, the mean ms of each; and the device work a chunk over 10 more
    (profiler, all kernels)."""
    import torch

    chunks = x.split(chunk, dim=-1)
    state, ms = {}, {name: 0.0 for name, _ in chain.steps}
    for i in range(n):
        c = chunks[i % len(chunks)]
        for name, fn in chain.steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c, state[name] = fn(c, state.get(name))
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t0) * 1e3 / n
    it = iter(range(n, n + 10**6))

    def step():
        nonlocal state
        _, state = chain(chunks[next(it) % len(chunks)], state)

    return ms, device_ms_by_kernel(step, (), 10)["all"]


@contextlib.contextmanager
def streams_on_plain_ballistics():
    """The streams' ``"exact"`` ballistics on the plain loop (the kernel's
    plain engine, on the card) while the block runs."""
    from dasp_tpu_torch import streaming as S
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_plain

    kernel = S.ballistics_pallas
    S.ballistics_pallas = ballistics_plain
    try:
        yield
    finally:
        S.ballistics_pallas = kernel


def check_stream(what, chain, offline, x, chunk, smoother, card):
    """One serving configuration: the main path (the stream over x from
    rest, launch counts zeroed just before and read just after), chunked
    against offline, for "exact" bitwise against the plain loop, and the
    serving latency. Returns the launches, the output and a result row."""
    import torch

    n_chunks = x.shape[-1] // chunk
    n_run = max(n_chunks, STREAM_WARMUP + STREAM_TIMED)
    reset_launch_counts()
    y, _, t = run_stream(chain, x, chunk, timed=STREAM_TIMED)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    want = {"ballistics": n_run} if smoother == "exact" else {}
    require(launches == want, f"{what}: launches {launches}, expected {want}")
    # both chains have one coupled stream step a chunk (the EQ; the exciter)
    launches["sosfilt_coupled_step"] = kernel_d_launches()
    require(launches["sosfilt_coupled_step"] == n_run,
            f"{what}: {launches['sosfilt_coupled_step']} kernel D launches, expected {n_run}")
    require(bool(torch.isfinite(y).all()) and y.shape == (x.shape[0], 2, x.shape[-1]), f"{what}: bad output")
    ref = offline(x)
    scale = max(1.0, float(ref.abs().max()))
    err = float((y - ref).abs().max()) / scale
    require(err <= STREAM_TOL, f"{what}: chunked differs from offline by {err:.3e} of max(1, peak) > {STREAM_TOL}")
    plain = "-"
    if smoother == "exact":
        # the plain loop's few launches a sample take about 10 s a stream:
        # the same stream over its first PLAIN_CHECK_T samples
        with streams_on_plain_ballistics():
            t0 = time.perf_counter()
            y_plain, _ = run_stream(chain, x[..., :PLAIN_CHECK_T], chunk)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        y_head = y[..., :PLAIN_CHECK_T]
        require(torch.equal(y_head, y_plain), f"{what}: the kernel path is not bitwise the plain loop's "
                f"({float((y_head - y_plain).abs().max()):.3e})")
        plain = f"the first {PLAIN_CHECK_T} samples bitwise the plain loop's ({plain_s:.1f} s host clock)"
    stages, device = stage_split(chain, x, chunk)
    chunk_ms = chunk / SR * 1e3
    row = {"chunk": chunk, "chunk_ms": chunk_ms, "p50_ms": t["dev"][0], "p99_ms": t["dev"][1],
           "host_p50_ms": t["host"][0], "host_p99_ms": t["host"][1], "margin": chunk_ms / t["dev"][0],
           "device_ms": device, "stages_ms": stages, "err": err, "launches": launches}
    print(f"[stream] {what}: {n_chunks} chunks of x ({n_run} run), launches {launches or 'none'}; chunked vs "
          f"offline {err:.3e} of max(1, peak); {plain}; per chunk (CUDA events, {n_run - STREAM_WARMUP} chunks after "
          f"{STREAM_WARMUP}) p50 {t['dev'][0]:.4f} ms, p99 "
          f"{t['dev'][1]:.4f} ms; host clock p50 {t['host'][0]:.4f} ms, p99 {t['host'][1]:.4f} ms; real-time "
          f"margin {row['margin']:.2f}x ({chunk_ms:.3f} ms of audio); device work {fmt_ms(device)} a chunk "
          f"(profiler); stages (synchronized, host clock) "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()) + f" | {card}")
    return launches, y, row


def phase_streaming(seed, device, card):
    """Phase 19: the serving path. The two chains of
    benchmarks/streaming_latency.py through StreamChain at full width
    (stereo, 131072 samples, a 65536-tap IR): each configuration chunked
    against its offline render, "exact" bitwise against the plain loop,
    one B-fwd launch a chunk and no B-bwd, latency and real-time margin;
    integrated loudness of the mastering output ("coupled", and "pallas":
    kernel A, one launch) against float64 on the card and the 997 Hz
    calibration; the mastering chain's processors through save_preset /
    load_preset, rendering the same bits. Returns the main paths' launches
    summed."""
    import tempfile

    import torch

    from dasp_tpu_torch import modules as M
    from dasp_tpu_torch import utils as U
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_pallas

    total = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    gen = torch.Generator(device=device).manual_seed(seed + 19)
    rows = []
    with torch.no_grad():
        for bs in STREAM_BS["classic"]:
            x = 0.3 * torch.randn((bs, 2, T), generator=gen, device=device)
            for chunk in STREAM_CHUNKS["classic"]:
                for smoother in ("block", "exact"):
                    chain, offline = classic_chain(bs, chunk, smoother, seed, device)
                    what = f"classic bs {bs} chunk {chunk} compressor {smoother!r}"
                    launches, _, row = check_stream(what, chain, offline, x, chunk, smoother, card)
                    count(launches)
                    rows.append((what, row))
        x = 0.3 * torch.randn((1, 2, T), generator=gen, device=device)
        for chunk in STREAM_CHUNKS["mastering"]:
            chain, offline = mastering_stream_chain(1, device)
            what = f"mastering bs 1 chunk {chunk} limiter 'exact'"
            launches, y_master, row = check_stream(what, chain, offline, x, chunk, "exact", card)
            count(launches)
            rows.append((what, row))

        # loudness of the mastering output: fp32 against float64 on the card
        reset_launch_counts()
        l_c = U.integrated_loudness(y_master, SR)
        require(not any(launch_counts().values()), "loudness 'coupled' launched a kernel")
        reset_launch_counts()
        l_p = U.integrated_loudness(y_master, SR, filter_method="pallas")
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        require(launches == {"sosfilt_cascade": 1}, f"loudness 'pallas' launches {launches}")
        count(launches)
        l_64 = U.integrated_loudness(y_master.double(), SR)
        errs = {m: abs(float(v) - float(l_64)) for m, v in (("coupled", l_c), ("pallas", l_p))}
        n = torch.arange(T, dtype=torch.float64, device=device) / SR
        sine = torch.sin(2 * math.pi * 997.0 * n).float()[None, None, :]
        l_sine = float(U.integrated_loudness(sine, SR))
        l_sine64 = float(U.integrated_loudness(sine.double(), SR))
        print(f"[stream] loudness of the mastering output: coupled {float(l_c):.6f}, pallas (A, 1 launch) "
              f"{float(l_p):.6f}, float64 {float(l_64):.6f} LUFS (errors {errs['coupled']:.2e}, {errs['pallas']:.2e} "
              f"LU); 0 dBFS 997 Hz sine {l_sine:.6f} LUFS (float64 {l_sine64:.6f}) | {card}")
        for m, e in errs.items():
            require(e <= LOUDNESS_TOL, f"loudness {m!r} {e:.3e} LU from float64 > {LOUDNESS_TOL}")
        require(abs(l_sine - l_sine64) <= LOUDNESS_TOL, f"997 Hz sine {l_sine} vs float64 {l_sine64}")
        require(abs(l_sine - CALIBRATION_LUFS) <= CALIBRATION_TOL,
                f"997 Hz sine reads {l_sine:.4f} LUFS, not {CALIBRATION_LUFS} +- {CALIBRATION_TOL}")

        # the mastering chain's processors through a preset file
        chain = M.Chain([M.TransientShaper(SR), M.DynamicEQ(SR, num_bands=3), M.Exciter(SR),
                         M.Limiter(SR, smoother="exact_pallas")])
        p = torch.rand((1, chain.num_params), generator=gen, device=device)
        y1 = chain.process_normalized(x, p, clip_params=True)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "mastering.json")
            U.save_preset(path, chain, p, metadata={"chain": "mastering"})
            chain2, p2 = U.load_preset(path)
        y2 = chain2.process_normalized(x, p2.to(device), clip_params=True)
        require(torch.equal(p2.to(device), p), "preset parameters changed on the round trip")
        require(torch.equal(y1, y2), f"preset round trip renders {float((y1 - y2).abs().max()):.3e} off")
        print(f"[stream] preset round trip of Chain([{', '.join(type(q).__name__ for q in chain.processors)}]), "
              f"{chain.num_params} parameters: the same bits on the card")

        # B-fwd alone on the streams' short rows, with y0
        for t_len in (128, 2048):
            g = -torch.rand((2, 1, t_len), generator=gen, device=device) * 20.0
            aa, ar = torch.full((2,), 0.99, device=device), torch.full((2,), 0.9999, device=device)
            y0 = torch.full((2, 1), -3.0, device=device)
            fn = lambda: ballistics_pallas(g, aa, ar, y0=y0)  # noqa: E731
            print(f"[stream] B-fwd on 2 x {t_len} with y0: {cuda_ms(fn, 200):.4f} ms a call (CUDA events), kernel "
                  f"alone {fmt_ms(kernel_device_ms(fn, 'ballistics_kernel', 50))} (profiler) | {card}")
    print("[stream] " + json.dumps({what: {k: v for k, v in r.items() if k != "launches"} for what, r in rows}))
    return total


def phase_coupled_step(seed, device, card):
    """Phase 22: kernel D, the coupled cascade's stream step, at the serving
    cells' shapes (bs 1 and 8 stereo streams, chunks of 512, the classic
    chain's 6 EQ sections, a carried state): against its plain float64
    loop and against the block-state loop it replaces (both within one
    fp32 ulp of the peak), its time alone and a call's beside its bound
    and the block-state loop's. Returns the bs 8 row's results."""
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import iir as I
    from dasp_tpu_torch.ops import iir_stream_kernel as DK

    gen = torch.Generator(device=device).manual_seed(seed + 22)
    out = {}
    for bs in STREAM_BS["classic"]:
        chunk, R, S = 512, 2 * bs, 6
        eq = [torch.full((bs,), v, device=device) for v in STREAM_EQ]
        sos = F.parametric_eq_sos(bs, torch.float32, SR, *eq, device=device)
        x = 0.3 * torch.randn((bs, 2, chunk), generator=gen, device=device)
        rows = x.reshape(R, chunk)
        ops = I.coupled_operators(sos, x.shape)
        real, blocks = ops.get("realization"), ops.get("blocks")
        zi = 0.1 * torch.randn((R, S, 2), generator=gen, device=device)
        reset_launch_counts()
        y, zf = DK.coupled_step(real, rows, zi)
        torch.cuda.synchronize()
        require(kernel_d_launches() == 1, f"kernel D on {R} x {chunk}: {kernel_d_launches()} launches")
        t0 = time.perf_counter()
        y_p, zf_p = DK.coupled_step_plain(real, rows, zi)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3

        def block_form():
            return I._sosfilt_coupled_rows(blocks, rows.double(), zi.double())

        y_b, zf_b = block_form()
        eps = float(torch.finfo(torch.float32).eps)
        errs = {}
        for name, (yy, zz) in (("plain", (y_p, zf_p)), ("block", (y_b, zf_b))):
            errs[name] = max(float((y.double() - yy).abs().max()) / float(yy.abs().max()),
                             float((zf.double() - zz).abs().max()) / float(zz.abs().max()))
            require(errs[name] <= eps, f"kernel D on {R} x {chunk}: {errs[name]:.3e} of the peak from the "
                    f"{name} loop > one fp32 ulp ({eps:.3e})")
        fn = lambda: DK.coupled_step(real, rows, zi)  # noqa: E731
        alone = kernel_device_ms(fn, "coupled_step_kernel", 200)
        call = cuda_ms(fn, 500)
        n_host = 2000
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_host):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / n_host
        torch.cuda.synchronize()
        block_dev = device_ms_by_kernel(block_form, (), 50)["all"]
        block_call = cuda_ms(block_form, 100)
        t0 = time.perf_counter()
        for _ in range(200):
            block_form()
        block_host = (time.perf_counter() - t0) * 1e3 / 200
        torch.cuda.synchronize()
        nbytes = 2 * R * chunk * 4 + R * S * 9 * 8 + 2 * R * S * 2 * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 12 * R * chunk * S / FP64_OPS_PER_S
        bnd = {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"[kernel D] {bs} x 2 x {chunk}, {S} sections, from a carried state: from the plain float64 loop "
              f"{errs['plain']:.3e}, from the block-state loop {errs['block']:.3e} of the peak; kernel alone "
              f"{fmt_ms(alone)} (profiler; {chunk + S - 1} dependent steps a row), a call {call:.4f} ms (CUDA "
              f"events), {host:.4f} ms of host time a call (no synchronize); bound {bnd['bound_ms']:.6f} ms "
              f"({bnd['bound_by']}); the block-state loop it replaces: device {fmt_ms(block_dev)} a call "
              f"(profiler, all kernels), {block_call:.4f} ms a call (CUDA events), {block_host:.4f} ms of host "
              f"time a call; the plain loop {plain_ms:.1f} ms (host clock) | {card}")
        out = {"err": errs["plain"], "ms": call, "alone_ms": alone, "plain_ms": plain_ms, **bnd}
    return out


def tcn_layer_gap(got, want, conv, bn):
    """(share of elements that differ, largest gap over the rule's bound)
    of kernel E's output against ``want`` (see TCN_DIFFER_SHARE)."""
    import torch

    scale = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).detach()[:, None]
    y = want.float()
    v = (y - bn.bias.detach()[:, None]) / scale + bn.running_mean[:, None]
    diff = (got.float() - y).abs()
    bnd = 2.0**-7 * (scale.abs() * (2 * v.abs() + conv.bias.detach().abs()[:, None]) + y.abs())
    return float((diff > 0).float().mean()), float((diff / bnd).max())


def encoder_layers(net):
    """The (conv, prelu, bn) of each of the encoder's layers, in order."""
    return [tuple(getattr(blk, f"{n}{j}") for n in ("conv", "prelu", "bn")) for blk in net.encoder.blocks
            for j in (0, 1)]


def randomize_bn(net, gen):
    """BatchNorm statistics and affine away from their defaults, so that
    every term of kernel E's epilogue shows."""
    import torch

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
            elif isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.05, 0.3, generator=gen)


def phase_tcn_layer(seed, device, card):
    """Phase 23: kernel E at the style encoder's 20 layer shapes (the
    render's 16 clips of 131072, activations chained from layer to layer)
    against its plain version and cuDNN's path, its times beside its bound,
    the plain version's and cuDNN's; then StyleTransferNet's forward at bs 8
    on kernel E and on cuDNN's path. Returns the summed row of the 20
    layers."""
    import torch

    from dasp_tpu_torch import models as M
    from dasp_tpu_torch.models import tcn
    from dasp_tpu_torch.ops import tcn_kernel as E

    gen = torch.Generator(device=device).manual_seed(seed + 23)
    net = M.StyleTransferNet(dtype=torch.bfloat16).to(device).eval()
    randomize_bn(net, gen)
    on_card = tcn._on_card

    def cudnn_path(fn):
        tcn._on_card = lambda t: False
        try:
            return fn()
        finally:
            tcn._on_card = on_card

    x = 0.3 * torch.randn((2 * BS, 1, T), generator=gen, device=device)
    tot = {"ms": 0.0, "alone_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "alone_n": 0}
    worst = 0.0
    with torch.inference_mode():
        for i, (conv, prelu, bn) in enumerate(encoder_layers(net)):
            args = (conv.weight, conv.bias, prelu.weight, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                    bn.eps, conv.stride[0], conv.dilation[0])
            reset_launch_counts()
            y = E.tcn_layer(x, *args)
            torch.cuda.synchronize()
            n_launch = trace_counts().get("kernel_e.forward", 0)
            require(n_launch == 1, f"kernel E layer {i}: {n_launch} launches")
            t0 = time.perf_counter()
            y_p = E.tcn_layer_plain(x, *args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            y_c = cudnn_path(lambda: net.encoder.blocks[i // 2]._layer(conv, prelu, bn, x))
            gaps = {name: tcn_layer_gap(y, ref, conv, bn) for name, ref in (("plain", y_p), ("cuDNN", y_c))}
            for name, (share, over) in gaps.items():
                require(over <= 1.0 and share <= TCN_DIFFER_SHARE,
                        f"kernel E layer {i} {tuple(x.shape)}: {share:.2e} of the elements differ from {name}'s, "
                        f"the largest at {over:.3f} of the bound")
            worst = max(worst, float((y.float() - y_p.float()).abs().max()))
            fn = lambda: E.tcn_layer(x, *args)  # noqa: E731
            alone = kernel_device_ms(fn, "tcn_layer", 20)
            call = cuda_ms(fn, 20)
            library = cuda_ms(lambda: cudnn_path(lambda: net.encoder.blocks[i // 2]._layer(conv, prelu, bn, x)), 20)
            c_in, taps = conv.in_channels, conv.kernel_size[0]
            rows = y.shape[0] * y.shape[2]
            flops = 2 * rows * E.CHANNELS * c_in * taps
            nbytes = 2 * (x.numel() + conv.weight.numel() + y.numel())
            t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
            bnd = max(t_ops, t_bytes) * 1e3
            print(f"[kernel E] layer {i} ({'conv0' if i % 2 == 0 else 'conv1'}, stride {conv.stride[0]}, dilation "
                  f"{conv.dilation[0]}): {tuple(x.shape)} -> {tuple(y.shape)}; kernel alone {fmt_ms(alone)}, a call "
                  f"{call:.4f} ms, bound {bnd:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}; "
                  f"{flops / call / 1e9:.1f} TFLOP/s a call); plain {plain_ms:.1f} ms (host clock, float64 sums); "
                  f"cuDNN's conv + PReLU + BatchNorm {library:.4f} ms; differ from plain / cuDNN on "
                  f"{gaps['plain'][0]:.2e} / {gaps['cuDNN'][0]:.2e} of the elements, largest at "
                  f"{gaps['plain'][1]:.3f} / {gaps['cuDNN'][1]:.3f} of the bound | {card}")
            for k, v in (("ms", call), ("alone_ms", alone or 0.0), ("alone_n", alone is not None),
                         ("plain_ms", plain_ms), ("library_ms", library), ("bound_ms", bnd)):
                tot[k] += v
            x = y
            del y_p, y_c

        inp = 0.3 * torch.randn((BS, 1, T), generator=gen, device=device)
        ref = 0.3 * torch.randn((BS, 1, T), generator=gen, device=device)
        reset_launch_counts()
        p_e = net(inp, ref)
        torch.cuda.synchronize()
        counts = trace_counts()
        require(counts.get("kernel_e.forward", 0) == 20 and counts.get("encoder.conv_layer", 0) == 20,
                f"StyleTransferNet forward: {counts.get('kernel_e.forward', 0)} kernel E launches and "
                f"{counts.get('encoder.conv_layer', 0)} layer calls, expected 20 and 20 (one merged pass)")
        p_c = cudnn_path(lambda: net(inp, ref))
        gap = max(float((p_e[k].double() - p_c[k].double()).abs().max()) for k in p_e)
        after = cuda_ms(lambda: net(inp, ref), 20)
        before = cuda_ms(lambda: cudnn_path(lambda: net(inp, ref)), 10)
    print(f"[kernel E] the 20 layers at {2 * BS} x {T}: {tot['ms']:.3f} ms of calls, bound {tot['bound_ms']:.3f} ms; "
          f"kernel alone {tot['alone_ms']:.3f} ms over the {tot['alone_n']} layers the profiler recorded; cuDNN's path "
          f"{tot['library_ms']:.3f} ms | {card}")
    print(f"[kernel E] StyleTransferNet forward, {BS} pairs of {T}: on kernel E {after:.3f} ms, on cuDNN's path "
          f"{before:.3f} ms (CUDA events); normalized parameters {gap:.3e} apart | {card}")
    require(gap <= 1.5e-3, f"StyleTransferNet's parameters on kernel E {gap:.3e} from cuDNN's path > 1.5e-3")
    return {"err": worst, "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations", "library_ms": tot["library_ms"], "forward_ms": after,
            "forward_cudnn_ms": before}


def trace_counts() -> dict:
    from dasp_tpu_torch import trace

    return trace.snapshot()["counts"]


def run_example(name, argv):
    """``dasp_tpu_torch.examples.<name>.main(argv)``, its output printed
    with a prefix and returned, with its launches and wall time."""
    import importlib
    import io

    import torch

    mod = importlib.import_module(f"dasp_tpu_torch.examples.{name}")
    out = io.StringIO()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    for line in out.getvalue().splitlines():
        print(f"[files] {name}: {line}")
    return res, out.getvalue(), launches, wall


def on_pcm_grid(path) -> bool:
    import numpy as np

    from dasp_tpu_torch.utils import load_wav

    audio, sr = load_wav(str(path))
    return sr == SR and audio.size > 0 and bool(np.array_equal(audio * 32768, np.round(audio * 32768)))


def prefetch_bitwise(host, device, depth: int, wire) -> None:
    """Phase 20's input check: the numpy batches ``host`` (on the 16-bit
    grid) through a one-worker threaded_iterator and device_prefetch at
    ``depth`` over ``wire`` (a BatchPacker takes ``{"audio": batch}``),
    each batch on the device compared bitwise with its host batch as soon
    as it is yielded (the host batches are on the card beforehand). At
    depth 1 with the f32 wire the yielded tensor is the copy's own
    destination, whose copy was issued just before: a consumer that did not
    wait for it would read a partial copy."""
    import torch

    from dasp_tpu_torch.utils import BatchPacker, device_prefetch, threaded_iterator

    packed = isinstance(wire, BatchPacker)
    refs = [torch.from_numpy(h).to(device) for h in host]
    if device.type == "cuda":
        torch.cuda.synchronize()
    source = threaded_iterator(lambda wid: ({"audio": h} if packed else h for h in host), num_workers=1)
    got = 0
    for ref, b in zip(refs, device_prefetch(source, size=depth, device=device, wire=wire)):
        b = b["audio"] if packed else b
        require(b.device.type == device.type, "device_prefetch left a batch on the host")
        require(torch.equal(b, ref), f"depth {depth}: batch {got} on the card differs from its host batch")
        got += 1
    require(got == len(host), f"depth {depth}: device_prefetch yielded {got} of {len(host)} batches")


def phase_files(seed, device, card):
    """Phase 20: file-backed training on the card. A directory of mono and
    stereo 16-bit wavs written by the port's save_wav and indexed by
    index_wav_dataset (native library required); PREFETCH_BATCHES stereo
    batches from load_clip_batch through BatchPacker into device_prefetch
    (depth 3, one worker) bitwise their host batches, and mono-mixed ones
    over the i16 wire with the upload thread bitwise the host decode; ms a
    batch of a blocking copy and of device_prefetch. Then the examples
    through their main(argv) on --data-dir: auto_eq --filter-method pallas
    (the auto_eq preset net, bs 8 x 131072) 4 steps with a checkpoint every
    2, resumed to step 6; blind_estimation of pitch_shift and of the
    compressor with exact_pallas, 3 steps each; exact launches a step of
    kernels A, C and B, finite losses. Then quickstart (tests/
    test_integration.py's threshold), demo, mixing_console, streaming_demo,
    denoise and virtual_analog with pre-placed amp pairs; every wav they
    write reads back on the 16-bit grid. Returns the launches summed."""
    import tempfile

    import numpy as np
    import torch

    from dasp_tpu_torch import native
    from dasp_tpu_torch.utils import (BatchPacker, device_prefetch, index_wav_dataset, load_clip_batch, save_wav,
                                      synthetic_batch, wire_decode, wire_encode)

    require(native.available(), "the native wav library did not build or load")
    print(f"[files] native library {native.lib_path().name} serves wav I/O, indexing and batch loading")
    total = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "wavs"
        data.mkdir()
        rng = np.random.default_rng(seed + 20)
        n = DATA_SECONDS * SR
        for i in range(DATA_FILES):
            clips = synthetic_batch(rng, 2, n, SR, kind="mixed" if i % 2 else "chirp")
            audio = clips[0] if i % 2 == 0 else np.concatenate([clips[0], clips[1]])
            save_wav(str(data / f"{'mono' if i % 2 == 0 else 'stereo'}_{i}.wav"), audio, SR)
        index = index_wav_dataset(str(data), T)
        print(f"[files] {DATA_FILES} wavs of {DATA_SECONDS} s (mono and stereo) -> {len(index)} chunks of {T}")
        require(len(index) == DATA_FILES * (n // T), f"index has {len(index)} chunks")

        # the input path: batches on the card bitwise their host batches
        picks = [[index[j] for j in rng.choice(len(index), BS)] for _ in range(PREFETCH_BATCHES)]
        host = [load_clip_batch(p, T, channels=2, mono_mix=False, pad_mode="repeat") for p in picks]
        require(all(np.array_equal(h * 32768, np.round(h * 32768)) for h in host), "host batches off the PCM grid")
        packer = BatchPacker({"audio": host[0]})
        prefetch_bitwise(host, device, PREFETCH_DEPTH, packer)
        prefetch_bitwise([np.concatenate(host[i:i + 4]) for i in range(0, len(host), 4)], device, 1, "f32")
        mono = [load_clip_batch(p, T, channels=1, mono_mix=True) for p in picks[:8]]
        want = [wire_decode(wire_encode(m, "i16")) for m in mono]
        pipe = device_prefetch(iter(mono), size=PREFETCH_DEPTH, device=device, wire="i16", upload_thread=True)
        for i, (w, b) in enumerate(zip(want, pipe)):
            require(torch.equal(b, w.to(device)), f"mono batch {i}: the card's i16 decode differs from the host's")
        print(f"[files] {PREFETCH_BATCHES} stereo batches of {BS} x 2 x {T} through BatchPacker ({packer.nbytes} "
              f"bytes a batch) and device_prefetch (depth {PREFETCH_DEPTH}, one worker), and the same as 4 batches "
              f"of {4 * BS} at depth 1 over the f32 wire (each read as its copy may still run): bitwise their host "
              f"batches; 8 mono-mixed batches over the i16 wire with the upload thread: bitwise the host's decode")

        def blocking():
            for h in host:
                torch.from_numpy(h).to(device).sum()

        def prefetched(wire):
            def run():
                for b in device_prefetch(iter(host), size=PREFETCH_DEPTH, device=device, wire=wire):
                    b.sum()
            return run

        runs = (("blocking", blocking), ("i16", prefetched("i16")), ("f32", prefetched("f32")),
                ("packer", prefetched(BatchPacker(host[0]))), ("blocking again", blocking))
        for _, f in runs:
            f()  # warm-up
        ms = {k: host_ms(f) / len(host) for k, f in runs}
        print(f"[files] ms a batch of {BS} x 2 x {T} fp32 ({host[0].nbytes} bytes) to the card (host clock, "
              f"{len(host)} batches, nothing else on the card): blocking pageable copy {ms['blocking']:.3f} / "
              f"{ms['blocking again']:.3f}; device_prefetch (pinned, side stream, depth {PREFETCH_DEPTH}) f32 wire "
              f"{ms['f32']:.3f}, i16 wire {ms['i16']:.3f}, BatchPacker {ms['packer']:.3f} (the i16 encode runs on "
              f"the host, in the consumer's thread) | {card}")

        def count(launches):
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

        def check_run(what, res, launches, wall, log_dir):
            steps = EXAMPLE_STEPS[what]
            want = {k: v * steps for k, v in EXAMPLE_STEP_LAUNCHES[what].items()}
            losses = res["losses"]
            require(len(losses) == steps and all(math.isfinite(v) for v in losses), f"{what}: losses {losses}")
            recs = [json.loads(line) for line in open(Path(log_dir) / "metrics.jsonl")]
            require(recs and all(math.isfinite(r["loss"]) for r in recs), f"{what}: metrics {recs}")
            require(launches == want, f"{what}: launches {launches}, expected {want} ({steps} steps)")
            count(launches)
            print(f"[files] {what}: {steps} steps, launches a step {EXAMPLE_STEP_LAUNCHES[what]} (exact), "
                  f"losses {[round(v, 6) for v in losses]}, {wall:.2f} s through main, "
                  f"{wall / steps * 1e3:.1f} ms a step with the first step's warm-up | {card}")

        dev = ["--device", str(device), "--data-dir", str(data)]
        log = Path(tmp) / "auto_eq"
        argv = dev + ["--filter-method", "pallas", "--checkpoint-every", "2", "--log-dir", str(log)]
        res, _, launches, wall = run_example("auto_eq", argv + ["--steps", "4"])
        check_run("auto_eq", res, launches, wall, log)
        require((log / "ckpt.pkl").exists() and on_pcm_grid(log / "recovered_3.wav"), "auto_eq: files missing")
        res, out, launches, wall = run_example("auto_eq", argv + ["--steps", "6", "--resume"])
        require("resumed from step 4" in out and res["start"] == 4, "auto_eq did not resume from step 4")
        check_run("auto_eq resumed", res, launches, wall, log)
        for proc, extra in (("pitch_shift", []), ("compressor", ["--smoother", "exact_pallas"])):
            what = "blind " + " ".join([proc] + extra[1:])
            log = Path(tmp) / f"blind_{proc}"
            res, _, launches, wall = run_example(
                "blind_estimation", dev + ["--processor", proc, *extra, "--steps", "3", "--log-dir", str(log)])
            check_run(what, res, launches, wall, log)

        # the other six at their smoke or small settings
        out_dir = Path(tmp) / "out"
        amps = Path(tmp) / "amps"
        amps.mkdir()
        pair = synthetic_batch(rng, 2, 4 * 8192, SR)
        save_wav(str(amps / "idmt-rock-input-varying-gain.wav"), pair[0], SR)
        save_wav(str(amps / "idmt-rock-clean2-jazz-amp-120.wav"), pair[1], SR)
        # tests/test_integration.py's quickstart clip: 8192 samples from seed 0
        wav_in = str(Path(tmp) / "quickstart_in.wav")
        save_wav(wav_in, synthetic_batch(np.random.default_rng(0), 1, 8192, SR)[0], SR)
        runs = [
            ("quickstart", ["--wav", wav_in, "--iters", "300", "--lr", "0.05"], ["recovered.wav", "target.wav"]),
            ("demo", [], ["dry.wav", "wet.wav"]),
            ("mixing_console", ["--steps", "20"], ["mix.wav", "target.wav"]),
            ("streaming_demo", ["--smoke"], ["dry.wav", "streamed.wav"]),
            ("denoise", ["--smoke"], ["noisy.wav", "denoised.wav", "clean.wav"]),
            ("virtual_analog", ["--amps", "jazz-amp", "--amp-audio-dir", str(amps), "--smoke", "--steps", "3"],
             ["jazz-amp/audio/idmt-rock-clean2-jazz-amp-120-pred.wav", "jazz-amp/audio/"
              "idmt-rock-clean2-jazz-amp-120-target.wav"]),
        ]
        for name, argv, files in runs:
            where = out_dir / name
            flag = "--log-dir" if name == "virtual_analog" else "--out-dir"
            res, _, launches, wall = run_example(name, ["--device", str(device), flag, str(where), *argv])
            count(launches)
            for f in files:
                require(on_pcm_grid(where / f), f"{name}: {f} missing or off the 16-bit grid")
            if name == "quickstart":
                require(res["loss"] < res["loss0"] / 20 and abs(res["drive"] - 16.0) < 4.0,
                        f"quickstart: {res}")
            print(f"[files] {name}: {wall:.2f} s through main, launches {launches}, wrote {', '.join(files)}, "
                  f"each on the 16-bit grid | {card}")
    print(f"[files] phase 20 took {time.perf_counter() - t_phase:.1f} s; launches {total} | {card}")
    return total


# phase 21: the parallel layer
PARALLEL_SP = (2, 4)
PARALLEL_CONV_IR = 16384  # (c)'s IR: a halo that a block of T / 4 holds
STYLE_STEPS = 5
# the CPU tests' tolerances (tests/test_torch_parallel.py, _step.py)
PARALLEL_TOL = {"conv": 1e-4, "coupled": 5e-4, "onepole": (2e-5, 2e-4), "tv filter": 2e-5, "tv power": 2e-4,
                "loss": 1e-6}
DPSP_LOSS_TOL, DPSP_GRAD_TOL, DPSP_STATS_TOL = 2e-5, 3e-3, 1e-5
# at full width fp32 alone moves the encoder blocks' gradient by percents
# (see phase_parallel); (d) holds each part of the net's gradient to this
# many times that part's noise, or to DPSP_GRAD_TOL where it is smaller
DPSP_NOISE_FACTOR = 3.0
DPSP_PARTS = ("encoder.blocks", "encoder.dense", "projectors")
# style_transfer's step launches on one card with EQ "pallas" and smoother
# "exact_pallas", and each rank's under sp with EQ "coupled" and the relay
DPSP_RANK_LAUNCHES = {"ballistics": 2, "ballistics_bwd": 1}
def _on_card(rank, target, args):
    """A spawned gloo rank on cuda:0, with the parent's fp32 settings."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return target(rank, *args)


def spawn_ranks(world, target, args):
    """``target(rank, *args)`` on ``world`` spawned gloo ranks that share
    cuda:0; their results in rank order. Every process has ended (or was
    terminated after 10 minutes) before this returns."""
    from dasp_tpu_torch.parallel import spawn

    return spawn(world, _on_card, (target, args), threads=max(1, 8 // world), timeout=600)


def parallel_inputs(seed):
    """(b) and (c)'s inputs as numpy: a compressor's stereo gain curve at
    BS x 2 x T with its coefficients and a cotangent, noise for the conv, the
    tv filter and the loss, a response per frame, an IR and an EQ's sections."""
    import numpy as np
    import torch

    from dasp_tpu_torch.ops import biquad
    from dasp_tpu_torch.ops.tv_filter import tv_frame_count

    rng = np.random.default_rng(seed + 21)
    cpu = torch.device("cpu")
    curves = [compressor_curve(rng, T, cpu) for _ in range(2)]
    g = torch.cat([c[0] for c in curves], dim=1).numpy()
    aa, ar = curves[0][1].numpy(), curves[0][2].numpy()
    n_frames = tv_frame_count(T, 512, 128)
    secs = []
    for gain, fc, q, ft in [(4.0, 200.0, 0.7, "low_shelf"), (6.0, 40.0, 2.0, "peaking"),
                            (-6.0, 1000.0, 2.0, "peaking"), (3.0, 8000.0, 0.7, "high_shelf")]:
        b, a = biquad(*(torch.full((BS,), v) for v in (gain, fc, q)), SR, ft)
        secs.append(torch.cat([b, a], dim=-1))
    return {
        "g": g, "aa": aa, "ar": ar,
        "ct": rng.standard_normal(g.shape).astype(np.float32),
        "x": rng.standard_normal((BS, 2, T)).astype(np.float32),
        "x2": rng.standard_normal((BS, 2, T)).astype(np.float32),
        "h": (rng.standard_normal((BS, 2, PARALLEL_CONV_IR)) * 0.01).astype(np.float32),
        "H": ((rng.standard_normal((BS, n_frames, 1025)) + 1j * rng.standard_normal((BS, n_frames, 1025))) * 0.3)
        .astype(np.complex64),
        "sos": torch.stack(secs, dim=1).numpy(),
    }


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def parallel_functions_rank(rank, sp, inp, dev):
    """(b) and (c) on one rank of an sp world on ``dev``: the relay's block,
    its launches, its gradient and its wall-clock marks, then every other
    sharded function's block."""
    import torch
    import torch.distributed as dist

    from dasp_tpu_torch import parallel as P

    dev = torch.device(dev)
    mesh = P.make_mesh((1, sp), device=dev)
    spec = P.Sharding(mesh, (None, None, "sp"))

    def blk(a):
        return spec.block(torch.as_tensor(a)).contiguous().to(dev)

    g, ct = blk(inp["g"]), blk(inp["ct"])
    aa, ar = (torch.as_tensor(inp[k], device=dev) for k in ("aa", "ar"))
    out = {}
    # (b) the relay: one launch of each kernel a rank, forward and backward
    leaves = [t.clone().requires_grad_() for t in (g, aa, ar)]
    reset_launch_counts()
    y = P.sharded_ballistics_smooth(*leaves, mesh)
    dg, daa, dar = torch.autograd.grad(y, leaves, ct)
    _sync(dev)
    out["relay launches"] = launch_counts()
    out["relay"] = y.detach().cpu().numpy()
    out["relay grad"] = [t.cpu().numpy() for t in (dg, daa, dar)]
    marks = []
    with torch.no_grad():
        for _ in range(4):  # the first is a warm-up
            dist.barrier()
            _sync(dev)
            t0 = time.time()
            P.sharded_ballistics_smooth(g, aa, ar, mesh)
            _sync(dev)
            marks.append((t0, time.time()))
    out["relay marks"] = marks[1:]
    # (c) every other sharded function
    reset_launch_counts()
    x, x2 = blk(inp["x"]), blk(inp["x2"])
    with torch.no_grad():
        out["conv"] = P.sharded_fft_conv_causal(x, torch.as_tensor(inp["h"], device=dev), mesh).cpu().numpy()
        out["coupled"] = P.sharded_sosfilt_coupled(torch.as_tensor(inp["sos"], device=dev), x, mesh).cpu().numpy()
        out["onepole"] = P.sharded_onepole(g, aa[:, None, None], mesh).cpu().numpy()
        for mode in ("attack_only", "parallel"):
            out[mode] = P.sharded_ballistics_smooth(g, aa, ar, mesh, mode=mode).cpu().numpy()
        out["tv filter"] = P.sharded_tv_freq_filter(x, torch.as_tensor(inp["H"], device=dev), 512, 128,
                                                    mesh).cpu().numpy()
        out["tv power"] = P.sharded_tv_power(x, 512, 128, 2048, mesh).cpu().numpy()
        out["loss"] = float(P.sharded_multi_resolution_stft_loss(x, x2, mesh))
    out["launches"] = launch_counts()
    return out


def style_args(dpsp: bool, dev):
    from dasp_tpu_torch.examples import style_transfer

    argv = ["--device", str(dev), "--filter-method", "coupled", "--smoother", "exact_pallas",
            "--batch-size", str(BS), "--steps", "10"]
    return style_transfer.parse(argv + (["--dp", "--sp", "2"] if dpsp else []))


def style_step_grads(mesh, x, rand, noise, dev, per_rank_stats=False):
    """One style_transfer make_step on this rank (the whole batch without a
    mesh): loss, gradients, BatchNorm statistics and launches.
    ``per_rank_stats`` plants a fault: BatchNorm normalises each rank's
    slice of the batch by its own statistics instead of the dp group's."""
    import torch

    from dasp_tpu_torch.examples import style_transfer
    from dasp_tpu_torch.models.tcn import sync_batch_norm
    from dasp_tpu_torch.parallel import shard_batch

    dev = torch.device(dev)
    args = style_args(mesh is not None, dev)
    procs, net = style_transfer.build(args, mesh, dev)
    if per_rank_stats:
        sync_batch_norm(net, None)
    opt, sched = style_transfer.make_optimizer(args, net)
    step = style_transfer.make_step(args, procs, net, opt, sched, mesh)
    x, noise = torch.as_tensor(x, device=dev), [torch.as_tensor(n, device=dev) for n in noise]
    rand = {k: torch.as_tensor(v, device=dev) for k, v in rand.items()}
    if mesh is not None:
        x, rand = shard_batch(x, mesh), {k: shard_batch(v, mesh) for k, v in rand.items()}
        rows = noise[0].shape[0] // mesh.shape["dp"]
        noise = [n[mesh.index("dp") * rows:(mesh.index("dp") + 1) * rows] for n in noise]
    reset_launch_counts()
    loss = float(step(x, rand, noise=tuple(noise)))
    _sync(dev)
    grads = {k: p.grad.cpu().numpy() for k, p in net.named_parameters()}
    stats = {k: v.cpu().numpy() for k, v in net.state_dict().items() if "running" in k}
    return loss, grads, stats, launch_counts()


def dpsp_style_rank(rank, x, rand, noise, dev):
    """(d) on one rank of the dp 2 x sp 2 world: the step, then the step
    with the planted fault (per-rank BatchNorm statistics)."""
    from dasp_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 2), device=dev)
    loss, grads, stats, launches = style_step_grads(mesh, x, rand, noise, dev)
    planted = style_step_grads(mesh, x, rand, noise, dev, per_rank_stats=True)[:3]
    return (loss, grads, stats, launches, planted) if rank == 0 else (loss, None, None, launches, None)


def phase_parallel(seed, device, card):
    """Phase 21 (see the module docstring). Returns the launches of its
    main-path runs, summed over the ranks."""
    import tempfile

    import numpy as np
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK
    from dasp_tpu_torch.ops import fft_conv_causal, sosfilt_coupled
    from dasp_tpu_torch.ops.iir import ballistics_smooth, onepole_exact
    from dasp_tpu_torch.ops.tv_filter import tv_freq_filter, tv_stft
    from dasp_tpu_torch.utils import multi_resolution_stft_loss

    total = {}
    t_phase = time.perf_counter()

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        # (a) style_transfer's main on a one-rank NCCL world, full width
        log = Path(tmp) / "style"
        argv = ["--device", device.type, "--dp", "--filter-method", "pallas", "--smoother", "exact_pallas",
                "--log-dir", str(log)]  # one checkpoint, after the last step's stamp
        res, out, launches, wall = run_example("style_transfer", argv + ["--steps", str(STYLE_STEPS)])
        backend = "nccl" if device.type == "cuda" else "gloo"
        require(f"mesh: dp=1 sp=1 ({backend}" in out, f"style_transfer --dp did not run on {backend}: {out[:300]}")
        want = {k: v * STYLE_STEPS for k, v in STEP_LAUNCHES.items()}
        require(launches == want, f"style_transfer --dp: launches {launches}, expected {want}")
        require(len(res["losses"]) == STYLE_STEPS and all(math.isfinite(v) for v in res["losses"]),
                f"style_transfer --dp: losses {res['losses']}")
        require((log / "ckpt.pkl").exists() and (log / "metrics.jsonl").exists(), "style_transfer: files missing")
        count(launches)
        # the metrics' wall-clock stamps after step 0 and the last step: the
        # steps between, without the build and the first step's warm-up
        stamps = [json.loads(line)["time_s"] for line in open(log / "metrics.jsonl")]
        step_ms = (stamps[-1] - stamps[0]) / (STYLE_STEPS - 1) * 1e3
        print(f"[parallel] style_transfer main --dp (one NCCL rank, StyleTransferNet() with its fp32 encoder, bs "
              f"{BS} x {2 * T}, 65536-tap IR): {STYLE_STEPS} steps, launches a step {STEP_LAUNCHES} (exact), losses "
              f"{[round(v, 6) for v in res['losses']]}, {wall:.2f} s through main with the build; {step_ms:.1f} ms a "
              f"step over steps 1-{STYLE_STEPS - 1} (host clock, the metrics' stamps) | {card}")
        res, out, launches, wall = run_example("style_transfer", argv + ["--steps", str(STYLE_STEPS + 1), "--resume"])
        require(f"resumed from step {STYLE_STEPS}" in out and res["start"] == STYLE_STEPS and len(res["losses"]) == 1
                and math.isfinite(res["losses"][0]), f"style_transfer did not resume: {res}")
        require(launches == STEP_LAUNCHES, f"style_transfer resumed: launches {launches}")
        count(launches)
        print(f"[parallel] resumed from step {STYLE_STEPS}: one step, loss {res['losses'][0]:.6f}, launches exact, "
              f"{wall:.2f} s through main | {card}")

        # (e) mastering's main on one rank
        steps = 3
        res, _, launches, wall = run_example("mastering", ["--device", device.type, "--steps", str(steps),
                                                           "--out-dir", str(Path(tmp) / "mastering")])
        want = {"ballistics": steps + 2, "ballistics_bwd": steps}  # the target, each step, the final render
        require(launches == want, f"mastering: launches {launches}, expected {want}")
        require(all(math.isfinite(v) for v in res["losses"]), f"mastering: losses {res['losses']}")
        for f in ("master.wav", "target.wav", "input.wav"):
            require(on_pcm_grid(Path(tmp) / "mastering" / f), f"mastering: {f} missing or off the grid")
        count(launches)
        print(f"[parallel] mastering main: {steps} steps, launches {launches} (exact), losses "
              f"{[round(v, 6) for v in res['losses']]}, {wall:.2f} s through main | {card}")

    # (b), (c) gloo ranks sharing the card
    inp = parallel_inputs(seed)
    g, aa, ar, ct = (torch.as_tensor(inp[k], device=device) for k in ("g", "aa", "ar", "ct"))
    R = BS * 2
    rows = (g.reshape(R, T), aa.repeat_interleave(2), ar.repeat_interleave(2), torch.zeros(R, device=device))
    engine = BK._CudaEngine if device.type == "cuda" else BK._PlainEngine
    y_ref = engine.forward(*rows).reshape(g.shape)
    fwd_ms = cuda_ms(lambda: engine.forward(*rows), 10)
    x, x2 = (torch.as_tensor(inp[k], device=device) for k in ("x", "x2"))
    refs = {
        "conv": fft_conv_causal(x, torch.as_tensor(inp["h"], device=device)),
        "coupled": sosfilt_coupled(torch.as_tensor(inp["sos"], device=device), x),
        "onepole": onepole_exact(g, aa[:, None, None]),
        "attack_only": ballistics_smooth(g, aa[:, None, None], ar[:, None, None], mode="attack_only"),
        "parallel": ballistics_smooth(g, aa[:, None, None], ar[:, None, None], mode="parallel"),
        "tv filter": tv_freq_filter(x, torch.as_tensor(inp["H"], device=device), 512, 128),
    }
    X = tv_stft(x, 512, 128, 2048)
    P_ref = (X.real ** 2 + X.imag ** 2).mean(dim=1).cpu().numpy()
    refs = {k: v.cpu().numpy() for k, v in refs.items()}
    loss_ref = float(multi_resolution_stft_loss(x, x2))
    del X
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref64 = None
    for sp in PARALLEL_SP:
        t0 = time.perf_counter()
        res = spawn_ranks(sp, parallel_functions_rank, (sp, inp, str(device)))
        spawn_s = time.perf_counter() - t0
        got = np.concatenate([r["relay"] for r in res], axis=-1)
        require(np.array_equal(got, y_ref.cpu().numpy()), f"sp {sp}: the relay differs from the unsharded B-fwd")
        per_rank = [{k: v for k, v in r["relay launches"].items() if v} for r in res]
        require(all(p == {"ballistics": 1, "ballistics_bwd": 1} for p in per_rank),
                f"sp {sp}: relay launches a rank {per_rank}")
        for p in per_rank:
            count(p)
        dg = np.concatenate([r["relay grad"][0] for r in res], axis=-1)
        daa, dar = (sum(r["relay grad"][i] for r in res) for i in (1, 2))  # replicated: the ranks' parts summed
        # against the plain reverse loop in float64 on float64 copies of the
        # whole rows (phase 6's reference): dg of its largest value; daa and
        # dar (an item's two channels, the ranks' parts summed) of theirs
        if ref64 is None:
            ref64 = BK.ballistics_bwd_rows_plain(*(t.cpu().double() for t in (
                y_ref.reshape(R, T), *rows, torch.as_tensor(inp["ct"]).reshape(R, T))))
            # daa and dar of an item relative to the sum of |terms| of their
            # branch over its two rows, as b_bwd_errors scales them
            y64, g64 = y_ref.reshape(R, T).cpu().double(), rows[0].cpu().double()
            y_prev = torch.cat([torch.zeros(R, 1, dtype=torch.float64), y64[:, :-1]], dim=1)
            attack = g64 < y_prev
            alpha = torch.where(attack, rows[1].cpu().double()[:, None], rows[2].cpu().double()[:, None])
            terms = (ref64[0] / (1.0 - alpha) * (y_prev - g64)).abs()
            branch = [(terms * m).sum(-1).reshape(BS, 2).sum(-1) for m in (attack, ~attack)]
        g_err = float((torch.as_tensor(dg).reshape(R, T).double() - ref64[0]).abs().max() / ref64[0].abs().max())
        a_err = max(float(((torch.as_tensor(d).double() - r.reshape(BS, 2).sum(-1)).abs()
                           / torch.clamp(b, min=1e-300)).max())
                    for d, r, b in ((daa, ref64[1], branch[0]), (dar, ref64[2], branch[1])))
        require(g_err <= B_BWD_TOL, f"sp {sp}: relay dg {g_err:.3e} from float64")
        require(a_err <= B_BWD_TOL, f"sp {sp}: relay daa/dar {a_err:.3e} from float64")
        marks = [r["relay marks"] for r in res]
        walls = [max(m[i][1] for m in marks) - min(m[i][0] for m in marks) for i in range(len(marks[0]))]
        print(f"[parallel] sp {sp} (gloo ranks sharing one card: correctness and launches, not multi-card speed): "
              f"the exact relay bitwise the unsharded B-fwd on {BS} x 2 x {T}; one B-fwd and one B-bwd a rank; "
              f"dg {g_err:.3e} and daa/dar {a_err:.3e} from float64 (bound {B_BWD_TOL}); relay wall "
              f"{min(walls) * 1e3:.2f} ms (best of {len(walls)}, host clock, p2p staged through the host) against "
              f"one unsharded B-fwd {fwd_ms:.3f} ms (CUDA events); the world's spawn and run {spawn_s:.1f} s | {card}")
        for k, want in refs.items():
            got = np.concatenate([r[k] for r in res], axis=-1)
            err_k = float(np.abs(got - want).max())
            if k == "onepole" or k in ("attack_only", "parallel"):
                rt, at = PARALLEL_TOL["onepole"]
                ok = np.all(np.abs(got - want) <= at + rt * np.abs(want))
            else:
                ok = err_k <= PARALLEL_TOL[k] * max(1.0, float(np.abs(want).max()))
            require(ok, f"sp {sp}: {k} {err_k:.3e} from the unsharded port")
            print(f"[parallel] sp {sp}: {k} {err_k:.3e} from the unsharded port (peak {np.abs(want).max():.3f})")
        for r in res:
            p_err = float(np.abs(r["tv power"] - P_ref).max() / P_ref.max())
            require(p_err <= PARALLEL_TOL["tv power"], f"sp {sp}: tv power {p_err:.3e} of the peak")
            l_err = abs(r["loss"] - loss_ref) / abs(loss_ref)
            require(l_err <= PARALLEL_TOL["loss"], f"sp {sp}: loss {r['loss']} against {loss_ref} ({l_err:.3e})")
        used = [{k: v for k, v in r["launches"].items() if v} for r in res]
        require(not any(used), f"sp {sp}: (c) launched {used}")
        print(f"[parallel] sp {sp}: tv power {p_err:.3e} of the peak, loss {l_err:.3e} relative; no kernel launched "
              f"by (c) | {card}")

    # (d) dp 2 x sp 2 ranks: style_transfer's step at full width
    from dasp_tpu_torch.examples import style_transfer

    rng = np.random.default_rng(seed + 22)
    x = (synthetic_batch_np(rng, BS, 2 * T)).astype(np.float32)
    procs, _ = style_transfer.build(style_args(False, device), None, torch.device("cpu"))
    rand = {k: v.numpy() for k, v in style_transfer.random_corruption(rng, BS, procs).items()}
    noise = [rng.standard_normal((BS * 2, 12, IR + 1022)).astype(np.float32) for _ in range(2)]
    del procs
    one = style_step_grads(None, x, rand, noise, device)
    # fp32's own noise in this gradient: the one-rank step on clips moved by
    # about an ulp (the L1 log-magnitude loss's gradient flips sign in every
    # bin where the spectra cross, so rounding anywhere moves the encoder
    # blocks' gradient by percents at full width; tests/test_torch_train.py)
    nudged = x * (1.0 + 2.0 ** -24 * rng.standard_normal(x.shape)).astype(np.float32)
    ulp = style_step_grads(None, nudged, rand, noise, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(4, dpsp_style_rank, (x, rand, noise, str(device)))
    spawn_s = time.perf_counter() - t0
    loss, grads, stats, _, planted = res[0]
    require(all(r[0] == loss for r in res), f"dp x sp: the ranks' losses differ: {[r[0] for r in res]}")
    per_rank = [{k: v for k, v in r[3].items() if v} for r in res]
    require(all(p == DPSP_RANK_LAUNCHES for p in per_rank), f"dp x sp: launches a rank {per_rank}")
    for p in per_rank:
        count(p)

    def by_part(got):
        """Each part's gradient difference from the one-rank step, of the
        part's norm."""
        out = {}
        for name in DPSP_PARTS:
            keys = [k for k in one[1] if k.startswith(name)]
            diff = sum(float(np.sum((got[k].astype(np.float64) - one[1][k]) ** 2)) for k in keys)
            out[name] = math.sqrt(diff / sum(float(np.sum(one[1][k].astype(np.float64) ** 2)) for k in keys))
        return out

    require(all(any(k.startswith(n) for n in DPSP_PARTS) for k in one[1]), "dp x sp: a parameter in no part")
    floor = by_part(ulp[1])
    bar = {k: max(DPSP_GRAD_TOL, DPSP_NOISE_FACTOR * v) for k, v in floor.items()}

    def verdict(what, got_loss, got_grads, got_stats):
        l_rel = abs(got_loss - one[0]) / abs(one[0])
        part = by_part(got_grads)
        s_err = max(float(np.abs(got_stats[k] - w).max() / max(1.0, np.abs(w).max())) for k, w in one[2].items())
        print(f"[parallel] {what} against one rank: loss {got_loss:.6f} / {one[0]:.6f} ({l_rel:.2e} relative), "
              "gradient difference of each part's norm " + ", ".join(
                  f"{k} {v:.2e} (bar {bar[k]:.2e})" for k, v in part.items())
              + f", BatchNorm statistics {s_err:.2e} | {card}")
        return (l_rel <= DPSP_LOSS_TOL, all(part[k] <= bar[k] for k in part), s_err <= DPSP_STATS_TOL)

    print(f"[parallel] one rank on clips moved by an ulp: gradient difference of each part's norm "
          + ", ".join(f"{k} {v:.2e}" for k, v in floor.items()) + f" (fp32's noise floor) | {card}")
    ok = verdict(f"dp 2 x sp 2 gloo ranks sharing the card, style_transfer's step at full width (bs {BS} x {2 * T}, "
                 f"65536-tap IR, EQ coupled, relay, BatchNorm over dp; launches a rank {per_rank[0]}; spawn and "
                 f"steps {spawn_s:.1f} s)", loss, grads, stats)
    require(all(ok), f"dp x sp: the step differs from one rank's (loss, gradient, statistics within: {ok})")
    # the planted fault: each rank's BatchNorm on its own slice of the batch;
    # the gradient bar alone must see it
    caught = verdict("planted fault (per-rank BatchNorm statistics)", *planted)
    require(not caught[1], "dp x sp: the gradient bar passes per-rank BatchNorm statistics")
    print(f"[parallel] phase 21 took {time.perf_counter() - t_phase:.1f} s; launches {total} | {card}")
    return total


def time_style_step(seed, device, card):
    """style_transfer's step split (phase 21's (a) reads only its whole
    step through main): its data iterator alone (the example's two loader
    threads, the i16 wire); make_step alone by CUDA events with the
    example's fp32 encoder and with phase 7's bf16 one, without a mesh and
    on a one-rank NCCL mesh (BatchNorm's all-gathers, the gradient sum, the
    sharded loss), 1 warm-up and 5 timed steps each; one checkpoint write."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from dasp_tpu_torch.examples import style_transfer as st
    from dasp_tpu_torch.examples.common import device_batches
    from dasp_tpu_torch.models import StyleTransferNet
    from dasp_tpu_torch.parallel import make_mesh
    from dasp_tpu_torch.utils import save_checkpoint

    args = st.parse(["--device", "cuda", "--filter-method", "pallas", "--smoother", "exact_pallas"])
    it = device_batches(args)
    next(it)
    data_ms = host_ms(lambda: [next(it) for _ in range(5)]) / 5
    print(f"[style step] data: {data_ms:.1f} ms a batch of {BS} x {2 * T} (two loader threads, synthetic audio, the "
          f"i16 wire; host clock) | {card}")
    x = next(it)
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        for what in ("fp32 encoder", "bf16 encoder", "fp32 encoder, one-rank NCCL mesh"):
            mesh = None
            if what.endswith("mesh"):
                dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
                mesh = make_mesh((1, 1), device=device)
            procs, net = st.build(args, mesh, device)
            if what.startswith("bf16"):
                torch.manual_seed(args.seed)
                net = StyleTransferNet(dtype=torch.bfloat16).to(device).train()
            opt, sched = st.make_optimizer(args, net)
            step = st.make_step(args, procs, net, opt, sched, mesh)
            rand = st.random_corruption(rng, BS, procs, device)
            gen = torch.Generator(device=device).manual_seed(seed)
            ms = cuda_ms(lambda: step(x, rand, generator=gen), 5)
            print(f"[style step] make_step alone, {what}: {ms:.1f} ms (CUDA events) | {card}")
            if mesh is None and what.startswith("fp32"):
                state = {"net": net.state_dict(), "opt": opt.state_dict(), "sched": sched.state_dict(), "step": 1}
                ckpt_ms = host_ms(lambda: save_checkpoint(f"{tmp}/ckpt.pkl", state))
                print(f"[style step] one checkpoint of the net and Adam's state: {ckpt_ms:.1f} ms (host clock) | {card}")
            if mesh is not None:
                dist.destroy_process_group()


def synthetic_batch_np(rng, bs, n):
    from dasp_tpu_torch.utils import synthetic_batch

    return synthetic_batch(rng, bs, n, SR)


def time_frac_delay(tree, seed, device, card):
    """C-fwd and C-bwd (without and with dx) of the package imported from
    ``tree`` on phases 8-9's operands made from ``seed``: a call by CUDA
    events, and the kernel alone (profiler) with its data in L2 and after a
    256 MB write has evicted it. Prints one JSON line. Run two trees in
    turns in one chip call (parent, change, change, parent)."""
    import numpy as np
    import torch

    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    rng = np.random.default_rng(seed)
    flush = torch.empty(64 << 20, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, x_ext, d, g, B, Dm in frac_delay_configs(rng, device):
        ct = torch.randn((*x_ext.shape[:2], d.shape[-1]), generator=gen, device=device)
        row = {}
        for use, fn, kernel in (
                ("fwd", lambda: FK._CudaEngine.forward(x_ext, d, g, B, Dm), "frac_delay_kernel"),
                ("bwd", lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False), "frac_delay_bwd"),
                ("bwd with dx", lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm), "frac_delay_bwd")):
            row[use] = {"ms": cuda_ms(fn, 20), "kernel_ms": kernel_device_ms(fn, kernel, 20),
                        "kernel_cold_ms": kernel_device_ms(lambda: (flush.zero_(), fn()), kernel, 20)}
        out[name] = row
        print(f"[time {tree}] {name}: " + "; ".join(
            f"{use} {v['ms']:.4f} ms a call, kernel alone {fmt_ms(v['kernel_ms'])} (L2 warm), "
            f"{fmt_ms(v['kernel_cold_ms'])} (cold)" for use, v in row.items()) + f" | {card}")
    print(json.dumps({"tree": tree, "card": card, "frac_delay": out}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-ballistics-of", metavar="DIR",
                    help="only time kernel B's two launches of the package in the checkout DIR (see "
                         "time_ballistics)")
    ap.add_argument("--time-frac-delay-of", metavar="DIR",
                    help="only time kernel C's launches of the package in the checkout DIR (see time_frac_delay)")
    ap.add_argument("--time-style-step", action="store_true",
                    help="only split style_transfer's step (see time_style_step)")
    ap.add_argument("--coupled-step", action="store_true", help="only run phase 22 (kernel D)")
    ap.add_argument("--tcn-layer", action="store_true", help="only run phase 23 (kernel E)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    tree = args.time_ballistics_of or args.time_frac_delay_of
    sys.path.insert(0, str(Path(tree or Path(__file__).parent).resolve()))
    import numpy as np

    from dasp_tpu_torch import _build

    # fp32 DSP and fp32 references: no TF32 in matmuls or convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    if tree:
        timer = time_ballistics if args.time_ballistics_of else time_frac_delay
        timer(tree, args.seed, device, card)
        return 0
    if args.time_style_step:
        time_style_step(args.seed, device, card)
        return 0
    if args.coupled_step:
        phase_coupled_step(args.seed, device, card)
        return 0
    if args.tcn_layer:
        phase_tcn_layer(args.seed, device, card)
        return 0
    log = _build.build_log()
    if log:  # ptxas -v: per kernel instantiation
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] ptxas: {len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
              f"registers per thread, {spills} bytes of spills")

    rng = np.random.default_rng(args.seed)
    res_a = phase_kernel_a(rng, device)
    res_b = phase_kernel_b(rng, device)
    render_e_launches = phase_slice(args.seed, device, card)
    res_adj = phase_adjoint_a(rng, device)
    res_bb = phase_ballistics_bwd(rng, device)
    launches, train_ctx = phase_training(args.seed, device, card)
    configs = frac_delay_configs(rng, device)
    res_c = phase_frac_delay_fwd(configs, device, card)
    res_cb = phase_frac_delay_bwd(configs, device, card)
    launches.update({k: v for k, v in phase_blind(args.seed, device, card).items() if k.startswith("frac_delay")})
    phase_fsm(rng, device, card)
    phase_block(rng, device, card)
    phase_block_step(train_ctx, device, card)
    phase_reference_chain(args.seed, device, card)
    phase_dynamics(args.seed, device, card)
    phase_mastering(args.seed, device, card)
    phase_wola_delay(args.seed, device, card)
    phase_denoise(args.seed, device, card)
    for k, v in phase_streaming(args.seed, device, card).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in phase_files(args.seed, device, card).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in phase_parallel(args.seed, device, card).items():
        launches[k] = launches.get(k, 0) + v
    res_d = phase_coupled_step(args.seed, device, card)
    res_e = phase_tcn_layer(args.seed, device, card)
    launches["tcn_layer"] = render_e_launches

    a, adj = res_a["S=6 (EQ)"], res_adj["S=6 (EQ)"]
    rows = [
        ("sosfilt_cascade", "sosfilt_cascade.cu", "dasp_tpu/ops/pallas_iir.py:84", a),
        ("sosfilt_cascade_save_all", "sosfilt_cascade_save_all.cu", "dasp_tpu/ops/pallas_iir.py:254",
         adj["save_all"]),
        ("sosfilt_cascade_adjoint", "sosfilt_cascade_adjoint.cu", "dasp_tpu/ops/pallas_iir.py:259",
         adj["adjoint"]),
        ("ballistics", "ballistics.cu", "dasp_tpu/ops/pallas_ballistics.py:48", res_b["compressor curve"]),
        ("ballistics_bwd", "ballistics_bwd.cu", "dasp_tpu/ops/pallas_ballistics.py:69", res_bb[T]),
        ("frac_delay", "frac_delay.cu", "dasp_tpu/ops/pallas_interp.py:96", res_c[configs[0][0]]),
        ("frac_delay_bwd", "frac_delay_bwd.cu", "dasp_tpu/ops/pallas_interp.py:135", res_cb[configs[0][0]]),
        ("sosfilt_coupled_step", "sosfilt_coupled_step.cu", None, res_d),
        ("tcn_layer", "tcn_layer.cu", None, res_e),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"dasp_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        for name, src, tpu, r in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
