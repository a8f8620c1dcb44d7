"""The classic live chain through ``streaming.StreamChain``: parametric EQ
-> compressor (true attack/release ballistics on kernel B, once a chunk)
-> filtered-noise reverb, ``bs`` stereo streams batched in each call. The
input is looped over a stereo clip made from the seed, one chunk after
another in a closed loop, each chunk timed on the host clock from the call
to the chunk ready (a plug-in host calling ``process()``).

Set-up warms up the chain on a state of its own; the window starts every
stream from rest. ``check`` runs the reference once over the whole signal
the window sent and compares every chunk the window returned (largest gap
over max(1, peak))."""

import time

import numpy as np
import torch

from h100bench.reference import dsp
from h100bench.reference import stream as ref
from h100bench.work import audio
from h100bench.work.device import sync


def setup(cfg, cell, seed, device, program=None):
    from dasp_tpu_torch import streaming as S

    S = program or S
    mix, ch = cell["mix"], cfg["chain"]
    bs, chunk, n, sr = mix["batch"], mix["chunk"], mix["loop_samples"], cfg["sample_rate"]
    rng = np.random.default_rng(seed)
    clip = torch.from_numpy(audio.synthetic_batch(rng, 2 * bs, n, sr, mix["kind"])).to(device).view(bs, 2, n)
    chunks = [c.contiguous() for c in clip.split(chunk, dim=-1)]
    eq = [torch.full((bs,), float(v), device=device) for v in ch["eq"]]
    comp = {k: torch.full((bs,), float(v), device=device) for k, v in ch["compressor"].items()}
    rv = ch["reverb"]
    ir_seed = seed + 1
    rev0 = S.reverb_stream_init(
        sr, torch.full((bs, 12), rv["band_gain"]), torch.full((bs, 12), rv["band_decay"]), rv["mix"],
        torch.Generator(device=device).manual_seed(ir_seed), num_samples=rv["num_samples"], chunk_len=chunk,
        device=device)
    steps = {
        "eq": lambda c, s: S.parametric_eq_stream(c, sr, *eq, zi=s),
        "comp": lambda c, s: S.compressor_stream(c, sr, **comp, zi=s, smoother=ch["smoother"]),
        "rev": lambda c, s: S.reverb_stream(c, rev0 if s is None else s),
    }
    state = {"S": S, "steps": steps, "chunks": chunks, "cfg": cfg, "mix": mix, "ir_seed": ir_seed,
             "device": device, "bs": bs}
    chain = S.StreamChain(list(steps.items()))
    st = None
    for c in chunks[:mix["warmup_chunks"]]:
        _, st = chain(c, st)
    sync(device)
    return state


def _timed_steps(state, tracer):
    """The chain's steps, each wrapped in a host-clock span when traced."""
    if tracer is None:
        return list(state["steps"].items())

    def timed(name, fn):
        def step(c, s):
            with tracer.host(name):
                return fn(c, s)
        return step

    return [(k, timed(k, fn)) for k, fn in state["steps"].items()]


def window(state, seconds, tracer=None):
    chain = state["S"].StreamChain(_timed_steps(state, tracer))
    chunks, device = state["chunks"], state["device"]
    lat, outs, st = [], [], None
    t_end = time.perf_counter() + seconds
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        y, st = chain(chunks[i % len(chunks)], st)
        sync(device)
        t1 = time.perf_counter()
        lat.append((t1 - t0) * 1e3)
        outs.append(y)
        i += 1
        if t1 >= t_end:
            break
    return {"latency_ms": lat, "window_s": time.perf_counter() - t_start, "attempted": len(lat), "failed": 0,
            "outs": outs}


def _reference(state, n_chunks: int, rnd=None):
    """The reference over the first ``n_chunks`` chunks the window sent,
    from rest, with the reverb's spectral draws the program's init drew
    from the same seed."""
    cfg, dev, bs = state["cfg"], state["device"], state["bs"]
    ch, rv = cfg["chain"], cfg["chain"]["reverb"]
    chunks = state["chunks"]
    x = torch.cat([chunks[i % len(chunks)] for i in range(n_chunks)], dim=-1)
    gen = torch.Generator(device=dev).manual_seed(state["ir_seed"])
    nb = rv["num_samples"] // 2 + 1
    re = torch.randn((2 * bs, 12, nb), generator=gen, device=dev)
    im = torch.randn((2 * bs, 12, nb), generator=gen, device=dev)
    comp = [ch["compressor"][k] for k in ("threshold_db", "ratio", "attack_ms", "release_ms", "knee_db",
                                          "makeup_gain_db")]
    kw = {} if rnd is None else {"rnd": rnd}
    return ref.classic_chain(x, ch["eq"], comp, re, im, rv["band_gain"], rv["band_decay"], rv["mix"],
                             rv["num_samples"], **kw)


def check(state, record, limits):
    for k in ("S", "steps"):
        state.pop(k, None)
    outs = record.pop("outs")
    y = torch.cat(outs, dim=-1) if isinstance(outs, list) else outs
    del outs
    y_ref = _reference(state, record["attempted"])
    bs, chunk = state["bs"], state["mix"]["chunk"]
    finite = torch.isfinite(y).view(bs, 2, -1, chunk).all(dim=3).all(dim=1).all(dim=0)
    record["failed"] = int((~finite).sum())
    gap = float((y.double() - y_ref).abs().max() / max(1.0, float(y_ref.abs().max())))
    return {"output": (gap, limits["output"])}, {"samples_compared": int(y.shape[-1])}


def calibrate(kind, cfg, cell, seed, device, seconds):
    """One reading of ``kind`` (see ``h100bench/calibrate.py``): the control
    is the reference with every stage's output, gain curve and IR rounded
    to bfloat16, over as many chunks as the program's window sent."""
    state = setup(cfg, cell, seed, device)
    record = window(state, seconds)
    if kind == "control":
        record["outs"] = _reference(state, record["attempted"], dsp.bf16_round).float()
    numbers, info = check(state, record, cell["limits"])
    return {k: v for k, (v, _) in numbers.items()}, info
