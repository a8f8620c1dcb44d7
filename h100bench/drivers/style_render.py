"""The served render: ``StyleTransferNet.forward`` in eval mode on (input,
reference) pairs, then ``apply_style_chain`` of the input with the reverb's
noise handed in; one client in a closed loop, each batch timed on the host
clock from the call to its output ready.

The window keeps the output and the parameters of a few batches whose
indices are drawn from the seed; ``check`` renders the same pairs with the
plain reference from the same weights and compares the outputs (largest
gap over the reference's peak) and the normalized parameters (largest
gap).
"""

import time

import numpy as np
import torch

from h100bench.reference import style as ref
from h100bench.work import audio
from h100bench.work.device import sync
from h100bench.work.weights import make_weights


def setup(cfg, cell, seed, device, program=None):
    from dasp_tpu_torch import models as M

    mix = cell["mix"]
    net_cfg, chain = cfg["net"], cfg["chain"]
    net = M.StyleTransferNet(dtype=getattr(torch, cfg["build"]["dtype"])).to(device)
    weights = make_weights(ref.param_shapes(net_cfg), torch.Generator(device=device).manual_seed(seed + 1), device)
    missing, unexpected = net.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in missing):
        raise RuntimeError(f"the net's weights differ from the configuration: {missing} {unexpected}")
    net.eval()
    procs = M.make_style_processors(
        cfg["sample_rate"], reverb_num_samples=chain["reverb_num_samples"],
        eq_filter_method=cfg["build"]["eq_filter_method"],
        compressor_smoother=cfg["build"]["compressor_smoother"], reverb_noise_mode=chain["reverb_noise"])
    bs, n, pool = mix["batch"], mix["clip_samples"], mix["pool"]
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(audio.synthetic_batch(rng, 2 * bs * pool, n, cfg["sample_rate"], mix["kind"]))
    clips = clips.to(device).view(pool, 2, bs, 1, n)
    gen = torch.Generator(device=device).manual_seed(seed)
    taps = chain["reverb_bandpass_taps"]
    noise = torch.randn((pool, 2 * bs, 12, chain["reverb_num_samples"] + taps - 1), generator=gen, device=device)
    batches = [(clips[i, 0], clips[i, 1], noise[i]) for i in range(pool)]
    keep = sorted(set(np.random.default_rng(seed + 2).choice(mix["sample_range"], mix["sample"], replace=False)))
    state = {"net": net, "procs": procs, "batches": batches, "cfg": cfg, "weights0": weights, "keep": keep,
             "apply": (program or M).apply_style_chain, "device": device}
    with torch.inference_mode():
        for inp, refc, nz in batches[:2]:
            state["apply"](procs, inp, net(inp, refc), noise=nz)
        sync(device)
    return state


def window(state, seconds, tracer=None):
    net, procs, batches, apply = state["net"], state["procs"], state["batches"], state["apply"]
    device, keep = state["device"], set(state["keep"])
    lat, kept = [], {}
    with torch.inference_mode():
        t_end = time.perf_counter() + seconds
        t_start = time.perf_counter()
        i = 0
        while True:
            inp, refc, nz = batches[i % len(batches)]
            t0 = time.perf_counter()
            if tracer is None:
                params = net(inp, refc)
                y = apply(procs, inp, params, noise=nz)
            else:
                with tracer.mark("encoder"):
                    params = net(inp, refc)
                with tracer.mark("chain"):
                    y = apply(procs, inp, params, noise=nz)
            sync(device)
            t1 = time.perf_counter()
            lat.append((t1 - t0) * 1e3)
            if i in keep:
                kept[i] = (params, y)
            i += 1
            if t1 >= t_end:
                break
    return {"latency_ms": lat, "window_s": time.perf_counter() - t_start, "attempted": len(lat), "failed": 0,
            "kept": kept}


def check(state, record, limits):
    for k in ("net", "procs", "apply"):
        state.pop(k, None)
    kept = record.pop("kept")
    if not kept:
        raise RuntimeError("the window rendered none of the sampled batches")
    cfg, dev = state["cfg"], state["device"]
    stats = ref.bn_stats(cfg["net"], dev)
    out_gap = param_gap = 0.0
    failed = 0
    for i, (params, y) in kept.items():
        inp, refc, nz = state["batches"][i % len(state["batches"])]
        p_ref, y_ref = ref.render(state["weights0"], stats, cfg["net"], inp, refc, nz, ref.stated(cfg))
        if not bool(torch.isfinite(y).all()):
            failed += 1
        out_gap = max(out_gap, float((y.double() - y_ref).abs().max() / y_ref.abs().max()))
        param_gap = max(param_gap, max(float((params[k].double() - p_ref[k].double()).abs().max()) for k in p_ref))
    record["failed"] = failed
    numbers = {"output": (out_gap, limits["output"]), "params": (param_gap, limits["params"])}
    return numbers, {"batches_compared": sorted(kept)}


def calibrate(kind, cfg, cell, seed, device, seconds):
    """One reading of ``kind`` (see ``h100bench/calibrate.py``): the control
    renders the sampled batches with the reference in the precision below
    the configuration's (fp8 convolutions, bfloat16 effects)."""
    state = setup(cfg, cell, seed, device)
    record = window(state, seconds)
    if kind == "control":
        stats = ref.bn_stats(cfg["net"], device)
        record["kept"] = {i: ref.render(state["weights0"], stats, cfg["net"], *state["batches"][i % len(state["batches"])],
                                        ref.CONTROL) for i in record["kept"]}
    numbers, info = check(state, record, cell["limits"])
    return {k: v for k, (v, _) in numbers.items()}, info
