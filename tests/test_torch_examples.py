"""The port's examples (dasp_tpu_torch/examples) against the JAX package's
(examples/*.py, loaded by path).

The functions the JAX examples define, in float64 on the same inputs:
``hidden_amp`` (virtual_analog), the mixing console's ``console``, and
demo's ``render`` with the reverb's noise injected into both (the JAX render
draws it from a PRNG key and the port's from a ``torch.Generator``, so the
noise itself is not compared): each within 1e-9 of max(1, peak). auto_eq's
step in float64 against a JAX rebuild of examples/auto_eq.py's
``train_step`` at its --smoke width, with the flax weights carried over by
``parameter_network_from_flax`` (one JAX compile): the loss within 1e-10
relative, each parameter's gradient within 1e-8 of its largest value and the
new BatchNorm statistics within 1e-10. A checkpoint taken after two steps
and loaded into a fresh net and optimizer gives the third step's loss of an
uninterrupted run, bitwise. Then each example's ``main`` (and
``reverse_eng``'s) runs on the CPU at a small size and writes its files,
which read back on the 16-bit grid; quickstart at the threshold of
tests/test_integration.py's ``test_quickstart_recovers_drive``.

style_transfer: its step (``make_step``, Adam with the cosine decay) in
float64 against a JAX rebuild of examples/style_transfer.py's ``step_fn``
at its --smoke width, the reverb's noise injected into both, at
tests/test_torch_train.py's float64 bars (the flax encoder takes its time
mean in float32): the loss within 1e-8 relative, each gradient within 1e-5
of its largest value, the updated parameters within 2 lr and the BatchNorm
statistics within 1e-8. Its ``main`` on 16-bit wav files through the
native loader and the i16 wire, with a resume that continues at step 3.
``--sp 2`` (two gloo CPU ranks) trains the one-rank run's numerics: with
the smoother it maps to (``exact_pallas`` through the relay, ``fsm`` to
the sharded attack-only one-pole) the first loss within 2e-5; mastering's
``--sp 2`` likewise.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401 - the JAX examples import it
import pytest
import torch

import dasp_tpu
from dasp_tpu import modules as JM
from dasp_tpu.models import ParameterNetwork as FlaxNet
from dasp_tpu.utils import multi_resolution_stft_loss as j_mrstft
from dasp_tpu_torch import modules as M
from dasp_tpu_torch.examples import (auto_eq, blind_estimation, demo, denoise, mastering, mixing_console,
                                     quickstart, reverse_eng, streaming_demo, style_transfer, virtual_analog)
from dasp_tpu_torch.models import parameter_network_from_flax, tcn
from dasp_tpu_torch.utils import load_wav, save_wav, synthetic_batch
from test_torch_models import randomized_variables

SR = 44100
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
_LOADED = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The examples take many small steps of small ops: with one intra-op
    thread, a worker that shares the CPU with others does not wait on its
    thread pool's stragglers at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_example(name):
    """examples/<name>.py as a module (it imports examples/common.py)."""
    if name not in _LOADED:
        sys.path.insert(0, str(EXAMPLES))
        try:
            spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        finally:
            sys.path.remove(str(EXAMPLES))
        _LOADED[name] = mod
    return _LOADED[name]


class x64:
    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def close(got, want, tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    print(f"max abs err {err:.3e} (peak {np.abs(want).max():.3f})")
    assert err <= tol * max(1.0, np.abs(want).max())


def test_hidden_amp_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 1, 4096)) * 0.3
    with x64():
        want = jax_example("virtual_analog").hidden_amp(jnp.asarray(x), SR)
    close(virtual_analog.hidden_amp(torch.tensor(x), SR), want)


def test_console_matches_jax():
    rng = np.random.default_rng(1)
    tracks = synthetic_batch(rng, 1, 4096).repeat(3, axis=1).astype(np.float64) * rng.uniform(0.5, 1, (1, 3, 1))
    params = {"eq_gains": rng.uniform(-1, 1, (1, 3, 10)), "pan": rng.uniform(-1.5, 1.5, (1, 3)),
              "send_db": rng.uniform(-0.4, 0.4, (1, 3)), "width": rng.uniform(-0.5, 0.5, (1,))}
    with x64():
        mc = jax_example("mixing_console")
        want = jax.jit(lambda t, p: mc.console(t, SR, p))(jnp.asarray(tracks), jax.tree.map(jnp.asarray, params))
    got = mixing_console.console(torch.tensor(tracks), SR, {k: torch.tensor(v) for k, v in params.items()})
    assert got.shape == (1, 2, 4096)
    close(got, want)


def test_demo_render_matches_jax_with_the_same_noise(monkeypatch):
    x = synthetic_batch(np.random.default_rng(2), 1, 4096, kind="pluck").astype(np.float64)
    noise = np.random.default_rng(3).standard_normal((2, 12, 65536 + 1022))
    real = dasp_tpu.noise_shaped_reverberation
    monkeypatch.setattr(dasp_tpu, "noise_shaped_reverberation",
                        lambda *a, key=None, **kw: real(*a, noise=jnp.asarray(noise), **kw))
    with x64():
        want = jax.jit(lambda a: jax_example("demo").render(a, SR, None))(jnp.asarray(x))
    got = demo.render(torch.tensor(x), SR, noise=torch.tensor(noise))
    close(got, want)


# ---------------------------------------------------------------------------
# auto_eq's step

BS, T = 2, 8192


def auto_eq_batch(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((BS, 1, T)) * 0.25).astype(dtype)
    return x, rng.uniform(0, 1, (BS, 18)).astype(dtype), rng.uniform(-24, 0, (BS, 1, 1)).astype(dtype)


def test_auto_eq_step_matches_jax_in_float64(monkeypatch):
    jae = jax_example("auto_eq")
    assert auto_eq.MRSTFT_KW == jae.MRSTFT_KW
    # the flax head casts its input to float32 whatever the run's dtype; do
    # the same on the port's side so the rest compares in float64
    monkeypatch.setattr(tcn, "_at_least_f32", lambda h: h.float().to(torch.promote_types(h.dtype, torch.float32)))
    x, rp, rg = auto_eq_batch(np.float64)
    with x64():
        jeq = JM.ParametricEQ(SR, max_q_factor=1.0, filter_method="fsm")
        fnet = FlaxNet(jeq.num_params, channels=(32,) * 4, kernel_size=7, dilations=(1, 2, 4, 8),
                       activation="prelu", mlp_hidden=64)
        variables = randomized_variables(fnet.init(jax.random.PRNGKey(0), jnp.zeros((BS, 1, T)), train=False), 0)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        @jax.jit
        def step(params, stats, x, rp, rg):  # examples/auto_eq.py's train_step, before Adam
            y = jeq.process_normalized(x, rp, clip_params=True)
            y = y / (jnp.max(jnp.abs(y), axis=-1, keepdims=True) + 1e-9) * 10.0 ** (rg / 20.0)

            def loss_fn(params):
                p_hat, upd = fnet.apply({"params": params, "batch_stats": stats}, y, train=True,
                                        mutable=["batch_stats"])
                x_hat = jnp.tanh(jeq.process_normalized(y, p_hat, clip_params=True))
                return j_mrstft(x_hat, x, sample_rate=SR, **jae.MRSTFT_KW), upd["batch_stats"]

            (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return loss, grads, new_stats

        loss_j, grads_j, stats_j = jax.device_get(step(variables["params"], variables["batch_stats"], x, rp, rg))
    equalizer = M.ParametricEQ(SR, max_q_factor=1.0, filter_method="fsm")
    net = auto_eq.smoke_net(equalizer.num_params)
    net.load_state_dict(parameter_network_from_flax(variables, net), strict=True)
    net.double()
    loss, p_hat, y, x_hat = auto_eq.auto_eq_loss(net, equalizer, *(torch.tensor(a) for a in (x, rp, rg)))
    loss.backward()
    gj = parameter_network_from_flax({"params": grads_j}, dtype=torch.float64)
    worst = max(float((dict(net.named_parameters())[k].grad - g).abs().max() / g.abs().max()) for k, g in gj.items())
    new = parameter_network_from_flax({"params": variables["params"], "batch_stats": stats_j}, dtype=torch.float64)
    state = net.state_dict()
    stats_err = max(float((state[k] - v).abs().max()) for k, v in new.items() if "running" in k)
    rel = abs(float(loss.detach()) - float(loss_j)) / float(loss_j)
    print(f"auto_eq float64: loss {float(loss.detach()):.12f} rel {rel:.3e}, worst gradient {worst:.3e}, stats {stats_err:.3e}")
    assert loss.dtype == torch.float64 and x_hat.shape == (BS, 1, T)
    assert rel <= 1e-10
    assert worst <= 1e-8
    assert stats_err <= 1e-10


def test_resumed_step_equals_uninterrupted(tmp_path):
    from dasp_tpu_torch.utils import load_checkpoint, save_checkpoint

    batches = [tuple(torch.tensor(a) for a in auto_eq_batch(np.float32)) for _ in range(3)]
    equalizer = M.ParametricEQ(SR, max_q_factor=1.0)

    def fresh():
        torch.manual_seed(0)
        net = auto_eq.smoke_net(equalizer.num_params)
        return net, torch.optim.Adam(net.parameters(), lr=2e-3)

    net, opt = fresh()
    straight = [float(auto_eq.auto_eq_step(net, equalizer, opt, *b)[0]) for b in batches]
    net, opt = fresh()
    for b in batches[:2]:
        auto_eq.auto_eq_step(net, equalizer, opt, *b)
    save_checkpoint(str(tmp_path / "ckpt.pkl"), {"net": net.state_dict(), "opt": opt.state_dict(), "step": 2})
    del net, opt
    state = load_checkpoint(str(tmp_path / "ckpt.pkl"))
    net, opt = fresh()
    net.load_state_dict(state["net"])
    opt.load_state_dict(state["opt"])
    assert state["step"] == 2
    assert float(auto_eq.auto_eq_step(net, equalizer, opt, *batches[2])[0]) == straight[2]


# ---------------------------------------------------------------------------
# every example's main, small, on the CPU


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Two mono and one stereo 16-bit wav of 16384 samples."""
    root = tmp_path_factory.mktemp("wavs")
    clips = synthetic_batch(np.random.default_rng(5), 4, 16384, kind="chirp")
    save_wav(str(root / "m0.wav"), clips[0], SR)
    save_wav(str(root / "m1.wav"), clips[1], SR)
    save_wav(str(root / "s0.wav"), np.concatenate([clips[2], clips[3]]), SR)
    return root


def on_grid(path):
    audio, sr = load_wav(str(path))
    assert sr == SR and audio.size and np.array_equal(audio * 32768, np.round(audio * 32768))
    return audio


def test_quickstart_recovers_drive(tmp_path):
    """tests/test_integration.py's threshold: 300 Adam steps at 0.05 on 8192 samples."""
    wav = tmp_path / "in.wav"
    save_wav(str(wav), synthetic_batch(np.random.default_rng(0), 1, 8192)[0], SR)
    out = quickstart.main(["--wav", str(wav), "--iters", "300", "--lr", "0.05", "--device", "cpu",
                           "--out-dir", str(tmp_path / "out")])
    assert out["loss"] < out["loss0"] / 20, out
    assert abs(out["drive"] - 16.0) < 4.0
    for f in ("recovered.wav", "target.wav"):
        on_grid(tmp_path / "out" / f)


def _amps(tmp_path):
    amp = tmp_path / "amps"
    amp.mkdir()
    x = synthetic_batch(np.random.default_rng(6), 2, 16384)
    save_wav(str(amp / virtual_analog.IDMT_SRC), x[0], SR)
    save_wav(str(amp / virtual_analog.IDMT_AMPS["jazz-amp"]), x[1], SR)
    return ["--amps", "jazz-amp", "--amp-audio-dir", str(amp)]


# example, its arguments (the data directory as "{data}"), and the files it writes
MAINS = {
    "quickstart": (quickstart, ["--wav", "{data}/m0.wav", "--iters", "2"], ["recovered.wav", "target.wav"]),
    "reverse_eng": (reverse_eng, ["--wav", "{data}/m1.wav", "--iters", "1"], ["recovered.wav", "target.wav"]),
    "demo": (demo, ["--wav", "{data}/s0.wav"], ["dry.wav", "wet.wav"]),
    "mixing_console": (mixing_console, ["--steps", "2", "--length", "8192", "--tracks", "2"], ["mix.wav", "target.wav"]),
    "streaming_demo": (streaming_demo, ["--smoke"], ["dry.wav", "streamed.wav"]),
    "denoise": (denoise, ["--steps", "2", "--length", "8192"], ["noisy.wav", "denoised.wav", "clean.wav"]),
    "blind_estimation": (blind_estimation, ["--data-dir", "{data}", "--steps", "2", "--length", "8192",
                                            "--batch-size", "2", "--processor", "pitch_shift"],
                         ["metrics.jsonl", "ckpt.pkl"]),
    "blind_estimation_auraloss": (blind_estimation, ["--steps", "1", "--length", "8192", "--batch-size", "2",
                                                     "--auraloss-compat"], ["metrics.jsonl", "ckpt.pkl"]),
    "auto_eq": (auto_eq, ["--data-dir", "{data}", "--smoke", "--steps", "2", "--checkpoint-every", "1"],
                ["metrics.jsonl", "ckpt.pkl", "corrupted_0.wav", "recovered_1.wav"]),
    "virtual_analog": (virtual_analog, ["--smoke", "--steps", "2"], ["metrics.jsonl", "ckpt.pkl"]),
    "virtual_analog_amps": (virtual_analog, ["--smoke", "--steps", "2"],
                            ["jazz-amp/audio/idmt-rock-clean2-jazz-amp-120-pred.wav", "jazz-amp/ckpt.pkl"]),
    "style_transfer": (style_transfer, ["--smoke", "--steps", "2"], ["metrics.jsonl", "ckpt.pkl"]),
    "mastering": (mastering, ["--smoke", "--steps", "2"], ["master.wav", "target.wav", "input.wav"]),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_example_main_writes_its_files(name, wav_dir, tmp_path, capsys):
    mod, argv, files = MAINS[name]
    out = tmp_path / "out"
    argv = [a.replace("{data}", str(wav_dir)) for a in argv] + ["--device", "cpu"]
    argv += ["--log-dir" if "metrics.jsonl" in files or name.endswith("amps") else "--out-dir", str(out)]
    if name == "virtual_analog_amps":
        argv += _amps(tmp_path)
    mod.main(argv)
    for f in files:
        assert (out / f).exists(), f
        if f.endswith(".wav"):
            on_grid(out / f)
        if f == "metrics.jsonl":
            recs = [json.loads(s) for s in open(out / f)]
            assert recs and all({"step", "time_s", "loss"} <= set(r) and np.isfinite(r["loss"]) for r in recs)
    if name == "auto_eq":
        assert len(os.listdir(out)) >= 6
        res = auto_eq.main(argv[:-4] + ["--steps", "3", "--resume", "--device", "cpu", "--log-dir", str(out)])
        assert "resumed from step 2" in capsys.readouterr().out
        assert res["start"] == 2 and len(res["losses"]) == 1 and np.isfinite(res["losses"][0])


def test_examples_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise.main(["--steps", "1", "--length", "4096"])


# ---------------------------------------------------------------------------
# style_transfer and mastering


def test_style_transfer_step_matches_jax_in_float64(monkeypatch):
    """examples/style_transfer.py's step_fn rebuilt in JAX (float64, the
    reverb's noise injected, Adam with the cosine decay) against the port's
    ``make_step`` from the same flax weights, clips and corruption."""
    from dasp_tpu.models import StyleTransferNet as FlaxStyle
    from dasp_tpu.models import make_style_processors as j_procs
    from dasp_tpu_torch.models import style_net_from_flax

    # the flax encoder takes its time mean in float32 whatever the run's
    # dtype; do the same on the port's side so the rest compares in float64
    monkeypatch.setattr(tcn, "_at_least_f32", lambda h: h.float().to(torch.promote_types(h.dtype, torch.float32)))
    args = style_transfer.parse(["--smoke", "--device", "cpu", "--steps", "3"])
    bs, T, ir = args.batch_size, args.length, 2048
    nprng = np.random.default_rng(40)
    x = (synthetic_batch(nprng, bs, T) * 0.5).astype(np.float64)
    procs_t, net = style_transfer.build(args, device="cpu")
    rand = {k: v.numpy().astype(np.float64) for k, v in style_transfer.random_corruption(nprng, bs, procs_t).items()}
    noise = [nprng.standard_normal((bs * 2, 12, ir + 1022)) for _ in range(2)]
    with x64():
        fnet = FlaxStyle(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4))
        variables = randomized_variables(fnet.init(jax.random.PRNGKey(0), jnp.zeros((bs, 1, T // 2)),
                                                   jnp.zeros((bs, 1, T // 2)), train=False), 1)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        jp = j_procs(SR, reverb_num_samples=ir)  # "fsm" EQ and smoother, the example's defaults
        opt = optax.chain(optax.adam(args.lr), optax.scale_by_schedule(optax.cosine_decay_schedule(1.0, args.steps)))

        @jax.jit
        def step(params, stats, x, rand, n_ref, n_out):  # step_fn, the reverb's noise injected
            ref = jp["equalizer"].process_normalized(x, rand["eq"], clip_params=True)
            ref = jp["compressor"].process_normalized(ref, rand["comp"], clip_params=True)
            ref = jp["reverb"].process_normalized(ref, rand["reverb"], clip_params=True, noise=n_ref)
            ref = ref / (jnp.max(jnp.abs(ref), axis=-1, keepdims=True) + 1e-9)
            ref = ref * 10.0 ** (-rand["ref_gain_db"] / 20.0)
            x = x * 10.0 ** (-rand["in_gain_db"] / 20.0)
            input_a, _ = jnp.split(x, 2, axis=-1)
            ref_a, ref_b = jnp.split(ref, 2, axis=-1)

            def loss_fn(params):
                p, upd = fnet.apply({"params": params, "batch_stats": stats}, input_a,
                                    jnp.mean(ref_b, axis=1, keepdims=True), train=True, mutable=["batch_stats"])
                y = jp["equalizer"].process_normalized(input_a, p["equalizer"], clip_params=True)
                y = jp["compressor"].process_normalized(y, p["compressor"], clip_params=True)
                y = jp["reverb"].process_normalized(y, p["reverb"], clip_params=True, noise=n_out)
                y = jp["gain"].process_normalized(y, p["gain"], clip_params=True)
                return j_mrstft(y, ref_a), upd["batch_stats"]

            (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = opt.update(grads, opt.init(params))
            return loss, grads, new_stats, optax.apply_updates(params, updates)

        loss_j, grads_j, stats_j, params_j = jax.device_get(step(
            variables["params"], variables["batch_stats"], x, rand, noise[0], noise[1]))
    net.load_state_dict(style_net_from_flax(variables, net), strict=True)
    net.double()
    opt_t, sched = style_transfer.make_optimizer(args, net)
    step_t = style_transfer.make_step(args, procs_t, net, opt_t, sched)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    loss = float(step_t(t(x), {k: t(v) for k, v in rand.items()}, noise=(t(noise[0]), t(noise[1]))))
    gj = style_net_from_flax({"params": grads_j}, dtype=torch.float64)
    worst = max(float((dict(net.named_parameters())[k].grad - g).abs().max() / g.abs().max()) for k, g in gj.items())
    new = style_net_from_flax({"params": params_j, "batch_stats": stats_j}, dtype=torch.float64)
    state = net.state_dict()
    # Adam's first update is -lr g / (|g| + eps) (bias-corrected moments):
    # on every element from the port's own gradient, and where |g| is at
    # least 1e4 eps (and 1e-3 of its tensor's largest) it does not depend on
    # g's last digits, so there the two packages' updates agree far below
    # lr; a tiny gradient of either sign may move its element by up to 2 lr
    old = style_net_from_flax(variables, dtype=torch.float64)
    grads_t = dict(net.named_parameters())
    adam = max(float((state[k] - (old[k] - args.lr * grads_t[k].grad / (grads_t[k].grad.abs() + 1e-8))).abs().max())
               for k in gj)
    big = {k: g.abs() > max(1e-3 * float(g.abs().max()), 1e4 * 1e-8) for k, g in gj.items()}
    moved = max(float((state[k] - new[k])[m].abs().max()) for k, m in big.items())
    held = sum(int(m.sum()) for m in big.values()) / sum(m.numel() for m in big.values())
    stats = max(float((state[k] - v).abs().max()) for k, v in new.items() if "running" in k)
    rel = abs(loss - float(loss_j)) / float(loss_j)
    print(f"style_transfer float64: loss {loss:.12f} rel {rel:.3e}, worst gradient {worst:.3e}, "
          f"parameters after the step {adam:.3e} from Adam's first step, {moved:.3e} from JAX's (on {held:.1%} of "
          f"them), statistics {stats:.3e}")
    # tests/test_torch_train.py's float64 bars: the flax encoder's float32
    # time mean leaks fp32 rounding (about 1e-9 of the loss) into JAX's
    # float64 step, which the port's float64 mean of the same fp32 values
    # does not round alike
    assert rel <= 1e-8
    assert worst <= 1e-5
    assert adam <= 1e-6 * args.lr
    assert moved <= 1e-6 * args.lr
    assert stats <= 1e-8


def test_style_transfer_optimizer_matches_optax():
    """``make_optimizer`` against the JAX example's optax chain (Adam, its
    update scaled by cosine_decay_schedule(1.0, steps)) after each step of a
    3-step run on fixed float64 gradients. The cosine factor goes 1, 0.75,
    0.25, so a schedule off by one step moves a parameter by lr / 4."""
    args = style_transfer.parse(["--smoke", "--device", "cpu", "--steps", "3"])
    rng = np.random.default_rng(41)
    p0 = {"w": rng.standard_normal((4, 5)), "b": rng.standard_normal(5)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in p0.items()} for _ in range(args.steps)]
    net = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()})
    opt_t, sched = style_transfer.make_optimizer(args, net)
    with x64():
        opt = optax.chain(optax.adam(args.lr), optax.scale_by_schedule(optax.cosine_decay_schedule(1.0, args.steps)))
        params, opt_state = p0, opt.init(p0)
        for i, g in enumerate(grads):
            updates, opt_state = opt.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            for k, p in net.items():
                p.grad = torch.tensor(g[k])
            opt_t.step()
            sched.step()
            err = max(float(np.abs(net[k].detach().numpy() - np.asarray(params[k])).max()) for k in p0)
            print(f"step {i}: parameters {err:.3e} from optax's")
            assert err <= 1e-6 * args.lr


def test_example_batches_do_not_depend_on_the_threads():
    """The examples' batch stream is one per seed: batch i comes from the
    generator seeded (seed, i) and the threads' batches come out in order,
    so a run draws the same batches whatever its loader threads, and so
    do the ranks of a multi-rank run."""
    from dasp_tpu_torch.examples.common import batch_iterator

    args = style_transfer.parse(["--smoke", "--device", "cpu"])
    streams = []
    for workers in (1, 3):
        it = batch_iterator(args, num_workers=workers, prefetch=2)
        streams.append([next(it) for _ in range(5)])
        it.close()
    for a, b in zip(*streams):
        assert np.array_equal(a, b)
    assert not np.array_equal(streams[0][0], streams[0][1])
    want = synthetic_batch(np.random.default_rng((args.seed, 3)), args.batch_size, args.length, args.sample_rate)
    assert np.array_equal(streams[1][3], want)


def test_style_transfer_on_wav_files_and_resume(wav_dir, tmp_path, capsys):
    """The real-file path: 16-bit wavs through the native loader and the i16
    wire, metrics and a checkpoint, and a resume that continues at step 3."""
    out = tmp_path / "st"
    argv = ["--data-dir", str(wav_dir), "--smoke", "--device", "cpu", "--log-dir", str(out)]
    res = style_transfer.main(argv + ["--steps", "3"])
    assert res["start"] == 0 and len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    assert "dataset: " in capsys.readouterr().out
    recs = [json.loads(s) for s in open(out / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [0, 2] and all(np.isfinite(r["loss"]) for r in recs)
    assert (out / "ckpt.pkl").exists()
    res = style_transfer.main(argv + ["--steps", "4", "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert res["start"] == 3 and len(res["losses"]) == 1 and np.isfinite(res["losses"][0])


@pytest.mark.parametrize("one_rank,sp_rank", [
    (["--smoother", "exact_pallas", "--filter-method", "coupled"], ["--smoother", "exact_pallas"]),
    (["--smoother", "attack_only", "--filter-method", "coupled"], []),  # "fsm" under sp: the sharded one-pole
])
def test_style_transfer_sp_trains_the_one_rank_numerics(tmp_path, one_rank, sp_rank):
    """One step of main with and without --sp 2 (two gloo CPU ranks): under
    sp the EQ is the sharded coupled cascade and the smoother its sharded
    equivalent, so at the one-rank run's matching options the loss agrees."""
    base = ["--smoke", "--steps", "1", "--device", "cpu"]
    one = style_transfer.main(base + one_rank + ["--log-dir", str(tmp_path / "one")])
    two = style_transfer.main(base + sp_rank + ["--sp", "2", "--ranks", "2", "--log-dir", str(tmp_path / "sp")])
    print(f"first loss: one rank {one['losses'][0]:.8f}, --sp 2 {two['losses'][0]:.8f}")
    assert abs(two["losses"][0] - one["losses"][0]) <= 2e-5 * max(1.0, abs(one["losses"][0]))


def test_mastering_sp_matches_one_rank(tmp_path):
    base = ["--smoke", "--steps", "2", "--device", "cpu"]
    one = mastering.main(base + ["--out-dir", str(tmp_path / "one")])
    two = mastering.main(base + ["--sp", "2", "--ranks", "2", "--out-dir", str(tmp_path / "sp")])
    print(f"losses: one rank {one['losses']}, --sp 2 {two['losses']}")
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=2e-5)


def test_sp_needs_the_ranks():
    """--sp 2 with one rank raises as the JAX package's make_mesh does."""
    with pytest.raises(ValueError, match="positive axis sizes"):
        style_transfer.main(["--smoke", "--steps", "1", "--device", "cpu", "--sp", "2"])
