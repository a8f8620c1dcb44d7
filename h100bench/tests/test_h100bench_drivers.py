"""Each driver on the CPU at a tiny size, through the harness's whole run
but the look for a card: sound, it compares within the cell's limits; with
the timed path broken underneath (each fault the cell can have), and with
the reference in the precision below the configuration's put in the
program's place (the control), ``correct`` comes out false."""

import types

import pytest
import torch

from conftest import tiny
from h100bench.drivers import stream_chain, style_render, style_train
from h100bench.run import load_json, run_cell, ROOT

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, program=None, seconds=1.0, trace=False):
    cfg, cell = tiny(name)
    return run_cell(name, SEED, seconds, trace, CPU, bench=load_json(ROOT / "BENCHMARK.json"), cell=cell, cfg=cfg,
                    program=program)


# ---------------------------------------------------------------- training


def _unchanged(step):
    """The fault "a step that returns its state unchanged": the loss and the
    gradient, then no update."""
    def broken(net, procs, opt, x, rand, noise=None, mark=None):
        saved = [p.detach().clone() for p in net.parameters()]
        loss = step(net, procs, opt, x, rand, noise=noise, mark=mark)
        with torch.no_grad():
            for p, s in zip(net.parameters(), saved):
                p.copy_(s)
        return loss
    return broken


def test_training_is_correct_and_reports_its_metrics():
    out = run("style_train.bs8")
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"setup_s", "train_steps_per_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_training_faults_are_not_correct(fault):
    from dasp_tpu_torch import train as T

    step = _unchanged(T.train_step) if fault == "unchanged" else style_train._half_step(T.train_step)
    out = run("style_train.bs8", program=types.SimpleNamespace(train_step=step))
    assert not out["correct"], out["compared"]
    if fault == "half":  # the number that catches it at the cell's own size too
        assert out["compared"]["stats"]["value"] > out["compared"]["stats"]["limit"], out["compared"]


def test_training_control_is_not_correct():
    cfg, cell = tiny("style_train.bs8")
    numbers, _ = style_train.calibrate("control", cfg, cell, SEED, CPU, 1.0)
    assert any(numbers[k] > lim for k, lim in cell["limits"].items()), numbers


# ---------------------------------------------------------------- render


def test_render_is_correct(small_net):
    out = run("style_render.bs8", seconds=2.0)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"setup_s", "render_ms_p95"}


def test_render_with_answers_altered_is_not_correct(small_net):
    from dasp_tpu_torch import models as M

    program = types.SimpleNamespace(apply_style_chain=lambda *a, **k: 1.1 * M.apply_style_chain(*a, **k))
    out = run("style_render.bs8", program=program, seconds=2.0)
    assert not out["correct"], out["compared"]


def test_render_control_is_not_correct(small_net):
    cfg, cell = tiny("style_render.bs8")
    numbers, _ = style_render.calibrate("control", cfg, cell, SEED, CPU, 2.0)
    assert any(numbers[k] > lim for k, lim in cell["limits"].items()), numbers


# ---------------------------------------------------------------- streams


class _Stateless:
    """The fault "a step that returns its state unchanged": every chunk
    from rest."""

    def __init__(self, steps):
        from dasp_tpu_torch import streaming as S

        self.chain = S.StreamChain(steps)

    def __call__(self, x, state=None):
        return self.chain(x, None)[0], None


class _Altered:
    """The fault "an answer altered where it is produced": the fifth chunk
    of the window scaled."""

    def __init__(self, steps):
        from dasp_tpu_torch import streaming as S

        self.chain, self.n = S.StreamChain(steps), 0

    def __call__(self, x, state=None):
        y, state = self.chain(x, state)
        self.n += 1
        return (1.05 * y if self.n == 5 else y), state


def _streaming_with(chain_cls):
    from dasp_tpu_torch import streaming as S

    ns = types.SimpleNamespace(**{k: getattr(S, k) for k in dir(S) if not k.startswith("__")})
    ns.StreamChain = chain_cls
    return ns


@pytest.mark.parametrize("name", ["stream_classic.chunk512", "stream_classic.bs8_chunk512"])
def test_stream_is_correct(name):
    out = run(name)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"setup_s", "chunk_ms_p95"}


@pytest.mark.parametrize("fault", [_Stateless, _Altered])
def test_stream_faults_are_not_correct(fault):
    out = run("stream_classic.chunk512", program=_streaming_with(fault))
    assert not out["correct"], out["compared"]


def test_stream_control_is_not_correct():
    cfg, cell = tiny("stream_classic.chunk512")
    numbers, _ = stream_chain.calibrate("control", cfg, cell, SEED, CPU, 1.0)
    assert any(numbers[k] > lim for k, lim in cell["limits"].items()), numbers
