"""The parametric EQ stream's memo of designed sections and coupled
operators (``dasp_tpu_torch.streaming._OperatorMemo``), on the CPU.

Every chunk is held to the rebuild path, the stream's body without the memo
(``parametric_eq_sos`` and ``sosfilt_stream``): output and state bitwise
equal, hit or miss. The counters ``stream.eq_operators.hit`` / ``.miss``
say which it was; a write to a parameter (in place, or through ``.data``,
which leaves the version counter alone), other values, another sample rate,
channel count or batch miss; NaN parameters never hit; grad mode with a
parameter that requires grad bypasses the memo.
"""

import sys
import threading

import pytest
import torch

from dasp_tpu_torch import functional as F
from dasp_tpu_torch import streaming as S
from dasp_tpu_torch import trace
from dasp_tpu_torch.ops.iir import coupled_operators, sosfilt_coupled

SR = 44100
# the classic live chain's 18 EQ values (benchmarks/streaming_latency.py)
EQ = (2.0, 200.0, 0.7, 3.0, 400.0, 1.0, -2.0, 3000.0, 2.0, 1.0, 9000.0, 1.0, 2.0, 13000.0, 1.0, -3.0, 8000.0, 0.7)
CHUNK = 256


@pytest.fixture(autouse=True)
def clean_memo():
    S._EQ_MEMO.clear()
    trace.reset()
    yield
    S._EQ_MEMO.clear()
    trace.reset()


def counts():
    c = trace.snapshot()["counts"]
    return c.get("stream.eq_operators.hit", 0), c.get("stream.eq_operators.miss", 0)


def params(bs=1, dtype=torch.float32, values=EQ):
    return [torch.full((bs,), v, dtype=dtype) for v in values]


def signal(bs=1, chs=2, n=8, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (0.25 * torch.randn((bs, chs, n * CHUNK), generator=g)).to(dtype).split(CHUNK, dim=-1)


def rebuild(x, p, zi, sr=SR):
    """The stream's body without the memo: design, then the coupled cascade."""
    sos = F.parametric_eq_sos(x.shape[0], x.dtype, sr, *p, device=x.device)
    return S.sosfilt_stream(sos, x, zi=zi)


def step_both(x, p, zi, sr=SR):
    """One chunk through the stream and through the rebuild, held bitwise."""
    y, zf = S.parametric_eq_stream(x, sr, *p, zi=zi)
    y_r, zf_r = rebuild(x, p, zi, sr)
    assert torch.equal(y, y_r) and torch.equal(zf, zf_r)
    return zf


@pytest.mark.parametrize("dtype,bs,chs", [(torch.float32, 1, 2), (torch.float64, 1, 2), (torch.float32, 3, 1)])
def test_eight_chunks_are_bitwise_a_rebuild_with_one_miss(dtype, bs, chs):
    p = params(bs, dtype)
    zi = None
    for c in signal(bs, chs, 8, dtype):
        zi = step_both(c, p, zi)
    assert counts() == (7, 1)
    assert len(S._EQ_MEMO) == 1


@pytest.mark.parametrize("write", ["in_place", "data"])
def test_a_write_to_a_parameter_misses(write):
    p = params()
    chunks = signal(n=4)
    zi = step_both(chunks[0], p, None)
    zi = step_both(chunks[1], p, zi)
    version = p[4]._version
    if write == "in_place":
        p[4].add_(50.0)
    else:
        p[4].data.fill_(450.0)
        assert p[4]._version == version  # the counter alone would not see it
    zi = step_both(chunks[2], p, zi)
    assert counts() == (1, 2)
    step_both(chunks[3], p, zi)
    assert counts() == (2, 2)


def test_new_tensors_hit_on_equal_values_and_miss_on_others():
    chunks = signal(n=3)
    zi = step_both(chunks[0], params(), None)
    zi = step_both(chunks[1], params(), zi)
    assert counts() == (1, 1)
    other = list(EQ)
    other[0] = 2.5
    step_both(chunks[2], params(values=other), zi)
    assert counts() == (1, 2)


def test_negative_zero_is_another_value():
    """Parameters compare bit for bit: -0.0 is not 0.0."""
    values = list(EQ)
    values[15] = 0.0
    chunks = signal(n=2)
    zi = step_both(chunks[0], params(values=values), None)
    values[15] = -0.0
    step_both(chunks[1], params(values=values), zi)
    assert counts() == (0, 2)


@pytest.mark.parametrize("change", ["sample_rate", "channels", "batch"])
def test_another_sample_rate_channel_count_or_batch_misses(change):
    step_both(signal()[0], params(), None)
    x, p, sr = signal()[1], params(), SR
    if change == "sample_rate":
        sr = 48000
    elif change == "channels":
        x = signal(chs=1)[1]
    else:
        x, p = signal(bs=2)[1], params(2)
    step_both(x, p, None, sr)
    assert counts() == (0, 2)
    assert len(S._EQ_MEMO) == 2


def test_python_number_parameters_hit_and_nan_never_does():
    chunks = signal(n=6)
    zi = step_both(chunks[0], list(EQ), None)
    zi = step_both(chunks[1], list(EQ), zi)
    assert counts() == (1, 1)
    nan = list(EQ)
    nan[1] = float("nan")
    for c in chunks[2:4]:
        y, _ = S.parametric_eq_stream(c, SR, *nan)
        assert not bool(torch.isfinite(y).all())
    p = params()
    p[2] = torch.full((1,), float("nan"))
    for c in chunks[4:6]:
        y, _ = S.parametric_eq_stream(c, SR, *p)
        assert not bool(torch.isfinite(y).all())
    assert counts() == (1, 5)
    assert len(S._EQ_MEMO) == 1


def test_eviction_keeps_the_bound_and_drops_the_least_recently_used():
    size = S._EQ_MEMO.size
    x = signal(n=1)[0]
    sets = [params(values=(2.0 + i,) + EQ[1:]) for i in range(size + 2)]
    for p in sets[:size]:
        step_both(x, p, None)
    step_both(x, sets[0], None)  # set 0 is now the most recent: set 1 goes first
    assert counts() == (1, size)
    for p in sets[size:]:
        step_both(x, p, None)
        assert len(S._EQ_MEMO) == size
    step_both(x, sets[0], None)
    assert counts() == (2, size + 2)
    step_both(x, sets[1], None)
    step_both(x, sets[2], None)
    assert counts() == (2, size + 4)


def test_grad_mode_with_parameters_that_require_grad_bypasses_the_memo():
    chunks = signal(n=3)
    p = [t.clone().requires_grad_() for t in params()]
    p_r = [t.clone().requires_grad_() for t in params()]
    zi = zi_r = None
    loss = loss_r = 0.0
    for c in chunks:
        y, zi = S.parametric_eq_stream(c, SR, *p, zi=zi)
        y_r, zi_r = rebuild(c, p_r, zi_r)
        assert torch.equal(y, y_r)
        loss, loss_r = loss + (y ** 2).sum(), loss_r + (y_r ** 2).sum()
    loss.backward()
    loss_r.backward()
    for a, b in zip(p, p_r):
        assert torch.equal(a.grad, b.grad)
    assert counts() == (0, 0) and len(S._EQ_MEMO) == 0
    with torch.no_grad():  # no graph to tie together: the memo engages
        zi = None
        for c in chunks:
            zi = step_both(c, p, zi)
    assert counts() == (2, 1)


def test_a_chunk_that_requires_grad_takes_its_gradient_through_kept_operators():
    p = params()
    chunks = signal(n=2)
    step_both(chunks[0], p, None)
    x, x_r = chunks[1].clone().requires_grad_(), chunks[1].clone().requires_grad_()
    y, _ = S.parametric_eq_stream(x, SR, *p)
    y_r, _ = rebuild(x_r, p, None)
    (y ** 2).sum().backward()
    (y_r ** 2).sum().backward()
    assert torch.equal(x.grad, x_r.grad)
    assert counts() == (1, 1)


def test_inference_mode_keeps_its_own_entries():
    """Operators built under inference mode are inference tensors, which
    autograd cannot save: a call outside it builds its own."""
    p = params()
    x = signal(n=1)[0]
    with torch.inference_mode():
        S.parametric_eq_stream(x, SR, *p)
    xg = x.clone().requires_grad_()
    y, _ = S.parametric_eq_stream(xg, SR, *p)
    y.sum().backward()
    assert counts() == (0, 2)


@pytest.mark.parametrize("case", ["block", "numpy_parameter"])
def test_bypassed_calls_count_nothing(case):
    x, p, method = signal(n=1)[0], params(), "coupled"
    if case == "block":
        method = "block"
    else:
        p[3] = p[3].numpy()
    y, zf = S.parametric_eq_stream(x, SR, *p, filter_method=method)
    sos = F.parametric_eq_sos(1, x.dtype, SR, *p)
    y_r, zf_r = S.sosfilt_stream(sos, x, filter_method=method)
    assert torch.equal(y, y_r) and torch.equal(zf, zf_r)
    assert counts() == (0, 0) and len(S._EQ_MEMO) == 0


def test_parameters_compare_as_the_design_reads_them():
    """float64 parameters of a float32 stream are read in float32: equal
    float32 values hit."""
    chunks = signal(n=3)
    zi = step_both(chunks[0], params(), None)
    zi = step_both(chunks[1], params(dtype=torch.float64), zi)
    assert counts() == (1, 1)
    p = params(dtype=torch.float64)
    p[0] = p[0] + 1e-12  # the same float32 value
    step_both(chunks[2], p, zi)
    assert counts() == (2, 1)


def test_threads_calling_streams_at_once_agree_with_a_rebuild():
    """More threads than entries, each alternating two parameter sets, with
    a short switch interval: every chunk bitwise its rebuild, the memo
    within its bound."""
    n_threads, n_chunks = 8, 6
    sets = [params(values=(1.0 + i,) + EQ[1:]) for i in range(n_threads + 1)]
    chunks = signal(n=n_chunks)
    errors = []

    def run(i):
        try:
            zi = zj = None
            for k, c in enumerate(chunks):
                zi = step_both(c, sets[i], zi)
                zj = step_both(c, sets[i + 1], zj)
                assert len(S._EQ_MEMO) <= S._EQ_MEMO.size, k
        except Exception as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    hits, misses = counts()
    assert hits + misses == 2 * n_threads * n_chunks


@pytest.mark.parametrize("shape,zi", [((2, 1, 700), False), ((2, 2, 512), True), ((1, 3, 256), True)])
def test_offline_coupled_cascade_with_and_without_operators_is_bitwise(shape, zi):
    g = torch.Generator().manual_seed(1)
    x = 0.25 * torch.randn(shape, generator=g)
    sos = F.parametric_eq_sos(shape[0], x.dtype, SR, *params(shape[0]))
    kw = {}
    if zi:
        kw = dict(zi=0.1 * torch.randn(shape[:-1] + (6, 2), generator=g), return_zf=True)
    built = sosfilt_coupled(sos, x, **kw)
    kept = sosfilt_coupled(None, x, operators=coupled_operators(sos, x.shape), **kw)
    for a, b in zip(built if zi else [built], kept if zi else [kept]):
        assert torch.equal(a, b)


def test_operators_for_another_shape_or_block_are_refused():
    x = torch.zeros((2, 2, 256))
    sos = F.parametric_eq_sos(2, x.dtype, SR, *params(2))
    with pytest.raises(ValueError, match="rows"):
        sosfilt_coupled(None, x, operators=coupled_operators(sos, (2, 1, 256)))
    with pytest.raises(ValueError, match="block"):
        sosfilt_coupled(None, x, block=64, operators=coupled_operators(sos, x.shape))
