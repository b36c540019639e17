"""The refined KKT solve as one CUDA graph (``optimization/kkt.py``,
``KKTFactor.solve_refined``).

CPU tests: on the CPU, with a context and without, ``solve_refined``
captures nothing and is bit-equal to the FGMRES the solve ran before
(kept below as ``_old_solve_refined``).  Tests marked ``cuda`` run on the
LP KKT of ``concat_fd_2d(40, 40)`` (N = 4,800, above
``SOLVE_CONTEXT_MIN_N``) with its panel inverses passed: a replayed solve
equals the eager one, a second right-hand side and a changed ``reg_diag``
give their own answers, a new context captures again, a dropped factor
returns its graph's memory to the pool the next factor's graph takes it
from, and neither a call without a context nor a
call inside the caller's own capture captures; they skip without a card.
The file imports no JAX:

    python -m pytest tests/test_torch_solve_graph.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from elemental_tpu_torch.matrices import concat_fd_2d
from elemental_tpu_torch.optimization.kkt import KKTFactor, _hessenberg_lstsq
from elemental_tpu_torch.optimization.lp import _build_lp_kkt, sparse_ruiz

COUNTERS = KKTFactor.solve_refined
ITERS = 16


def _counts():
    return COUNTERS.captures, COUNTERS.replays


def _old_solve_refined(fact, rhs, reg_diag=None, iters=2, ctx=None):
    """``KKTFactor.solve_refined`` as it was before the graph: FGMRES
    issued from the host on every call."""
    def K0(x):
        kx = fact.sys.matvec(fact.vals, x)
        if reg_diag is not None:
            kx = kx - reg_diag * x
        return kx

    N = rhs.shape[0]
    if ctx is None:
        ctx = fact.default_context()
    dev, dt = rhs.device, rhs.dtype
    beta = torch.linalg.norm(rhs)
    k = max(1, int(iters))
    V = torch.zeros((k + 1, N), dtype=dt, device=dev)
    V[0] = rhs / torch.where(beta > 0, beta, torch.ones_like(beta))
    Z = torch.zeros((k, N), dtype=dt, device=dev)
    H = torch.zeros((k + 1, k), dtype=dt, device=dev)
    ar = torch.arange(k + 1, device=dev)
    for j in range(k):
        z = fact.solve(V[j], ctx)
        w = K0(z)
        coef = (V @ w) * (ar <= j)
        w = w - V.T @ coef
        hn = torch.linalg.norm(w)
        H[:, j] = coef
        H[j + 1, j] = hn
        V[j + 1] = w / torch.where(hn > 0, hn, torch.ones_like(hn))
        Z[j] = z
    e1 = torch.zeros(k + 1, dtype=dt, device=dev)
    e1[0] = beta
    y = _hessenberg_lstsq(H, e1, k)
    cand = Z.T @ y
    x0 = beta * Z[0]
    better = (torch.linalg.norm(rhs - K0(cand))
              < torch.linalg.norm(rhs - K0(x0)))
    return torch.where(better, cand, x0)


def _lp_kkt(n1, device, dtype):
    """The LP KKT of ``concat_fd_2d(n1, n1)``, a seeded interior point's
    factor, and seeded right-hand sides and ``reg_diag``."""
    A = sparse_ruiz(concat_fd_2d(n1, n1))[0]
    kkt, _ = _build_lp_kkt(A, 1e-2, 1e-2, None, device=device, dtype=dtype)
    rng = np.random.default_rng(n1)
    theta = torch.as_tensor(rng.uniform(0.05, 20.0, A.width), device=device,
                            dtype=dtype)
    vals = kkt.assemble([theta])
    rhs = torch.as_tensor(rng.standard_normal((2, kkt.N)), device=device,
                          dtype=dtype)
    return kkt, vals, rhs, kkt.reg


# ----------------------------------------------------------------- the CPU


@pytest.fixture(scope="module")
def cpu_kkt():
    return _lp_kkt(16, "cpu", torch.float64)


@pytest.mark.parametrize("with_ctx", [True, False])
@pytest.mark.parametrize("with_reg", [True, False])
@pytest.mark.parametrize("iters", [1, 4])
def test_cpu_solve_captures_nothing(cpu_kkt, with_ctx, with_reg, iters):
    kkt, vals, rhs, reg = cpu_kkt
    fact = kkt.prepare(vals)
    ctx = fact.solve_context() if with_ctx else None
    reg = reg if with_reg else None
    before = _counts()
    got = fact.solve_refined(rhs[0], reg, iters=iters, ctx=ctx)
    again = fact.solve_refined(rhs[0], reg, iters=iters, ctx=ctx)
    assert _counts() == before
    assert fact._graph is None
    want = _old_solve_refined(fact, rhs[0], reg, iters=iters, ctx=ctx)
    assert torch.equal(got, want) and torch.equal(again, want)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_CARD = {}


@pytest.fixture
def card_kkt(cuda):
    """The n1 = 40 LP KKT on the card in float32, built once."""
    if "kkt" not in _CARD:
        _CARD["kkt"] = _lp_kkt(40, cuda, torch.float32)
    return _CARD["kkt"]


def _rel(x, ref):
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


# the KKT matvec's index_add_ adds with atomics in no fixed order, so two
# eager calls differ in the last bits, amplified by the system's
# conditioning: on an H100 a replay read 5-6e-8 from the eager call at
# n1 = 224, as two eager calls did, and 1.09e-6 here with reg_diag
# doubled (K0's lower block then +δ, no longer 0); a stale input buffer
# would miss by ~1e-2
GATE = 1e-5


@pytest.mark.cuda
def test_replay_equals_eager(card_kkt):
    kkt, vals, rhs, reg = card_kkt
    fact = kkt.prepare(vals)
    ctx = fact.solve_context()
    assert kkt.N == 4800 and kkt.N > fact.SOLVE_CONTEXT_MIN_N
    c0, r0 = _counts()
    first = fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx)
    assert _counts() == (c0 + 1, r0)
    replayed = [fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx)
                for _ in range(3)]
    assert _counts() == (c0 + 1, r0 + 3)
    eager = fact._fgmres(rhs[0], reg, ITERS, ctx)
    old = _old_solve_refined(fact, rhs[0], reg, iters=ITERS, ctx=ctx)
    torch.cuda.synchronize()
    assert _rel(eager, old) <= GATE
    for x in [first] + replayed:
        assert torch.isfinite(x).all()
        assert _rel(x, eager) <= GATE
    # each answer is a copy: the next replay does not overwrite it
    assert first.data_ptr() != replayed[0].data_ptr()


@pytest.mark.cuda
def test_second_rhs_and_reg_give_their_own_answers(card_kkt):
    kkt, vals, rhs, reg = card_kkt
    fact = kkt.prepare(vals)
    ctx = fact.solve_context()
    a = fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx)
    c0, r0 = _counts()
    b = fact.solve_refined(rhs[1], reg, iters=ITERS, ctx=ctx)
    reg2 = 2 * reg
    c = fact.solve_refined(rhs[0], reg2, iters=ITERS, ctx=ctx)
    assert _counts() == (c0, r0 + 2)
    assert _rel(b, fact._fgmres(rhs[1], reg, ITERS, ctx)) <= GATE
    assert _rel(c, fact._fgmres(rhs[0], reg2, ITERS, ctx)) <= GATE
    assert _rel(a, b) > 0.1 and _rel(a, c) > GATE


@pytest.mark.cuda
def test_new_key_captures_again(card_kkt):
    kkt, vals, rhs, reg = card_kkt
    fact = kkt.prepare(vals)
    ctx = fact.solve_context()
    c0, r0 = _counts()
    fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx)
    ctx2 = fact.solve_context()
    x = fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx2)
    assert _counts() == (c0 + 2, r0)
    assert fact._graph.ctx is ctx2
    assert _rel(x, fact._fgmres(rhs[0], reg, ITERS, ctx2)) <= GATE
    # iters, and a call without reg_diag, are keys of their own
    fact.solve_refined(rhs[0], reg, iters=3, ctx=ctx2)
    y = fact.solve_refined(rhs[0], iters=3, ctx=ctx2)
    assert _counts() == (c0 + 4, r0)
    assert _rel(y, fact._fgmres(rhs[0], None, 3, ctx2)) <= GATE


@pytest.mark.cuda
def test_dropped_factor_returns_graph_memory(card_kkt):
    kkt, vals, rhs, reg = card_kkt
    # one capture first: the capture stream and its cuBLAS workspace are
    # made once a process and stay
    warm = kkt.prepare(vals)
    warm.solve_refined(rhs[0], reg, iters=ITERS, ctx=warm.solve_context())
    del warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    fact = kkt.prepare(vals)
    ctx = fact.solve_context()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    x = fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx)
    del x
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() > before
    del fact, ctx
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    # the new factor's graph took what the dropped one held: nothing more
    # is reserved
    assert torch.cuda.memory_reserved() == reserved


@pytest.mark.cuda
def test_no_capture_without_context(card_kkt):
    kkt, vals, rhs, reg = card_kkt
    fact = kkt.prepare(vals)
    before = _counts()
    got = fact.solve_refined(rhs[0], reg, iters=ITERS)
    assert _counts() == before and fact._graph is None
    want = _old_solve_refined(fact, rhs[0], reg, iters=ITERS)
    assert _rel(got, want) <= GATE


@pytest.mark.cuda
def test_no_capture_inside_the_callers_capture(card_kkt):
    kkt, vals, rhs, reg = card_kkt
    fact = kkt.prepare(vals)
    ctx = fact.solve_context()
    static = rhs[0].clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):         # the caller's own warm-up
        fact._fgmres(static, reg, ITERS, ctx)
    torch.cuda.current_stream().wait_stream(stream)
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fact.solve_refined(static, reg, iters=ITERS, ctx=ctx)
    assert _counts() == before and fact._graph is None
    static.copy_(rhs[1])
    graph.replay()
    assert _rel(out, fact._fgmres(rhs[1], reg, ITERS, ctx)) <= GATE


@pytest.mark.cuda
def test_capture_and_replay_spans(card_kkt):
    """Under a profiler: a capture span in the first call of a key, with
    the tree solves' spans inside it, and a replay span in the next call,
    with none."""
    from torch.profiler import ProfilerActivity, profile
    kkt, vals, rhs, reg = card_kkt
    fact = kkt.prepare(vals)
    fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=fact.solve_context())
    ctx = fact.solve_context()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fact.solve_refined(rhs[0], reg, iters=ITERS, ctx=ctx)
        fact.solve_refined(rhs[1], reg, iters=ITERS, ctx=ctx)
    events = prof.profiler.kineto_results.events()
    spans = {}
    for e in events:
        if e.name().startswith("el."):
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert len(spans["el.kkt.solve_refined"]) == 2
    (capture,) = spans["el.kkt.solve_graph.capture"]
    (replay,) = spans["el.kkt.solve_graph.replay"]
    first, second = sorted(spans["el.kkt.solve_refined"])
    assert first[0] <= capture[0] and capture[1] <= first[1]
    assert second[0] <= replay[0] and replay[1] <= second[1]
    solves = spans["el.ldl.solve"]
    assert len(solves) == ITERS
    assert all(capture[0] <= a and b <= capture[1] for a, b in solves)
