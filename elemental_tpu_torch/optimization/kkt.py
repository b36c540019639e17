"""Fixed-pattern sparse KKT engine (counterpart of ``elemental_tpu/
optimization/kkt.py``; reference pipeline SURVEY §3.6,
``examples/interface/LPDirect.py:70-115``).

The KKT pattern is assembled ONCE on the host (static blocks plus *dynamic
slots* whose values change every IPM iteration).  Per iteration, on the
device: scatter-add the dynamic values onto the static base, Ruiz-equilibrate,
refactor with the multifrontal LDL reusing the symbolic analysis (reference
``ChangeNonzeroValues``, ``DistSparseLDLFactorization.cpp:149``), and solve
with FGMRES against the *unregularized* KKT.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.policy import real_working_dtype
from ..core.profiling import profile_region, profiled
from ..sparse.csr import SparseMatrix
from ..sparse_direct.ea_plan import EAPlan, build_ea_plan
from ..sparse_direct.numeric import LDLFactorization, factor as _mf_factor
from ..sparse_direct.symbolic import SymbolicFactorization, analyze


class KKTBuilder:
    """Assemble a symmetric quasi-definite KKT pattern from static COO
    blocks plus dynamic slots (the reference's ``ChangeNonzeroValues`` reuse,
    made explicit)."""

    def __init__(self, N: int, dtype=np.float64):
        self.N = int(N)
        self.dtype = np.dtype(dtype)
        self._srows: List[np.ndarray] = []
        self._scols: List[np.ndarray] = []
        self._svals: List[np.ndarray] = []
        self._dyn: List[Tuple[np.ndarray, np.ndarray]] = []
        self._reg = np.zeros(self.N, self.dtype)

    def add_static(self, rows, cols, vals) -> None:
        self._srows.append(np.asarray(rows, np.int64))
        self._scols.append(np.asarray(cols, np.int64))
        self._svals.append(np.asarray(vals, self.dtype))

    def add_regularization(self, idx, vals) -> None:
        """Static diagonal regularization (+γ, −δ): added as static entries
        and kept, signed, as :attr:`KKTSystem.reg`."""
        self.add_static(idx, idx, vals)
        np.add.at(self._reg, np.asarray(idx, np.int64), vals)

    def add_dynamic(self, rows, cols) -> int:
        """Register a dynamic slot; per-iteration values are scatter-ADDED
        (duplicates with static entries sum, as in COO assembly).  Returns
        the slot id for :meth:`KKTSystem.assemble`."""
        self._dyn.append((np.asarray(rows, np.int64),
                          np.asarray(cols, np.int64)))
        return len(self._dyn) - 1

    @profiled("el.kkt.finalize")
    def finalize(self, perm: Optional[np.ndarray] = None, relax: int = 8,
                 cutoff: int = 64, *, device, dtype) -> "KKTSystem":
        """Host ordering + symbolic analysis + extend-add plan; the plans and
        values move to ``device`` (values in ``dtype``)."""
        dtype = real_working_dtype(dtype)
        N = self.N
        srows = (np.concatenate(self._srows) if self._srows
                 else np.empty(0, np.int64))
        scols = (np.concatenate(self._scols) if self._scols
                 else np.empty(0, np.int64))
        svals = (np.concatenate(self._svals) if self._svals
                 else np.empty(0, self.dtype))
        all_rows = np.concatenate([srows] + [r for r, _ in self._dyn])
        all_cols = np.concatenate([scols] + [c for _, c in self._dyn])
        uniq, inv = np.unique(all_rows * N + all_cols, return_inverse=True)
        base = np.zeros(uniq.shape[0], self.dtype)
        np.add.at(base, inv[:srows.size], svals)
        dyn_pos: List[np.ndarray] = []
        off = srows.size
        for r, _ in self._dyn:
            dyn_pos.append(inv[off:off + r.size].copy())
            off += r.size

        rows = (uniq // N).astype(np.int64)
        cols = (uniq % N).astype(np.int64)
        rowptr = np.zeros(N + 1, np.int64)
        np.add.at(rowptr, rows + 1, 1)
        pattern = SparseMatrix(N, N, np.cumsum(rowptr), cols, base)

        if perm is None:
            from ..sparse_direct.ordering import nested_dissection
            perm = nested_dissection(pattern, cutoff=cutoff)
        host = analyze(pattern, perm=perm, relax=relax)
        to = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        return KKTSystem(N, pattern, host.to(device),
                         build_ea_plan(host).to(device),
                         torch.as_tensor(base).to(device, dtype),
                         [to(p) for p in dyn_pos], to(rows), to(cols),
                         dtype, torch.as_tensor(self._reg).to(device, dtype))


@dataclasses.dataclass
class KKTSystem:
    """Finalized fixed-pattern KKT: assemble / equilibrate / factor /
    matvec building blocks on the device."""

    N: int
    pattern: SparseMatrix            # host CSR (structure; vals = statics)
    symb: SymbolicFactorization      # index arrays on the device
    ea_plan: EAPlan                  # extend-add plan, on the device
    base_vals: torch.Tensor          # (nnz,) static entries
    dyn_pos: List[torch.Tensor]      # per-slot positions into vals
    csr_rows: torch.Tensor           # (nnz,) int64 row ids
    csr_cols: torch.Tensor           # (nnz,) int64
    dtype: torch.dtype
    reg: torch.Tensor                # (N,) signed static regularization

    @property
    def nnz(self) -> int:
        return int(self.base_vals.shape[0])

    def assemble(self, dyn_vals: Sequence[torch.Tensor]) -> torch.Tensor:
        """Scatter the dynamic slot values onto the static base."""
        vals = self.base_vals.clone()
        for pos, v in zip(self.dyn_pos, dyn_vals):
            vals.index_add_(0, pos, v.to(vals.dtype))
        return vals

    @profiled("el.kkt.equilibrate")
    def equilibrate(self, vals: torch.Tensor, iters: int = 3
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Symmetric Ruiz scaling D·K·D (pattern unchanged), bounding the
        element growth of the pivot-free quasi-definite LDL (reference
        ``equilibrate/SymmetricRuiz`` role)."""
        d = torch.ones(self.N, dtype=vals.dtype, device=vals.device)
        v = vals
        for _ in range(iters):
            rmax = torch.zeros_like(d).scatter_reduce_(
                0, self.csr_rows, torch.abs(v), "amax")
            d = d / torch.where(rmax > 0, torch.sqrt(rmax),
                                torch.ones_like(rmax))
            v = vals * d[self.csr_rows] * d[self.csr_cols]
        return v, d

    @profiled("el.kkt.prepare")
    def prepare(self, vals: torch.Tensor, spd: bool = False,
                equilibrate: bool = True,
                pivot_floor=None) -> "KKTFactor":
        """Equilibrate + factor the assembled KKT.  ``pivot_floor``:
        optional (N,) signed floors (original order, equilibrated scale)
        for the dynamic pivot regularization (reference
        ``RegularizedLDL``).  Without floors, a factor with a pivot that is
        exactly zero (where the JAX package divides by it) is taken again
        with :attr:`reg` as the floors; any other factor is kept as it is,
        at the cost of one check on the host."""
        if equilibrate:
            v, scale = self.equilibrate(vals)
        else:
            v, scale = vals, torch.ones(self.N, dtype=vals.dtype,
                                        device=vals.device)
        num = _mf_factor(self.symb, v, ea_plan=self.ea_plan,
                         dtype=v.dtype, spd=spd, pivot_floor=pivot_floor)
        if pivot_floor is None and bool((num.d == 0).any()):
            with profile_region("el.kkt.factor_retake"):
                num = _mf_factor(self.symb, v, ea_plan=self.ea_plan,
                                 dtype=v.dtype, spd=spd,
                                 pivot_floor=self.reg * scale * scale)
        return KKTFactor(self, vals, num.pool, num.d, scale)

    def matvec(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """K·x with the given value vector (refinement residuals)."""
        prod = vals * x[self.csr_cols]
        return torch.zeros(self.N, dtype=prod.dtype,
                           device=prod.device).index_add_(0, self.csr_rows,
                                                          prod)


def _hessenberg_lstsq(H: torch.Tensor, b: torch.Tensor,
                      k: int) -> torch.Tensor:
    """min‖H·y − b‖ for the (k+1)×k GMRES Hessenberg via k Givens rotations
    + back-substitution (normal equations would square the conditioning,
    which an f32 subsolve cannot survive)."""
    R = H.clone()
    b = b.clone()
    one = torch.ones((), dtype=H.dtype, device=H.device)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    for j in range(k):
        a1, a2 = R[j, j], R[j + 1, j]
        rho = torch.sqrt(a1 * a1 + a2 * a2)
        safe = torch.where(rho > 0, rho, one)
        c = torch.where(rho > 0, a1 / safe, one)
        s = torch.where(rho > 0, a2 / safe, zero)
        rj, rj1 = R[j].clone(), R[j + 1].clone()
        R[j] = c * rj + s * rj1
        R[j + 1] = -s * rj + c * rj1
        bj, bj1 = b[j].clone(), b[j + 1].clone()
        b[j] = c * bj + s * bj1
        b[j + 1] = -s * bj + c * bj1
    y = torch.zeros(k, dtype=H.dtype, device=H.device)
    for j in range(k - 1, -1, -1):
        num = b[j] - R[j, :k] @ y     # y[i]=0 for i ≤ j, so this is Σ_{i>j}
        dj = R[j, j]
        y[j] = torch.where(torch.abs(dj) > 0,
                           num / torch.where(dj == 0, one, dj), zero)
    return y


@dataclasses.dataclass
class KKTFactor:
    """Factored (equilibrated) KKT: K = D⁻¹·(L·D_L·Lᵀ)·D⁻¹."""

    sys: KKTSystem
    vals: torch.Tensor              # unscaled assembled values
    pool: torch.Tensor
    d: torch.Tensor
    scale: torch.Tensor             # D (equilibration)
    # the refined solve's CUDA graph, released with the factor
    _graph: Optional[_SolveGraph] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    # Above this size solve_refined builds the per-level panel inverses
    # when the caller gives none.  Numerics, not compile cost: below it,
    # substitution's eps·‖L‖ residual beats the inverse's eps·κ(panel) on
    # ill-conditioned spread-θ panels (measured on the JAX package: the f64
    # RNNLS solver loses x ≥ 0 with the inverse at N=245).
    SOLVE_CONTEXT_MIN_N = 4096

    def _ldl(self) -> LDLFactorization:
        return LDLFactorization(self.sys.symb, self.pool, self.d)

    def solve(self, rhs: torch.Tensor, ctx=None) -> torch.Tensor:
        return self.scale * self._ldl().solve(self.scale * rhs, ctx)

    def solve_context(self):
        """Per-level panel inverses of the equilibrated factor: build once
        per factor, pass to every ``solve_refined`` against it."""
        return self._ldl().solve_context()

    def default_context(self):
        """The context ``solve_refined`` builds when given none: the panel
        inverses above ``SOLVE_CONTEXT_MIN_N``, else None (substitution).
        An engine that solves twice against one factor builds it once here
        and passes it to both solves, with the same numbers."""
        if self.sys.N > self.SOLVE_CONTEXT_MIN_N:
            return self.solve_context()
        return None

    @profiled("el.kkt.solve_refined")
    def solve_refined(self, rhs: torch.Tensor,
                      reg_diag: Optional[torch.Tensor] = None,
                      iters: int = 2, ctx=None) -> torch.Tensor:
        """Solve K₀·x = rhs, K₀ = K − diag(reg_diag), by ``iters`` steps of
        FGMRES preconditioned with the LDL factor of the regularized K (the
        reference's refined ``SolveAfter``, upgraded from Richardson to a
        Krylov-optimal correction).  Never worse than the plain factored
        solve, which is recovered as β·Z[0].

        On a CUDA card, with the context given by the caller, the call is
        one fixed chain of kernels with no host wait: the first call of a
        key (``ctx``, ``iters``, ``rhs``'s shape and dtype, ``reg_diag``'s,
        the current stream) captures it as a CUDA graph held by the
        factor, and later calls copy their inputs in, replay it and return
        a copy of its answer (``solve_refined.captures``, ``.replays``
        count them).  A call of another key captures again and replaces
        the graph."""
        if ctx is None:
            return self._fgmres(rhs, reg_diag, iters, self.default_context())
        if (rhs.device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return self._fgmres(rhs, reg_diag, iters, ctx)
        reg = None if reg_diag is None else (reg_diag.shape, reg_diag.dtype)
        key = (int(iters), rhs.shape, rhs.dtype, reg,
               torch.cuda.current_stream(rhs.device))
        g = self._graph
        if g is not None and g.ctx is ctx and g.key == key:
            with profile_region("el.kkt.solve_graph.replay"):
                out = g.replay(rhs, reg_diag)
            _SOLVE_REFINED.replays += 1
            return out
        self._graph = None              # the old graph's memory goes first
        with profile_region("el.kkt.solve_graph.capture"):
            g = self._graph = _SolveGraph(
                lambda b, r: self._fgmres(b, r, iters, ctx), key, ctx, rhs,
                reg_diag)
            out = g.replay(rhs, reg_diag)
        _SOLVE_REFINED.captures += 1
        return out

    def _fgmres(self, rhs: torch.Tensor, reg_diag: Optional[torch.Tensor],
                iters: int, ctx) -> torch.Tensor:
        """The refined solve's kernels, issued from the host."""
        def K0(x):
            kx = self.sys.matvec(self.vals, x)
            if reg_diag is not None:
                kx = kx - reg_diag * x
            return kx

        N = rhs.shape[0]
        dev, dt = rhs.device, rhs.dtype
        beta = torch.linalg.norm(rhs)
        k = max(1, int(iters))
        V = torch.zeros((k + 1, N), dtype=dt, device=dev)
        V[0] = rhs / torch.where(beta > 0, beta, torch.ones_like(beta))
        Z = torch.zeros((k, N), dtype=dt, device=dev)
        H = torch.zeros((k + 1, k), dtype=dt, device=dev)
        ar = torch.arange(k + 1, device=dev)
        for j in range(k):
            z = self.solve(V[j], ctx)
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
        x0 = beta * Z[0]               # the plain preconditioned solve
        # monotone safeguard: keep the Krylov combination only if it helps
        better = (torch.linalg.norm(rhs - K0(cand))
                  < torch.linalg.norm(rhs - K0(x0)))
        return torch.where(better, cand, x0)


_SOLVE_REFINED = KKTFactor.solve_refined
_SOLVE_REFINED.captures = 0     # refined solves captured as a CUDA graph
_SOLVE_REFINED.replays = 0      # refined solves that replayed one


class _SolveGraph:
    """One refined solve captured as a CUDA graph: the key and context it
    was captured for (holding the context keeps the panel inverses it reads
    alive), the static input buffers it reads and the output it writes."""

    __slots__ = ("key", "ctx", "graph", "rhs", "reg", "out")

    # one capture stream a card, warmed by an eager solve before its first
    # capture: cuBLAS's workspace for the stream, and every kernel's module,
    # then exist before any capture
    _streams: Dict[torch.device, "torch.cuda.Stream"] = {}
    # the last graph captured for each replay stream, whose memory pool the
    # next capture there shares: a graph's intermediates live only while it
    # runs, replays on one stream never overlap, and each answer is copied
    # out right after its replay, so a new factor's graph reuses what a
    # dropped factor's held (a pool of its own would stay reserved after
    # the graph is gone); kept only for its pool
    _last: Dict["torch.cuda.Stream", "torch.cuda.CUDAGraph"] = {}

    def __init__(self, fn, key, ctx, rhs: torch.Tensor,
                 reg_diag: Optional[torch.Tensor]):
        """Capture ``fn(rhs, reg_diag)`` on the card's capture stream into
        a graph that shares the pool of the last graph captured for the
        current stream.  Only the first capture on a card runs anything
        there: ``fn`` once, eagerly, to warm the stream."""
        self.key, self.ctx = key, ctx
        self.rhs = rhs.clone()
        self.reg = None if reg_diag is None else reg_diag.clone()
        self.graph = torch.cuda.CUDAGraph()
        dev = rhs.device
        current = torch.cuda.current_stream(dev)
        stream = self._streams.get(dev)
        with torch.cuda.device(dev):
            last = self._last.get(current)
            shared = {} if last is None else {"pool": last.pool()}
            if stream is None:
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    fn(self.rhs, self.reg)
                current.wait_stream(stream)
                self._streams[dev] = stream
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.graph.capture_begin(capture_error_mode="thread_local",
                                         **shared)
                try:
                    self.out = fn(self.rhs, self.reg)
                finally:
                    self.graph.capture_end()
            self._last[current] = self.graph

    def replay(self, rhs: torch.Tensor,
               reg_diag: Optional[torch.Tensor]) -> torch.Tensor:
        """Copy the inputs in, replay on the current stream, and return a
        copy of the answer (callers keep earlier answers)."""
        self.rhs.copy_(rhs)
        if reg_diag is not None:
            self.reg.copy_(reg_diag)
        self.graph.replay()
        return self.out.clone()
