"""Sparse IO (counterpart of ``elemental_tpu/sparse/io.py``): MatrixMarket
read/write (reference ``src/io/`` MatrixMarket formats) and an MPS
linear-program reader (spec: the reference ships netlib instances
``data/optimization/{afiro,adlittle,share1b,share2b}.mps`` consumed by the
IPM examples).  Host NumPy, as in the JAX package.

One deliberate difference: an RHS entry on the objective row is read as the
objective constant, ``c0 = −rhs`` (the MPS convention of CPLEX and HiGHS);
the JAX reader drops it and always returns ``c0 = 0``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .csr import SparseMatrix


# --------------------------------------------------------------------------
# MatrixMarket
# --------------------------------------------------------------------------

def read_matrix_market(path: str) -> SparseMatrix:
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        parts = header.split()
        fmt, field = parts[2], parts[3]
        symmetry = parts[4] if len(parts) > 4 else "general"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        if fmt == "coordinate":
            m, n, nnz = (int(x) for x in line.split())
            data = np.loadtxt(f, ndmin=2)
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(rows.shape[0])
            else:
                vals = data[:, 2]
            if symmetry in ("symmetric", "skew-symmetric"):
                off = rows != cols
                sgn = -1.0 if symmetry == "skew-symmetric" else 1.0
                rows = np.concatenate([rows, cols[off]])
                cols_full = np.concatenate([cols, data[off, 0].astype(np.int64) - 1])
                vals = np.concatenate([vals, sgn * vals[off]])
                cols = cols_full
            return SparseMatrix.from_coo(m, n, rows, cols, vals,
                                         sum_duplicates=False)
        else:  # array (dense)
            m, n = (int(x) for x in line.split()[:2])
            vals = np.loadtxt(f).reshape(n, m).T  # column-major
            return SparseMatrix.from_dense(vals)


def write_matrix_market(path: str, A: SparseMatrix) -> None:
    rows = np.repeat(np.arange(A.height), A.row_nnz())
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{A.height} {A.width} {A.nnz}\n")
        for r, c, v in zip(rows, A.colind, A.vals):
            f.write(f"{r + 1} {c + 1} {float(v):.17g}\n")


# --------------------------------------------------------------------------
# MPS linear programs
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MPSData:
    """General-form LP:  min cᵀx + c0
    s.t.  A_eq·x = b_eq,  A_le·x ≤ b_le  (G rows pre-negated into ≤),
    l ≤ x ≤ u  (±inf where free)."""

    name: str
    c: np.ndarray
    c0: float
    A_eq: SparseMatrix
    b_eq: np.ndarray
    A_le: SparseMatrix
    b_le: np.ndarray
    lower: np.ndarray
    upper: np.ndarray
    col_names: list
    row_names: list


def read_mps(path: str) -> MPSData:
    """Parse (fixed-format) MPS as shipped in the reference's data dir."""
    section = None
    name = ""
    row_type: Dict[str, str] = {}
    row_order: list = []
    obj_row: Optional[str] = None
    cols: Dict[str, Dict[str, float]] = {}
    col_order: list = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    bounds: Dict[str, Tuple[Optional[float], Optional[float]]] = {}

    def ensure_col(c):
        if c not in cols:
            cols[c] = {}
            col_order.append(c)

    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.startswith("*"):
                continue
            if not line[0].isspace():
                parts = line.split()
                section = parts[0].upper()
                if section == "NAME":
                    name = parts[1] if len(parts) > 1 else ""
                if section == "ENDATA":
                    break
                continue
            parts = line.split()
            if section == "ROWS":
                t, rname = parts[0].upper(), parts[1]
                if t == "N":
                    if obj_row is None:
                        obj_row = rname
                else:
                    row_type[rname] = t
                    row_order.append(rname)
            elif section == "COLUMNS":
                if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                    continue  # integer markers ignored (LP relaxation)
                cname = parts[0]
                ensure_col(cname)
                for i in range(1, len(parts) - 1, 2):
                    rname, val = parts[i], float(parts[i + 1])
                    cols[cname][rname] = cols[cname].get(rname, 0.0) + val
            elif section == "RHS":
                for i in range(1, len(parts) - 1, 2):
                    rhs[parts[i]] = float(parts[i + 1])
            elif section == "RANGES":
                for i in range(1, len(parts) - 1, 2):
                    ranges[parts[i]] = float(parts[i + 1])
            elif section == "BOUNDS":
                btype = parts[0].upper()
                cname = parts[2]
                ensure_col(cname)
                val = float(parts[3]) if len(parts) > 3 else 0.0
                lo, hi = bounds.get(cname, (0.0, None))
                if btype == "UP":
                    hi = val
                    if val < 0 and lo == 0.0:
                        lo = -np.inf
                elif btype == "LO":
                    lo = val
                elif btype == "FX":
                    lo = hi = val
                elif btype == "FR":
                    lo, hi = -np.inf, None
                elif btype == "MI":
                    lo = -np.inf
                elif btype == "PL":
                    hi = None
                elif btype == "BV":
                    lo, hi = 0.0, 1.0
                bounds[cname] = (lo, hi)

    ncols = len(col_order)
    col_idx = {c: j for j, c in enumerate(col_order)}
    c = np.zeros(ncols)
    for cname, entries in cols.items():
        if obj_row in entries:
            c[col_idx[cname]] = entries[obj_row]

    eq_rows = [r for r in row_order if row_type[r] == "E"]
    ineq_rows = [r for r in row_order if row_type[r] in ("L", "G")]
    # RANGES turn one-sided rows into two-sided; expand G/L + range into an
    # extra ≤ row pair.
    def build(rows_list, flip_g=False):
        ridx = {r: i for i, r in enumerate(rows_list)}
        rr, cc, vv = [], [], []
        for cname, entries in cols.items():
            j = col_idx[cname]
            for rname, val in entries.items():
                if rname in ridx:
                    sgn = -1.0 if (flip_g and row_type[rname] == "G") else 1.0
                    rr.append(ridx[rname])
                    cc.append(j)
                    vv.append(sgn * val)
        A = SparseMatrix.from_coo(len(rows_list), ncols,
                                  np.array(rr, np.int64),
                                  np.array(cc, np.int64), np.array(vv))
        b = np.array([(-1.0 if (flip_g and row_type[r] == "G") else 1.0)
                      * rhs.get(r, 0.0) for r in rows_list])
        return A, b

    A_eq, b_eq = build(eq_rows)
    A_le, b_le = build(ineq_rows, flip_g=True)

    # ranged inequality rows add the opposite-side constraint
    extra_rows, extra_b = [], []
    for r in ineq_rows:
        if r in ranges:
            i = ineq_rows.index(r)
            rng = abs(ranges[r])
            # existing row: a·x ≤ b (after flip); add −a·x ≤ −(b − rng)
            extra_rows.append(i)
            extra_b.append(rng)
    if extra_rows:
        import scipy.sparse as sp
        base = A_le.to_scipy()
        neg = -base[extra_rows]
        A_le = SparseMatrix.from_scipy(sp.vstack([base, neg]).tocsr())
        b_le = np.concatenate([b_le,
                               [-(b_le[i] - e)
                                for i, e in zip(extra_rows, extra_b)]])

    lower = np.zeros(ncols)
    upper = np.full(ncols, np.inf)
    for cname, (lo, hi) in bounds.items():
        j = col_idx[cname]
        lower[j] = -np.inf if lo is not None and np.isneginf(lo) else (
            lo if lo is not None else 0.0)
        upper[j] = hi if hi is not None else np.inf

    c0 = -rhs[obj_row] if obj_row in rhs else 0.0
    return MPSData(name, c, c0, A_eq, b_eq, A_le, b_le, lower, upper,
                   col_order, row_order)
