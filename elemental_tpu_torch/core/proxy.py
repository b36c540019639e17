"""Distribution proxies (counterpart of ``elemental_tpu/core/proxy.py``;
reference ``include/El/core/Proxy.hpp``: ``DistMatrixReadProxy`` /
``DistMatrixReadWriteProxy`` — redistribute only when needed, restore on
write-back).

In a functional array model the write-back is explicit, so proxies reduce to
two helpers; they exist so ported algorithm code keeps its shape."""

from __future__ import annotations

from .dist import Dist
from .distmatrix import DistMatrix


class ReadProxy:
    """Ensure A is in [coldist, rowdist]; no copy when it already is
    (reference ``DistMatrixReadProxy``)."""

    def __init__(self, A: DistMatrix, coldist: Dist, rowdist: Dist):
        if A.dist() == (coldist, rowdist):
            self.value = A
        else:
            self.value = A.redistribute(coldist, rowdist)

    def get(self) -> DistMatrix:
        return self.value


class ReadWriteProxy:
    """Redistribute in, compute, then ``restore(new_value)`` redistributes
    back to the original layout (reference ``DistMatrixReadWriteProxy``'s
    RAII write-back, made explicit)."""

    def __init__(self, A: DistMatrix, coldist: Dist, rowdist: Dist):
        self._orig = A.dist()
        self._grid = A.grid
        self.value = (A if A.dist() == (coldist, rowdist)
                      else A.redistribute(coldist, rowdist))

    def restore(self, new_value: DistMatrix) -> DistMatrix:
        return new_value.redistribute(*self._orig)
