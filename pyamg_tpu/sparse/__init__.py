"""Device sparse substrate: padded-ELL and block-ELL containers."""

from .ell import SparseELL, ell_matvec
from .bell import BlockELL
from .dia import SparseDIA
from .bdia import SparseBDIA
from .linop import (ComposedOp, GridRepeatOp, GridPoolOp, DenseOp,
                    CptProlongOp, CptRestrictOp)
from .device_op import device_operator, count_diagonals
from .ops import spgemm, rap, transpose

__all__ = ["SparseELL", "BlockELL", "SparseDIA", "SparseBDIA", "ComposedOp",
           "GridRepeatOp", "GridPoolOp", "DenseOp", "CptProlongOp",
           "CptRestrictOp", "device_operator",
           "count_diagonals", "ell_matvec", "spgemm", "rap", "transpose"]
