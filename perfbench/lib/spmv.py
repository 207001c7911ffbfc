"""Bytes of one band (DIA) sparse matrix-vector product, the arithmetic
of the port's SpMV roofline frozen here: the values of the matrix's
structurally nonzero blocks read once, x read once, y written once.

The matrix of a box of hexahedra with one ghost cell per boundary face
has a b x b block on the diagonal of every row (interior and ghost) and
two off-diagonal blocks per interior face. Blocks that couple a ghost
cell to its interior cell are identically zero in the port's band
storage, so they are not counted: the kernel's padding and zeros are
work these inputs do not need."""

ITEMSIZE = {"float32": 4, "float64": 8}


def band_spmv_bytes(rows: int, interior_faces: int, block: int,
                    dtype: str) -> int:
    """Bytes one product needs at these sizes and this dtype."""
    blocks = rows + 2 * interior_faces
    return ITEMSIZE[dtype] * (blocks * block * block + 2 * rows * block)
